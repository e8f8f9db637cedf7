"""Synthetic LBSN generator shaped to the paper's four datasets (a copy
of ``repro.data.lbsn``: the same specs and seeds give the same graphs).

The paper's datasets are not bundled, so the generator reproduces the
*structural statistics that drive the paper's results* (Table 2),
scaled down by a recorded factor:

* user/venue split          — Yelp 93/7 vs Gowalla 13/87 etc.
* edge density              — m/n between 2.8 (Weeplaces) and 10 (Yelp)
* social SCC structure      — the key variable.  ``reciprocity`` controls
  how much of the social graph collapses: Gowalla's social graph is one
  giant SCC (1 user SCC), Yelp's is nearly a DAG (87.9% of SCCs are user
  SCCs).  Reciprocal follow edges create 2-cycles that Tarjan merges.
* spatial skew              — venues drawn from a Gaussian-mixture of
  "cities" over a [0, 100]^2 world, so region queries see realistic
  selectivity variance.
* venues are sinks          — check-in edges point user -> venue and
  venues have no outgoing edges (the LBSN data model in §5.1).

``dataset_stats`` computes a generated graph's Table-2-style
statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core.graph import GeosocialGraph, make_graph


@dataclasses.dataclass(frozen=True)
class LBSNSpec:
    name: str
    n_nodes: int
    venue_frac: float        # fraction of nodes that are venues
    social_avg_deg: float    # mean social out-degree per user
    checkin_avg: float       # mean check-in edges per user
    reciprocity: float       # P(follow edge is reciprocated) — SCC knob
    n_cities: int = 12
    city_sigma: float = 3.0
    zipf_users: float = 1.3  # popularity skew of follow targets
    zipf_venues: float = 1.2
    seed: int = 0
    # paper Table 2 reference statistics (full-scale, for reporting)
    ref: Optional[Dict[str, float]] = None


# Scaled to ~2% of the real datasets; the *ratios* are what matters.
SPECS: Dict[str, LBSNSpec] = {
    "foursquare": LBSNSpec(
        name="foursquare", n_nodes=65_000, venue_frac=0.348,
        social_avg_deg=7.0, checkin_avg=2.5, reciprocity=0.55, seed=11,
        ref=dict(users=2_119_987, venues=1_132_617, nodes=3_252_604,
                 edges=19_685_786, sccs=1_400_154, user_sccs=267_537),
    ),
    "gowalla": LBSNSpec(
        name="gowalla", n_nodes=62_000, venue_frac=0.87,
        social_avg_deg=30.0, checkin_avg=4.5, reciprocity=0.95, seed=12,
        ref=dict(users=407_533, venues=2_723_102, nodes=3_130_635,
                 edges=23_778_362, sccs=2_723_103, user_sccs=1),
    ),
    "weeplaces": LBSNSpec(
        name="weeplaces", n_nodes=50_000, venue_frac=0.984,
        social_avg_deg=40.0, checkin_avg=2.2, reciprocity=0.95, seed=13,
        ref=dict(users=16_022, venues=971_309, nodes=987_331,
                 edges=2_758_946, sccs=971_311, user_sccs=2),
    ),
    "yelp": LBSNSpec(
        name="yelp", n_nodes=43_000, venue_frac=0.07,
        social_avg_deg=9.5, checkin_avg=1.2, reciprocity=0.04, seed=14,
        ref=dict(users=1_987_693, venues=150_310, nodes=2_138_003,
                 edges=21_357_271, sccs=1_238_535, user_sccs=1_088_225),
    ),
}


def _zipf_weights(k: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** a
    return w / w.sum()


def generate_lbsn(spec: LBSNSpec) -> GeosocialGraph:
    rng = np.random.default_rng(spec.seed)
    n = spec.n_nodes
    n_venues = int(round(n * spec.venue_frac))
    n_users = n - n_venues
    users = np.arange(n_users)
    venues = np.arange(n_users, n)

    # --- social follow edges (user -> user) ------------------------------
    deg = rng.poisson(spec.social_avg_deg, size=n_users).astype(np.int64)
    total = int(deg.sum())
    src = np.repeat(users, deg)
    pop = _zipf_weights(n_users, spec.zipf_users)
    dst = rng.choice(n_users, size=total, p=pop)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # reciprocity: each follow edge is returned with probability r
    rec = rng.random(len(src)) < spec.reciprocity
    social = np.concatenate(
        [
            np.stack([src, dst], axis=1),
            np.stack([dst[rec], src[rec]], axis=1),
        ]
    )

    # --- check-in edges (user -> venue); venues are sinks -----------------
    ndeg = rng.poisson(spec.checkin_avg, size=n_users).astype(np.int64)
    ctotal = int(ndeg.sum())
    csrc = np.repeat(users, ndeg)
    vpop = _zipf_weights(n_venues, spec.zipf_venues)
    cdst = venues[rng.choice(n_venues, size=ctotal, p=vpop)]
    checkins = np.stack([csrc, cdst], axis=1)

    edges = np.concatenate([social, checkins])

    # --- venue coordinates: mixture of cities ----------------------------
    centers = rng.random((spec.n_cities, 2)) * 100.0
    city = rng.integers(0, spec.n_cities, size=n_venues)
    coords = np.zeros((n, 2), dtype=np.float32)
    coords[venues] = (
        centers[city] + rng.standard_normal((n_venues, 2)) * spec.city_sigma
    ).astype(np.float32)
    np.clip(coords, 0.0, 100.0, out=coords)

    spatial_mask = np.zeros(n, dtype=bool)
    spatial_mask[venues] = True

    g = make_graph(n, edges, coords, spatial_mask)
    g.validate()
    return g


def dataset_stats(g: GeosocialGraph) -> Dict[str, float]:
    """Table-2-style statistics of a generated graph."""
    from ..core.condensation import condense
    from ..core.scc import scc_np

    labels = scc_np(g.n_nodes, g.edges)
    cond = condense(g.n_nodes, g.edges, labels)
    d = cond.n_comps
    spatial_comp = np.zeros(d, dtype=bool)
    sv = g.spatial_ids
    spatial_comp[cond.comp[sv]] = True
    return dict(
        users=g.n_nodes - g.n_spatial,
        venues=g.n_spatial,
        nodes=g.n_nodes,
        edges=g.n_edges,
        sccs=d,
        user_sccs=int((~spatial_comp).sum()),
    )
