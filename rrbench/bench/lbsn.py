"""The benchmark's own copy of the synthetic LBSN generator.

A frozen copy of ``repro_torch.data.lbsn.generate_lbsn``: given the same
parameters and seed it draws the same edges, coordinates and spatial mask,
but it returns plain NumPy arrays and imports nothing of the program, so
the data that the program and the reference are handed is the yardstick's.

The graph is shaped to the paper's Table-2 statistics by the parameters of
a configuration file (``rrbench/configs/<name>.json``, key ``graph``):

* ``n_nodes``, ``venue_frac``      users and venues;
* ``social_avg_deg``               mean follow edges per user, targets Zipf
                                   (``zipf_users``) over users;
* ``reciprocity``                  the chance a follow edge is returned: the
                                   knob of the social SCC structure;
* ``checkin_avg``                  mean check-ins per user, venues Zipf
                                   (``zipf_venues``); venues are sinks;
* ``venue_min_checkins``           check-ins every venue gets on top of
                                   those, each from a user drawn uniformly
                                   (an LBSN's venues are the places someone
                                   checked in at); drawn last, so at 0 the
                                   draw is the program generator's;
* ``n_cities``, ``city_sigma``     venues drawn from a mixture of Gaussian
                                   cities over a [0, 100]^2 world;
* ``city_seed`` (optional)         where given, the cities' centres are
                                   drawn from it and not from the run's
                                   seed: the deployment's geography, the
                                   same in every run, so that a seed
                                   changes the data and not the work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A generated geosocial graph, as raw arrays."""

    n_nodes: int
    edges: np.ndarray         # (m, 2) int64, duplicates possible
    coords: np.ndarray        # (n, 2) float32; 0 for users
    spatial_mask: np.ndarray  # (n,) bool: the venues


GRAPH_KEYS = ("n_nodes", "venue_frac", "social_avg_deg", "checkin_avg",
              "reciprocity", "n_cities", "city_sigma", "zipf_users",
              "zipf_venues", "venue_min_checkins")


def _zipf_weights(k: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** a
    return w / w.sum()


def generate(params: Dict[str, float], seed: int) -> Graph:
    """The graph of ``params`` (``GRAPH_KEYS``) drawn from ``seed``."""
    missing = [k for k in GRAPH_KEYS if k not in params]
    if missing:
        raise ValueError(f"graph parameters missing: {missing}")
    rng = np.random.default_rng(seed)
    n = int(params["n_nodes"])
    n_venues = int(round(n * params["venue_frac"]))
    n_users = n - n_venues
    users = np.arange(n_users)
    venues = np.arange(n_users, n)

    # social follow edges (user -> user), each returned with probability r
    deg = rng.poisson(params["social_avg_deg"], size=n_users).astype(np.int64)
    total = int(deg.sum())
    src = np.repeat(users, deg)
    pop = _zipf_weights(n_users, params["zipf_users"])
    dst = rng.choice(n_users, size=total, p=pop)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rec = rng.random(len(src)) < params["reciprocity"]
    social = np.concatenate([np.stack([src, dst], axis=1),
                             np.stack([dst[rec], src[rec]], axis=1)])

    # check-in edges (user -> venue); venues are sinks
    ndeg = rng.poisson(params["checkin_avg"], size=n_users).astype(np.int64)
    csrc = np.repeat(users, ndeg)
    vpop = _zipf_weights(n_venues, params["zipf_venues"])
    cdst = venues[rng.choice(n_venues, size=int(ndeg.sum()), p=vpop)]
    edges = np.concatenate([social, np.stack([csrc, cdst], axis=1)])

    # venue coordinates: a mixture of cities
    n_cities = int(params["n_cities"])
    centers = rng.random((n_cities, 2)) * 100.0
    if params.get("city_seed") is not None:
        centers = np.random.default_rng(int(params["city_seed"])).random(
            (n_cities, 2)) * 100.0
    city = rng.integers(0, n_cities, size=n_venues)
    coords = np.zeros((n, 2), dtype=np.float32)
    coords[venues] = (centers[city] + rng.standard_normal((n_venues, 2))
                      * params["city_sigma"]).astype(np.float32)
    np.clip(coords, 0.0, 100.0, out=coords)

    # every venue checked in at least ``venue_min_checkins`` times
    k = int(params["venue_min_checkins"])
    if k > 0:
        vdst = np.repeat(venues, k)
        vsrc = rng.integers(0, n_users, size=len(vdst))
        edges = np.concatenate([edges, np.stack([vsrc, vdst], axis=1)])
    spatial = np.zeros(n, dtype=bool)
    spatial[venues] = True
    return Graph(n_nodes=n, edges=edges.astype(np.int64), coords=coords,
                 spatial_mask=spatial)


def out_degree(g: Graph) -> np.ndarray:
    """Out-degree over the distinct edges, as the program's graph counts
    it after dropping duplicates.  Sorts and masks rather than calling
    ``np.unique``, whose hash table (NumPy 2.3 and later) is many times
    slower on ten million distinct keys."""
    key = np.sort(g.edges[:, 0] << 32 | g.edges[:, 1])
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    return np.bincount(key[first] >> 32,
                       minlength=g.n_nodes).astype(np.int64)


def spatial_extent(g: Graph) -> np.ndarray:
    """[xmin, ymin, xmax, ymax] of the venues, float32."""
    pts = g.coords[g.spatial_mask]
    if not len(pts):
        return np.zeros(4, dtype=np.float32)
    return np.array([pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(),
                     pts[:, 1].max()], dtype=np.float32)
