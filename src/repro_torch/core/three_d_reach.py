"""3DReach and 3DReach-Rev baselines (Bouros et al., EDBT'25).

A copy of ``repro.core.three_d_reach`` (host NumPy).

The paper compares against these, so they are implemented from scratch:

* **3DReach**: SCC condensation -> AIJ interval labels -> every spatial
  vertex indexed as the 3-D point ``(x, y, post(comp(v)))`` in ONE 3-D
  R-tree.  A query issues **one 3-D range probe per interval** of the
  query component's label — the multiplicity that makes its latency blow
  up on high-social-complexity graphs (paper Fig. 3, Yelp).
* **3DReach-Rev**: interval labels on the *reversed* condensation; a
  spatial vertex becomes one **vertical line segment** ``(x, y,
  [lo, hi])`` per reverse interval (so the index stores more/larger
  geometry — paper Table 4 shows ~2x size), and a query is a single 3-D
  probe at ``z = post_rev(comp(u))``.

Both reuse the packed R-tree forest (dim=3; segments are genuine boxes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np

from .condensation import Condensation, condense
from .graph import GeosocialGraph
from .interval_labels import IntervalLabels, build_interval_labels
from .rtree import (
    DEFAULT_FANOUT,
    RTreeForest,
    _ragged_arange,
    build_forest,
    query_host,
)
from .scc import scc_np


@dataclasses.dataclass
class ThreeDReachIndex:
    variant: str                 # "3d" | "3drev"
    n: int
    cond: Condensation
    labels: IntervalLabels       # forward labels (3d) or reverse (3drev)
    forest: RTreeForest          # single 3-D tree (tree id 0)
    stats: Dict[str, float]

    def nbytes_rtree(self) -> int:
        return self.forest.nbytes_total()

    def nbytes_labels(self) -> int:
        # 3DReach stores the labelling; 3DReach-Rev bakes it into geometry
        return self.labels.nbytes() if self.variant == "3d" else int(
            self.labels.post.nbytes
        )

    def nbytes_total(self) -> int:
        return self.nbytes_rtree() + self.nbytes_labels()

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        us = np.asarray(us, dtype=np.int64)
        rects = np.asarray(rects, dtype=np.float32).reshape(len(us), 4)
        c = self.cond.comp[us]
        if self.variant == "3d":
            # one 3-D probe per interval of the query component
            s = self.labels.indptr[c]
            e = self.labels.indptr[c + 1]
            cnt = (e - s).astype(np.int64)
            qi = np.repeat(np.arange(len(us)), cnt)
            slot = np.repeat(s, cnt) + _ragged_arange(cnt)
            lo = self.labels.lo[slot].astype(np.float32)
            hi = self.labels.hi[slot].astype(np.float32)
            r = rects[qi]
            rect3 = np.stack(
                [r[:, 0], r[:, 1], lo - 0.5, r[:, 2], r[:, 3], hi + 0.5],
                axis=1,
            )
            sub = query_host(
                self.forest, np.zeros(len(qi), dtype=np.int64), rect3
            )
            ans = np.zeros(len(us), dtype=bool)
            np.logical_or.at(ans, qi, sub)
            return ans
        # 3drev: single probe at z = post_rev(comp(u))
        z = self.labels.post[c].astype(np.float32)
        rect3 = np.stack(
            [rects[:, 0], rects[:, 1], z, rects[:, 2], rects[:, 3], z],
            axis=1,
        )
        return query_host(self.forest, np.zeros(len(us), dtype=np.int64), rect3)

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])

    def intervals_per_query_comp(self, us: np.ndarray) -> np.ndarray:
        c = self.cond.comp[np.asarray(us, dtype=np.int64)]
        return (self.labels.indptr[c + 1] - self.labels.indptr[c]).astype(
            np.int64
        )


def build_3dreach(
    graph: GeosocialGraph,
    variant: str = "3d",
    fanout: int = DEFAULT_FANOUT,
) -> ThreeDReachIndex:
    if variant not in ("3d", "3drev"):
        raise ValueError(f"unknown 3DReach variant {variant!r}; expected "
                         f"'3d' or '3drev'")
    t_start = time.perf_counter()
    stats: Dict[str, float] = {}
    n = graph.n_nodes

    t0 = time.perf_counter()
    labels_v = scc_np(n, graph.edges)
    cond = condense(n, graph.edges, labels_v)
    stats["t_scc"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if variant == "3d":
        lbl = build_interval_labels(cond)
    else:
        rev = Condensation(
            comp=cond.comp,
            n_comps=cond.n_comps,
            dag_edges=cond.dag_edges[:, ::-1] if cond.dag_edges.size
            else cond.dag_edges,
            level=cond.level,  # unused by labelling
            comp_sizes=cond.comp_sizes,
        )
        lbl = build_interval_labels(rev)
    stats["t_labels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sv = graph.spatial_ids
    pts = graph.coords[sv]
    c = cond.comp[sv]
    if variant == "3d":
        z = lbl.post[c].astype(np.float32)
        boxes = np.stack(
            [pts[:, 0], pts[:, 1], z, pts[:, 0], pts[:, 1], z], axis=1
        )
        ids = sv
    else:
        # one segment per (spatial vertex, reverse interval)
        s = lbl.indptr[c]
        e = lbl.indptr[c + 1]
        cnt = (e - s).astype(np.int64)
        vi = np.repeat(np.arange(len(sv)), cnt)
        slot = np.repeat(s, cnt) + _ragged_arange(cnt)
        lo = lbl.lo[slot].astype(np.float32)
        hi = lbl.hi[slot].astype(np.float32)
        p2 = pts[vi]
        boxes = np.stack(
            [p2[:, 0], p2[:, 1], lo, p2[:, 0], p2[:, 1], hi], axis=1
        )
        ids = sv[vi]
    ext = graph.spatial_extent()
    zmax = float(cond.n_comps)
    extent3 = np.array(
        [ext[0], ext[1], 0.0, ext[2], ext[3], zmax], dtype=np.float32
    )
    forest = build_forest(
        boxes,
        ids.astype(np.int32),
        np.zeros(len(boxes), dtype=np.int64),
        n_trees=1,
        fanout=fanout,
        extent=extent3,
    )
    stats["t_forest"] = time.perf_counter() - t0
    stats["t_total"] = time.perf_counter() - t_start
    stats["n_comps"] = float(cond.n_comps)
    stats["total_intervals"] = float(lbl.total_intervals)

    return ThreeDReachIndex(
        variant=variant, n=n, cond=cond, labels=lbl, forest=forest,
        stats=stats,
    )

