"""GeoReach baseline (Sun & Sarwat 2016) — SPA-graph pruned traversal.

A copy of ``repro.core.georeach`` (host NumPy).

The first dedicated RangeReach method: every vertex carries precomputed
spatial-reachability summaries and the query *traverses the graph*,
pruning branches whose summary cannot intersect the region.  We implement
the B (reachability bit) and R (reachability MBR) tiers of the SPA-graph,
computed per SCC component (all members share a summary) via the same
reverse-topological closure substrate as 2DReach — only tracking 4-float
MBRs instead of bitsets.

The traversal runs on the condensation (equivalent to the vertex-level
SPA-graph walk but strictly less work) and exhibits exactly the failure
mode the paper describes: when the answer is negative or the graph has
many components, large portions of the DAG must be explored.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np

from .condensation import Condensation, condense
from .graph import GeosocialGraph
from .reachability import closure_mbr_np
from .scc import scc_np


@dataclasses.dataclass
class GeoReachIndex:
    n: int
    cond: Condensation
    comp_mbr: np.ndarray        # (d, 4) reachability MBR per component
    dag_indptr: np.ndarray      # DAG out-edge CSR
    dag_adj: np.ndarray
    own_indptr: np.ndarray      # per-comp own spatial vertex CSR
    own_pts: np.ndarray         # (k, 2) coordinates aligned with own CSR
    stats: Dict[str, float]
    _visit_stamp: np.ndarray = dataclasses.field(default=None, repr=False)
    _stamp: int = 0

    def nbytes_spatial(self) -> int:
        """Spatial-structure bytes: the R-MBR summaries plus the
        per-component venue point lists (GeoReach's stand-in for the
        R-tree column of the paper's Table 4)."""
        return int(
            self.comp_mbr.nbytes + self.own_indptr.nbytes
            + self.own_pts.nbytes
        )

    def nbytes_social(self) -> int:
        """Social-side bytes: the condensation DAG the query traverses."""
        return int(self.dag_indptr.nbytes + self.dag_adj.nbytes)

    def nbytes_total(self) -> int:
        return self.nbytes_spatial() + self.nbytes_social()

    def query(self, u: int, rect) -> bool:
        """DFS over the condensation with R-MBR pruning."""
        xmin, ymin, xmax, ymax = (float(v) for v in rect)
        c0 = int(self.cond.comp[u])
        if c0 < 0:
            return False
        if self._visit_stamp is None or len(self._visit_stamp) != self.cond.n_comps:
            self._visit_stamp = np.zeros(self.cond.n_comps, dtype=np.int64)
            self._stamp = 0
        self._stamp += 1
        stamp = self._stamp
        vis = self._visit_stamp
        mbr = self.comp_mbr
        indptr, adj = self.dag_indptr, self.dag_adj
        oi, op = self.own_indptr, self.own_pts
        stack = [c0]
        vis[c0] = stamp
        explored = 0
        while stack:
            c = stack.pop()
            explored += 1
            # R tier prune: reachability MBR disjoint from region
            if (
                mbr[c, 0] > xmax or mbr[c, 2] < xmin
                or mbr[c, 1] > ymax or mbr[c, 3] < ymin
            ):
                continue
            # own spatial members inside the region?
            s, e = oi[c], oi[c + 1]
            if s < e:
                pts = op[s:e]
                if (
                    (pts[:, 0] >= xmin) & (pts[:, 0] <= xmax)
                    & (pts[:, 1] >= ymin) & (pts[:, 1] <= ymax)
                ).any():
                    self.stats["last_explored"] = float(explored)
                    return True
            for ch in adj[indptr[c]:indptr[c + 1]]:
                if vis[ch] != stamp:
                    vis[ch] = stamp
                    stack.append(ch)
        self.stats["last_explored"] = float(explored)
        return False

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        us = np.asarray(us, dtype=np.int64)
        rects = np.asarray(rects, dtype=np.float32).reshape(len(us), 4)
        return np.array(
            [self.query(int(u), r) for u, r in zip(us, rects)], dtype=bool
        )


def build_georeach(graph: GeosocialGraph) -> GeoReachIndex:
    t_start = time.perf_counter()
    stats: Dict[str, float] = {}
    n = graph.n_nodes

    t0 = time.perf_counter()
    labels = scc_np(n, graph.edges)
    cond = condense(n, graph.edges, labels)
    stats["t_scc"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    comp_mbr = closure_mbr_np(cond, graph.coords, graph.spatial_mask)
    stats["t_mbr_closure"] = time.perf_counter() - t0

    d = cond.n_comps
    # DAG CSR
    de = cond.dag_edges
    if de.size:
        order = np.argsort(de[:, 0], kind="stable")
        dag_indptr = np.zeros(d + 1, dtype=np.int64)
        np.cumsum(np.bincount(de[order, 0], minlength=d), out=dag_indptr[1:])
        dag_adj = de[order, 1].astype(np.int32)
    else:
        dag_indptr = np.zeros(d + 1, dtype=np.int64)
        dag_adj = np.zeros(0, dtype=np.int32)

    # own spatial members CSR
    sv = graph.spatial_ids
    c = cond.comp[sv]
    ok = c >= 0
    c, sv2 = c[ok], sv[ok]
    order = np.argsort(c, kind="stable")
    own_indptr = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(np.bincount(c[order], minlength=d), out=own_indptr[1:])
    own_pts = graph.coords[sv2[order]]

    stats["t_total"] = time.perf_counter() - t_start
    return GeoReachIndex(
        n=n, cond=cond, comp_mbr=comp_mbr,
        dag_indptr=dag_indptr, dag_adj=dag_adj,
        own_indptr=own_indptr, own_pts=own_pts, stats=stats,
    )
