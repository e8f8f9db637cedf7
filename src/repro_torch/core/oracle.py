"""Brute-force RangeReach oracle — ground truth for every index method.

BFS over the raw graph; an index answer disagreeing with this is a bug.
A copy of ``repro.core.oracle`` (the RangeReach, count, collect, kNN
and polygon oracles), kept here so the port stands alone.
"""

from __future__ import annotations

import numpy as np

from .graph import GeosocialGraph


def reachable_mask(graph: GeosocialGraph, u: int) -> np.ndarray:
    """(n,) bool — vertices reachable from u (including u)."""
    csr = graph.csr
    seen = np.zeros(graph.n_nodes, dtype=bool)
    seen[u] = True
    frontier = np.array([u], dtype=np.int64)
    while frontier.size:
        starts = csr.indptr[frontier]
        ends = csr.indptr[frontier + 1]
        cnt = (ends - starts).astype(np.int64)
        if cnt.sum() == 0:
            break
        slot = np.repeat(starts, cnt) + _ragged_arange(cnt)
        nxt = np.unique(csr.indices[slot])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def rangereach_oracle(graph: GeosocialGraph, u: int, rect) -> bool:
    xmin, ymin, xmax, ymax = (float(v) for v in rect)
    seen = reachable_mask(graph, u)
    pts = graph.coords
    ok = (
        seen & graph.spatial_mask
        & (pts[:, 0] >= xmin) & (pts[:, 0] <= xmax)
        & (pts[:, 1] >= ymin) & (pts[:, 1] <= ymax)
    )
    return bool(ok.any())


def rangereach_oracle_batch(
    graph: GeosocialGraph, us: np.ndarray, rects: np.ndarray
) -> np.ndarray:
    return np.array(
        [rangereach_oracle(graph, int(u), r) for u, r in zip(us, rects)],
        dtype=bool,
    )


def _reachable_venues_in_rect(graph: GeosocialGraph, u: int,
                              rect) -> np.ndarray:
    xmin, ymin, xmax, ymax = (np.float32(v) for v in np.asarray(rect))
    seen = reachable_mask(graph, u)
    pts = graph.coords
    ok = (
        seen & graph.spatial_mask
        & (pts[:, 0] >= xmin) & (pts[:, 0] <= xmax)
        & (pts[:, 1] >= ymin) & (pts[:, 1] <= ymax)
    )
    return np.nonzero(ok)[0].astype(np.int32)


def range_count_oracle(graph: GeosocialGraph, u: int, rect) -> int:
    """Exact number of reachable venues intersecting rect."""
    return int(len(_reachable_venues_in_rect(graph, u, rect)))


def range_collect_oracle(graph: GeosocialGraph, u: int, rect) -> np.ndarray:
    """ALL reachable venue ids in rect, ascending (callers truncate to
    K for the capped-collect comparison)."""
    return _reachable_venues_in_rect(graph, u, rect)


def knn_reach_oracle(graph: GeosocialGraph, u: int, point, k: int):
    """(ids, dist2) of the k nearest reachable venues to ``point`` by
    (dist², id) ascending — distances float64 over the float32 coords,
    the canonical order every engine reproduces."""
    seen = reachable_mask(graph, u)
    ids = np.nonzero(seen & graph.spatial_mask)[0]
    if len(ids) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float64)
    p = np.asarray(point, dtype=np.float32).reshape(2)
    dx = graph.coords[ids, 0].astype(np.float64) - float(p[0])
    dy = graph.coords[ids, 1].astype(np.float64) - float(p[1])
    d2 = dx * dx + dy * dy
    order = np.lexsort((ids, d2))[: int(k)]
    return ids[order].astype(np.int32), d2[order]


def polygon_reach_oracle(graph: GeosocialGraph, u: int, vertices) -> bool:
    """Any reachable venue inside the canonical (bbox + float32
    half-plane) convex-polygon region."""
    from .polygon import (  # deferred: polygon imports this module
        convex_halfplanes,
        points_in_polygon_region,
        polygon_bbox,
    )

    seen = reachable_mask(graph, u)
    ids = np.nonzero(seen & graph.spatial_mask)[0]
    if len(ids) == 0:
        return False
    return bool(points_in_polygon_region(
        graph.coords[ids], polygon_bbox(vertices),
        convex_halfplanes(vertices)).any())


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
