"""RangeReach query-workload generators — the paper's parameters.

A copy of the RangeReach, kNN and polygon parts of ``repro.data.queries``:
the same seeds give the same query vertices, regions and focus points.

* region extent ratio   — query region area as a percentage of the global
                          spatial extent (1/2/5/10/20 %, default 5%).
* vertex degree         — out-degree bucket of the query vertex
                          ([1-49] ... [200-], default [100-149]); the
                          generator relaxes a bucket to the nearest
                          non-empty one on scaled graphs.
* spatial selectivity   — number of spatial vertices inside the region as
                          a fraction of graph nodes; regions are grown
                          around a sampled venue until the count matches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.graph import GeosocialGraph

REGION_EXTENT_VALUES = (0.01, 0.02, 0.05, 0.10, 0.20)
REGION_EXTENT_DEFAULT = 0.05
DEGREE_BUCKETS = ((1, 49), (50, 99), (100, 149), (150, 199), (200, 10**9))
DEGREE_DEFAULT = (100, 149)
SELECTIVITY_VALUES = (0.00001, 0.0001, 0.001, 0.01)


def sample_vertices_by_degree(
    g: GeosocialGraph,
    bucket: Tuple[int, int],
    n: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Query vertices whose out-degree falls in [lo, hi]; on scaled graphs
    an empty bucket falls back to the closest available degrees."""
    deg = g.out_degree()
    lo, hi = bucket
    cand = np.nonzero((deg >= lo) & (deg <= hi))[0]
    if len(cand) == 0:
        # nearest-degree fallback: take the n vertices closest to the
        # bucket midpoint (keeps the sweep meaningful at small scale)
        mid = lo if hi >= 10**9 else (lo + hi) / 2
        order = np.argsort(np.abs(deg - mid), kind="stable")
        cand = order[: max(n, 100)]
    return rng.choice(cand, size=n, replace=len(cand) < n)


def region_for_extent(
    g: GeosocialGraph, ratio: float, n: int, rng: np.random.Generator
) -> np.ndarray:
    """(n, 4) square regions with area = ratio * extent area, centred at
    uniform points of the extent (paper's region-extent sweep)."""
    ext = g.spatial_extent()
    w = ext[2] - ext[0]
    h = ext[3] - ext[1]
    side_x = w * np.sqrt(ratio)
    side_y = h * np.sqrt(ratio)
    cx = rng.random(n) * w + ext[0]
    cy = rng.random(n) * h + ext[1]
    return np.stack(
        [cx - side_x / 2, cy - side_y / 2, cx + side_x / 2, cy + side_y / 2],
        axis=1,
    ).astype(np.float32)


def region_for_selectivity(
    g: GeosocialGraph, selectivity: float, n: int, rng: np.random.Generator
) -> np.ndarray:
    """(n, 4) square regions containing ~selectivity * n_nodes venues,
    grown around sampled venues by Chebyshev-radius quantile."""
    pts = g.coords[g.spatial_mask]
    k = max(1, int(round(selectivity * g.n_nodes)))
    k = min(k, len(pts))
    centers = pts[rng.integers(0, len(pts), size=n)]
    rects = np.empty((n, 4), dtype=np.float32)
    for i, c in enumerate(centers):
        cheb = np.maximum(np.abs(pts[:, 0] - c[0]), np.abs(pts[:, 1] - c[1]))
        r = np.partition(cheb, k - 1)[k - 1] + 1e-6
        rects[i] = (c[0] - r, c[1] - r, c[0] + r, c[1] + r)
    return rects


KNN_DEFAULT_K = 10
POLYGON_EDGE_VALUES = (3, 4, 6, 8, 12)
POLYGON_EDGES_DEFAULT = 6


def knn_workload(
    g: GeosocialGraph,
    n_queries: int = 1000,
    degree_bucket: Tuple[int, int] = DEGREE_DEFAULT,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(us, points) for the KNNReach class: query vertices by the
    paper's degree-bucket methodology, focus points uniform over the
    spatial extent."""
    rng = np.random.default_rng(seed)
    us = sample_vertices_by_degree(g, degree_bucket, n_queries, rng)
    ext = g.spatial_extent()
    w = max(float(ext[2] - ext[0]), 1e-3)
    h = max(float(ext[3] - ext[1]), 1e-3)
    points = np.stack(
        [rng.random(n_queries) * w + ext[0],
         rng.random(n_queries) * h + ext[1]],
        axis=1,
    ).astype(np.float32)
    return us.astype(np.int64), points


def polygon_workload(
    g: GeosocialGraph,
    n_queries: int = 1000,
    n_edges: int = POLYGON_EDGES_DEFAULT,
    extent_ratio: float = REGION_EXTENT_DEFAULT,
    degree_bucket: Tuple[int, int] = DEGREE_DEFAULT,
    seed: int = 0,
) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """(us, polygons) for the convex-polygon class: per query an
    ``n_edges``-gon inscribed in an ellipse whose area tracks the
    region-extent sweep — vertices at sorted random angles, which is
    convex by construction."""
    rng = np.random.default_rng(seed)
    us = sample_vertices_by_degree(g, degree_bucket, n_queries, rng)
    ext = g.spatial_extent()
    w = max(float(ext[2] - ext[0]), 1e-3)
    h = max(float(ext[3] - ext[1]), 1e-3)
    rx = w * np.sqrt(extent_ratio) / 2
    ry = h * np.sqrt(extent_ratio) / 2
    polys = []
    for _ in range(n_queries):
        cx = rng.random() * w + ext[0]
        cy = rng.random() * h + ext[1]
        ang = np.sort(rng.random(n_edges) * 2 * np.pi)
        # nudge coincident angles apart so the polygon is proper
        ang = ang + np.arange(n_edges) * 1e-6
        polys.append(np.stack(
            [cx + rx * np.cos(ang), cy + ry * np.sin(ang)], axis=1
        ).astype(np.float32))
    return us.astype(np.int64), tuple(polys)


def workload(
    g: GeosocialGraph,
    n_queries: int = 1000,
    extent_ratio: Optional[float] = REGION_EXTENT_DEFAULT,
    degree_bucket: Tuple[int, int] = DEGREE_DEFAULT,
    selectivity: Optional[float] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(us, rects) per the paper's methodology: selectivity overrides the
    extent ratio when given."""
    rng = np.random.default_rng(seed)
    us = sample_vertices_by_degree(g, degree_bucket, n_queries, rng)
    if selectivity is not None:
        rects = region_for_selectivity(g, selectivity, n_queries, rng)
    else:
        rects = region_for_extent(g, extent_ratio, n_queries, rng)
    return us.astype(np.int64), rects
