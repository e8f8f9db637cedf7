"""The benchmark's own copy of the paper's RangeReach query generator.

A frozen copy of ``repro_torch.data.queries.sample_vertices_by_degree``
and ``region_for_extent``: the same graph, parameters and generator give
the same query vertices and regions.  A traffic file
(``rrbench/traffic/<name>.json``) names the parameters:

* ``degree_bucket``  out-degree bucket [lo, hi] of the query vertex (the
                     paper's default [100, 149]); an empty bucket falls back
                     to the vertices nearest its midpoint;
* ``extent``         the region's area as a share of the venues' extent
                     (the paper's default 5%), a square centred uniformly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def sample_vertices_by_degree(deg: np.ndarray, bucket: Sequence[int], n: int,
                              rng: np.random.Generator) -> np.ndarray:
    """``n`` query vertices whose out-degree lies in ``bucket``."""
    lo, hi = int(bucket[0]), int(bucket[1])
    cand = np.nonzero((deg >= lo) & (deg <= hi))[0]
    if len(cand) == 0:
        mid = lo if hi >= 10**9 else (lo + hi) / 2
        order = np.argsort(np.abs(deg - mid), kind="stable")
        cand = order[: max(n, 100)]
    return rng.choice(cand, size=n, replace=len(cand) < n)


def region_for_extent(extent: np.ndarray, ratio: float, n: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(n, 4) float32 square regions [xmin, ymin, xmax, ymax] of area
    ``ratio`` of ``extent``, centred at uniform points of it."""
    w = extent[2] - extent[0]
    h = extent[3] - extent[1]
    side_x = w * np.sqrt(ratio)
    side_y = h * np.sqrt(ratio)
    cx = rng.random(n) * w + extent[0]
    cy = rng.random(n) * h + extent[1]
    return np.stack([cx - side_x / 2, cy - side_y / 2, cx + side_x / 2,
                     cy + side_y / 2], axis=1).astype(np.float32)


def pool(deg: np.ndarray, extent: np.ndarray, bucket: Sequence[int],
         ratio: float, n: int, rng: np.random.Generator
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(us (n,) int64, rects (n, 4) float32): the paper's workload."""
    us = sample_vertices_by_degree(deg, bucket, n, rng).astype(np.int64)
    return us, region_for_extent(extent, ratio, n, rng)
