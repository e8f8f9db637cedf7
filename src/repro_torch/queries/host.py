"""Host (NumPy) implementations of the analytics query classes (the port
of ``repro.queries.host``).

Each function routes exactly like the boolean host path — the Alg. 2
spatial-sink special case answers from the query vertex's own point,
everything else resolves a tree id and runs the matching
:mod:`repro_torch.core.rtree` descent — and returns the *canonical*
answer the device engine reproduces exactly:

* counts are exact int64 totals;
* collects are the K smallest venue ids ascending (+ exact totals and
  overflow flags);
* polygon regions use the canonical float32 bbox + half-plane predicate
  of :mod:`repro_torch.core.polygon`.

kNN lives in :mod:`repro_torch.queries.knn`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.polygon import (
    convex_halfplanes,
    points_in_polygon_region,
    polygon_bbox,
)
from ..core.rtree import query_host_collect_batch, query_host_count
from ..core.two_d_reach import TwoDReachIndex
from .program import CollectResult


def _point_in_rect(pts: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """(B, 2) points vs (B, 4) rects, the Alg. 2 float32 compares."""
    return (
        (pts[:, 0] >= rects[:, 0]) & (pts[:, 0] <= rects[:, 2])
        & (pts[:, 1] >= rects[:, 1]) & (pts[:, 1] <= rects[:, 3])
    )


def _route(index: TwoDReachIndex, us: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(excluded mask, tree ids) — tree id is -1 for excluded vertices
    and for components with no reachable venues."""
    exc = index.excluded[us]
    tid = np.full(len(us), -1, dtype=np.int64)
    if (~exc).any():
        tid[~exc] = index.lookup_tree(us[~exc])
    return exc, tid


def range_count_host(index: TwoDReachIndex, us: np.ndarray,
                     rects: np.ndarray) -> np.ndarray:
    """(B,) int64 — exact number of venues reachable from each query
    vertex intersecting its rect."""
    us = np.asarray(us, dtype=np.int64)
    B = len(us)
    rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
    exc, tid = _route(index, us)
    counts = np.zeros(B, dtype=np.int64)
    if exc.any():
        counts[exc] = _point_in_rect(index.coords[us[exc]], rects[exc])
    rest = ~exc
    if rest.any():
        counts[rest] = query_host_count(index.forest, tid[rest], rects[rest])
    return counts


def collect_csr_host(index: TwoDReachIndex, us: np.ndarray,
                     rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Uncapped collect: CSR ``(indptr (B+1,), ids int32)`` of *all*
    reachable venue ids per query, sorted ascending per row."""
    us = np.asarray(us, dtype=np.int64)
    B = len(us)
    rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
    exc, tid = _route(index, us)
    indptr, ids = query_host_collect_batch(index.forest, tid, rects)
    if not exc.any():
        return indptr, ids
    # splice the excluded rows' own point back in ({u} when inside)
    hit = np.zeros(B, dtype=bool)
    hit[exc] = _point_in_rect(index.coords[us[exc]], rects[exc])
    counts = np.diff(indptr)
    counts[hit] = 1
    out_indptr = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    out_ids = np.empty(int(out_indptr[-1]), dtype=np.int32)
    for b in range(B):
        if hit[b]:
            out_ids[out_indptr[b]] = us[b]
        else:
            out_ids[out_indptr[b]:out_indptr[b + 1]] = \
                ids[indptr[b]:indptr[b + 1]]
    return out_indptr, out_ids


def range_collect_host(index: TwoDReachIndex, us: np.ndarray,
                       rects: np.ndarray, k: int) -> CollectResult:
    """RangeCollect: the K smallest reachable venue ids per rect,
    ascending, with exact totals and overflow flags."""
    k = int(k)
    if k < 1:
        raise ValueError(f"collect needs k >= 1, got {k}")
    indptr, all_ids = collect_csr_host(index, us, rects)
    B = len(indptr) - 1
    counts = np.diff(indptr).astype(np.int64)
    ids = np.full((B, k), -1, dtype=np.int32)
    for b in range(B):
        row = all_ids[indptr[b]:indptr[b + 1]][:k]
        ids[b, : len(row)] = row
    return CollectResult(ids=ids, counts=counts, overflow=counts > k)


def polygon_reach_host(index: TwoDReachIndex, us: np.ndarray,
                       polygons) -> np.ndarray:
    """Batched convex-polygon RangeReach: bbox prefilter through the
    R-tree descent, canonical float32 half-plane postfilter."""
    us = np.asarray(us, dtype=np.int64)
    B = len(us)
    if len(polygons) != B:
        raise ValueError(f"{len(polygons)} polygons for {B} queries")
    bboxes = np.stack([polygon_bbox(p) for p in polygons]) if B else \
        np.zeros((0, 4), np.float32)
    exc, tid = _route(index, us)
    out = np.zeros(B, dtype=bool)
    indptr, cand = query_host_collect_batch(index.forest, tid, bboxes)
    for b in range(B):
        hp = convex_halfplanes(polygons[b])
        if exc[b]:
            out[b] = bool(points_in_polygon_region(
                index.coords[us[b]][None], bboxes[b], hp)[0])
            continue
        row = cand[indptr[b]:indptr[b + 1]]
        if row.size:
            out[b] = bool(points_in_polygon_region(
                index.coords[row], bboxes[b], hp).any())
    return out
