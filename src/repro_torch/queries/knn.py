"""KNNReach — k nearest *reachable* venues to a query point (the port of
``repro.queries.knn``).

Two engines, one canonical answer (the exact k nearest by ``(dist²,
vertex id)`` ascending, distances float64 over the float32 coords):

* **host** (:func:`knn_reach_host`) — best-first branch-and-bound over
  the packed R-tree (``core.rtree.query_host_knn``).

* **device** (:func:`knn_radius_doubling`) — a radius-doubling loop
  over the engine's RangeCount/RangeCollect: grow a square region
  around the query point until it counts >= k reachable venues (or
  provably covers the whole venue extent), bound the kth distance by
  the box diagonal, then collect *every* venue inside the bounding
  disk's box and select the exact top-k by true distance.  All boxes
  are rounded outward (float64 -> float32 nextafter) so the candidate
  superset provably contains the true top-k; the final NumPy selection
  makes the answer equal to the host descent.

  On a fused-path engine the loop **hoists the routing**: the
  vertex→tree lookup is computed once on the padded batch and every
  round runs only the fused serve with the new rects.  On a two-phase
  engine every round is a ``count_batch`` (prune + count scan).
  Doubling rounds are capped at :data:`_MAX_DOUBLINGS`; queries still
  unresolved at the cap (a query point far from the venue extent) fall
  back to the exact host best-first descent, so the answer stays exact.

Both resolve the Alg. 2 spatial-sink special case first: an excluded
query vertex reaches exactly itself.
"""

from __future__ import annotations

import numpy as np

from ..core.polygon import round_bounds_outward
from ..core.rtree import query_host_knn
from ..core.two_d_reach import TwoDReachIndex
from ..obs import span
from .program import KNNResult

# Doubling-round cap: the initial radius is extent-span / 2^16, so ~17
# rounds reach a box covering the whole extent from any in-extent point;
# the slack covers far-out points before the exact host top-up takes
# over.
_MAX_DOUBLINGS = 24


def _fused_count(engine, us_sub: np.ndarray, rects: np.ndarray,
                 state: dict) -> np.ndarray:
    """One radius-doubling count round through the fused serve with
    hoisted routing: pad the rects, reuse the routing computed on the
    first round, ratchet-and-rerun on capacity overflow (the engine's
    monotone high-water mark)."""
    n = len(us_sub)
    _, us_dev, rsoa = engine._pad(us_sub, rects)
    routing = state.get("routing")
    if routing is None:
        routing = state["routing"] = engine._route(us_dev)
    with span("engine.fused", cat="engine", batch=n, mode="count") as sp:
        forced, args = engine._serve_args(rsoa, *routing)
        out, _, tot, wait_ns = engine._fused_ratchet(args, "count")
        sp.set(wait_us=wait_ns / 1e3)
    engine.stats["batches"] += 1
    engine.stats["queries"] += n
    engine.stats["tiles_scanned"] += tot
    return (out.long() + forced.long())[:n].cpu().numpy()


def outward_rect(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(B, 2) float64 lo/hi -> (B, 4) float32 rects rounded outward, so
    the f32 box always contains the intended f64 box."""
    lo32, hi32 = round_bounds_outward(lo, hi)
    return np.concatenate([lo32, hi32], axis=1).astype(np.float32)


def _pt_d2(coords: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Canonical squared distances: float64 over float32 coords, x term
    then y term — the exact op order of the R-tree descent."""
    dx = coords[:, 0].astype(np.float64) - float(p[0])
    dy = coords[:, 1].astype(np.float64) - float(p[1])
    return dx * dx + dy * dy


def _empty(B: int, k: int) -> KNNResult:
    return KNNResult(
        ids=np.full((B, k), -1, dtype=np.int32),
        dist2=np.full((B, k), np.inf, dtype=np.float64),
    )


def knn_reach_host(index: TwoDReachIndex, us: np.ndarray,
                   points: np.ndarray, k: int) -> KNNResult:
    """Host KNNReach: per-query best-first branch-and-bound descent."""
    us = np.asarray(us, dtype=np.int64)
    B = len(us)
    k = int(k)
    if k < 1:
        raise ValueError(f"knn needs k >= 1, got {k}")
    points = np.asarray(points, dtype=np.float32).reshape(B, 2)
    res = _empty(B, k)
    exc = index.excluded[us]
    for b in range(B):
        if exc[b]:
            res.ids[b, 0] = us[b]
            res.dist2[b, 0] = _pt_d2(
                index.coords[us[b]][None], points[b])[0]
            continue
        tid = int(index.lookup_tree(us[b:b + 1])[0])
        ids, d2 = query_host_knn(index.forest, tid, points[b], k)
        res.ids[b, : len(ids)] = ids
        res.dist2[b, : len(d2)] = d2
    return res


def knn_radius_doubling(engine, us: np.ndarray, points: np.ndarray,
                        k: int) -> KNNResult:
    """Device KNNReach over a :class:`~repro_torch.core.engine.QueryEngine`'s
    count/collect (see module docstring)."""
    us = np.asarray(us, dtype=np.int64)
    B = len(us)
    k = int(k)
    if k < 1:
        raise ValueError(f"knn needs k >= 1, got {k}")
    points = np.asarray(points, dtype=np.float32).reshape(B, 2)
    res = _empty(B, k)
    if B == 0:
        return res
    exc = engine._excluded_host[us]
    for b in np.nonzero(exc)[0]:
        res.ids[b, 0] = us[b]
        res.dist2[b, 0] = _pt_d2(
            engine._coords_host[us[b]][None], points[b])[0]
    rest = np.nonzero(~exc)[0]
    ext = engine._extent_host
    if rest.size == 0 or ext is None:
        return res       # no venues at all — every tree probe is empty

    # ---- phase 1: double the count box until it holds k venues -------
    n = len(rest)
    p = points[rest].astype(np.float64)
    ext_span = max(float(ext[2] - ext[0]), float(ext[3] - ext[1]), 1e-6)
    r = np.full(n, ext_span / 2 ** 16, dtype=np.float64)
    resolved = np.zeros(n, dtype=bool)
    final_rects = np.zeros((n, 4), dtype=np.float32)
    # fused engines hoist the routing out of the loop (state carries it
    # between rounds); two-phase engines re-enter count_batch
    fused = engine.path == "fused"
    state: dict = {}
    for _ in range(_MAX_DOUBLINGS):
        rects = outward_rect(p - r[:, None], p + r[:, None])
        if fused:
            counts = _fused_count(engine, us[rest], rects, state)
        else:
            counts = engine.count_batch(us[rest], rects)
        covers = (
            (rects[:, 0].astype(np.float64) <= ext[0])
            & (rects[:, 1].astype(np.float64) <= ext[1])
            & (rects[:, 2].astype(np.float64) >= ext[2])
            & (rects[:, 3].astype(np.float64) >= ext[3])
        )
        newly = ~resolved & ((counts >= k) | covers)
        if newly.any():
            idx = np.nonzero(newly)[0]
            cov = idx[covers[idx]]
            # a covering box already holds the whole venue set
            final_rects[cov] = rects[cov]
            cnt = idx[~covers[idx]]
            if cnt.size:
                # kth distance <= diagonal of the box's true half-widths
                # (from the f32 bounds actually counted, so the bound
                # survives the outward rounding)
                hwx = np.maximum(p[cnt, 0] - rects[cnt, 0],
                                 rects[cnt, 2].astype(np.float64) - p[cnt, 0])
                hwy = np.maximum(p[cnt, 1] - rects[cnt, 1],
                                 rects[cnt, 3].astype(np.float64) - p[cnt, 1])
                R = np.sqrt(hwx * hwx + hwy * hwy)
                final_rects[cnt] = outward_rect(
                    p[cnt] - R[:, None], p[cnt] + R[:, None])
            resolved |= newly
        if resolved.all():
            break
        r = np.where(resolved, r, r * 2)
    if not resolved.all():
        # capped out: answer the stragglers with the exact host
        # best-first descent and drop them from the device collect phase
        index = engine._index
        for j in np.nonzero(~resolved)[0]:
            b = rest[j]
            tid = int(index.lookup_tree(us[b:b + 1])[0])
            ids, d2 = query_host_knn(index.forest, tid, points[b], k)
            res.ids[b, : len(ids)] = ids
            res.dist2[b, : len(d2)] = d2
        rest = rest[resolved]
        final_rects = final_rects[resolved]
        if rest.size == 0:
            return res

    # ---- phase 2: collect every candidate in the bounding box --------
    # collect totals are exact even when capped, so one overflow is
    # enough to jump the cap straight to the largest box population;
    # the cap rides a per-engine high-water mark so it only ratchets up
    kcap = max(getattr(engine, "_knn_kcap_hwm", 1), k)
    col = engine.collect_batch(us[rest], final_rects, kcap)
    if col.overflow.any():
        kcap = max(kcap, int(col.counts.max()))
        col = engine.collect_batch(us[rest], final_rects, kcap)
    engine._knn_kcap_hwm = kcap

    # ---- exact final selection (shared with the host path) -----------
    for j, b in enumerate(rest):
        cand = col.row(j)
        if cand.size == 0:
            continue
        d2 = _pt_d2(engine._coords_host[cand], points[b])
        order = np.lexsort((cand, d2))[:k]
        res.ids[b, : len(order)] = cand[order]
        res.dist2[b, : len(order)] = d2[order]
    return res
