"""Device-resident RangeReach query engine (the port of
``repro.core.engine``).

:class:`QueryEngine` uploads a built
:class:`~repro_torch.core.two_d_reach.TwoDReachIndex` to the GPU **once**
and answers ``query_batch`` / ``count_batch`` / ``collect_batch`` on one
of two paths:

* ``path="fused"`` (the default): one launch of the fused serve kernel
  per batch (:func:`~repro_torch.kernels.range_query.fused.fused_serve`).
  The vertex→tree lookup runs as tensor code on the card, the leaf tiles
  are pruned against *quantized* tile-MBR planes (int16 fine / int32
  coarse, outward-rounded so the candidate set provably contains the
  f32 truth), the survivors are compacted into an in-kernel worklist and
  scanned with the exact f32 leaf predicate.  The candidate capacity is
  a monotone high-water mark: an overflowing batch re-runs once at the
  ratcheted capacity.
* ``path="two_phase"`` (and the ``*_two_phase`` methods): the retained
  reference path, the fused path's oracle.  The float32 prune kernel
  (:func:`~repro_torch.kernels.range_query.descent.prune_tiles`) masks
  the leaf tiles each query tile needs, the mask is compacted in
  PyTorch, the host reads the largest candidate count and ratchets the
  same high-water mark, and one scan kernel walks the candidate lists:
  ``descent_scan`` (reach), ``count_scan`` or ``collect_scan``.  It
  never truncates.

Batches are padded to power-of-two buckets by a :class:`DevicePadder`.
Exactness never rests on the pruning: the scans re-mask by arena slice
and exact box test, so both paths answer exactly like the host
``TwoDReachIndex.query_batch``.  ``knn_batch`` runs the radius-doubling
loop of :mod:`repro_torch.queries.knn` over either path;
``polygon_batch`` serves convex-polygon regions on the two-phase path,
with the half-plane postfilter inside the leaf scan
(:func:`~repro_torch.kernels.range_query.analytics.polygon_scan`).

The arena of an index built with ``backend="device"`` is adopted from
the build's :class:`~repro_torch.core.rtree.DeviceForest` when it lies
on the engine's device (nothing is uploaded).  The entry planes are
those of :func:`~repro_torch.kernels.range_query.layout.forest_planes`,
one copy per forest and device shared with the leaf-scan engine;
:data:`UPLOAD_COUNTERS` (that module's) counts uploads and adoptions.

Not ported yet (a later slice): the tracing / fault-injection hooks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..kernels.range_query.analytics import (
    collect_scan,
    count_scan,
    polygon_scan,
)
from ..kernels.range_query.descent import (
    descent_scan,
    prune_tiles,
    take_candidates,
)
from ..kernels.range_query.fused import (
    compact_ascending,
    fused_serve,
    make_quant_grid,
    quantize_coarse,
    quantize_fine,
    quantize_rects,
)
from ..kernels.range_query.layout import (
    ID_SENTINEL,
    TB,
    UPLOAD_COUNTERS,  # noqa: F401  (the handoff counters, read as engine's)
    build_tile_pyramid,
    forest_planes,
    forest_soa,
)
from ..queries.program import CollectResult
from .polygon import convex_halfplanes, points_in_polygon_region, polygon_bbox
from .two_d_reach import TwoDReachIndex


def _bucket(n: int, lo: int) -> int:
    """Smallest power-of-two >= max(n, lo) (lo itself a power of two)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _collect_post(mat: torch.Tensor, *, kc: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K*TP) ids-or-sentinel -> the ``kc`` smallest ids per row
    (sentinel sorts last) + exact totals."""
    srt = torch.sort(mat, dim=1).values
    cnt = (mat != int(ID_SENTINEL)).sum(dim=1)
    return srt[:, :kc], cnt


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of uint32 words held zero-extended in int64, with
    the reference's masks; the final multiply wraps at 32 bits as the
    uint32 version does."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# --------------------------------------------------------------------------
# Upload pieces
# --------------------------------------------------------------------------



class PointerSide:
    """Device-resident vertex→tree lookup side of a 2DReach index: the
    coords, the excluded mask and the variant's pointer structure.  The
    Pointer variant's uint32 BitRank words are held zero-extended in
    int64 (torch's uint32 support is thin)."""

    def __init__(self, index: TwoDReachIndex, device: torch.device):
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        self.variant = index.variant
        self.dim = index.forest.dim
        self._coords = dev(index.coords, torch.float32)
        self._excluded = dev(index.excluded, torch.bool)
        if self.variant == "pointer":
            self._vertex_comp = dev(index.vertex_comp, torch.int64)
            bits = index.bitrank.bits.astype(np.int64)
            rank = index.bitrank.rank.astype(np.int64)
            if not len(bits):      # no components: every lookup misses
                bits, rank = np.zeros(1, np.int64), np.zeros(1, np.int64)
            self._bits = dev(bits, torch.int64)
            self._rank = dev(rank, torch.int64)
            self._tree_ptrs = dev(index.tree_ptrs, torch.int64)
            self._vertex_tree = None
        else:
            self._vertex_tree = dev(index.vertex_tree, torch.int64)

    def lookup(self, us: torch.Tensor) -> torch.Tensor:
        """Vertex -> tree id (-1: excluded / no tree)."""
        if self.variant != "pointer":
            return self._vertex_tree[us]
        c = self._vertex_comp[us]
        ok = c >= 0
        cc = c.clamp(min=0)
        w = cc // 32
        b = cc % 32
        word = self._bits[w]
        member = ((word >> b) & 1) > 0
        below = word & ((1 << b) - 1)
        rank = self._rank[w] + _popcount32(below)
        t = self._tree_ptrs[rank.clamp(max=self._tree_ptrs.shape[0] - 1)]
        return torch.where(ok & member, t, -1)


@dataclasses.dataclass(frozen=True)
class TileArena:
    """One uploaded SoA entry arena + its tile-MBR pyramid."""

    entries: torch.Tensor     # (2*dim, Pp) float32 SoA planes
    fine: torch.Tensor        # (2*dim, NTp) float32 leaf-tile MBRs
    coarse: torch.Tensor      # (2*dim, NTp // COARSE_GROUP) float32
    entry_off: torch.Tensor   # (T+1,) int32 per-tree arena slices
    n_tiles: int              # true fine tile count (Pp // TP)
    adopted: bool = False     # taken from a device build, not uploaded

    @classmethod
    def for_forest(cls, forest, dim: int,
                   device: torch.device) -> "TileArena":
        """Arena for a built forest over its shared entry planes
        (:func:`forest_planes`): the pyramid too is adopted from the
        forest's ``build_forest_device`` handoff where the planes were
        (the tensors already have exactly this layout), built from the
        host transposition and uploaded otherwise."""
        entries, off = forest_planes(forest, device)
        dev = getattr(forest, "device", None)
        if dev is not None and entries is dev.entries:
            return cls(entries=entries, fine=dev.fine, coarse=dev.coarse,
                       entry_off=off, n_tiles=dev.n_tiles, adopted=True)
        fine, coarse, nt = build_tile_pyramid(forest_soa(forest)[0], dim)
        return cls(entries=entries,
                   fine=torch.as_tensor(fine, device=device),
                   coarse=torch.as_tensor(coarse, device=device),
                   entry_off=off, n_tiles=nt)


def check_vertex_ids(us: np.ndarray, n_nodes: int) -> None:
    """Raise ``IndexError`` for a vertex id outside ``[-n_nodes,
    n_nodes)``, as the host index's NumPy gathers do."""
    us = np.asarray(us, dtype=np.int64)
    bad = (us >= n_nodes) | (us < -n_nodes)
    if bad.any():
        u = int(us[bad][0])
        raise IndexError(f"vertex id {u} is out of bounds for a graph of "
                         f"{n_nodes} vertices")


class DevicePadder:
    """Batch padding to the power-of-two bucket on the device.

    Keeps, per bucket, a host *staging* pair (pinned when the device is
    CUDA) and one preallocated device pair.  A batch writes only its
    true-B prefix into the staging arrays, uploads the bucket-shaped
    staging, and an index-vs-live-count mask makes the stale tail inert
    on the device (``us=0``, rect min=+inf / max=-inf), so a larger
    previous batch can never leak rects into a smaller one's padding.
    The device pair is reused by the next batch of the same bucket; the
    engine reads a batch's results back before it pads again, which
    also retires the asynchronous copy out of the pinned staging.
    """

    def __init__(self, dim: int, device: torch.device):
        self.dim = dim
        self.device = device
        self._pin = device.type == "cuda"
        self._bufs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._stage: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def pad(self, us: np.ndarray, rects: np.ndarray
            ) -> Tuple[int, torch.Tensor, torch.Tensor]:
        """Returns ``(Bb, us_dev (Bb,) int32, rsoa_dev (2*dim, Bb)
        float32)``, device-resident.  Padding rects must miss every box
        regardless of data extent: min=+inf / max=-inf fails both halves
        of the intersect test."""
        B = len(us)
        Bb = _bucket(B, TB)
        dim = self.dim
        stage = self._stage.get(Bb)
        if stage is None:
            stage = self._stage[Bb] = (
                torch.zeros(Bb, dtype=torch.int32, pin_memory=self._pin),
                torch.zeros((2 * dim, Bb), dtype=torch.float32,
                            pin_memory=self._pin))
        us_s, r_s = stage
        us_s.numpy()[:B] = us
        r_s.numpy()[:, :B] = np.asarray(
            rects, dtype=np.float32).reshape(B, 2 * dim).T
        bufs = self._bufs.get(Bb)
        if bufs is None:
            bufs = self._bufs[Bb] = (
                torch.empty(Bb, dtype=torch.int32, device=self.device),
                torch.empty((2 * dim, Bb), dtype=torch.float32,
                            device=self.device),
                torch.arange(Bb, dtype=torch.int32, device=self.device))
        us_b, r_b, iota = bufs
        us_b.copy_(us_s, non_blocking=True)
        r_b.copy_(r_s, non_blocking=True)
        dead = iota >= B
        us_b.masked_fill_(dead, 0)
        r_b[:dim].masked_fill_(dead, float("inf"))
        r_b[dim:].masked_fill_(dead, float("-inf"))
        return Bb, us_b, r_b


# --------------------------------------------------------------------------
# Single-device engine
# --------------------------------------------------------------------------

class QueryEngine:
    """Device engine over a built ``TwoDReachIndex``.

    Parameters
    ----------
    index:  any 2DReach variant (``base`` / ``comp`` / ``pointer``).
    device: ``None`` (the GPU; raises where CUDA is absent), or an
            explicit device.  On ``"cpu"`` every kernel runs its plain
            PyTorch version.
    path:   ``"fused"`` (default) serves reach/count/collect through the
            single-launch fused kernel; ``"two_phase"`` through the
            retained prune → compact → scan path.
    """

    def __init__(self, index: TwoDReachIndex, device: DeviceLike = None,
                 path: str = "fused"):
        if not isinstance(index, TwoDReachIndex):
            raise TypeError(
                f"QueryEngine serves TwoDReachIndex, got {type(index).__name__}"
            )
        if path not in ("fused", "two_phase"):
            raise ValueError(f"unknown engine path {path!r}")
        self.device = resolve_device(device)
        self.path = path
        self.variant = index.variant
        self.dim = index.forest.dim
        self._index = index        # host mirror (kNN exact top-up)
        dev = self.device

        # ---- one-time upload ------------------------------------------
        self._side = PointerSide(index, dev)
        self._arena = TileArena.for_forest(index.forest, self.dim, dev)
        self.n_tiles = self._arena.n_tiles
        # host mirrors for the analytics classes: Alg. 2 routing of
        # excluded vertices and the kNN loop's distances and extent
        self._excluded_host = index.excluded
        self._coords_host = index.coords
        Pp = int(self._arena.entries.shape[1])
        ids_row = np.full((1, Pp), ID_SENTINEL, dtype=np.int32)
        ids_row[0, : len(index.forest.entry_ids)] = index.forest.entry_ids
        self._ids_row = torch.as_tensor(ids_row, device=dev)
        ent = index.forest.entries
        self._extent_host = (
            np.concatenate([ent[:, : self.dim].min(0),
                            ent[:, self.dim:].max(0)]).astype(np.float64)
            if len(ent) else None
        )
        # quantized MBR planes: int16 fine / int32 coarse codes over the
        # arena extent, rounded outward
        self._grid = make_quant_grid(self._extent_host, self.dim, dev)
        self._qfine = quantize_fine(self._grid, self._arena.fine, self.dim)
        self._qcoarse = quantize_coarse(
            self._grid, self._arena.coarse, self.dim)

        self.stats: Dict[str, float] = {
            "batches": 0, "queries": 0,
            "adopted": int(self._arena.adopted),
            "tiles_scanned": 0, "tiles_grid": 0, "tiles_full_scan": 0,
            "fused_reruns": 0,
        }
        # candidate-capacity high-water mark, shared by both paths: only
        # ratchets up
        self._kb_hwm = 1
        self._padder = DevicePadder(self.dim, dev)

    def _route(self, us: torch.Tensor):
        """Vertex -> (arena slice, point, excluded)."""
        us = us.long()
        tid = self._side.lookup(us)
        exc = self._side._excluded[us]
        valid = (tid >= 0) & ~exc
        off = self._arena.entry_off
        last = off.shape[0] - 1     # an empty forest has only off[0]
        t = tid.clamp(min=0)
        zero = torch.zeros((), dtype=off.dtype, device=off.device)
        qs = torch.where(valid, off[t.clamp(max=last)], zero)
        qe = torch.where(valid, off[(t + 1).clamp(max=last)], zero)
        return qs, qe, self._side._coords[us], exc

    def _serve_args(self, rsoa, qs, qe, pts, exc):
        """The rect-dependent half of a fused batch, given its routing:
        the Alg. 2 answers of spatial-sink query vertices (``forced``)
        and the fused serve's tensor inputs (quantized rects)."""
        r16, r32 = quantize_rects(self._grid, rsoa, self.dim)
        args = (self._qfine, self._qcoarse, self._arena.entries,
                self._ids_row, r16, r32, rsoa, qs, qe)
        return self._forced(rsoa, pts, exc), args

    def _forced(self, rsoa, pts, exc):
        """Alg. 2: an excluded query vertex answers by its own point
        against the rect, with the host's float32 compares."""
        inr = torch.ones(rsoa.shape[1], dtype=torch.bool, device=self.device)
        for a in range(self.dim):
            inr &= pts[:, a] >= rsoa[a]
            inr &= pts[:, a] <= rsoa[self.dim + a]
        return exc & inr

    def _pad(self, us: np.ndarray, rects: np.ndarray):
        """Check the batch's vertex ids on the host, then pad it onto the
        device (:meth:`DevicePadder.pad`).  An id outside ``[-n, n)``
        raises ``IndexError`` before anything is uploaded: gathered on
        the card it would fire a device-side assert and leave the CUDA
        context unusable.  Ids in ``[-n, 0)`` wrap, as NumPy's do."""
        check_vertex_ids(us, len(self._excluded_host))
        return self._padder.pad(us, rects)

    def _prepare(self, us: np.ndarray, rects: np.ndarray):
        """Pad, route and quantize one batch.  Returns ``(Bb, forced,
        args)`` (see :meth:`_serve_args`; the rect and slice tensors live
        in the padder's per-bucket buffers until the next batch of the
        same bucket)."""
        Bb, us_dev, rsoa = self._pad(us, rects)
        forced, args = self._serve_args(rsoa, *self._route(us_dev))
        return Bb, forced, args

    def _fused_ratchet(self, args, mode: str, kc: Optional[int] = None):
        """One fused launch at the current capacity high-water mark; a
        batch whose true candidate count passes it ratchets the mark and
        re-runs.  Returns ``(out, kcap, tiles)``: for collect, ``out`` is
        the ``(top, counts)`` pair; ``tiles`` the live candidate tiles."""
        while True:
            kcap = min(self._kb_hwm, self.n_tiles)
            out, cnt = fused_serve(*args, mode=mode, kcap=kcap,
                                   nt=self.n_tiles, dim=self.dim,
                                   device=self.device)
            mx, tot = torch.stack([cnt.max(), cnt.sum()]).tolist()
            if mx <= kcap or kcap >= self.n_tiles:
                break
            self._kb_hwm = min(_bucket(mx, 1), self.n_tiles)
            self.stats["fused_reruns"] += 1
        if mode == "collect":
            out = _collect_post(out, kc=kc)
        return out, kcap, tot

    def _fused_serve(self, us: np.ndarray, rects: np.ndarray, mode: str,
                     kc: Optional[int] = None):
        """One launch per batch for reach/count/collect (plus ratchet
        re-runs).  Returns ``(forced, out)``."""
        Bb, forced, args = self._prepare(us, rects)
        out, kcap, tot = self._fused_ratchet(args, mode, kc)
        self.stats["batches"] += 1
        self.stats["queries"] += len(us)
        self.stats["tiles_scanned"] += tot
        self.stats["tiles_grid"] += (Bb // TB) * kcap
        self.stats["tiles_full_scan"] += (Bb // TB) * self.n_tiles
        return forced, out

    def _route_prune(self, us: np.ndarray, rects: np.ndarray):
        """Phase 1 of the two-phase path: pad, route, prune (K2),
        compact, and ratchet the candidate high-water mark on the
        batch's largest candidate count (one sync), so the scan never
        truncates.  Returns ``(Bb, rsoa, forced, qs, qe, cand_k)`` with
        ``cand_k`` the first ``_kb_hwm`` candidate columns."""
        B = len(us)
        Bb, us_dev, rsoa = self._pad(us, rects)
        qs, qe, pts, exc = self._route(us_dev)
        mask = prune_tiles(self._arena.fine, self._arena.coarse, rsoa, qs,
                           qe, dim=self.dim, device=self.device)
        cand, cnt = compact_ascending(mask, self.n_tiles)
        mx, tot = torch.stack([cnt.max(), cnt.sum()]).tolist()
        self._kb_hwm = max(self._kb_hwm,
                           min(_bucket(max(mx, 1), 1), self.n_tiles))
        kb = self._kb_hwm
        self.stats["batches"] += 1
        self.stats["queries"] += B
        # tiles_scanned: live candidate tiles (pruning effectiveness);
        # tiles_grid: scan slots incl. padding (the kernels' work)
        self.stats["tiles_scanned"] += tot
        self.stats["tiles_grid"] += (Bb // TB) * kb
        self.stats["tiles_full_scan"] += (Bb // TB) * self.n_tiles
        forced = self._forced(rsoa, pts, exc)
        return Bb, rsoa, forced, qs, qe, take_candidates(cand, kb)

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Batched RangeReach, same contract as ``TwoDReachIndex
        .query_batch`` (and bit-identical to it)."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        if self.path == "fused":
            forced, hit = self._fused_serve(us, rects, "reach")
        else:
            _, rsoa, forced, qs, qe, cand_k = self._route_prune(us, rects)
            hit = descent_scan(cand_k, self._arena.entries, rsoa, qs, qe,
                               dim=self.dim, device=self.device)
        return ((hit > 0) | forced)[:B].cpu().numpy()

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])

    def _with_path(self, path: str, fn, *args):
        prev, self.path = self.path, path
        try:
            return fn(*args)
        finally:
            self.path = prev

    def query_batch_two_phase(self, us, rects) -> np.ndarray:
        """``query_batch`` through the two-phase path (prune → compact →
        descent scan), the fused path's oracle."""
        return self._with_path("two_phase", self.query_batch, us, rects)

    def count_batch_two_phase(self, us, rects) -> np.ndarray:
        """``count_batch`` through the two-phase path."""
        return self._with_path("two_phase", self.count_batch, us, rects)

    def collect_batch_two_phase(self, us, rects, k: int) -> CollectResult:
        """``collect_batch`` through the two-phase path."""
        return self._with_path("two_phase", self.collect_batch, us, rects, k)

    def count_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Batched RangeCount: (B,) int64 exact number of reachable
        venues intersecting each rect.  A forced (spatial-sink) query
        vertex reaches exactly itself; its tree probe counted nothing."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=np.int64)
        if self.path == "fused":
            forced, counts = self._fused_serve(us, rects, "count")
        else:
            _, rsoa, forced, qs, qe, cand_k = self._route_prune(us, rects)
            counts = count_scan(cand_k, self._arena.entries, rsoa, qs, qe,
                                dim=self.dim, device=self.device)
        return (counts.long() + forced.long())[:B].cpu().numpy()

    def collect_batch(self, us: np.ndarray, rects: np.ndarray,
                      k: int) -> CollectResult:
        """Batched RangeCollect: the K smallest reachable venue ids in
        each rect + exact totals and overflow flags."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        k = int(k)
        if k < 1:
            raise ValueError(f"collect needs k >= 1, got {k}")
        if B == 0:
            return CollectResult(
                ids=np.zeros((0, k), np.int32),
                counts=np.zeros(0, np.int64),
                overflow=np.zeros(0, bool),
            )
        if self.path == "fused":
            forced, (top, cnt) = self._fused_serve(
                us, rects, "collect", kc=_bucket(k, 1))
        else:
            _, rsoa, forced, qs, qe, cand_k = self._route_prune(us, rects)
            mat = collect_scan(cand_k, self._arena.entries, self._ids_row,
                               rsoa, qs, qe, dim=self.dim,
                               device=self.device)
            top, cnt = _collect_post(mat, kc=_bucket(k, 1))
        top = top[:B].cpu().numpy()
        counts = cnt[:B].cpu().numpy().astype(np.int64)
        forced = forced[:B].cpu().numpy()
        ids = np.full((B, k), ID_SENTINEL, dtype=np.int32)
        take = min(k, top.shape[1])
        ids[:, :take] = top[:, :take]
        ids[ids == ID_SENTINEL] = -1
        exc = self._excluded_host[us]
        if exc.any():
            hit = np.nonzero(exc & forced)[0]
            ids[hit, 0] = us[hit]
            counts[hit] = 1
        return CollectResult(ids=ids, counts=counts, overflow=counts > k)

    def knn_batch(self, us: np.ndarray, points: np.ndarray, k: int):
        """Batched KNNReach via the radius-doubling loop over this
        engine's count and collect (see ``repro_torch.queries.knn``): the
        exact (dist², id)-ordered k nearest reachable venues, equal to
        the host best-first descent."""
        from ..queries.knn import knn_radius_doubling  # deferred: no cycle

        return knn_radius_doubling(self, us, points, k)

    def polygon_batch(self, us: np.ndarray, polygons) -> np.ndarray:
        """Batched convex-polygon RangeReach on the two-phase path: the
        polygons' bboxes route and prune (K2), and the half-plane
        postfilter runs inside the leaf scan (K6); equal to
        ``polygon_reach_host``.  Edge counts bucket to a power of two
        >= 4 with inert half-planes."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        if len(polygons) != B:
            raise ValueError(f"{len(polygons)} polygons for {B} queries")
        bboxes = np.stack([polygon_bbox(p) for p in polygons])
        ne = max(len(np.asarray(p).reshape(-1, 2)) for p in polygons)
        neb = _bucket(ne, 4)
        hps = np.stack([convex_halfplanes(p, pad_to=neb) for p in polygons])
        # ``forced`` tests a spatial-sink query vertex against the bbox
        # only; such a vertex is answered below against the whole region
        Bb, rsoa, _, qs, qe, cand_k = self._route_prune(us, bboxes)
        # (B, 3, neb) -> (3*neb, Bb); padded batch lanes get inert
        # half-planes (A=B=0, C=+inf) to match their impossible rects
        lines = np.zeros((3 * neb, Bb), dtype=np.float32)
        lines[2 * neb:] = np.inf
        lines[:, :B] = hps.transpose(1, 2, 0).reshape(3 * neb, B)
        hit = polygon_scan(cand_k, self._arena.entries, rsoa,
                           torch.as_tensor(lines, device=self.device), qs,
                           qe, ne=neb, dim=self.dim, device=self.device)
        out = (hit[:B] > 0).cpu().numpy()
        exc = self._excluded_host[us]
        for i in np.nonzero(exc)[0]:
            out[i] = bool(points_in_polygon_region(
                self._coords_host[us[i]][None], bboxes[i], hps[i])[0])
        return out


def engine_for(index, device: DeviceLike = None,
               required: bool = False) -> Optional[QueryEngine]:
    """Memoised ``QueryEngine`` for a built 2DReach index (one upload per
    index instance and device).  For an index type the device engine
    does not serve (3DReach, GeoReach) it returns ``None``, so that the
    caller can serve the host path, or, with ``required=True``, raises a
    ``ValueError`` naming the index."""
    if not isinstance(index, TwoDReachIndex):
        if not required:
            return None
        method = getattr(index, "variant", None)
        via = f" (method {method!r})" if isinstance(method, str) else ""
        raise ValueError(
            f"no device QueryEngine for {type(index).__name__}{via}: device "
            f"serving supports the 2DReach variants only (2dreach, "
            f"2dreach-comp, 2dreach-pointer)")
    dev = resolve_device(device)
    eng = getattr(index, "_device_engine", None)
    if eng is None or not same_device(eng.device, dev):
        eng = QueryEngine(index, device=dev)
        index._device_engine = eng
    return eng
