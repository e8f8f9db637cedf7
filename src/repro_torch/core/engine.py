"""Device-resident RangeReach query engine (the port of
``repro.core.engine``, fused path).

:class:`QueryEngine` uploads a built
:class:`~repro_torch.core.two_d_reach.TwoDReachIndex` to the GPU **once**
and answers ``query_batch`` / ``count_batch`` / ``collect_batch`` with
one launch of the fused serve kernel per batch
(:func:`~repro_torch.kernels.range_query.fused.fused_serve`): the
vertex→tree lookup runs as tensor code on the card, the leaf tiles are
pruned against *quantized* tile-MBR planes (int16 fine / int32 coarse,
outward-rounded so the candidate set provably contains the f32 truth),
the survivors are compacted into an in-kernel worklist and scanned with
the exact f32 leaf predicate.  Batches are padded to power-of-two
buckets by a :class:`DevicePadder`, and the candidate capacity is a
monotone high-water mark: an overflowing batch re-runs once at the
ratcheted capacity.

Exactness never rests on the pruning: the scan re-masks by arena slice
and exact box test, so the engine answers exactly like the host
``TwoDReachIndex.query_batch``.

Not ported yet (a later slice): the two-phase prune→scan path, kNN and
polygon queries, and the tracing / fault-injection hooks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..kernels.range_query.fused import (
    fused_serve,
    make_quant_grid,
    quantize_coarse,
    quantize_fine,
    quantize_rects,
)
from ..kernels.range_query.layout import (
    ID_SENTINEL,
    TB,
    build_tile_pyramid,
    forest_soa,
)
from ..queries.program import CollectResult
from .two_d_reach import TwoDReachIndex

_LATER = ("is not ported yet: the two-phase path, kNN and polygon queries "
          "come with the next slice of the port (ROADMAP Queue 1)")


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

    @classmethod
    def upload(cls, esoa: np.ndarray, off: np.ndarray, dim: int,
               device: torch.device) -> "TileArena":
        fine, coarse, nt = build_tile_pyramid(esoa, dim)
        return cls(
            entries=torch.as_tensor(esoa, device=device),
            fine=torch.as_tensor(fine, device=device),
            coarse=torch.as_tensor(coarse, device=device),
            entry_off=torch.as_tensor(
                np.asarray(off, np.int32), device=device),
            n_tiles=nt,
        )

    @classmethod
    def for_forest(cls, forest, dim: int,
                   device: torch.device) -> "TileArena":
        esoa, off = forest_soa(forest)        # cached transposition
        return cls.upload(esoa, off, dim, device)


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
            explicit device.  On ``"cpu"`` the fused serve runs its plain
            PyTorch version.
    path:   ``"fused"`` — the only path ported so far.
    """

    def __init__(self, index: TwoDReachIndex, device: DeviceLike = None,
                 path: str = "fused"):
        if not isinstance(index, TwoDReachIndex):
            raise TypeError(
                f"QueryEngine serves TwoDReachIndex, got {type(index).__name__}"
            )
        if path == "two_phase":
            raise NotImplementedError(f"path='two_phase' {_LATER}")
        if path != "fused":
            raise ValueError(f"unknown engine path {path!r}")
        self.device = resolve_device(device)
        self.path = path
        self.variant = index.variant
        self.dim = index.forest.dim
        dev = self.device

        # ---- one-time upload ------------------------------------------
        self._side = PointerSide(index, dev)
        self._arena = TileArena.for_forest(index.forest, self.dim, dev)
        self.n_tiles = self._arena.n_tiles
        self._excluded_host = index.excluded
        Pp = int(self._arena.entries.shape[1])
        ids_row = np.full((1, Pp), ID_SENTINEL, dtype=np.int32)
        ids_row[0, : len(index.forest.entry_ids)] = index.forest.entry_ids
        self._ids_row = torch.as_tensor(ids_row, device=dev)
        ent = index.forest.entries
        extent = (
            np.concatenate([ent[:, : self.dim].min(0),
                            ent[:, self.dim:].max(0)]).astype(np.float64)
            if len(ent) else None
        )
        # quantized MBR planes: int16 fine / int32 coarse codes over the
        # arena extent, rounded outward
        self._grid = make_quant_grid(extent, self.dim, dev)
        self._qfine = quantize_fine(self._grid, self._arena.fine, self.dim)
        self._qcoarse = quantize_coarse(
            self._grid, self._arena.coarse, self.dim)

        self.stats: Dict[str, float] = {
            "batches": 0, "queries": 0, "tiles_scanned": 0,
            "tiles_grid": 0, "tiles_full_scan": 0, "fused_reruns": 0,
        }
        # candidate-capacity high-water mark: only ratchets up
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

    def _prepare(self, us: np.ndarray, rects: np.ndarray):
        """Pad, route and quantize one batch.  Returns ``(Bb, forced,
        args)``: ``forced`` the Alg. 2 answers of spatial-sink query
        vertices, ``args`` the fused serve's tensor inputs (the rect and
        slice tensors live in the padder's per-bucket buffers until the
        next batch of the same bucket)."""
        Bb, us_dev, rsoa = self._padder.pad(us, rects)
        qs, qe, pts, exc = self._route(us_dev)
        dim = self.dim
        inr = torch.ones(Bb, dtype=torch.bool, device=self.device)
        for a in range(dim):
            inr &= pts[:, a] >= rsoa[a]
            inr &= pts[:, a] <= rsoa[dim + a]
        r16, r32 = quantize_rects(self._grid, rsoa, dim)
        args = (self._qfine, self._qcoarse, self._arena.entries,
                self._ids_row, r16, r32, rsoa, qs, qe)
        return Bb, exc & inr, args

    def _fused_serve(self, us: np.ndarray, rects: np.ndarray, mode: str,
                     kc: Optional[int] = None):
        """One launch per batch for reach/count/collect at the current
        capacity high-water mark; a batch whose true candidate count
        passes it ratchets the mark and re-runs.  Returns ``(forced,
        out)`` — for collect, ``out`` is the ``(top, counts)`` pair."""
        Bb, forced, args = self._prepare(us, rects)
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
        self.stats["batches"] += 1
        self.stats["queries"] += len(us)
        self.stats["tiles_scanned"] += tot
        self.stats["tiles_grid"] += (Bb // TB) * kcap
        self.stats["tiles_full_scan"] += (Bb // TB) * self.n_tiles
        return forced, out

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Batched RangeReach, same contract as ``TwoDReachIndex
        .query_batch`` (and bit-identical to it)."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        forced, hit = self._fused_serve(us, rects, "reach")
        return ((hit > 0) | forced)[:B].cpu().numpy()

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])

    def count_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Batched RangeCount: (B,) int64 exact number of reachable
        venues intersecting each rect.  A forced (spatial-sink) query
        vertex reaches exactly itself; its tree probe counted nothing."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=np.int64)
        forced, counts = self._fused_serve(us, rects, "count")
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
        forced, (top, cnt) = self._fused_serve(
            us, rects, "collect", kc=_bucket(k, 1))
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

    def knn_batch(self, us, points, k: int):
        raise NotImplementedError(f"QueryEngine.knn_batch {_LATER}")

    def polygon_batch(self, us, polygons):
        raise NotImplementedError(f"QueryEngine.polygon_batch {_LATER}")


def engine_for(index: TwoDReachIndex,
               device: DeviceLike = None) -> QueryEngine:
    """Memoised ``QueryEngine`` for a built 2DReach index (one upload per
    index instance and device).  Raises a ``ValueError`` naming any
    other index type: device serving supports the 2DReach variants."""
    if not isinstance(index, TwoDReachIndex):
        raise ValueError(
            f"no device QueryEngine for {type(index).__name__}: device "
            f"serving supports the 2DReach variants only (2dreach, "
            f"2dreach-comp, 2dreach-pointer)")
    dev = resolve_device(device)
    eng = getattr(index, "_device_engine", None)
    if eng is None or not same_device(eng.device, dev):
        eng = QueryEngine(index, device=dev)
        index._device_engine = eng
    return eng
