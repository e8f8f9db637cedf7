"""Fused serving: quantized prune → ascending compaction → exact scan.

The port of ``repro.kernels.range_query.fused``.  One launch per batch
answers RangeReach (``mode="reach"``), RangeCount (``"count"``) or
RangeCollect (``"collect"``):

* **Quantized MBR planes** (:class:`QuantGrid`): rects and tile MBRs are
  snapped onto an integer grid over the arena's extent — ``int16`` for
  the fine (leaf-tile) plane, ``int32`` for the coarse plane — with
  every bound rounded *outward* (mins down, maxs up, ±1 grid cell of
  slack so float32 scaling error can never round inward).  The
  quantized test is a superset of the float32 truth, so pruning stays
  sound and the exact f32 leaf test decides every answer.  Padding
  (±inf) bounds map to reserved sentinel codes that fail both halves of
  the intersect test.
* :func:`fused_serve` — the wrapper.  For CUDA tensors it launches the
  hand-written kernel ``csrc/fused_serve.cu`` (a cluster of
  :func:`cluster_size` blocks per 8-query tile: prune of the leaf tiles
  its slices can reach, ballot compaction into an ascending worklist,
  exact scan of at most ``kcap`` tiles split over the cluster); for CPU
  tensors it runs :func:`fused_serve_torch`.
* :func:`fused_serve_torch` — the plain PyTorch version (a port of
  ``fused_serve_xla``): dense quantized prune, ascending compaction,
  gathered leaf-tile scan.  The kernel is held against it bit for bit.

Capacity contract: both scan at most ``kcap`` candidate tiles per query
tile and report the *true* per-tile candidate counts.  A count above
``kcap`` means the scan was truncated and the caller re-runs at a larger
capacity (the engine's ratchet).

Scanned-count contract: given ``scanned``, a ``(B // TB,)`` int32 tensor,
both write into it the candidate tiles each query tile's scan tested.
The kernel's reach scan stops testing a query once it has a hit, so a
tile whose queries all have one is skipped: its count is at most
``min(cnt, kcap)``, and equals it where no query of the tile hits.  The
plain version, and the kernel's count and collect scans, test every
candidate and write ``min(cnt, kcap)``.  ``out`` and ``cnt`` are the
same either way.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_aligned, check_tensor, sm_count
from .descent import take_candidates, tile_hits
from .layout import COARSE_GROUP, ID_SENTINEL, TB, TP, cluster_size

# int16 fine-plane code space: finite bounds clip to [I16_LO, I16_HI];
# the values just outside are reserved for ±inf padding so an inert
# tile/rect fails both halves of the intersect test by construction.
I16_LO, I16_HI = -32767, 32766
I16_PAD_MIN, I16_PAD_MAX = 32767, -32768          # min=+inf / max=-inf
# int32 coarse-plane code space (2^20-cell grid, clip well inside int32)
I32_LO, I32_HI = -2_000_000, 2_000_000
I32_PAD_MIN, I32_PAD_MAX = 2_100_000, -2_100_000
_GRID16 = 60000.0       # fine grid cells across the arena extent
_GRID32 = float(2 ** 20)  # coarse grid cells

MODES = ("reach", "count", "collect")


# --------------------------------------------------------------------------
# Quantization (outward-rounded, provably conservative)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantGrid:
    """Per-axis affine maps onto the int16 / int32 code grids:
    ``code = (x - mid) * scale``, mins floored (−1 slack) and maxs ceiled
    (+1 slack) before clipping into the finite code range."""

    mid: torch.Tensor   # (dim,) float32 extent midpoint
    s16: torch.Tensor   # (dim,) float32 cells-per-unit, fine grid
    s32: torch.Tensor   # (dim,) float32 cells-per-unit, coarse grid


def make_quant_grid(extent, dim: int, device: torch.device) -> QuantGrid:
    """Grid from a ``(2*dim,)`` [mins..., maxs...] extent (``None`` /
    empty arena → a degenerate grid under which every finite bound maps
    near 0 — maximally permissive, still exact downstream).  Computed in
    float64 and rounded to float32, as the reference does."""
    if extent is None:
        lo = np.zeros(dim, np.float64)
        hi = np.zeros(dim, np.float64)
    else:
        extent = np.asarray(extent, np.float64)
        lo, hi = extent[:dim], extent[dim:2 * dim]
    width = np.maximum(hi - lo, 1e-9)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return QuantGrid(mid=f32((lo + hi) / 2.0), s16=f32(_GRID16 / width),
                     s32=f32(_GRID32 / width))


def _q_plane(plane: torch.Tensor, mid: torch.Tensor, s: torch.Tensor,
             dim: int, *, lo_code: int, hi_code: int, pad_min: int,
             pad_max: int, dtype: torch.dtype) -> torch.Tensor:
    """Quantize a (2*dim, N) [mins..., maxs...] SoA plane outward, with
    the reference's float32 operation order per element: ``(x - mid) *
    s``, then ``floor - 1`` (mins) or ``ceil + 1`` (maxs), clamp, the
    ±inf sentinels, cast."""
    mid2 = torch.cat([mid, mid])[:, None]
    s2 = torch.cat([s, s])[:, None]
    is_min = (torch.arange(2 * dim, device=plane.device) < dim)[:, None]
    v = (plane - mid2) * s2
    q = torch.where(is_min, torch.floor(v) - 1.0, torch.ceil(v) + 1.0)
    q = q.clamp(float(lo_code), float(hi_code))
    q = torch.where(is_min & (plane == float("inf")), float(pad_min), q)
    q = torch.where(~is_min & (plane == float("-inf")), float(pad_max), q)
    return q.to(dtype)


def quantize_fine(grid: QuantGrid, fine: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """(2*dim, NTp) f32 fine tile MBRs -> int16 codes (outward)."""
    return _q_plane(fine, grid.mid, grid.s16, dim, lo_code=I16_LO,
                    hi_code=I16_HI, pad_min=I16_PAD_MIN,
                    pad_max=I16_PAD_MAX, dtype=torch.int16)


def quantize_coarse(grid: QuantGrid, coarse: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """(2*dim, NCp) f32 coarse MBRs -> int32 codes (outward)."""
    return _q_plane(coarse, grid.mid, grid.s32, dim, lo_code=I32_LO,
                    hi_code=I32_HI, pad_min=I32_PAD_MIN,
                    pad_max=I32_PAD_MAX, dtype=torch.int32)


def quantize_rects(grid: QuantGrid, rsoa: torch.Tensor,
                   dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2*dim, B) f32 rects -> (int16, int32) outward-rounded codes.

    Rects round outward too (mins down, maxs up): expanding *both*
    sides of the intersect test keeps the quantized candidate set a
    superset of the float32 one.
    """
    return (quantize_fine(grid, rsoa, dim), quantize_coarse(grid, rsoa, dim))


# --------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the kernel's oracle on the card)
# --------------------------------------------------------------------------

def quantized_prune_mask(
    qfine, qcoarse, r16, r32, qstart, qend, *, dim: int = 2,
) -> torch.Tensor:
    """(B // TB, NTp) bool — quantized coarse∧fine∧slice prune, the
    conjunction taken per query and the OR over each query tile."""
    ntp = qfine.shape[1]
    B = r16.shape[1]
    gidx = torch.arange(ntp, dtype=torch.int32, device=qfine.device)[None, :]
    ok = (gidx * TP < qend[:, None]) & (gidx * TP + TP > qstart[:, None])
    for a in range(dim):
        ok &= qfine[a][None, :] <= r16[dim + a][:, None]
        ok &= qfine[dim + a][None, :] >= r16[a][:, None]
    cok = torch.ones((B, qcoarse.shape[1]), dtype=torch.bool,
                     device=qfine.device)
    for a in range(dim):
        cok &= qcoarse[a][None, :] <= r32[dim + a][:, None]
        cok &= qcoarse[dim + a][None, :] >= r32[a][:, None]
    ok &= cok.repeat_interleave(COARSE_GROUP, dim=1)[:, :ntp]
    return ok.reshape(B // TB, TB, ntp).any(dim=1)


def compact_ascending(mask: torch.Tensor, nt: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune mask (NB, >=nt) -> (cand (NB, nt) int32 ascending actives
    then the last active repeated, cnt (NB,) int32)."""
    active = mask[:, :nt] > 0
    cnt = active.sum(dim=1, dtype=torch.int32)
    j = torch.arange(nt, dtype=torch.int32, device=mask.device)
    order = torch.argsort(
        torch.where(active, j[None, :], nt + j[None, :]), dim=1
    ).to(torch.int32)
    rows = torch.arange(order.shape[0], device=mask.device)
    last = order[rows, (cnt - 1).clamp(min=0).long()]
    cand = torch.where(j[None, :] < cnt[:, None], order, last[:, None])
    return cand, cnt


def fused_serve_torch(
    qfine, qcoarse, entries_soa, ids_soa, r16, r32, rects_soa,
    qstart, qend, *, mode: str, kcap: int, nt: int, dim: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`fused_serve`, in plain PyTorch: dense
    quantized prune → ascending compaction → gathered leaf-tile scan."""
    if mode not in MODES:
        raise ValueError(f"unknown fused mode {mode!r}")
    B = rects_soa.shape[1]
    kcap = max(int(kcap), 1)
    mask = quantized_prune_mask(qfine, qcoarse, r16, r32, qstart, qend,
                                dim=dim)
    cand, cnt = compact_ascending(mask, nt)
    ck = take_candidates(cand, kcap)                     # (nb, kcap)
    live = (torch.arange(kcap, dtype=torch.int32,
                         device=entries_soa.device)[None, :]
            < cnt[:, None])                              # (nb, kcap)
    hit, g = tile_hits(ck, entries_soa, rects_soa, qstart, qend, dim=dim)
    hit &= live.repeat_interleave(TP, dim=1)[:, None, :]
    if mode == "reach":
        out = hit.any(dim=2).to(torch.int32).reshape(B)
    elif mode == "count":
        out = hit.sum(dim=2, dtype=torch.int32).reshape(B)
    else:
        ids = ids_soa[0][g.long()]                       # (nb, K*TP)
        out = torch.where(hit, ids[:, None, :],
                          torch.tensor(int(ID_SENTINEL), dtype=torch.int32,
                                       device=ids.device)).reshape(
                                           B, kcap * TP)
    return out, cnt


# --------------------------------------------------------------------------
# The wrapper: the CUDA kernel on the card, the plain version on the CPU
# --------------------------------------------------------------------------

_MODE_CODE = {"reach": 0, "count": 1, "collect": 2}
_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6

def fused_serve(
    qfine: torch.Tensor,        # (2*dim, NTp) int16 quantized fine MBRs
    qcoarse: torch.Tensor,      # (2*dim, NTp // COARSE_GROUP) int32
    entries_soa: torch.Tensor,  # (2*dim, P) float32 arena
    ids_soa: torch.Tensor,      # (1, P) int32 payload ids (collect mode)
    r16: torch.Tensor,          # (2*dim, B) int16 quantized rects
    r32: torch.Tensor,          # (2*dim, B) int32 quantized rects
    rects_soa: torch.Tensor,    # (2*dim, B) float32 exact rects
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    mode: str,                  # "reach" | "count" | "collect"
    kcap: int,                  # worklist capacity (tiles per query tile)
    nt: int,                    # true fine tile count
    dim: int = 2,
    device: DeviceLike = None,
    scanned: Optional[torch.Tensor] = None,  # (B // TB,) int32, written
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-launch fused serve.  Returns ``(out, cnt)``:

    * ``out`` — mode reach/count: (B,) int32 hits / exact counts;
      mode collect: (B, kcap*TP) int32 ids-or-sentinel matrix;
    * ``cnt`` — (B // TB,) int32 true candidate-tile counts.  Any value
      > ``kcap`` means the scan was truncated.

    ``scanned``, where given, gets the candidate tiles each query tile's
    scan tested (the module's scanned-count contract).

    ``device`` (``None``: the GPU) must be where the tensors lie.  On a
    CUDA device the hand-written kernel runs, and a build or launch
    failure raises; on the CPU the plain version runs.
    """
    dev = resolve_device(device)
    if mode not in MODES:
        raise ValueError(f"unknown fused mode {mode!r}")
    kcap = max(int(kcap), 1)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if scanned is not None:
        check_tensor("scanned", scanned, torch.int32,
                     (rects_soa.shape[1] // TB,), dev)
    if dev.type == "cpu":
        out, cnt = fused_serve_torch(
            qfine, qcoarse, entries_soa, ids_soa, r16, r32, rects_soa,
            qstart, qend, mode=mode, kcap=kcap, nt=nt, dim=dim)
        if scanned is not None:
            torch.clamp(cnt, max=kcap, out=scanned)
        return out, cnt

    P = entries_soa.shape[1]
    B = rects_soa.shape[1]
    ntp = qfine.shape[1]
    if dim != 2:
        raise ValueError(f"the CUDA kernel serves dim=2, got dim={dim}")
    if P % TP or B % TB or B == 0 or ntp % COARSE_GROUP:
        raise ValueError(f"P={P} must be a multiple of {TP}, B={B} a "
                         f"positive multiple of {TB}, NTp={ntp} a "
                         f"multiple of {COARSE_GROUP}")
    if not 0 < nt <= ntp or ntp * TP >= 2 ** 31 or P >= 2 ** 31:
        raise ValueError(f"tile counts out of range: nt={nt} NTp={ntp} "
                         f"P={P} (entry indices must stay int32)")
    check_tensor("qfine", qfine, torch.int16, (4, ntp), dev)
    check_tensor("qcoarse", qcoarse, torch.int32, (4, ntp // COARSE_GROUP), dev)
    check_tensor("entries_soa", entries_soa, torch.float32, (4, P), dev)
    check_tensor("ids_soa", ids_soa, torch.int32, (1, P), dev)
    check_tensor("r16", r16, torch.int16, (4, B), dev)
    check_tensor("r32", r32, torch.int32, (4, B), dev)
    check_tensor("rects_soa", rects_soa, torch.float32, (4, B), dev)
    check_tensor("qstart", qstart, torch.int32, (B,), dev)
    check_tensor("qend", qend, torch.int32, (B,), dev)
    check_aligned("entries_soa", entries_soa)     # cp.async, 16 bytes
    check_aligned("ids_soa", ids_soa)

    nb = B // TB
    dev = entries_soa.device
    shape = (B, kcap * TP) if mode == "collect" else (B,)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    cnt = torch.empty(nb, dtype=torch.int32, device=dev)
    call("fused_serve", "fused_serve_launch", _ARGS, dev, _MODE_CODE[mode],
         qfine.data_ptr(), qcoarse.data_ptr(), entries_soa.data_ptr(),
         ids_soa.data_ptr(), r16.data_ptr(), r32.data_ptr(),
         rects_soa.data_ptr(), qstart.data_ptr(), qend.data_ptr(),
         out.data_ptr(), cnt.data_ptr(),
         None if scanned is None else scanned.data_ptr(), ntp, nt, P, B, kcap,
         cluster_size(nb, sm_count(dev)))
    fused_serve.launches += 1
    if scanned is not None and mode != "reach":
        torch.clamp(cnt, max=kcap, out=scanned)
    return out, cnt


fused_serve.launches = 0
