"""Analytics leaf scans over the compacted candidate tiles: count,
collect and polygon (the port of ``repro.kernels.range_query.analytics``).

The boolean scan (:func:`~.descent.descent_scan`) tolerates a repeated
candidate tile, because OR is idempotent; a sum does not.  Compacted
lists hold the active tiles strictly ascending, then the last active
tile repeated, so a slot whose tile is not above the previous slot's
(``cand[i, k] <= cand[i, k-1]``, ``k > 0``) is padding and contributes
nothing (:func:`dup_slots`, the reference's ``_dup_slot``).

* :func:`count_scan` — (B,) int32 exact hit counts.  On a CUDA tensor
  it launches ``csrc/leaf_scan.cu`` (K4, a thread block cluster of
  :func:`~.descent.scan_cluster_size` CTAs per 8-query tile); on a CPU
  tensor it runs :func:`count_scan_torch`.
* :func:`collect_scan` — (B, K*TP) int32: the payload id of every hit
  entry, ``ID_SENTINEL`` everywhere else.  On a CUDA tensor it launches
  ``csrc/leaf_scan.cu`` (K5, a warp per query tile and slot,
  :func:`collect_warps` of them a CTA, float4 loads and int4 stores); on
  a CPU tensor it runs :func:`collect_scan_torch`.
* :func:`polygon_scan` — (B,) int32 0/1: boolean RangeReach where the
  query rect is a convex polygon's bbox and each query also carries
  ``ne`` half-planes ``A*x + B*y <= C`` (float32, inert padding ``A = B
  = 0, C = +inf``), tested on each entry point inside the leaf scan.
  Each product and the sum round on their own (no fused multiply-add),
  as ``core.polygon.points_in_polygon_region`` computes them.  On a CUDA
  tensor it launches ``csrc/leaf_scan.cu`` (K6, clustered as K4); on a
  CPU tensor it runs :func:`polygon_scan_torch`.
* :func:`count_scan_ref` / :func:`collect_scan_ref` /
  :func:`polygon_scan_ref` — dense versions over the whole arena, the
  oracles of the tests.
"""

from __future__ import annotations

import ctypes

import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_aligned, check_tensor, sm_count
from .descent import check_scan_inputs, scan_cluster_size, tile_hits
from .layout import ID_SENTINEL, TB, TP

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


COLLECT_MAX_WARPS = 8   # K5: slots (warps) per CTA


def collect_warps(n_query_tiles: int, K: int, n_sms: int) -> int:
    """Warps per CTA of K5, one candidate slot each, on ``n_query_tiles
    * ceil(K / w)`` CTAs: of 1, 2, 4 and 8 (at most K), the one whose
    grid comes nearest to one CTA per multiprocessor (by ratio; a tie
    goes to the wider CTA).  Every warp does the same work, two dependent
    memory round trips and eight 512-byte row stores, and each CTA costs
    the block scheduler and a prologue, so fewer and wider CTAs are
    cheaper as long as they still reach every multiprocessor.  On 132
    multiprocessors at K = 16: B/8 = 1 takes 1 (16 CTAs), 32 (the
    serving batch) takes 4 (128 CTAs; ``chip_smoke.py --ab`` on an H100
    times 2 and 1 a little slower, and 8, on 64 multiprocessors,
    slowest), 256 takes 8 (512 CTAs, the fewest it can have)."""
    def off(w):
        grid = n_query_tiles * -(-K // w)
        return max(grid / n_sms, n_sms / grid)

    widths = [w for w in (8, 4, 2, 1) if w <= min(K, COLLECT_MAX_WARPS)]
    return min(widths, key=off)


def dup_slots(cand: torch.Tensor) -> torch.Tensor:
    """(NB, K) bool — True where slot k of a compacted list is padding."""
    dup = torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    dup[:, 1:] = cand[:, 1:] <= cand[:, :-1]
    return dup


def _live_hits(cand, entries_soa, rects_soa, qstart, qend, dim):
    hit, g = tile_hits(cand, entries_soa, rects_soa, qstart, qend, dim=dim)
    hit &= ~dup_slots(cand).repeat_interleave(TP, dim=1)[:, None, :]
    return hit, g


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' oracles on the card)
# --------------------------------------------------------------------------

def count_scan_torch(cand, entries_soa, rects_soa, qstart, qend, *,
                     dim: int = 2) -> torch.Tensor:
    """(B,) int32 exact hit counts over the K candidate tiles, padding
    slots counting zero (same contract as :func:`count_scan`)."""
    hit, _ = _live_hits(cand, entries_soa, rects_soa, qstart, qend, dim)
    return hit.sum(dim=2, dtype=torch.int32).reshape(-1)


def collect_scan_torch(cand, entries_soa, ids_soa, rects_soa, qstart, qend,
                       *, dim: int = 2) -> torch.Tensor:
    """(B, K*TP) int32 hit payload ids, ``ID_SENTINEL`` elsewhere and on
    padding slots (same contract as :func:`collect_scan`)."""
    hit, g = _live_hits(cand, entries_soa, rects_soa, qstart, qend, dim)
    ids = ids_soa[0][g.long()]                           # (nb, K*TP)
    sentinel = torch.tensor(int(ID_SENTINEL), dtype=torch.int32,
                            device=ids.device)
    return torch.where(hit, ids[:, None, :], sentinel).reshape(
        -1, cand.shape[1] * TP)


def _in_halfplanes(ok, x, y, lines_soa, ne: int):
    """AND the ``ne`` half-planes of each query into ``ok`` (B, N):
    ``A*x + B*y <= C`` with each float32 product and the sum rounded on
    their own (separate tensor operations, never a fused multiply-add).
    ``x``/``y`` broadcast against ``ok``; ``lines_soa`` is (3*ne, B)."""
    for hp in range(ne):
        a = lines_soa[hp][:, None]
        b = lines_soa[ne + hp][:, None]
        c = lines_soa[2 * ne + hp][:, None]
        ok &= (a * x + b * y) <= c
    return ok


def polygon_scan_torch(cand, entries_soa, rects_soa, lines_soa, qstart,
                       qend, *, ne: int, dim: int = 2) -> torch.Tensor:
    """(B,) int32 0/1 — any entry point of the K candidate tiles inside
    the bbox and all ``ne`` half-planes (same contract as
    :func:`polygon_scan`).  Padding slots repeat a tile: an idempotent
    OR."""
    hit, g = tile_hits(cand, entries_soa, rects_soa, qstart, qend, dim=dim)
    B = qstart.shape[0]
    hit = hit.reshape(B, -1)                             # (B, K*TP)
    pts = entries_soa[:2, g.long()].repeat_interleave(TB, dim=1)
    hit = _in_halfplanes(hit, pts[0], pts[1], lines_soa, ne)
    return hit.any(dim=1).to(torch.int32)


def _dense_hits(entries_soa, rects_soa, qstart, qend, dim):
    P = entries_soa.shape[1]
    gidx = torch.arange(P, dtype=torch.int32,
                        device=entries_soa.device)[None, :]
    ok = (gidx >= qstart[:, None]) & (gidx < qend[:, None])
    for a in range(dim):
        ok &= entries_soa[a][None, :] <= rects_soa[dim + a][:, None]
        ok &= entries_soa[dim + a][None, :] >= rects_soa[a][:, None]
    return ok


def count_scan_ref(entries_soa, rects_soa, qstart, qend, *,
                   dim: int = 2) -> torch.Tensor:
    """Dense oracle: (B,) int32 exact counts scanning the whole arena."""
    return _dense_hits(entries_soa, rects_soa, qstart, qend, dim).sum(
        dim=1, dtype=torch.int32)


def collect_scan_ref(entries_soa, ids_soa, rects_soa, qstart, qend, *,
                     dim: int = 2) -> torch.Tensor:
    """Dense oracle: (B, P) ids-or-sentinel over the whole arena."""
    ok = _dense_hits(entries_soa, rects_soa, qstart, qend, dim)
    sentinel = torch.tensor(int(ID_SENTINEL), dtype=torch.int32,
                            device=ok.device)
    return torch.where(ok, ids_soa[0][None, :], sentinel)


def polygon_scan_ref(entries_soa, rects_soa, lines_soa, qstart, qend, *,
                     ne: int, dim: int = 2) -> torch.Tensor:
    """Dense oracle: (B,) int32 0/1 over the whole arena (the port of
    ``polygon_scan_ref``)."""
    ok = _dense_hits(entries_soa, rects_soa, qstart, qend, dim)
    ok = _in_halfplanes(ok, entries_soa[0][None, :], entries_soa[1][None, :],
                        lines_soa, ne)
    return ok.any(dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# The wrappers: the CUDA kernels on the card, the plain versions on the CPU
# --------------------------------------------------------------------------

def count_scan(
    cand: torch.Tensor,         # (B // TB, K) int32 compacted candidates
    entries_soa: torch.Tensor,  # (2*dim, P) float32, P % TP == 0
    rects_soa: torch.Tensor,    # (2*dim, B) float32, B % TB == 0
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B,) int32 exact hit counts over the K candidate tiles.  ``cand``
    must be a compacted list (actives strictly ascending, then the last
    active repeated) covering every tile with a possible hit.  On a CUDA
    device the K4 kernel runs; on the CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return count_scan_torch(cand, entries_soa, rects_soa, qstart, qend,
                                dim=dim)
    B, P, K = check_scan_inputs(cand, entries_soa, rects_soa, qstart, qend,
                                dim, dev)
    out = torch.empty(B, dtype=torch.int32, device=entries_soa.device)
    call("leaf_scan", "count_scan_launch", [_PTR] * 6 + [_INT] * 4,
         out.device, cand.data_ptr(), entries_soa.data_ptr(),
         rects_soa.data_ptr(), qstart.data_ptr(), qend.data_ptr(),
         out.data_ptr(), K, P, B,
         scan_cluster_size(B // TB, K, sm_count(out.device)))
    count_scan.launches += 1
    return out


count_scan.launches = 0


def collect_scan(
    cand: torch.Tensor,         # (B // TB, K) int32 compacted candidates
    entries_soa: torch.Tensor,  # (2*dim, P) float32, P % TP == 0
    ids_soa: torch.Tensor,      # (1, P) int32 payload ids
    rects_soa: torch.Tensor,    # (2*dim, B) float32, B % TB == 0
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B, K*TP) int32 — the hit payload ids of each query, every other
    slot ``ID_SENTINEL``.  Sort rows and keep the prefix for the K
    smallest ids; count non-sentinels for the exact total.  On a CUDA
    device the K5 kernel runs: it loads the planes and ids as float4 and
    int4, so ``entries_soa`` and ``ids_soa`` must start on a 16-byte
    boundary (a ``ValueError`` otherwise); on the CPU the plain version
    runs."""
    dev = resolve_device(device)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return collect_scan_torch(cand, entries_soa, ids_soa, rects_soa,
                                  qstart, qend, dim=dim)
    B, P, K = check_scan_inputs(cand, entries_soa, rects_soa, qstart, qend,
                                dim, dev)
    check_tensor("ids_soa", ids_soa, torch.int32, (1, P), dev)
    check_aligned("entries_soa", entries_soa)
    check_aligned("ids_soa", ids_soa)
    out = torch.empty((B, K * TP), dtype=torch.int32,
                      device=entries_soa.device)
    check_aligned("out", out)
    call("leaf_scan", "collect_scan_launch", [_PTR] * 7 + [_INT] * 4,
         out.device, cand.data_ptr(), entries_soa.data_ptr(),
         ids_soa.data_ptr(), rects_soa.data_ptr(), qstart.data_ptr(),
         qend.data_ptr(), out.data_ptr(), K, P, B,
         collect_warps(B // TB, K, sm_count(out.device)))
    collect_scan.launches += 1
    return out


collect_scan.launches = 0


def polygon_scan(
    cand: torch.Tensor,         # (B // TB, K) int32 compacted candidates
    entries_soa: torch.Tensor,  # (2*dim, P) float32, P % TP == 0
    rects_soa: torch.Tensor,    # (2*dim, B) float32 polygon bboxes
    lines_soa: torch.Tensor,    # (3*ne, B) float32 half-planes [A.., B.., C..]
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    ne: int,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B,) int32 0/1 — any entry point of the K candidate tiles inside
    the bbox AND all ``ne`` half-planes (the convex-polygon region).
    ``cand`` must cover every tile with a possible hit; a repeated tile
    is harmless.  On a CUDA device the K6 kernel runs; on the CPU the
    plain version runs."""
    dev = resolve_device(device)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return polygon_scan_torch(cand, entries_soa, rects_soa, lines_soa,
                                  qstart, qend, ne=ne, dim=dim)
    B, P, K = check_scan_inputs(cand, entries_soa, rects_soa, qstart, qend,
                                dim, dev)
    if ne < 1:
        raise ValueError(f"polygon scan needs ne >= 1, got {ne}")
    check_tensor("lines_soa", lines_soa, torch.float32, (3 * ne, B), dev)
    out = torch.empty(B, dtype=torch.int32, device=entries_soa.device)
    call("leaf_scan", "polygon_scan_launch", [_PTR] * 7 + [_INT] * 5,
         out.device, cand.data_ptr(), entries_soa.data_ptr(),
         rects_soa.data_ptr(), lines_soa.data_ptr(), qstart.data_ptr(),
         qend.data_ptr(), out.data_ptr(), K, P, B, ne,
         scan_cluster_size(B // TB, K, sm_count(out.device)))
    polygon_scan.launches += 1
    return out


polygon_scan.launches = 0
