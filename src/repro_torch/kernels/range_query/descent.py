"""Two-phase descent: hierarchical prune (phase 1), then a scan of the
compacted candidate tiles (phase 2).

The port of ``repro.kernels.range_query.descent``:

* :func:`prune_tiles` — phase 1.  Each query rect is tested against the
  float32 tile pyramid: the coarse MBR of every group of
  ``COARSE_GROUP`` leaf tiles, the fine MBR of every leaf tile and the
  overlap of the tile's entries ``[g*TP, g*TP + TP)`` with the query's
  arena slice ``[qs, qe)``.  The result is OR-ed over the ``TB``
  queries of each query tile: a ``(B // TB, NTp)`` int32 0/1 mask.  On a
  CUDA tensor it launches ``csrc/prune_tiles.cu`` (K2); on a CPU tensor
  it runs :func:`prune_tiles_torch`, a port of ``prune_tiles_ref``.
* :func:`descent_scan` — phase 2 for RangeReach: OR over the ``K``
  candidate tiles of each query tile of the exact slice and box test,
  ``(B,)`` int32 0/1.  On a CUDA tensor it launches
  ``csrc/leaf_scan.cu`` (K3, a thread block cluster of
  :func:`scan_cluster_size` CTAs per 8-query tile, as K4 and K6); on a
  CPU tensor it runs :func:`descent_scan_torch`, a gathered scan with
  the same contract.

Exactness never rests on the mask: the scan re-tests every entry by
arena slice and exact box, so a superfluous candidate tile adds nothing
and a repeated one is an idempotent OR.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_aligned, check_tensor, sm_count
from .layout import COARSE_GROUP, TB, TP, TPT, cluster_size

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


# --------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' oracles on the card)
# --------------------------------------------------------------------------

def prune_tiles_torch(fine_soa, coarse_soa, rects_soa, qstart, qend, *,
                      dim: int = 2) -> torch.Tensor:
    """(B // TB, NTp) int32 — 1 iff any query of tile i needs leaf tile
    j: the float32 coarse AND fine MBR test AND the arena-slice overlap,
    per query, OR-ed over each query tile (``prune_tiles_ref``)."""
    ntp = fine_soa.shape[1]
    B = rects_soa.shape[1]
    dev = fine_soa.device
    gidx = torch.arange(ntp, dtype=torch.int32, device=dev)[None, :]
    ok = (gidx * TP < qend[:, None]) & (gidx * TP + TP > qstart[:, None])
    for a in range(dim):
        ok &= fine_soa[a][None, :] <= rects_soa[dim + a][:, None]
        ok &= fine_soa[dim + a][None, :] >= rects_soa[a][:, None]
    cok = torch.ones((B, coarse_soa.shape[1]), dtype=torch.bool, device=dev)
    for a in range(dim):
        cok &= coarse_soa[a][None, :] <= rects_soa[dim + a][:, None]
        cok &= coarse_soa[dim + a][None, :] >= rects_soa[a][:, None]
    ok &= cok.repeat_interleave(COARSE_GROUP, dim=1)
    return ok.reshape(B // TB, TB, ntp).any(dim=1).to(torch.int32)


def take_candidates(cand: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` candidate columns of a ``(NB, nt)`` compacted
    list, contiguous; beyond ``nt`` the last column repeats (a padding
    slot, as compaction pads)."""
    nt = cand.shape[1]
    if k <= nt:
        return cand[:, :k].contiguous()
    return torch.cat([cand, cand[:, -1:].expand(cand.shape[0], k - nt)],
                     dim=1)


def tile_hits(cand, entries_soa, rects_soa, qstart, qend, *, dim: int = 2
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact leaf test over gathered candidate tiles.

    ``cand`` (NB, K) holds leaf-tile ids.  Returns ``(hit (NB, TB,
    K*TP) bool, g (NB, K*TP) int32)``: ``g`` the global entry index of
    each lane of each candidate tile, ``hit`` whether query ``q`` of the
    query tile holds that entry in its arena slice and its rect.  A
    tile outside ``[0, P // TP)`` is a miss, as the kernels never read
    it: its entries lie outside every arena slice (``0 <= qstart``,
    ``qend <= P``), and its ``g`` is clamped into the arena for the
    gathers."""
    nb, k = cand.shape
    dev = entries_soa.device
    g = (cand[:, :, None] * TP
         + torch.arange(TP, dtype=torch.int32, device=dev)[None, None, :]
         ).reshape(nb, k * TP)
    qs = qstart.reshape(nb, TB)[:, :, None]
    qe = qend.reshape(nb, TB)[:, :, None]
    q = rects_soa.reshape(2 * dim, nb, TB)
    hit = (g[:, None, :] >= qs) & (g[:, None, :] < qe)  # (nb, TB, K*TP)
    g = g.clamp(0, entries_soa.shape[1] - 1)
    tiles = entries_soa[:, g.long()]                    # (2*dim, nb, K*TP)
    for a in range(dim):
        hit &= tiles[a][:, None, :] <= q[dim + a][:, :, None]
        hit &= tiles[dim + a][:, None, :] >= q[a][:, :, None]
    return hit, g


def descent_scan_torch(cand, entries_soa, rects_soa, qstart, qend, *,
                       dim: int = 2) -> torch.Tensor:
    """(B,) int32 0/1 — OR over the K candidate tiles of each query
    tile (same contract as :func:`descent_scan`)."""
    hit, _ = tile_hits(cand, entries_soa, rects_soa, qstart, qend, dim=dim)
    return hit.any(dim=2).to(torch.int32).reshape(-1)


# --------------------------------------------------------------------------
# The wrappers: the CUDA kernels on the card, the plain versions on the CPU
# --------------------------------------------------------------------------

def check_scan_inputs(cand, entries_soa, rects_soa, qstart, qend, dim: int,
                      dev: torch.device) -> Tuple[int, int, int]:
    """Checks shared by the leaf-scan wrappers (K3, K4, K5); returns
    ``(B, P, K)``."""
    P = entries_soa.shape[1]
    B = rects_soa.shape[1]
    if dim != 2:
        raise ValueError(f"the CUDA kernels serve dim=2, got dim={dim}")
    if P % TP or P >= 2 ** 31 or B % TB or B == 0:
        raise ValueError(f"P={P} must be a multiple of {TP} below 2^31, "
                         f"B={B} a positive multiple of {TB}")
    if cand.dim() != 2 or cand.shape[1] < 1:
        raise ValueError(f"cand must be (B // {TB}, K) with K >= 1, got "
                         f"shape {tuple(cand.shape)}")
    K = cand.shape[1]
    check_tensor("cand", cand, torch.int32, (B // TB, K), dev)
    check_tensor("entries_soa", entries_soa, torch.float32, (4, P), dev)
    check_tensor("rects_soa", rects_soa, torch.float32, (4, B), dev)
    check_tensor("qstart", qstart, torch.int32, (B,), dev)
    check_tensor("qend", qend, torch.int32, (B,), dev)
    return B, P, K


def scan_cluster_size(n_query_tiles: int, K: int, n_sms: int) -> int:
    """CTAs per query tile in the thread block cluster of K3, K4 and K6:
    K1's choice (:func:`.layout.cluster_size`, 8 at 32 query tiles on 132
    multiprocessors, 1 from 132 up), capped at the K candidate slots,
    which the cluster's CTAs share round robin, so that no CTA is left
    without a slot."""
    return min(cluster_size(n_query_tiles, n_sms), K)


PRUNE_THREADS = 256   # K2's block: 4 leaf tiles per thread and step
PRUNE_QUAD = 4
PRUNE_BLOCKS_PER_SM = 4   # resident at K2's register budget


def prune_stripes(n_query_tiles: int, ntp: int, n_sms: int) -> int:
    """Blocks per query tile's mask row in K2's grid: as many as keep the
    grid to one wave (``PRUNE_BLOCKS_PER_SM`` on every multiprocessor),
    at least one, and no more than give each thread one step."""
    steps = -(-(ntp // PRUNE_QUAD) // PRUNE_THREADS)
    wave = PRUNE_BLOCKS_PER_SM * n_sms // n_query_tiles
    return max(1, min(steps, wave, 65535))


def prune_tiles(
    fine_soa: torch.Tensor,     # (2*dim, NTp) float32, NTp % TPT == 0
    coarse_soa: torch.Tensor,   # (2*dim, NTp // COARSE_GROUP) float32
    rects_soa: torch.Tensor,    # (2*dim, B) float32, B % TB == 0
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B // TB, NTp) int32 — 1 iff any query of tile i needs leaf tile
    j.  ``device`` (``None``: the GPU) must be where the tensors lie: on
    a CUDA device the K2 kernel runs, and a build or launch failure
    raises; on the CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(fine_soa.device, dev):
        raise ValueError(f"fine_soa lies on {fine_soa.device}, expected {dev}")
    if dev.type == "cpu":
        return prune_tiles_torch(fine_soa, coarse_soa, rects_soa, qstart,
                                 qend, dim=dim)

    ntp = fine_soa.shape[1]
    B = rects_soa.shape[1]
    nb = B // TB
    if dim != 2:
        raise ValueError(f"the CUDA kernel serves dim=2, got dim={dim}")
    if ntp % TPT or ntp == 0 or B % TB or B == 0:
        raise ValueError(f"NTp={ntp} must be a positive multiple of {TPT}, "
                         f"B={B} a positive multiple of {TB}")
    if ntp * TP >= 2 ** 31 or nb >= 2 ** 31:
        raise ValueError(f"NTp={ntp}, B={B} out of range: the slice test "
                         f"g*{TP} and the grid must stay int32")
    check_tensor("fine_soa", fine_soa, torch.float32, (4, ntp), dev)
    check_tensor("coarse_soa", coarse_soa, torch.float32,
                 (4, ntp // COARSE_GROUP), dev)
    check_tensor("rects_soa", rects_soa, torch.float32, (4, B), dev)
    check_tensor("qstart", qstart, torch.int32, (B,), dev)
    check_tensor("qend", qend, torch.int32, (B,), dev)
    check_aligned("fine_soa", fine_soa)
    mask = torch.empty((nb, ntp), dtype=torch.int32, device=fine_soa.device)
    call("prune_tiles", "prune_tiles_launch", [_PTR] * 6 + [_INT] * 3,
         mask.device, fine_soa.data_ptr(), coarse_soa.data_ptr(),
         rects_soa.data_ptr(), qstart.data_ptr(), qend.data_ptr(),
         mask.data_ptr(), ntp, B, prune_stripes(nb, ntp, sm_count(dev)))
    prune_tiles.launches += 1
    return mask


prune_tiles.launches = 0


def descent_scan(
    cand: torch.Tensor,         # (B // TB, K) int32 leaf tiles in [0, P // TP)
    entries_soa: torch.Tensor,  # (2*dim, P) float32, P % TP == 0
    rects_soa: torch.Tensor,    # (2*dim, B) float32, B % TB == 0
    qstart: torch.Tensor,       # (B,) int32
    qend: torch.Tensor,         # (B,) int32
    *,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B,) int32 0/1 — OR over the K candidate tiles of each query tile
    of the exact slice and box test.  Duplicate candidates are harmless,
    and a candidate outside ``[0, P // TP)`` is a miss: the kernel never
    reads it, and the plain version's :func:`tile_hits` counts it as one
    (held by ``test_torch_analytics.py::
    test_tiles_outside_the_arena_are_misses``).  On a CUDA device the K3
    kernel runs (a cluster of :func:`scan_cluster_size` CTAs per query
    tile); on the CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return descent_scan_torch(cand, entries_soa, rects_soa, qstart, qend,
                                  dim=dim)

    B, P, K = check_scan_inputs(cand, entries_soa, rects_soa, qstart, qend,
                                dim, dev)
    out = torch.empty(B, dtype=torch.int32, device=entries_soa.device)
    call("leaf_scan", "descent_scan_launch", [_PTR] * 6 + [_INT] * 4,
         out.device, cand.data_ptr(), entries_soa.data_ptr(),
         rects_soa.data_ptr(), qstart.data_ptr(), qend.data_ptr(),
         out.data_ptr(), K, P, B,
         scan_cluster_size(B // TB, K, sm_count(out.device)))
    descent_scan.launches += 1
    return out


descent_scan.launches = 0
