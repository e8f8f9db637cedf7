"""Packed boolean OR-AND matrix product (the port of
``repro.kernels.bitset_mm``):

    out[i, w] = OR_j ( A[i, j] AND R[j, w] )

with ``A`` packed along ``j`` (``(f, Wm)`` words, bit ``k`` of word
``jw`` is column ``32*jw + k``) and ``R`` packed along its columns
(``(m, W)`` words, ``m <= 32*Wm``).  The level-scheduled closure
(:func:`repro_torch.core.reachability.closure_bitset_mm`) calls it once
per condensation level with the level's frontier.

torch has no usable ``uint32`` (no shifts, no ``index_put_``), so packed
words live in ``int32`` tensors holding the same bits; the kernel reads
them as ``uint32_t``.  :func:`uint32_bits` turns NumPy ``uint32`` masks
into such tensors.

* :func:`bitset_mm` — on a CUDA tensor it launches
  ``csrc/bitset_mm.cu`` (K7), in the instantiation
  :func:`cluster_size` picks (a warp per row of A, or a hub row's set
  columns spread over a block or a thread block cluster); on a CPU
  tensor it runs :func:`bitset_mm_torch`.
* :func:`bitset_mm_torch` — the plain version, a port of
  ``bitset_mm_ref``: unpack, float32 matrix product, threshold, pack.
* :func:`bitset_mm_mxu` — the port of the reference's MXU product
  (``_mxu_step``, a plain product outside any Pallas kernel): unpack to
  bf16, ``torch.matmul``, threshold, pack.  It trades 32x the operands'
  bytes for the tensor cores' rate.
* :func:`closure_fixpoint` — ``R <- OWN | A.R`` iterated until no row
  changes: the unscheduled closure, each step by :func:`bitset_mm` (K7)
  or :func:`bitset_mm_mxu`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_tensor, sm_count

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
ROWS = 8            # rows of A per CTA of K7
MAX_CLUSTER = 8     # CTAs per thread block cluster of K7
HUB = 64            # set columns per row of A from which K7 spreads a row


def uint32_bits(x: np.ndarray, device) -> torch.Tensor:
    """NumPy ``uint32`` words -> an ``int32`` tensor with the same bits."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(x, np.uint32)).view(np.int32),
        device=device)


def unpack_bits(bits: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(r, W) packed words -> (r, n_cols) bool, LSB-first per word."""
    r, W = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    b = (bits[:, :, None] >> shifts[None, None, :]) & 1
    return b.reshape(r, W * 32)[:, :n_cols] > 0


def pack_bits(rows: torch.Tensor) -> torch.Tensor:
    """(r, p) bool -> (r, ceil(p/32)) int32 words, LSB-first per word."""
    r, p = rows.shape
    W = (p + 31) // 32
    pad = torch.zeros((r, W * 32), dtype=torch.int64, device=rows.device)
    pad[:, :p] = rows.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=rows.device)
    v = (pad.reshape(r, W, 32) << shifts).sum(dim=-1)      # [0, 2^32)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def bitset_mm_torch(a_bits: torch.Tensor, r_bits: torch.Tensor
                    ) -> torch.Tensor:
    """(f, W) int32 — the dense boolean semiring product (same contract
    as :func:`bitset_mm`)."""
    m, W = r_bits.shape
    a = unpack_bits(a_bits, m)                    # (f, m) bool
    r = unpack_bits(r_bits, W * 32)               # (m, W*32) bool
    return pack_bits((a.to(torch.float32) @ r.to(torch.float32)) > 0)


def cluster_size(f: int, m: int, n_sms: int) -> int:
    """K7's instantiation for ``f`` rows of A over ``m`` columns: 0
    (ROWWISE, a warp per row) unless the rows average at least ``HUB``
    set columns; then SPREAD, the set columns of each 8 rows shared by
    a thread block cluster of the least of 1, 2, 4, 8 CTAs whose
    clusters cover the ``n_sms`` multiprocessors.  In the closure every
    column is set in some row (the columns are the level's distinct
    destinations), so ``m / f`` is a lower bound on a row's average: a
    hub of the condensation, a single row with hundreds of out-edges,
    is spread over several multiprocessors, and every other level keeps
    a warp per row."""
    if m < HUB * f:
        return 0
    blocks = (f + ROWS - 1) // ROWS
    c = 1
    while c < MAX_CLUSTER and blocks * c < n_sms:
        c *= 2
    return c


def bitset_mm(
    a_bits: torch.Tensor,   # (f, Wm) int32 packed adjacency rows
    r_bits: torch.Tensor,   # (m, W) int32 packed set rows, m <= 32*Wm
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(f, W) int32 packed OR-AND product.  Bits of ``A`` at columns
    ``>= m`` contribute nothing.  On a CUDA device the K7 kernel runs
    (it masks its own ragged edges: no padding of the operands); on the
    CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(a_bits.device, dev):
        raise ValueError(f"a_bits lies on {a_bits.device}, expected {dev}")
    f, Wm = a_bits.shape
    m, W = r_bits.shape
    if m > 32 * Wm:
        raise ValueError(f"r_bits has {m} rows, more than 32 * Wm = "
                         f"{32 * Wm} columns of a_bits")
    if dev.type == "cpu":
        return bitset_mm_torch(a_bits, r_bits)
    check_tensor("a_bits", a_bits, torch.int32, (f, Wm), dev)
    check_tensor("r_bits", r_bits, torch.int32, (m, W), dev)
    if (W + 127) // 128 > 65535:
        raise ValueError(f"W={W} words out of range for the kernel's grid")
    out = torch.empty((f, W), dtype=torch.int32, device=a_bits.device)
    if f == 0 or W == 0:
        return out
    call("bitset_mm", "bitset_mm_launch", [_PTR] * 3 + [_INT] * 5,
         out.device, a_bits.data_ptr(), r_bits.data_ptr(), out.data_ptr(),
         f, Wm, m, W, cluster_size(f, m, sm_count(out.device)))
    bitset_mm.launches += 1
    return out


bitset_mm.launches = 0


def bitset_mm_mxu(a_bits: torch.Tensor, r_bits: torch.Tensor, *,
                  device: DeviceLike = None) -> torch.Tensor:
    """(f, W) int32 packed OR-AND product (the contract of
    :func:`bitset_mm`) as a dense matrix product: the bits unpacked to
    bf16 0/1, one ``torch.matmul`` (float32 accumulation on the card),
    ``> 0``, packed.  Every term is 0 or 1, so a positive count stays
    positive in any precision, and any count works.  ``device``
    (``None``: the GPU) must be where the tensors lie."""
    dev = resolve_device(device)
    if not same_device(a_bits.device, dev):
        raise ValueError(f"a_bits lies on {a_bits.device}, expected {dev}")
    m, W = r_bits.shape
    if m > 32 * a_bits.shape[1]:
        raise ValueError(f"r_bits has {m} rows, more than 32 * Wm = "
                         f"{32 * a_bits.shape[1]} columns of a_bits")
    a = unpack_bits(a_bits, m).to(torch.bfloat16)         # (f, m)
    r = unpack_bits(r_bits, W * 32).to(torch.bfloat16)    # (m, 32 W)
    return pack_bits(torch.matmul(a, r) > 0)


def closure_fixpoint(
    own_bits: np.ndarray,   # (d, W) uint32: own spatial columns per comp
    a_bits: np.ndarray,     # (d, ceil(d/32)) uint32: DAG adjacency, packed
    n_iters: int,
    *,
    use_mxu: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """``R <- OWN | A.R`` iterated on ``device`` (``None``: the GPU) at
    most ``n_iters`` times, stopping early once no row changes; returns
    the reachable-set bitset matrix as (d, W) ``uint32``.  ``n_iters``
    must be at least the condensation's level count (its longest path).
    Each step is :func:`bitset_mm` (K7 on the card, its plain version on
    the CPU) or, with ``use_mxu``, :func:`bitset_mm_mxu`."""
    dev = resolve_device(device)
    own = uint32_bits(own_bits, dev)
    a = uint32_bits(a_bits, dev)
    r = own
    for _ in range(int(n_iters)):
        step = (bitset_mm_mxu(a, r, device=dev) if use_mxu
                else bitset_mm(a, r, device=dev))
        nxt = own | step
        if torch.equal(nxt, r):
            break
        r = nxt
    return r.cpu().numpy().view(np.uint32)
