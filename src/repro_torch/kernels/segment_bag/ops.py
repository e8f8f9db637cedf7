"""Fused EmbeddingBag (the port of ``repro.kernels.segment_bag``):

    out[s, :] = sum over k with seg[k] == s of w[k] * table[idx[k], :]

over a ``(V, D)`` float32 or bfloat16 table, with ``seg`` sorted and
padding lookups carrying ``seg == n_segments`` (a scratch row that is
dropped).  The result is float32 for either table type, as the
reference's production path ``segment_bag_ref`` returns it (the Pallas
kernel would return the table's type; ROADMAP R7).

* :func:`pack_bags` — the host packer: bags given as ``indices`` and
  ``offsets`` -> tile-aligned ``(idx, seg, w)``, the reference's arrays.
* :func:`segment_bag` — on a CUDA tensor it launches
  ``csrc/segment_bag.cu`` (K10, the port of ``segment_bag_pallas``: a
  warp walks :func:`warp_segments` consecutive segments, found by one
  32-ary search, staging each batch of 32 rows in shared memory by
  copies of :func:`copy_bytes` bytes); on a CPU tensor it runs
  :func:`segment_bag_torch`.
* :func:`segment_bag_torch` — the plain version, a port of
  ``segment_bag_ref``: gather, scale, sum into ``n_segments + 1`` rows.
* :func:`embedding_bag` — ``torch.nn.EmbeddingBag``'s ``sum`` / ``mean``
  over bags, built on the two.
* :func:`sum_error_bound` — how far two float32 sums of one bag's
  products, added in different orders, may lie apart: what K10 (ascending
  adds) is held to against the plain version on the card (atomic adds).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_tensor, sm_count

TL = 8   # lookups per tile: packed arrays are padded to a multiple of it
# K10's warps on one multiprocessor (nine 4-warp blocks fit at its 56
# registers a thread: 36, counted as 32), and the waves of warps its
# grid is cut into (see warp_segments)
WARPS_PER_SM = 32
WAVES = 32

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LAUNCH = {torch.float32: "segment_bag_f32_launch",
           torch.bfloat16: "segment_bag_bf16_launch"}


def pack_bags(indices: np.ndarray, offsets: np.ndarray, tl: int = TL):
    """-> ``(idx, seg, w)`` int32 / int32 / float32 arrays of length
    ``max(tl, round_up(L, tl))``: bag ``b`` is ``indices[offsets[b]:
    offsets[b + 1]]`` with weight 1; padding has index 0, segment ``B``
    and weight 0."""
    indices = np.asarray(indices, dtype=np.int32)
    offsets = np.asarray(offsets, dtype=np.int64)
    B = len(offsets) - 1
    L = len(indices)
    seg = np.repeat(
        np.arange(B, dtype=np.int32), np.diff(offsets).astype(np.int64)
    )
    Lp = max(tl, ((L + tl - 1) // tl) * tl)
    idx_p = np.zeros(Lp, dtype=np.int32)
    seg_p = np.full(Lp, B, dtype=np.int32)
    w_p = np.zeros(Lp, dtype=np.float32)
    idx_p[:L] = indices
    seg_p[:L] = seg
    w_p[:L] = 1.0
    return idx_p, seg_p, w_p


def copy_bytes(table: torch.Tensor) -> int:
    """Bytes of each copy K10 makes of a table row: the widest of 16, 8
    and 4 (2 for bfloat16) that divides both a row's bytes and the
    table's base address, so every copy is aligned.  Each width is its
    own instantiation of the kernel; 2 bytes (a bf16 table of odd D)
    takes plain loads, since ``cp.async`` copies no less than 4.  D = 18
    takes 8 in float32 (9 copies a row) and 4 in bf16."""
    row = table.shape[1] * table.element_size()
    for nbytes in (16, 8, 4, 2):
        if (nbytes >= table.element_size() and row % nbytes == 0
                and table.data_ptr() % nbytes == 0):
            return nbytes
    raise ValueError(f"a {table.dtype} table at address "
                     f"{table.data_ptr():#x} is not element-aligned")


def warp_segments(n_segments: int, n_sms: int) -> int:
    """Consecutive segments a warp of K10 walks after its one search:
    ``n_segments`` spread over WAVES times the WARPS_PER_SM warps each of
    ``n_sms`` multiprocessors holds at once, and at least 1.  A small
    batch gets a warp a segment, so its bags walk side by side; a large
    one two or more, so each search (5 dependent rounds at L = 16.4M)
    serves more lookups, in many short waves.  On 132 multiprocessors:
    1 up to 135,168 segments (serve_p99's 512 bags: 512 warps), 2 at
    serve_bulk's 262,144, where ``chip_smoke.py --ab`` on an H100 timed
    2 fastest of 1 to 64, by a few percent."""
    return max(1, -(-n_segments // (n_sms * WARPS_PER_SM * WAVES)))


def segment_bag_torch(table: torch.Tensor, indices: torch.Tensor,
                      segments: torch.Tensor, weights: torch.Tensor, *,
                      n_segments: int) -> torch.Tensor:
    """(n_segments, D) float32 (same contract as :func:`segment_bag`).
    An index in ``[-V, 0)`` wraps; one outside ``[-V, V)`` gathers its
    clamped row, filled with NaN before the weight, so its bag comes out
    NaN, as ``jnp.take`` fills it in ``segment_bag_ref``.  The product
    promotes a bf16 row to float32, as ``segment_bag_ref``'s does; on
    the CPU ``index_add_`` adds the rows in ascending ``k``."""
    V = table.shape[0]
    bad = (indices < -V) | (indices >= V)
    rows = table[indices.clamp(-V, V - 1)].masked_fill(
        bad[:, None], float("nan")) * weights[:, None]
    out = torch.zeros((n_segments + 1, table.shape[1]), dtype=rows.dtype,
                      device=table.device)
    out.index_add_(0, segments, rows)
    return out[:n_segments]


def sum_error_bound(table: torch.Tensor, indices: torch.Tensor,
                    segments: torch.Tensor, weights: torch.Tensor, *,
                    n_segments: int) -> torch.Tensor:
    """(n_segments, D) float32: the most two float32 sums of a bag's
    products may differ when they add them in different orders,

        2 * n_b * 2^-24 * sum_k |w_k| * |table[idx_k]|  +  ulp(that sum)

    per bag ``b`` and column, ``n_b`` the bag's lookups.  Each order's
    sum lies within ``(n_b - 1) * 2^-24`` of the magnitude sum from the
    exact one, so two lie within twice that; the ulp of the magnitude
    sum is the floor for a bag of one or no lookup.  The magnitude sum
    is the plain version over ``table.abs()`` and ``weights.abs()``, on
    the tensors' device.  A bag holding an id outside the table is NaN
    here, as it is in the sums."""
    mag = segment_bag_torch(table.abs(), indices, segments, weights.abs(),
                            n_segments=n_segments)
    n = torch.bincount(segments.long(), minlength=n_segments + 1)
    n = n[:n_segments].to(torch.float32)[:, None]
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return 2 * n * 2.0 ** -24 * mag + ulp


def segment_bag(
    table: torch.Tensor,      # (V, D) float32 or bfloat16
    indices: torch.Tensor,    # (L,) int32; [-V, 0) wraps, else NaN
    segments: torch.Tensor,   # (L,) int32 sorted; padding -> n_segments
    weights: torch.Tensor,    # (L,) float32 (padding: 0)
    *,
    n_segments: int,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(n_segments, D) float32 segment-weighted sums of table rows.
    ``device`` (``None``: the GPU) must be where the tensors lie: on a
    CUDA device the K10 kernel runs, one launch, and a build or launch
    failure raises; on the CPU the plain version runs.  An index in
    ``[-V, 0)`` wraps, and one outside ``[-V, V)`` adds NaN to its bag
    (the kernel stages row 0 for it with a NaN weight, so it reads no
    byte outside the table; lookups into a table of no rows raise
    ``IndexError``, as the plain version's gather does); the kernel
    trusts ``segments`` to be sorted, as
    :func:`pack_bags` makes them.  Its launch shape is
    :func:`warp_segments`, its row copies :func:`copy_bytes` wide."""
    dev = resolve_device(device)
    if not same_device(table.device, dev):
        raise ValueError(f"table lies on {table.device}, expected {dev}")
    if dev.type == "cpu":
        return segment_bag_torch(table, indices, segments, weights,
                                 n_segments=n_segments)
    if table.dim() != 2 or table.dtype not in _LAUNCH:
        raise ValueError(f"table must be (V, D) float32 or bfloat16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    V, D = table.shape
    L = indices.shape[0]
    check_tensor("table", table, table.dtype, (V, D), dev)
    check_tensor("indices", indices, torch.int32, (L,), dev)
    check_tensor("segments", segments, torch.int32, (L,), dev)
    check_tensor("weights", weights, torch.float32, (L,), dev)
    if (n_segments < 0 or n_segments >= 2 ** 31 - 1 or L >= 2 ** 31 - 64
            or V >= 2 ** 31):
        raise ValueError(f"n_segments={n_segments}, L={L}, V={V} out of "
                         f"the kernel's int32 range")
    if V == 0 and L:     # K10 stages row 0 for an id outside the table
        raise IndexError("segment_bag: lookups into a table of no rows")
    out = torch.empty((n_segments, D), dtype=torch.float32,
                      device=table.device)
    if n_segments == 0 or D == 0:
        return out
    call("segment_bag", _LAUNCH[table.dtype], [_PTR] * 5 + [_INT] * 6,
         out.device, table.data_ptr(), indices.data_ptr(),
         segments.data_ptr(), weights.data_ptr(), out.data_ptr(), V, L, D,
         n_segments, copy_bytes(table),
         warp_segments(n_segments, sm_count(out.device)))
    segment_bag.launches += 1
    return out


segment_bag.launches = 0


def embedding_bag(
    table: torch.Tensor,
    indices: np.ndarray,
    offsets: np.ndarray,
    mode: str = "sum",
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """EmbeddingBag over a ``(V, D)`` table -> ``(B, D)`` float32: bag
    ``b`` pools ``table[indices[offsets[b]:offsets[b + 1]]]`` by ``sum``
    or ``mean`` (an empty bag is 0).  An index in ``[-V, 0)`` wraps, and
    a bag holding one outside ``[-V, V)`` comes out NaN, as the
    reference's ``jnp.take`` and ``segment_sum`` make it; an index that
    does not fit int32 becomes ``INT32_MIN`` (outside any table) before
    the cast.  The bags are packed on the host (:func:`pack_bags`) and
    summed by :func:`segment_bag` on ``device`` (``None``: the GPU; the
    table must lie there)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    indices = np.asarray(indices, dtype=np.int64)
    offsets = np.asarray(offsets)
    L = len(indices)
    if (offsets.ndim != 1 or len(offsets) < 1 or offsets[0] != 0
            or offsets[-1] != L or (np.diff(offsets) < 0).any()):
        raise ValueError("offsets must rise from 0 to len(indices)")
    i32 = np.iinfo(np.int32)
    indices = np.where((indices < i32.min) | (indices > i32.max), i32.min,
                       indices)
    B = len(offsets) - 1
    dev = resolve_device(device)
    idx, seg, w = (torch.as_tensor(a, device=dev)
                   for a in pack_bags(indices, offsets))
    out = segment_bag(table, idx, seg, w, n_segments=B, device=dev)
    if mode == "mean":
        cnt = np.maximum(np.diff(offsets), 1).astype(np.float32)
        out = out / torch.as_tensor(cnt, device=dev)[:, None]
    return out
