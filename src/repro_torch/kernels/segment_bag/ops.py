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
  ``csrc/segment_bag.cu`` (K10, the port of ``segment_bag_pallas``); on
  a CPU tensor it runs :func:`segment_bag_torch`.
* :func:`segment_bag_torch` — the plain version, a port of
  ``segment_bag_ref``: gather, scale, sum into ``n_segments + 1`` rows.
* :func:`embedding_bag` — ``torch.nn.EmbeddingBag``'s ``sum`` / ``mean``
  over bags, built on the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_tensor

TL = 8   # lookups per tile: packed arrays are padded to a multiple of it

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


def segment_bag_torch(table: torch.Tensor, indices: torch.Tensor,
                      segments: torch.Tensor, weights: torch.Tensor, *,
                      n_segments: int) -> torch.Tensor:
    """(n_segments, D) float32 (same contract as :func:`segment_bag`).
    The product promotes a bf16 row to float32, as ``segment_bag_ref``'s
    does; on the CPU ``index_add_`` adds the rows in ascending ``k``."""
    rows = table[indices] * weights[:, None]
    out = torch.zeros((n_segments + 1, table.shape[1]), dtype=rows.dtype,
                      device=table.device)
    out.index_add_(0, segments, rows)
    return out[:n_segments]


def segment_bag(
    table: torch.Tensor,      # (V, D) float32 or bfloat16
    indices: torch.Tensor,    # (L,) int32 in [0, V)
    segments: torch.Tensor,   # (L,) int32 sorted; padding -> n_segments
    weights: torch.Tensor,    # (L,) float32 (padding: 0)
    *,
    n_segments: int,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(n_segments, D) float32 segment-weighted sums of table rows.
    ``device`` (``None``: the GPU) must be where the tensors lie: on a
    CUDA device the K10 kernel runs, and a build or launch failure
    raises; on the CPU the plain version runs.  The kernel trusts
    ``indices`` to lie in ``[0, V)`` and ``segments`` to be sorted, as
    :func:`pack_bags` makes them."""
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
    if n_segments < 0 or n_segments >= 2 ** 31 - 1 or L >= 2 ** 31:
        raise ValueError(f"n_segments={n_segments}, L={L} out of the "
                         f"kernel's int32 range")
    out = torch.empty((n_segments, D), dtype=torch.float32,
                      device=table.device)
    if n_segments == 0 or D == 0:
        return out
    call("segment_bag", _LAUNCH[table.dtype], [_PTR] * 5 + [_INT] * 3,
         out.device, table.data_ptr(), indices.data_ptr(),
         segments.data_ptr(), weights.data_ptr(), out.data_ptr(), L, D,
         n_segments)
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
    or ``mean`` (an empty bag is 0).  The bags are packed on the host
    (:func:`pack_bags`) and summed by :func:`segment_bag` on ``device``
    (``None``: the GPU; the table must lie there)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    indices = np.asarray(indices)
    offsets = np.asarray(offsets)
    V = table.shape[0]
    L = len(indices)
    if (offsets.ndim != 1 or len(offsets) < 1 or offsets[0] != 0
            or offsets[-1] != L or (np.diff(offsets) < 0).any()):
        raise ValueError("offsets must rise from 0 to len(indices)")
    if L and (indices.min() < 0 or indices.max() >= V):
        raise ValueError(f"indices must lie in [0, {V})")
    B = len(offsets) - 1
    dev = resolve_device(device)
    idx, seg, w = (torch.as_tensor(a, device=dev)
                   for a in pack_bags(indices, offsets))
    out = segment_bag(table, idx, seg, w, n_segments=B, device=dev)
    if mode == "mean":
        cnt = np.maximum(np.diff(offsets), 1).astype(np.float32)
        out = out / torch.as_tensor(cnt, device=dev)[:, None]
    return out
