"""Segmented-MBR reduction for the device R-tree bulk load (the port of
``repro.kernels.forest_build``).

Every node's MBR is the min (low axes) / max (high axes) over its at
most ``fan`` children, which the bulk-load sort makes contiguous.  The
device path pads every node to exactly ``fan`` child slots (inert slots
are +inf/-inf boxes) and lays the slots out **slot-major**:

    children[(k * 2*dim) + a, j] = axis ``a`` of child ``k`` of node ``j``

The same reduction builds the R-tree node levels (``fan`` = fanout), the
engine's fine tile pyramid (``fan = TP``) and its coarse plane
(``fan = COARSE_GROUP``).

* :func:`seg_mbr` — on a CUDA tensor it launches ``csrc/seg_mbr.cu``
  (K8); on a CPU tensor it runs :func:`seg_mbr_torch`, a port of
  ``seg_mbr_ref``.
* :func:`slot_major`, :func:`gather_child_slots`, :func:`mbr_reduce`,
  :func:`level_mbr`, :func:`tile_pyramid_device`, :func:`np_inert_plane`
  — ports of the reference's ``ops.py`` building blocks, in torch on
  the build's device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_tensor

_PTR = ctypes.c_void_p
_INT = ctypes.c_int

TN = 128    # the reference's nodes per block; level_mbr pads to >= TN


def _pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _inert(dim: int, device) -> torch.Tensor:
    """(2*dim,) the inert box: +inf mins, -inf maxes."""
    return torch.tensor([float("inf")] * dim + [float("-inf")] * dim,
                        dtype=torch.float32, device=device)


def np_inert_plane(dim: int, width: int) -> np.ndarray:
    """Host helper: (2*dim, width) impossible-box plane (min > max),
    matching ``forest_to_soa``'s padding convention."""
    soa = np.empty((2 * dim, width), dtype=np.float32)
    soa[:dim] = 1.0
    soa[dim:] = 0.0
    return soa


# --------------------------------------------------------------------------
# The reduction: plain version and wrapper
# --------------------------------------------------------------------------

def seg_mbr_torch(children: torch.Tensor, *, dim: int, fan: int
                  ) -> torch.Tensor:
    """Slot-major (fan*2*dim, N) child planes -> (2*dim, N) node MBRs
    (same contract as :func:`seg_mbr`)."""
    rows, n = children.shape
    if rows != fan * 2 * dim:
        raise ValueError(f"children has {rows} rows, expected "
                         f"fan * 2*dim = {fan * 2 * dim}")
    c = children.reshape(fan, 2 * dim, n)
    return torch.cat([c[:, :dim].amin(dim=0), c[:, dim:].amax(dim=0)])


def seg_mbr(
    children: torch.Tensor,   # (fan * 2*dim, N) float32 slot-major
    *,
    dim: int,
    fan: int,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(2*dim, N) node MBRs: min over the ``fan`` slots of each low axis,
    max of each high axis; inert slots must be +inf/-inf.  On a CUDA
    device the K8 kernel runs (any N: it masks its own ragged edge); on
    the CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(children.device, dev):
        raise ValueError(f"children lies on {children.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return seg_mbr_torch(children, dim=dim, fan=fan)
    rows, n = children.shape
    if fan < 1 or dim < 1 or rows != fan * 2 * dim:
        raise ValueError(f"children has {rows} rows, expected "
                         f"fan * 2*dim = {fan} * {2 * dim}")
    check_tensor("children", children, torch.float32, (rows, n), dev)
    out = torch.empty((2 * dim, n), dtype=torch.float32,
                      device=children.device)
    if n == 0:
        return out
    call("seg_mbr", "seg_mbr_launch", [_PTR] * 2 + [_INT] * 3, out.device,
         children.data_ptr(), out.data_ptr(), n, dim, fan)
    seg_mbr.launches += 1
    return out


seg_mbr.launches = 0


# --------------------------------------------------------------------------
# Building blocks of the bulk load
# --------------------------------------------------------------------------

def slot_major(x: torch.Tensor, fan: int) -> torch.Tensor:
    """(2*dim, N*fan) node-major child planes -> (fan*2*dim, N)
    slot-major layout the reduction consumes (a contiguous copy)."""
    two_dim, m = x.shape
    n = m // fan
    return x.reshape(two_dim, n, fan).permute(2, 0, 1).reshape(
        fan * two_dim, n)


def gather_child_slots(
    src_soa: torch.Tensor,   # (2*dim, C) float32 child-level planes
    starts: torch.Tensor,    # (N,) int64 first child of each node
    ends: torch.Tensor,      # (N,) int64 one past the last child
    fan: int,
    dim: int,
) -> torch.Tensor:
    """(2*dim, N*fan) node-major slots; ragged tails filled inert.

    Node ``j`` owns children ``[starts[j], ends[j])`` of the child level
    (contiguous after the bulk-load sort); slots past the end get +inf
    mins / -inf maxes so they never move a min/max."""
    C = src_soa.shape[1]
    idx = starts[:, None] + torch.arange(fan, dtype=starts.dtype,
                                         device=starts.device)[None, :]
    mask = idx < ends[:, None]                           # (N, fan)
    g = src_soa[:, idx.clamp(0, max(C - 1, 0))]          # (2*dim, N, fan)
    g = torch.where(mask[None], g, _inert(dim, g.device)[:, None, None])
    return g.reshape(2 * dim, starts.shape[0] * fan)


def mbr_reduce(children_soa: torch.Tensor, dim: int, fan: int, *,
               device: DeviceLike = None) -> torch.Tensor:
    """(2*dim, N) segmented MBRs of (2*dim, N*fan) node-major child
    planes — one reduction (K8 on the card) per ``fan`` slots."""
    return seg_mbr(slot_major(children_soa, fan), dim=dim, fan=fan,
                   device=device)


def level_mbr(src_soa: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
              fan: int, dim: int, *, device: DeviceLike = None
              ) -> torch.Tensor:
    """(2*dim, Np2) node MBRs for one bulk-load level: gather and reduce.
    ``N`` is padded to a power of two >= ``TN`` with empty segments
    (inert +inf/-inf columns past ``N``), as the reference pads it."""
    n = len(starts)
    np2 = _pow2(max(n, 1), TN)
    sp = np.zeros(np2, dtype=np.int64)
    ep = np.zeros(np2, dtype=np.int64)
    sp[:n] = starts
    ep[:n] = ends
    dev = src_soa.device
    slots = gather_child_slots(src_soa, torch.as_tensor(sp, device=dev),
                               torch.as_tensor(ep, device=dev), fan, dim)
    return mbr_reduce(slots, dim, fan, device=device)


def tile_pyramid_device(
    esoa: torch.Tensor,   # (2*dim, Pp) float32 entry planes, Pp % tp == 0
    dim: int,
    *,
    tp: int,
    tpt: int,
    group: int,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Device mirror of ``layout.build_tile_pyramid`` (same shapes, same
    float32 values): ``(fine (2*dim, NTp), coarse (2*dim, NCp),
    n_tiles)``."""
    two_dim, pp = esoa.shape
    if two_dim != 2 * dim or pp % tp:
        raise ValueError(f"esoa shape {tuple(esoa.shape)} is not "
                         f"(2*{dim}, a multiple of {tp})")
    nt = pp // tp
    fine = mbr_reduce(esoa, dim, tp, device=device)
    inert = _inert(dim, esoa.device)[:, None]
    nc = -(-nt // group)
    fine_in = torch.cat([fine, inert.expand(two_dim, nc * group - nt)], 1)
    coarse = mbr_reduce(fine_in, dim, group, device=device)
    ntp = max(tpt, -(-nt // tpt) * tpt)
    ncp = ntp // group
    fine_soa = torch.cat([fine, inert.expand(two_dim, ntp - nt)], 1)
    coarse_soa = torch.cat([coarse, inert.expand(two_dim, ncp - nc)], 1)
    return fine_soa, coarse_soa, nt
