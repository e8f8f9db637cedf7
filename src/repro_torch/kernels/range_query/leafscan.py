"""The leaf-scan engine: does any entry of a query's arena slice intersect
its rect?

The port of ``repro.kernels.range_query`` ``kernel.py`` / ``ops.py`` /
``ref.py``:

* :func:`range_query` — on a CUDA tensor it launches
  ``csrc/range_query.cu`` (K9, the port of ``range_query_pallas``); on a
  CPU tensor it runs :func:`range_query_torch`, the port of
  ``range_query_ref``.  ``out[b] = OR over p in [qstart[b], qend[b]) of
  box(p) ∩ rect(b)``, (B,) int32 0/1.
* :func:`range_query_forest` — the engine over a built
  :class:`~repro_torch.core.rtree.RTreeForest`: each query's tree id
  selects its slice of the forest's SoA entry planes.  The planes are
  :func:`~.layout.forest_planes`: one copy per forest and device,
  shared with ``QueryEngine``, uploaded once or adopted from a
  ``backend="device"`` build.  It answers like ``core.rtree.query_host``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, same_device
from .._build import call, check_tensor
from .layout import TB, forest_planes

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def range_query_torch(entries_soa, rects_soa, qstart, qend, *,
                      dim: int = 2) -> torch.Tensor:
    """(B,) int32 0/1, computed densely over every (query, entry) pair
    (``range_query_ref``): entries ``(2*dim, P)``, rects ``(2*dim, B)``
    float32, slices ``qstart``/``qend`` ``(B,)`` int32."""
    P = entries_soa.shape[1]
    gidx = torch.arange(P, dtype=torch.int32,
                        device=entries_soa.device)[None, :]
    ok = (gidx >= qstart[:, None]) & (gidx < qend[:, None])
    for a in range(dim):
        ok &= entries_soa[a][None, :] <= rects_soa[dim + a][:, None]
        ok &= entries_soa[dim + a][None, :] >= rects_soa[a][:, None]
    return ok.any(dim=1).to(torch.int32)


def vector_planes(entries_soa: torch.Tensor) -> bool:
    """Whether K9 reads the planes of ``entries_soa`` (``(2*dim, P)``,
    contiguous) as 16-byte vectors: every plane must start on a 16-byte
    boundary, so ``P % 4 == 0`` and an aligned base.  The engines' planes
    are padded to a multiple of 128 entries and take it; other planes
    take the kernel's scalar instantiation."""
    return entries_soa.shape[1] % 4 == 0 and entries_soa.data_ptr() % 16 == 0


def range_query(
    entries_soa: torch.Tensor,   # (2*dim, P) float32
    rects_soa: torch.Tensor,     # (2*dim, B) float32
    qstart: torch.Tensor,        # (B,) int32 arena slice per query
    qend: torch.Tensor,          # (B,) int32
    *,
    dim: int = 2,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B,) int32 0/1 — any entry in ``[qstart, qend)`` intersecting the
    query's rect.  ``device`` (``None``: the GPU) must be where the
    tensors lie: on a CUDA device the K9 kernel runs (``dim`` 2 or 3,
    any ``B`` >= 1; a slice is clipped to ``[0, P)``, as the plain
    version's index test clips it; :func:`vector_planes` picks its
    instantiation), and a build or launch failure
    raises; on the CPU the plain version runs."""
    dev = resolve_device(device)
    if not same_device(entries_soa.device, dev):
        raise ValueError(f"entries_soa lies on {entries_soa.device}, "
                         f"expected {dev}")
    if dev.type == "cpu":
        return range_query_torch(entries_soa, rects_soa, qstart, qend,
                                 dim=dim)

    if dim not in (2, 3):
        raise ValueError(f"the CUDA kernel serves dim 2 or 3, got dim={dim}")
    P = entries_soa.shape[1]
    B = rects_soa.shape[1]
    if P >= 2 ** 30 or B == 0 or B >= 2 ** 30:
        raise ValueError(f"P={P} must be below 2^30 (the kernel's int "
                         f"slice walk), B={B} in [1, 2^30)")
    check_tensor("entries_soa", entries_soa, torch.float32, (2 * dim, P), dev)
    check_tensor("rects_soa", rects_soa, torch.float32, (2 * dim, B), dev)
    check_tensor("qstart", qstart, torch.int32, (B,), dev)
    check_tensor("qend", qend, torch.int32, (B,), dev)
    out = torch.empty(B, dtype=torch.int32, device=entries_soa.device)
    call("range_query", "range_query_launch", [_PTR] * 5 + [_INT] * 4,
         out.device, entries_soa.data_ptr(), rects_soa.data_ptr(),
         qstart.data_ptr(), qend.data_ptr(), out.data_ptr(), P, B, dim,
         int(vector_planes(entries_soa)))
    range_query.launches += 1
    return out


range_query.launches = 0


def rects_to_soa(rects: np.ndarray, dim: int) -> np.ndarray:
    """(B, 2*dim) -> (2*dim, B_padded); padding rects are empty boxes."""
    B = len(rects)
    Bp = max(TB, ((B + TB - 1) // TB) * TB)
    soa = np.empty((2 * dim, Bp), dtype=np.float32)
    soa[:dim, :] = 1.0
    soa[dim:, :] = 0.0
    if B:
        soa[:, :B] = np.asarray(rects, dtype=np.float32).T
    return soa


def range_query_forest(
    forest,
    tree_ids: np.ndarray,
    rects: np.ndarray,
    *,
    device: DeviceLike = None,
) -> np.ndarray:
    """Batched leaf-scan probe of a forest on ``device`` (``None``: the
    GPU; ``"cpu"`` runs the plain version): (B,) bool, equal to
    ``core.rtree.query_host``.  Tree ids < 0 answer False.  One K9
    launch per call on the card."""
    dev = resolve_device(device)
    dim = forest.dim
    B = len(tree_ids)
    esoa, off = forest_planes(forest, dev)
    if forest.n_trees == 0:                 # no tree id is valid
        return np.zeros(B, dtype=bool)
    rsoa = torch.as_tensor(rects_to_soa(rects, dim), device=dev)
    Bp = rsoa.shape[1]
    tid = torch.full((Bp,), -1, dtype=torch.int64)
    tid[:B] = torch.as_tensor(np.asarray(tree_ids, dtype=np.int64))
    tid = tid.to(dev)
    t = tid.clamp(min=0)
    ok = tid >= 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    qs = torch.where(ok, off[t], zero)
    qe = torch.where(ok, off[t + 1], zero)
    out = range_query(esoa, rsoa, qs, qe, dim=dim, device=dev)
    return out[:B].bool().cpu().numpy()
