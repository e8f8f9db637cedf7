"""Collectives over a process mesh's axes, with the autograd rules of the
expert- and data-parallel arms.

A process mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims (``launch.mesh.make_process_mesh``: ``("data", "model")``).
Every rank runs the same program on its own rows (``data``) and its own
experts (``model``).  The reference runs these arms inside
``shard_map``, whose ``psum`` transposes to itself and whose replicated
outputs divide their cotangent among the shards; here each crossing of
an axis is one of four functions, each the identity on an axis the mesh
does not have:

* ``reduce_from``: forward a sum over the axis, backward the identity.
  It completes partial sums of a layer whose inputs are the same on
  every rank of the axis, so each rank's cotangent is already the whole
  one.  ``torch.distributed.nn.functional.all_reduce`` sums in its
  backward too, which hands every tensor upstream size x its gradient.
* ``copy_to``: forward the identity, backward a sum over the axis, where
  a tensor that is the same on every rank enters a layer split over it.
* ``first_of``: forward the value at coordinate 0 of the axis, backward
  the cotangent over the axis size.  That is the reference's
  ``shard_map`` output of spec ``P()`` with its check off (its MoE aux
  loss): the value is shard 0's, while the gradient is that of the
  shards' mean (ROADMAP R13).
* ``all_reduce``: a sum with no autograd rule (token counts, gradients).

A parameter's gradient under a process mesh is the sum over the data
ranks of each rank's gradient: each rank's backward gives its rows'
share of the global loss.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from .sharding import mesh_sizes


def process_mesh(mesh):
    """``mesh`` if it is a process mesh; ``None`` for no mesh or a mesh
    of one device.  Any other mesh over more than one device raises
    ``ValueError``: one process holds no global sharded tensor, so no
    placement on it could be right."""
    if mesh is None:
        return None
    if dist.is_available():
        from torch.distributed.device_mesh import DeviceMesh

        if isinstance(mesh, DeviceMesh):
            return mesh
    big = {a: n for a, n in mesh_sizes(mesh).items() if n > 1}
    n_dev = len(getattr(mesh, "devices", ()))
    if big or n_dev > 1:
        raise ValueError(
            f"a mesh of {max(n_dev, 1)} device(s) with axes {big} in one "
            f"process: sharded work needs a process mesh "
            f"(launch.mesh.init_ranks, then make_process_mesh)")
    return None


def axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.clone(), ctx.group), None


class _FirstOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.broadcast(out, src=dist.get_process_group_ranks(group)[0],
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _apply(fn, x, mesh, axis):
    if axis not in mesh.mesh_dim_names:
        return x
    return fn.apply(x, mesh.get_group(axis))


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _apply(_ReduceFrom, x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _apply(_CopyTo, x, mesh, axis)


def first_of(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _apply(_FirstOf, x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis``, in place (no autograd)."""
    if axis in mesh.mesh_dim_names:
        _sum_(x, mesh.get_group(axis))
    return x


def rows_of(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's block of ``x``'s rows: the leading dim split evenly
    over ``axis``."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the "
                         f"{n} ranks of {axis!r}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


# --------------------------------------------------------------------------
# DTensor leaves
# --------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """A DTensor's local shard; any other value as it is."""
    return x.to_local() if is_dtensor(x) else x


def like(ref, x: torch.Tensor):
    """``x``, this rank's shard, as a DTensor placed as ``ref`` is; ``x``
    itself when ``ref`` is no DTensor."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def sharded_dims(x) -> Tuple[int, ...]:
    """The mesh dims a DTensor is split over (none for a plain tensor)."""
    if not is_dtensor(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard())


def full(x) -> Any:
    """A DTensor's logical tensor, on its device (a collective: every
    rank of its mesh calls it); any other value as it is.  The blocks
    are gathered by plain ``all_gather``s, the last mesh dim first,
    undoing DTensor's order (mesh dim 0 major).  DTensor's own
    ``full_tensor`` kills a gloo rank on a CUDA mesh (SIGSEGV, torch
    2.11: ``python -m repro_torch.launch.dtensor_probe``), where
    these plain gathers run."""
    if not is_dtensor(x):
        return x
    t = x.to_local()
    mesh = x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard():
            parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
            t = torch.cat(parts, dim=p.dim)
    return t
