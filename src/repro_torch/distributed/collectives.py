"""Collectives over a process mesh's axes, with the autograd rules of the
expert-, tensor- and data-parallel arms, and a tally of the bytes they
move.

A process mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims (``launch.mesh.make_process_mesh``: ``("data", "model")``).
Every rank runs the same program on its own rows (``data``) and its own
experts, heads, hidden columns and vocabulary rows (``model``).  The
reference runs these arms inside ``shard_map`` or leaves GSPMD to place
them; here each crossing of an axis is one function, each the identity
with no mesh (``None``) and on an axis the mesh does not have or that
holds one rank.  ``axes`` is one axis name or a tuple of them
(``("pod", "data")``, crossed as one group):

* ``reduce_from``: forward a sum over the axes, backward the identity.
  It completes partial sums of a layer whose inputs are the same on
  every rank of the axis, so each rank's cotangent is already the whole
  one.  ``torch.distributed.nn.functional.all_reduce`` sums in its
  backward too, which hands every tensor upstream size x its gradient.
* ``copy_to``: forward the identity, backward a sum over the axes, where
  a tensor that is the same on every rank enters a layer split over it.
* ``all_gather``: forward the ranks' blocks joined along a tensor dim,
  backward this rank's block of the cotangent (a replicated consumer
  hands every rank the whole cotangent).
* ``gather_sum``: forward the same join, backward the cotangent summed
  over the ranks and cut to this rank's block (a reduce-scatter), where
  each rank's consumer differs: a graph's node rows gathered over
  ``data`` for each rank's own edges.
* ``reduce_scatter``: forward this rank's block of a sum over the ranks,
  backward the ranks' cotangent blocks joined (an all-gather): the
  edge-to-node sums of each rank's edges returned to the node blocks.
* ``first_of``: forward the value at coordinate 0 of the axes, backward
  the cotangent over their size.  That is the reference's ``shard_map``
  output of spec ``P()`` with its check off (its MoE aux loss): the
  value is shard 0's, while the gradient is that of the shards' mean
  (ROADMAP R13).
* ``all_reduce``, ``max_over``: a sum and a maximum with no autograd
  rule (token counts, the loss's logsumexp shift, gradients).

A parameter's gradient under a process mesh is the sum over the data
ranks of each rank's gradient: each rank's backward gives its rows'
share of the global loss.

**The tally.**  Inside ``with Tally() as t`` every crossing adds the
bytes of its result on this rank to ``t.bytes`` under its kind, the
reference's names and convention (``launch/dryrun.py``'s
``collective_bytes``: result-shape bytes per device): ``all-reduce``
(sums and maxima), ``all-gather``, ``reduce-scatter``,
``collective-permute`` (``first_of``'s broadcast from coordinate 0) and
``total``.  Backward crossings are tallied when autograd runs them.  Off
by default: outside a ``Tally`` a crossing counts nothing.

**The counting mesh.**  :class:`CountingMesh` stands in for rank 0 of a
mesh of any sizes with no process group: every crossing on it tallies
and returns a tensor of the shape the live one would (the block, the
joined blocks, ``x`` itself for a sum).  On ``meta`` tensors nothing
else is observable, so the dry run counts a 256-rank step in one process
through the code the live ranks run.  ``elastic.reshard`` onto it cuts
each leaf to rank 0's block and records its spec (:func:`spec_of`), as
a DTensor carries its placements (:func:`place_block`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from .sharding import mesh_sizes

Axes = Union[str, Sequence[str]]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


# --------------------------------------------------------------------------
# the tally
# --------------------------------------------------------------------------

_TALLIES = []


class Tally:
    """Bytes of every crossing's result on this rank, by kind, while the
    context is open (``bytes``: the kinds seen and ``total``)."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        for k in (kind, "total"):
            self.bytes[k] = self.bytes.get(k, 0) + nbytes

    def __enter__(self) -> "Tally":
        _TALLIES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _TALLIES.remove(self)


def _tally(kind: str, x: torch.Tensor, n: int = 1) -> None:
    if _TALLIES:
        nbytes = x.numel() * x.element_size() * n
        for t in _TALLIES:
            t.add(kind, nbytes)


# --------------------------------------------------------------------------
# meshes and groups
# --------------------------------------------------------------------------

class CountingGroup:
    """The group of ``n`` ranks of a counting mesh's axes; this rank is
    coordinate 0 of it."""

    def __init__(self, n: int):
        self.n = n


class CountingMesh:
    """Rank 0 of a mesh of ``sizes`` (``{axis: size}``, in mesh order),
    no process group behind it: a ``DeviceMesh``'s names, sizes and
    coordinates, with every crossing tallied and none sent."""

    def __init__(self, sizes: Mapping[str, int]):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(int(n) for n in sizes.values())

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str) -> CountingGroup:
        return CountingGroup(self.shape[self.mesh_dim_names.index(axis)])


def process_mesh(mesh):
    """``mesh`` if it is a process mesh or a counting mesh; ``None`` for
    no mesh or a mesh of one device.  Any other mesh over more than one
    device raises ``ValueError``: one process holds no global sharded
    tensor, so no placement on it could be right."""
    if mesh is None:
        return None
    if isinstance(mesh, CountingMesh):
        return mesh
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


def _axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The names of ``axes`` the mesh has, in the order given (none for
    no mesh)."""
    if mesh is None:
        return ()
    names = mesh.mesh_dim_names
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if a in names)


def axis_size(mesh, axes: Axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _axes(mesh, axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate on ``axes`` (major first; 0 on axes the
    mesh lacks)."""
    i = 0
    for a in _axes(mesh, axes):
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return i


def _group(mesh, axes: Axes):
    """The group of ``axes`` (``None`` where the mesh has none of them
    or they hold one rank: nothing crosses).  A process mesh crosses one
    axis at a time."""
    present = _axes(mesh, axes)
    if not present or axis_size(mesh, present) == 1:
        return None
    if isinstance(mesh, CountingMesh):
        return CountingGroup(axis_size(mesh, present))
    if len(present) > 1:
        raise ValueError(f"a crossing of axes {present} at once: a process "
                         f"mesh crosses one axis at a time")
    return mesh.get_group(present[0])


def _size(group) -> int:
    if isinstance(group, CountingGroup):
        return group.n
    return dist.get_world_size(group)


# --------------------------------------------------------------------------
# the crossings' plain forms (tallied)
# --------------------------------------------------------------------------

def _sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place."""
    _tally("all-reduce", x)
    if not isinstance(group, CountingGroup):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _max_(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over ``group``, in place."""
    _tally("all-reduce", x)
    if not isinstance(group, CountingGroup):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in group order."""
    n = _size(group)
    _tally("all-gather", x, n)
    if isinstance(group, CountingGroup):
        return torch.cat([x] * n, dim=dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int, index: int
                 ) -> torch.Tensor:
    """Block ``index`` (this rank's) along ``dim`` of ``x`` summed over
    ``group``.  Gloo sums the whole tensor and keeps the block (its
    reduce-scatter is missing from some releases); the tally counts the
    block, as a reduce-scatter's result."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    b = x.shape[dim] // n
    if isinstance(group, CountingGroup):
        out = x.narrow(dim, index * b, b).clone()
    elif dist.get_backend(group) == "gloo":
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        out = out.narrow(dim, index * b, b).contiguous()
    else:
        out = x.new_empty(x.narrow(dim, 0, b).shape)
        dist.reduce_scatter(out, [c.contiguous() for c in x.split(b, dim)],
                            op=dist.ReduceOp.SUM, group=group)
    _tally("reduce-scatter", out)
    return out


def _bcast(x: torch.Tensor, group) -> torch.Tensor:
    """The value of coordinate 0 of ``group``, on every rank."""
    out = x.clone()
    _tally("collective-permute", out)
    if not isinstance(group, CountingGroup):
        dist.broadcast(out, src=dist.get_process_group_ranks(group)[0],
                       group=group)
    return out


# --------------------------------------------------------------------------
# the crossings with their autograd rules
# --------------------------------------------------------------------------

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
        ctx.n = _size(group)
        return _bcast(x, group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.dim, ctx.index, ctx.b = dim, index, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.b, ctx.b), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.index = group, dim, index
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_sum(g, ctx.group, ctx.dim, ctx.index), None, None,
                None)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim, index)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None, None


def _apply(fn, x, mesh, axes):
    group = _group(mesh, axes)
    if group is None:
        return x
    return fn.apply(x, group)


def reduce_from(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _apply(_ReduceFrom, x, mesh, axes)


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _apply(_CopyTo, x, mesh, axes)


def first_of(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    return _apply(_FirstOf, x, mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``axes`` joined along ``dim`` (backward: this
    rank's block of the cotangent)."""
    group = _group(mesh, axes)
    if group is None:
        return x
    return _AllGather.apply(x, group, dim % x.dim(), axis_index(mesh, axes))


def gather_sum(x: torch.Tensor, mesh, axes: Axes, dim: int
               ) -> torch.Tensor:
    """The ranks' blocks of ``axes`` joined along ``dim`` (backward: the
    cotangent summed over the ranks, then this rank's block)."""
    group = _group(mesh, axes)
    if group is None:
        return x
    return _GatherSum.apply(x, group, dim % x.dim(), axis_index(mesh, axes))


def all_reduce(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` summed over ``axes``, in place (no autograd)."""
    group = _group(mesh, axes)
    if group is not None:
        _sum_(x, group)
    return x


def max_over(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x``'s maximum over ``axes``, a new tensor with no gradient."""
    x = x.detach().clone()
    group = _group(mesh, axes)
    if group is not None:
        _max_(x, group)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over ``axes``
    (backward: the ranks' cotangent blocks joined; ``x`` itself where the
    mesh has none of them)."""
    group = _group(mesh, axes)
    if group is None:
        return x
    return _ScatterSum.apply(x, group, dim % x.dim(), axis_index(mesh, axes))


def rows_of(x: torch.Tensor, mesh, axes: Axes = "data") -> torch.Tensor:
    """This rank's block of ``x``'s rows: the leading dim split evenly
    over ``axes``."""
    n, i = axis_size(mesh, axes), axis_index(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the "
                         f"{n} ranks of {axes!r}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def block(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the logical tensor ``x`` under ``spec`` (a
    view); a dim its axes do not divide raises ``ValueError``."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            n, i = axis_size(mesh, entry), axis_index(mesh, entry)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over the {n} ranks of {entry!r}")
            b = x.shape[dim] // n
            x = x.narrow(dim, i * b, b)
    return x


# --------------------------------------------------------------------------
# placed leaves: DTensors, and a counting mesh's blocks
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
    """``x``, this rank's shard, placed as ``ref`` is: a DTensor where
    ``ref`` is one, a block recorded with ``ref``'s spec where ``ref``
    is a counting mesh's block, else ``x`` itself."""
    if is_dtensor(ref):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, ref.device_mesh, ref.placements,
                                  run_check=False, shape=ref.shape,
                                  stride=ref.stride())
    placed = _placed(ref)
    if placed is not None:
        _PLACED[x] = placed
    return x


_PLACED = WeakIdKeyDictionary()     # a counting mesh's block: (mesh, spec)


def _placed(x):
    return _PLACED.get(x) if isinstance(x, torch.Tensor) else None


def place_block(x: torch.Tensor, mesh: CountingMesh, spec) -> torch.Tensor:
    """Record ``x`` as rank 0's block of a leaf placed on the counting
    mesh ``mesh`` by ``spec`` (``elastic.reshard`` cuts it)."""
    _PLACED[x] = (mesh, tuple(spec))
    return x


def mesh_of(x):
    """The mesh a placed leaf lives on (``None`` for a plain tensor)."""
    if is_dtensor(x):
        return x.device_mesh
    placed = _placed(x)
    return None if placed is None else placed[0]


def spec_of(x) -> Tuple:
    """A placed leaf's spec, the reference's form (one entry per dim: an
    axis name, a tuple of names major first, or ``None``); ``()`` for a
    plain tensor."""
    if is_dtensor(x):
        names = x.device_mesh.mesh_dim_names
        parts = [[] for _ in range(x.dim())]
        for i, p in enumerate(x.placements):
            if p.is_shard():
                parts[p.dim].append(names[i])
        return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                     for a in parts)
    placed = _placed(x)
    return () if placed is None else placed[1]


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec names, in order."""
    out = []
    for entry in spec:
        if entry is not None:
            out += [entry] if isinstance(entry, str) else list(entry)
    return tuple(out)


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
            t = _gather(t, mesh.get_group(i), p.dim)
    return t
