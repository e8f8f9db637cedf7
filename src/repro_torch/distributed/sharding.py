"""Sharding rules: parameters, optimizer state (ZeRO-1), batches, and
the cluster index's arrays (the port of ``repro.distributed.sharding``).

Axis roles (the reference's ``launch/mesh.py``):
    pod    — inter-pod data parallelism
    data   — intra-pod data parallelism (+ ZeRO-1 optimizer sharding)
    model  — tensor/expert parallelism

Rules are name+shape pattern matchers over ``(path, shape, axes, tp)``.
A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names, or ``None`` (replicated on that dim); ``()`` is replicated.
Any dim not divisible by the axis size falls back to replication (e.g.
gemma2's 8 heads on a 17-way model axis), and specs are padded with
leading ``None`` for stacked (segment) layer parameters, as the
reference's ``PartitionSpec``s are.

A mesh here is a ``{axis: size}`` mapping, an object whose ``shape``
is one (``launch.mesh.ShardMesh``), or a process mesh (a named
``DeviceMesh``); an axis it does not name has size 1.  The reference's
``named`` (a spec tree to ``NamedSharding``s) has no counterpart:
``elastic.reshard`` places a tree by its specs directly, each spec
turned into DTensor placements by ``placements``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping, Tuple

from .tree import at, map_leaves

Spec = Tuple


def mesh_sizes(mesh) -> Mapping[str, int]:
    """``{axis: size}`` of a mapping, a named ``DeviceMesh`` or an object
    with a ``shape`` mapping."""
    if isinstance(mesh, Mapping):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def placements(spec: Spec, mesh, shape: Tuple[int, ...]) -> Tuple:
    """DTensor placements on the process mesh ``mesh`` (one per mesh
    dim) of a tensor of ``shape`` under the reference's ``spec``: an
    axis name gives ``Shard(dim)`` on that mesh dim, a tuple of names
    ``Shard(dim)`` on each (major first, as JAX orders them, so the
    names must come in the mesh's order), ``None`` and every mesh dim no
    entry names ``Replicate()``.  A dim that the named axes do not
    divide raises ``ValueError``, as JAX refuses it (DTensor would split
    it unevenly without a word)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than "
                         f"{len(shape)} dims")
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no axis {a!r} in the "
                                 f"mesh's {names}")
            i = names.index(a)
            if i in idx or not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} must come in the "
                             f"mesh's order {names}")
        n = 1
        for i in idx:
            n *= mesh.size(i)
            out[i] = Shard(dim)
        if shape[dim] % n:
            raise ValueError(f"spec {spec}: {n} shards do not evenly "
                             f"divide dim {dim} of shape {tuple(shape)}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: Tuple[str, ...] = ("data",)     # ("pod", "data") multi-pod
    model: str = "model"

    def data_size(self, mesh) -> int:
        s = 1
        for a in self.data:
            s *= mesh_sizes(mesh).get(a, 1)
        return s

    def model_size(self, mesh) -> int:
        return mesh_sizes(mesh).get(self.model, 1)


def _pad(spec: Tuple, ndim: int) -> Spec:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return (None,) * (ndim - len(spec)) + spec


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# --------------------------------------------------------------------------
# LM parameter rules
# --------------------------------------------------------------------------

def lm_param_spec(path: str, shape: Tuple[int, ...], axes: MeshAxes,
                  tp: int) -> Spec:
    """The LM family's layout, the reference's rule: the layout
    ``elastic.reshard`` places, and the process mesh trains and serves
    in (``models.lm.model``'s Megatron pairing, ``moe.py``'s experts),
    with ``opt_state_specs`` placing the moments (ZeRO-1)."""
    nd = len(shape)
    m = axes.model

    def last2(a, b):
        return _pad((a, b), nd)

    if path.endswith("embed/emb") or "lm_head/w" in path:
        # vocab over model (vocab dim is first for embed, last for head)
        if path.endswith("embed/emb"):
            return last2(m if _div(shape[-2], tp) else None, None)
        return last2(None, m if _div(shape[-1], tp) else None)
    if "/attn/" in path:
        name = path.rsplit("/", 1)[-1]
        if name in ("wq", "wk", "wv", "wq_b", "wkv_b"):
            return last2(None, m if _div(shape[-1], tp) else None)
        if name == "wo":
            return last2(m if _div(shape[-2], tp) else None, None)
        return _pad((), nd)  # wq_a / wkv_a / norms: replicated
    # the reference's precedence: "/ffn/" or ("/mtp/" and a w_gu/w_d)
    if "/ffn/" in path or "/mtp/" in path and path.endswith(("w_gu", "w_d")):
        if path.endswith("w_gu"):       # (d, 2, f)
            return _pad((None, None, m if _div(shape[-1], tp) else None), nd)
        if path.endswith("w_d"):        # (f, d)
            return last2(m if _div(shape[-2], tp) else None, None)
    if "/moe/" in path:
        name = path.rsplit("/", 1)[-1]
        if name in ("w_gu", "w_d"):     # (E, d, f*): experts over model
            return _pad(
                (m if _div(shape[-3], tp) else None, None, None), nd)
        if name == "sh_gu":             # (d, 2, fs)
            return _pad((None, None, m if _div(shape[-1], tp) else None), nd)
        if name == "sh_d":              # (fs, d)
            return last2(m if _div(shape[-2], tp) else None, None)
        return _pad((), nd)             # router replicated
    return _pad((), nd)                 # norms, scalars


def lm_expert_param_spec(path: str, shape: Tuple[int, ...], axes: MeshAxes,
                         tp: int) -> Spec:
    """``lm_param_spec`` on the MoE leaves (routed experts over
    ``model``, the shared expert split), every other leaf replicated:
    expert parallelism alone.  The model follows either layout leaf by
    leaf."""
    if "/moe/" in path:
        return lm_param_spec(path, shape, axes, tp)
    return _pad((), len(shape))


# --------------------------------------------------------------------------
# Generic MLP-family rules (GNN / recsys)
# --------------------------------------------------------------------------

def mlp_param_spec(path: str, shape: Tuple[int, ...], axes: MeshAxes,
                   tp: int) -> Spec:
    nd = len(shape)
    m = axes.model
    name = path.rsplit("/", 1)[-1]
    if name == "emb" and nd >= 2:
        # embedding tables row-sharded (the recsys layout)
        return _pad((m if _div(shape[-2], tp) else None, None), nd)
    if name == "w" and nd >= 2:
        # Megatron pairing inside MLPs: first layer col-shard, the later
        # ones row-shard
        if "/l0/" in path:
            return _pad((None, m if _div(shape[-1], tp) else None), nd)
        if re.search(r"/l(\d+)/w$", path) is not None and _div(shape[-2],
                                                                tp):
            return _pad((m, None), nd)
    return _pad((), nd)


# --------------------------------------------------------------------------
# Application helpers
# --------------------------------------------------------------------------

def param_specs(params: Any, rule: Callable[[str, Tuple[int, ...],
                                             MeshAxes, int], Spec],
                axes: MeshAxes, mesh) -> Any:
    """``rule`` over every parameter (tensors, meta tensors or arrays;
    paths as the reference names them): a tree of specs of the
    parameters' structure."""
    tp = axes.model_size(mesh)
    return map_leaves(
        lambda path, x: rule(path, tuple(x.shape), axes, tp), params)


def zero1_specs(params: Any, pspecs: Any, axes: MeshAxes, mesh) -> Any:
    """ZeRO-1: optimizer moments additionally sharded over the data axes
    on the first dim that is still replicated and divisible."""
    dsize = axes.data_size(mesh)

    def one(path, x) -> Spec:
        spec = at(pspecs, path)
        parts = list(spec) + [None] * (len(x.shape) - len(spec))
        for i, (dim, s) in enumerate(zip(x.shape, parts)):
            if s is None and _div(dim, dsize) and dim >= dsize:
                parts[i] = axes.data
                break
        return tuple(parts)

    return map_leaves(one, params)


def batch_spec(axes: MeshAxes) -> Spec:
    """Leading-dim data-parallel spec for host batches."""
    return (axes.data,)


def opt_state_specs(opt_state, params, pspecs, axes: MeshAxes, mesh,
                    zero1: bool = True):
    """Specs for ``AdamWState(step, m, v)``."""
    from ..train.optim import AdamWState

    mspec = zero1_specs(params, pspecs, axes, mesh) if zero1 else pspecs
    return AdamWState(step=(), m=mspec,
                      v=map_leaves(lambda path, _: at(mspec, path), params))


# --------------------------------------------------------------------------
# RangeReach index sharding (cluster serving)
# --------------------------------------------------------------------------

def index_shard_specs(axis: str = "data") -> Dict[str, Spec]:
    """Specs of the cluster ``ShardedEngine``'s device arrays.

    The stacked per-shard R-tree arenas (SoA entry planes plus the
    fine/coarse tile-pyramid planes, all shaped ``(S, 2*dim, width)``)
    shard over ``axis`` on the leading (shard) dim; the vertex->tree
    routing arrays are replicated on every device (the pointer side is
    tiny next to the arenas, and every device must route every query).
    ``ShardedEngine._place`` places its arrays by this table.
    """
    arena = (axis, None, None)
    replicated = ()
    return {
        "entries": arena,
        "fine": arena,
        "coarse": arena,
        "tree_shard": replicated,
        "tree_qs": replicated,
        "tree_qe": replicated,
    }
