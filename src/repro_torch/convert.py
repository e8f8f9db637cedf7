"""Carry a built index across as plain NumPy arrays.

:func:`index_to_arrays` reads any object with the attributes of a
2DReach, 3DReach (both variants) or GeoReach index (this package's, or
the reference's) into a flat ``dict[str, np.ndarray]``;
:func:`index_from_arrays` builds this package's index of the same kind
from such a dict.  With the pair, one index can be served by two
engines, so serving is compared apart from the build, and two builds
compare array for array.

:func:`din_params_from_jax` carries a DIN parameter tree of the
reference (JAX arrays or NumPy) into this package's: the same nested
dict, with each array as a tensor.  Both keep a dense layer as ``w``
``(d_in, d_out)`` and ``b``, so nothing is transposed.
:func:`adamw_state_from_jax` carries the reference's AdamW state (its
step and moments) across the same way, so training can continue from a
state that is not zero.  :func:`lm_params_from_jax` carries an LM
parameter tree (``repro_torch.models.lm``) across in the reference's
layout.  :func:`gnn_params_from_jax` carries a GNN parameter tree
(``repro_torch.models.gnn``: SchNet, DimeNet, GraphCast or
EquiformerV2) across the same way.  Every leaf converts bit for bit, the reference's bf16 and
float8 leaves (``ml_dtypes``, which ``torch.from_numpy`` cannot read)
included.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.condensation import Condensation
from .core.georeach import GeoReachIndex
from .core.interval_labels import IntervalLabels
from .core.rtree import RTreeForest
from .core.three_d_reach import ThreeDReachIndex
from .core.two_d_reach import BitRank, TwoDReachIndex
from .device import DeviceLike, resolve_device

_COND = ("comp", "n_comps", "dag_edges", "level", "comp_sizes")
_LABELS = ("post", "indptr", "lo", "hi")
_GEOREACH = ("comp_mbr", "dag_indptr", "dag_adj", "own_indptr", "own_pts")


def _forest_arrays(f) -> Dict[str, np.ndarray]:
    """A forest's arrays; per-level ones keyed ``level_mbr.<l>`` and
    ``tree_off.<l>``."""
    arrays = {"dim": np.asarray(f.dim), "fanout": np.asarray(f.fanout),
              "entries": f.entries, "entry_ids": f.entry_ids,
              "entry_off": f.entry_off}
    for l, (mbr, off) in enumerate(zip(f.level_mbr, f.tree_off)):
        arrays[f"level_mbr.{l}"] = mbr
        arrays[f"tree_off.{l}"] = off
    return arrays


def _forest_from(arrays: Dict[str, np.ndarray]) -> RTreeForest:
    """The host forest of :func:`_forest_arrays` (never a device-resident
    one: an engine uploads the host arrays)."""
    depth = sum(1 for k in arrays if k.startswith("level_mbr."))
    return RTreeForest(
        dim=int(arrays["dim"]),
        fanout=int(arrays["fanout"]),
        entries=arrays["entries"],
        entry_ids=arrays["entry_ids"],
        entry_off=arrays["entry_off"],
        level_mbr=[arrays[f"level_mbr.{l}"] for l in range(depth)],
        tree_off=[arrays[f"tree_off.{l}"] for l in range(depth)],
    )


def _cond_from(arrays: Dict[str, np.ndarray]) -> Condensation:
    kw = {k: arrays[f"cond.{k}"] for k in _COND}
    kw["n_comps"] = int(kw["n_comps"])
    return Condensation(**kw)


def index_to_arrays(index) -> Dict[str, np.ndarray]:
    """The state of a built index as named arrays; ``kind`` names its
    type (``2dreach``, ``3dreach`` or ``georeach``)."""
    if hasattr(index, "labels"):                       # 3DReach, 3DReach-Rev
        arrays = {"kind": "3dreach", "variant": index.variant, "n": index.n,
                  **{f"cond.{k}": getattr(index.cond, k) for k in _COND},
                  **{f"labels.{k}": getattr(index.labels, k)
                     for k in _LABELS},
                  **_forest_arrays(index.forest)}
    elif hasattr(index, "comp_mbr"):                   # GeoReach
        arrays = {"kind": "georeach", "n": index.n,
                  **{f"cond.{k}": getattr(index.cond, k) for k in _COND},
                  **{k: getattr(index, k) for k in _GEOREACH}}
    else:                                              # 2DReach
        arrays = {
            "kind": "2dreach",
            "variant": index.variant,
            "backend": getattr(index, "backend", "host"),
            "coords": index.coords,
            "excluded": index.excluded,
            "vertex_comp": index.vertex_comp,
            "comp_tree": index.comp_tree,
            **_forest_arrays(index.forest),
        }
        if index.vertex_tree is not None:
            arrays["vertex_tree"] = index.vertex_tree
        if index.bitrank is not None:
            arrays["bits"] = index.bitrank.bits
            arrays["rank"] = index.bitrank.rank
            arrays["tree_ptrs"] = index.tree_ptrs
    return {k: np.asarray(v) for k, v in arrays.items()}


def index_from_arrays(arrays: Dict[str, np.ndarray]):
    """This package's index from :func:`index_to_arrays`'s dict.  The
    build ``stats`` are not carried; nor is a 2DReach index's ``cond``
    (serving never reads it) or a device-resident forest."""
    kind = str(arrays["kind"])
    if kind == "3dreach":
        return ThreeDReachIndex(
            variant=str(arrays["variant"]), n=int(arrays["n"]),
            cond=_cond_from(arrays),
            labels=IntervalLabels(**{k: arrays[f"labels.{k}"]
                                     for k in _LABELS}),
            forest=_forest_from(arrays), stats={})
    if kind == "georeach":
        return GeoReachIndex(n=int(arrays["n"]), cond=_cond_from(arrays),
                             stats={}, **{k: arrays[k] for k in _GEOREACH})
    if kind != "2dreach":
        raise ValueError(f"unknown index kind {kind!r}")
    pointer = "bits" in arrays
    return TwoDReachIndex(
        variant=str(arrays["variant"]),
        n=len(arrays["coords"]),
        coords=arrays["coords"],
        excluded=arrays["excluded"],
        vertex_comp=arrays["vertex_comp"],
        cond=None,
        forest=_forest_from(arrays),
        comp_tree=arrays["comp_tree"],
        vertex_tree=arrays.get("vertex_tree"),
        bitrank=(BitRank(bits=arrays["bits"], rank=arrays["rank"])
                 if pointer else None),
        tree_ptrs=arrays["tree_ptrs"] if pointer else None,
        stats={},
        backend=str(arrays.get("backend", "host")),
    )


_DIN_KEYS = {"item_emb", "cate_emb", "attn", "mlp"}


def din_params_from_jax(tree, device: DeviceLike = None):
    """The port's DIN parameters (``repro_torch.models.recsys.din``) from
    the reference's tree ``{"item_emb": {"emb"}, "cate_emb": {"emb"},
    "attn": {"l<i>": {"w", "b"}}, "mlp": {...}}`` of arrays, on
    ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    if set(tree) != _DIN_KEYS:
        raise ValueError(f"not a DIN parameter tree: keys {sorted(tree)}")

    return _tree_from_jax(tree, dev)


_LM_KEYS = {"embed", "ln_f"}
_LM_OPTIONAL = {"lm_head", "mtp"}

# the ml_dtypes floats torch holds: name -> (unsigned view, torch dtype)
_ML_FLOATS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e4m3fnuz": (np.uint8, torch.float8_e4m3fnuz),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
    "float8_e5m2fnuz": (np.uint8, torch.float8_e5m2fnuz),
    "float8_e8m0fnu": (np.uint8, torch.float8_e8m0fnu),
}


def lm_params_from_jax(tree, device: DeviceLike = None):
    """The port's LM parameters (``repro_torch.models.lm``) from the
    reference's tree, on ``device`` (``None``: the GPU).  The layout is
    kept exactly: dense weights ``(d_in, d_out)``, the stacked leading
    repeat dim of every scanned segment ``seg<i>`` (none where the
    segment has one repeat), and ``mtp`` and the untied ``lm_head``
    where the config has them."""
    dev = resolve_device(device)
    keys = set(tree)
    segs = {k for k in keys if k.startswith("seg") and k[3:].isdigit()}
    if not (_LM_KEYS <= keys and segs
            and keys <= _LM_KEYS | _LM_OPTIONAL | segs):
        raise ValueError(f"not an LM parameter tree: keys {sorted(keys)}")
    return _tree_from_jax(tree, dev)


# per GNN: (the keys it always has, the prefix of its numbered blocks,
# the keys it may have)
_GNN_TREES = {
    "schnet": ({"out"}, "int", {"embed", "enc"}),
    "dimenet": ({"embed", "rbf_proj", "msg_init", "out_final"}, "blk",
                {"enc"}),
    "graphcast": ({"enc_node", "enc_edge", "dec", "proc"}, None, set()),
    "equiformer-v2": ({"out"}, "layer", {"embed", "enc"}),
}


def gnn_params_from_jax(tree, device: DeviceLike = None):
    """The port's GNN parameters (``repro_torch.models.gnn``) from the
    reference's tree of SchNet, DimeNet, GraphCast or EquiformerV2, on
    ``device`` (``None``: the GPU).  The layout is kept exactly: dense
    weights ``(d_in, d_out)``, DimeNet's ``bilin`` ``(nb, nb, d)`` and
    GraphCast's processor ``proc`` stacked on a leading ``n_layers``
    dim."""
    dev = resolve_device(device)
    keys = set(tree)
    for need, prefix, may in _GNN_TREES.values():
        blocks = {k for k in keys if prefix and k.startswith(prefix)
                  and k[len(prefix):].isdigit()}
        if (need <= keys <= need | may | blocks
                and bool(blocks) == bool(prefix)):
            return _tree_from_jax(tree, dev)
    raise ValueError(f"not a GNN parameter tree: keys {sorted(keys)}")


def _leaf_to_tensor(node, dev: torch.device, key: str) -> torch.Tensor:
    """One array, bit for bit: an ``ml_dtypes`` float is read through
    its unsigned view and viewed back as torch's dtype of that name."""
    a = np.asarray(node)
    if a.dtype.name in _ML_FLOATS:
        view, dt = _ML_FLOATS[a.dtype.name]
        t = torch.from_numpy(np.require(a, requirements="C").view(view))
        t = t.view(dt)
        return t.to(dev)
    try:
        return torch.as_tensor(np.array(a), device=dev)
    except TypeError as e:
        raise TypeError(f"{key}: {e}") from None


def _tree_from_jax(node, dev: torch.device, key: str = ""):
    if isinstance(node, dict):
        return {k: _tree_from_jax(v, dev, f"{key}/{k}")
                for k, v in node.items()}
    return _leaf_to_tensor(node, dev, key or "/")


def adamw_state_from_jax(state, device: DeviceLike = None):
    """The port's :class:`~repro_torch.train.AdamWState` from the
    reference's ``repro.train.optim.AdamWState`` (``step`` and the
    moment trees ``m``, ``v`` of arrays), on ``device`` (``None``: the
    GPU): the step as an int32 scalar, the moments as float32
    tensors."""
    from .train.optim import AdamWState

    dev = resolve_device(device)
    step, m, v = state
    return AdamWState(
        step=torch.as_tensor(np.array(step, np.int32), device=dev),
        m=_tree_from_jax(m, dev), v=_tree_from_jax(v, dev))
