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

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.array(node), device=dev)

    return conv(tree)
