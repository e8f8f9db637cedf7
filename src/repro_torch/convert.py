"""Carry a built 2DReach index across as plain NumPy arrays.

:func:`index_to_arrays` reads any object with the 2DReach index
attributes (this package's ``TwoDReachIndex``, or the reference's) into
a flat ``dict[str, np.ndarray]``; :func:`index_from_arrays` builds this
package's :class:`~repro_torch.core.two_d_reach.TwoDReachIndex` from
such a dict.  With the pair, one index can be served by two engines, so
serving is compared apart from the build.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .core.rtree import RTreeForest
from .core.two_d_reach import BitRank, TwoDReachIndex


def index_to_arrays(index) -> Dict[str, np.ndarray]:
    """The serving state of a 2DReach index as named arrays.  Per-level
    forest arrays are keyed ``level_mbr.<l>`` and ``tree_off.<l>``."""
    f = index.forest
    arrays = {
        "variant": np.asarray(index.variant),
        "coords": index.coords,
        "excluded": index.excluded,
        "vertex_comp": index.vertex_comp,
        "comp_tree": index.comp_tree,
        "dim": np.asarray(f.dim),
        "fanout": np.asarray(f.fanout),
        "entries": f.entries,
        "entry_ids": f.entry_ids,
        "entry_off": f.entry_off,
    }
    if index.vertex_tree is not None:
        arrays["vertex_tree"] = index.vertex_tree
    if index.bitrank is not None:
        arrays["bits"] = index.bitrank.bits
        arrays["rank"] = index.bitrank.rank
        arrays["tree_ptrs"] = index.tree_ptrs
    for l, (mbr, off) in enumerate(zip(f.level_mbr, f.tree_off)):
        arrays[f"level_mbr.{l}"] = mbr
        arrays[f"tree_off.{l}"] = off
    return {k: np.asarray(v) for k, v in arrays.items()}


def index_from_arrays(arrays: Dict[str, np.ndarray]) -> TwoDReachIndex:
    """This package's ``TwoDReachIndex`` from :func:`index_to_arrays`'s
    dict (``cond`` is not carried: serving never reads it)."""
    depth = sum(1 for k in arrays if k.startswith("level_mbr."))
    forest = RTreeForest(
        dim=int(arrays["dim"]),
        fanout=int(arrays["fanout"]),
        entries=arrays["entries"],
        entry_ids=arrays["entry_ids"],
        entry_off=arrays["entry_off"],
        level_mbr=[arrays[f"level_mbr.{l}"] for l in range(depth)],
        tree_off=[arrays[f"tree_off.{l}"] for l in range(depth)],
    )
    pointer = "bits" in arrays
    return TwoDReachIndex(
        variant=str(arrays["variant"]),
        n=len(arrays["coords"]),
        coords=arrays["coords"],
        excluded=arrays["excluded"],
        vertex_comp=arrays["vertex_comp"],
        cond=None,
        forest=forest,
        comp_tree=arrays["comp_tree"],
        vertex_tree=arrays.get("vertex_tree"),
        bitrank=(BitRank(bits=arrays["bits"], rank=arrays["rank"])
                 if pointer else None),
        tree_ptrs=arrays["tree_ptrs"] if pointer else None,
        stats={},
    )
