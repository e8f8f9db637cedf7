"""Size-balanced partitioning of a 2DReach forest for sharded serving
(the port of ``repro.cluster.partition``).

The 2DReach forest is embarrassingly partitionable: each component's 2D
R-tree is an independent lookup target, so any assignment of whole trees
to shards preserves exactness — a query probes exactly the shard that
owns its tree.  What matters is *balance*: per-shard work is
proportional to resident leaf entries (arena size bounds both memory and
the worst-case scan), so trees are bin-packed by entry count with the
classic LPT (longest-processing-time) greedy — sort descending, always
assign to the least-loaded shard — which is deterministic and within
4/3 of the optimal whole-tree assignment.  Whole trees are the unit of
placement, so when a single tree dominates the forest (a giant SCC) the
optimum itself is skewed and ``ForestPartition.balance()`` reports a
max/mean ratio well above 1.

The partition is summarised by three per-tree arrays (``tree_shard``,
``tree_qs``, ``tree_qe``) that every device holds: each routes every
query's tree id to (owning shard, local arena slice) with plain gathers,
as the single-device engine's lookup does.  The per-shard arenas are
stacked into one ``(S, 2*dim, Pp)`` plane (plus the fine/coarse
tile-pyramid planes) padded to a common width, so that each shard is a
contiguous slice of the stack.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np
import torch

from ..core.rtree import RTreeForest, _ragged_arange
from ..kernels.forest_build import np_inert_plane, tile_pyramid_device
from ..kernels.range_query.layout import (
    COARSE_GROUP,
    TP,
    TPT,
    UPLOAD_COUNTERS,
    build_tile_pyramid,
    forest_soa,
)


def balanced_assignment(weights: np.ndarray, n_shards: int) -> np.ndarray:
    """LPT greedy bin packing: (T,) weights -> (T,) shard ids.

    Deterministic: items are processed in descending weight order with
    index as tie-break, and ties between equally loaded shards go to the
    lowest shard id.
    """
    T = len(weights)
    assign = np.zeros(T, dtype=np.int32)
    if T == 0 or n_shards <= 1:
        return assign
    order = np.lexsort((np.arange(T), -np.asarray(weights, np.int64)))
    heap: List[Tuple[int, int]] = [(0, s) for s in range(n_shards)]
    heapq.heapify(heap)
    for t in order:
        load, s = heapq.heappop(heap)
        assign[t] = s
        heapq.heappush(heap, (load + int(weights[t]), s))
    return assign


@dataclasses.dataclass(frozen=True)
class ForestPartition:
    """Tree→shard assignment + replicated routing arrays.

    ``tree_shard``/``tree_qs``/``tree_qe`` are padded to length
    ``max(T, 1)`` so an empty forest still gathers safely (every lookup
    then resolves to shard -1 / an empty slice).
    """

    n_shards: int
    shard_trees: Tuple[np.ndarray, ...]  # ascending global tree ids
    tree_shard: np.ndarray               # (max(T,1),) int32, -1 pad
    tree_qs: np.ndarray                  # (max(T,1),) int32 local start
    tree_qe: np.ndarray                  # (max(T,1),) int32 local end
    shard_entries: np.ndarray            # (S,) int64 resident leaf entries

    @property
    def n_trees(self) -> int:
        return sum(len(t) for t in self.shard_trees)

    def balance(self) -> float:
        """max/mean shard load (1.0 = perfectly balanced)."""
        mean = self.shard_entries.mean() if self.n_shards else 0.0
        return float(self.shard_entries.max() / mean) if mean > 0 else 1.0

    @property
    def width(self) -> int:
        """``Pp``: the common arena width of every shard, the largest
        shard's entry count rounded up to whole leaf tiles (at least
        one)."""
        return max(TP, -(-int(self.shard_entries.max(initial=0)) // TP) * TP)


def partition_forest(forest: RTreeForest, n_shards: int) -> ForestPartition:
    """Assign whole trees to ``n_shards`` size-balanced shards."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    T = forest.n_trees
    counts = np.diff(forest.entry_off).astype(np.int64)
    assign = balanced_assignment(counts, n_shards)
    shard_trees = tuple(
        np.nonzero(assign == s)[0].astype(np.int64) for s in range(n_shards)
    )
    pad = max(T, 1)
    tree_shard = np.full(pad, -1, dtype=np.int32)
    tree_qs = np.zeros(pad, dtype=np.int32)
    tree_qe = np.zeros(pad, dtype=np.int32)
    shard_entries = np.zeros(n_shards, dtype=np.int64)
    for s, trees in enumerate(shard_trees):
        lo = 0
        for t in trees:
            c = int(counts[t])
            tree_shard[t] = s
            tree_qs[t] = lo
            tree_qe[t] = lo + c
            lo += c
        shard_entries[s] = lo
    return ForestPartition(
        n_shards=n_shards,
        shard_trees=shard_trees,
        tree_shard=tree_shard,
        tree_qs=tree_qs,
        tree_qe=tree_qe,
        shard_entries=shard_entries,
    )


def shard_arenas(forest: RTreeForest, part: ForestPartition):
    """Stacked per-shard SoA arenas + tile pyramids.

    Returns ``(entries (S, 2*dim, Pp), fine (S, 2*dim, NTp),
    coarse (S, 2*dim, NTp // COARSE_GROUP), n_tiles)`` — every shard
    padded to the *common* width ``Pp`` (:attr:`ForestPartition.width`)
    with impossible boxes (min > max), so padding tiles have impossible
    MBRs and never activate.  ``n_tiles = Pp // TP`` is therefore
    uniform across shards.

    A host-built forest gives NumPy arrays from its (cached) host
    transposition, counted as one ``host_uploads`` of the engine's
    ``UPLOAD_COUNTERS``, the arrays the engine then uploads.  A forest
    built with ``build_forest_device`` carries its serving arrays on its
    device already: the shard stacks are then gathered there from the
    resident global plane and the per-shard pyramids reduced there too
    (one segmented-MBR reduction, K8 on the card, per pyramid level and
    shard), as tensors on that device and one ``device_adoptions``: no
    host transposition, no upload.  Both paths give equal float32
    planes.
    """
    dev = getattr(forest, "device", None)
    if dev is not None:
        return _shard_arenas_device(forest, part, dev)
    UPLOAD_COUNTERS["host_uploads"] += 1
    esoa, off = forest_soa(forest)           # cached global transposition
    dim = forest.dim
    S = part.n_shards
    Pp = part.width
    entries = np.empty((S, 2 * dim, Pp), dtype=np.float32)
    entries[:, :dim] = 1.0                    # impossible box padding
    entries[:, dim:] = 0.0
    for s, trees in enumerate(part.shard_trees):
        lo = 0
        for t in trees:
            a, b = int(off[t]), int(off[t + 1])
            entries[s, :, lo:lo + (b - a)] = esoa[:, a:b]
            lo += b - a
    fine_l, coarse_l = [], []
    nt = Pp // TP
    for s in range(S):
        fine, coarse, nt_s = build_tile_pyramid(entries[s], dim)
        assert nt_s == nt
        fine_l.append(fine)
        coarse_l.append(coarse)
    return entries, np.stack(fine_l), np.stack(coarse_l), nt


def _shard_arenas_device(forest: RTreeForest, part: ForestPartition, dev
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, int]:
    """``shard_arenas`` for a device-built forest: gather each shard's
    arena from the resident global entry plane (``index_select`` on the
    host-made position map, whose sentinel names one inert column
    appended to the plane) and reduce each shard's tile pyramid on the
    device.  Equal planes to the host path."""
    UPLOAD_COUNTERS["device_adoptions"] += 1
    dim = forest.dim
    S = part.n_shards
    off = forest.entry_off
    Pp = part.width
    Pg = int(dev.entries.shape[1])
    device = dev.entries.device
    # host-made gather map (small ints); sentinel Pg -> the inert column
    pos = np.full((S, Pp), Pg, dtype=np.int64)
    for s, trees in enumerate(part.shard_trees):
        if len(trees):
            cnt = (off[trees + 1] - off[trees]).astype(np.int64)
            within = _ragged_arange(cnt)
            dstp = np.repeat(np.r_[0, np.cumsum(cnt)[:-1]], cnt) + within
            srcp = np.repeat(off[trees], cnt) + within
            pos[s, dstp] = srcp
    pos = torch.as_tensor(pos, device=device)
    src = torch.cat([dev.entries, torch.as_tensor(np_inert_plane(dim, 1),
                                                  device=device)], dim=1)
    entries = src.index_select(1, pos.reshape(-1)).reshape(
        2 * dim, S, Pp).permute(1, 0, 2).contiguous()
    fine_l, coarse_l = [], []
    nt = Pp // TP
    for s in range(S):
        fine, coarse, nt_s = tile_pyramid_device(
            entries[s], dim, tp=TP, tpt=TPT, group=COARSE_GROUP,
            device=device)
        assert nt_s == nt
        fine_l.append(fine)
        coarse_l.append(coarse)
    return entries, torch.stack(fine_l), torch.stack(coarse_l), nt
