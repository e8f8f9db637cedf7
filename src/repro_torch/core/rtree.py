"""Packed, pointer-free R-tree forest with spatial bulk loading (host).

A copy of the host half of ``repro.core.rtree``.  The whole forest (one
R-tree per SCC as paper Alg. 1 requires) lives in a handful of dense
arrays:

* Leaf **entries** are boxes ``(P, 2*dim)`` (points are degenerate
  boxes), concatenated over trees in spatial sort order, ``entry_off``
  giving each tree's slice.
* Bulk load = one global lexsort by ``(tree, morton(coord))``;
  consecutive groups of ``fanout`` entries form the leaf nodes.
* Every upper level is a dense ``(count_l, 2*dim)`` MBR array; the child
  range of local node ``j`` is arithmetic: ``[j*F, min((j+1)*F, c_below))``
  — no pointers anywhere.

``query_host`` is the vectorised NumPy ragged-wavefront descent with
per-query early exit; ``query_host_count`` / ``query_host_collect_batch``
run the same descent without early exit, and ``query_host_knn`` is a
best-first branch-and-bound.  ``query_wavefront`` is the fixed-capacity
wavefront engine in torch on a device (the reference's
``query_jax_wavefront``); the leaf-scan engine over ``entries`` and
``entry_off`` is ``kernels.range_query.leafscan.range_query_forest``.

``build_forest_device`` (the device half of ``repro.core.rtree``) runs
the same bulk load in torch on the build's device: float64 Morton
codes, a sort equal to ``np.lexsort((code, tree))``, and the
segmented-MBR reduction (K8) for every level and for the serving tile
pyramid, which the engine adopts through ``RTreeForest.device``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..kernels.forest_build import (
    level_mbr,
    np_inert_plane,
    tile_pyramid_device,
)
from ..kernels.range_query.layout import COARSE_GROUP, TP, TPT
from ..obs import span


DEFAULT_FANOUT = 16


# --------------------------------------------------------------------------
# Morton order
# --------------------------------------------------------------------------

def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x33333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x55555555)
    return x


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton_code(centers: np.ndarray, extent: np.ndarray) -> np.ndarray:
    """Interleaved Morton code of box centers for bulk-load ordering.

    ``extent`` is the global [mins, maxs] (2*dim,) used to quantise.
    """
    dim = centers.shape[1]
    lo = extent[:dim].astype(np.float64)
    hi = extent[dim:].astype(np.float64)
    span = np.where(hi > lo, hi - lo, 1.0)
    unit = np.clip((centers.astype(np.float64) - lo) / span, 0.0, 1.0)
    if dim == 2:
        q = (unit * 0xFFFF).astype(np.uint64)
        return _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << np.uint64(1))
    elif dim == 3:
        q = (unit * 0x3FF).astype(np.uint64)
        return (
            _part1by2(q[:, 0])
            | (_part1by2(q[:, 1]) << np.uint64(1))
            | (_part1by2(q[:, 2]) << np.uint64(2))
        )
    raise ValueError(f"dim {dim} unsupported")


# --------------------------------------------------------------------------
# Forest container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RTreeForest:
    """Packed forest of R-trees; see module docstring for layout.

    Levels are numbered 0 (leaf MBRs) .. depth-1 (roots); ``level_mbr[l]``
    is the global (count_l, 2*dim) array for level l, nodes of tree t at
    ``tree_off[l][t] : tree_off[l][t+1]``.
    """

    dim: int
    fanout: int
    entries: np.ndarray            # (P, 2*dim) float32 leaf boxes
    entry_ids: np.ndarray          # (P,) int32 payload (original vertex id)
    entry_off: np.ndarray          # (T+1,) int64
    level_mbr: List[np.ndarray]    # depth arrays, each (count_l, 2*dim)
    tree_off: List[np.ndarray]     # depth arrays, each (T+1,) int64
    # device-resident serving arrays (set by ``build_forest_device``);
    # engines on that device adopt these instead of uploading the host
    # arrays
    device: Optional["DeviceForest"] = None

    @property
    def n_trees(self) -> int:
        return len(self.entry_off) - 1

    @property
    def depth(self) -> int:
        return len(self.level_mbr)

    def nbytes_nodes(self) -> int:
        return int(sum(l.nbytes for l in self.level_mbr))

    def nbytes_entries(self) -> int:
        return int(self.entries.nbytes)

    def nbytes_total(self) -> int:
        return (
            self.nbytes_nodes()
            + self.nbytes_entries()
            + int(self.entry_ids.nbytes)
            + int(self.entry_off.nbytes)
            + int(sum(o.nbytes for o in self.tree_off))
        )

    def tree_n_entries(self) -> np.ndarray:
        return np.diff(self.entry_off)

    # -- device views ----------------------------------------------------
    def device_arrays(self, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level arrays stacked for the wavefront engine on
        ``device`` (``None``: the GPU): mbr ``(D, Nmax, 2*dim)`` float32,
        padding boxes inert (min > max), and off ``(D, T+1)`` int64."""
        dev = resolve_device(device)
        D = self.depth
        nmax = max(int(l.shape[0]) for l in self.level_mbr) if D else 0
        mbr = np.zeros((D, nmax, 2 * self.dim), dtype=np.float32)
        mbr[..., : self.dim] = 1.0
        mbr[..., self.dim:] = 0.0
        off = np.zeros((D, self.n_trees + 1), dtype=np.int64)
        for l in range(D):
            mbr[l, : len(self.level_mbr[l])] = self.level_mbr[l]
            off[l] = self.tree_off[l]
        return (torch.as_tensor(mbr, device=dev),
                torch.as_tensor(off, device=dev))


def build_forest(
    boxes: np.ndarray,
    ids: np.ndarray,
    tree_of_entry: np.ndarray,
    n_trees: int,
    fanout: int = DEFAULT_FANOUT,
    extent: Optional[np.ndarray] = None,
) -> RTreeForest:
    """Bulk-load a forest.

    Parameters
    ----------
    boxes:          (P, 2*dim) leaf boxes ([mins, maxs]); for point data
                    pass ``np.concatenate([pts, pts], axis=1)``.
    ids:            (P,) payload ids.
    tree_of_entry:  (P,) tree assignment in [0, n_trees).
    """
    boxes = np.asarray(boxes, dtype=np.float32)
    P, two_dim = boxes.shape
    dim = two_dim // 2
    ids = np.asarray(ids, dtype=np.int32)
    tree_of_entry = np.asarray(tree_of_entry, dtype=np.int64)

    if extent is None:
        if P:
            extent = np.concatenate(
                [boxes[:, :dim].min(0), boxes[:, dim:].max(0)]
            )
        else:
            extent = np.zeros(2 * dim, dtype=np.float32)

    centers = (boxes[:, :dim] + boxes[:, dim:]) * 0.5
    code = morton_code(centers, np.asarray(extent)) if P else np.zeros(0, np.uint64)
    order = np.lexsort((code, tree_of_entry)) if P else np.zeros(0, np.int64)
    boxes = boxes[order]
    ids = ids[order]
    sorted_tree = tree_of_entry[order]

    counts = np.bincount(sorted_tree, minlength=n_trees).astype(np.int64)
    entry_off = np.zeros(n_trees + 1, dtype=np.int64)
    np.cumsum(counts, out=entry_off[1:])

    level_mbr: List[np.ndarray] = []
    tree_off: List[np.ndarray] = []
    cur_boxes = boxes
    cur_counts = counts
    while True:
        node_counts = -(-cur_counts // fanout)  # ceil div; 0 stays 0
        off = np.zeros(n_trees + 1, dtype=np.int64)
        np.cumsum(node_counts, out=off[1:])
        n_nodes = int(off[-1])
        mbr = np.empty((n_nodes, 2 * dim), dtype=np.float32)
        if n_nodes:
            # segment boundaries of each node's children in the packed
            # child-level array
            child_off = np.zeros(n_trees + 1, dtype=np.int64)
            np.cumsum(cur_counts, out=child_off[1:])
            # start index of node j of tree t = child_off[t] + j*fanout
            node_tree = np.repeat(np.arange(n_trees), node_counts)
            local = _ragged_arange(node_counts)
            starts = child_off[node_tree] + local * fanout
            ends = np.minimum(starts + fanout, child_off[node_tree + 1])
            # reduceat over [starts, ends) — contiguous coverage lets us use
            # reduceat with the starts only (segments tile the child array)
            mbr[:, :dim] = np.minimum.reduceat(cur_boxes[:, :dim], starts, axis=0)
            mbr[:, dim:] = np.maximum.reduceat(cur_boxes[:, dim:], starts, axis=0)
            # reduceat caveat: a start equal to the next start (empty tree)
            # cannot occur because node_counts==0 trees emit no nodes; a
            # final segment runs to the end of cur_boxes which is correct.
            del ends
        level_mbr.append(mbr)
        tree_off.append(off)
        if np.all(node_counts <= 1):
            break
        cur_boxes = mbr
        cur_counts = node_counts

    return RTreeForest(
        dim=dim,
        fanout=fanout,
        entries=boxes,
        entry_ids=ids,
        entry_off=entry_off,
        level_mbr=level_mbr,
        tree_off=tree_off,
    )


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


# --------------------------------------------------------------------------
# Device bulk load (backend="device" build pipeline)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceForest:
    """Device-resident serving arrays produced by ``build_forest_device``:
    exactly the tensors :class:`~repro_torch.core.engine.TileArena`
    holds, so an engine on the same device adopts them instead of
    transposing and uploading the host forest."""

    entries: torch.Tensor     # (2*dim, Pp) float32 SoA planes, inert padding
    fine: torch.Tensor        # (2*dim, NTp) float32 leaf-tile MBRs
    coarse: torch.Tensor      # (2*dim, NCp) float32
    entry_off: torch.Tensor   # (T+1,) int32
    n_tiles: int


_CODE_SHIFT = 31              # key = code << 31 | entry index (P < 2^31)


def _part1by1_torch(x: torch.Tensor) -> torch.Tensor:
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _morton_code_torch(centers: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """Device mirror of the 2-D ``morton_code``: the same float64
    operations, so the codes (and the bulk-load order) equal the host
    build's.  Codes are int64 below 2^32."""
    if centers.shape[1] != 2:
        raise ValueError(f"dim {centers.shape[1]} unsupported: the device "
                         f"bulk load serves the 2-D 2DReach forests")
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    unit = ((centers.to(torch.float64) - lo) / span).clamp(0.0, 1.0)
    q = (unit * 0xFFFF).to(torch.int64)           # truncates, as astype
    return _part1by1_torch(q[:, 0]) | (_part1by1_torch(q[:, 1]) << 1)


def _morton_keys(soa: torch.Tensor, extent: np.ndarray) -> torch.Tensor:
    """(P,) int64 sort keys ``code << 31 | entry index``.  The centres
    are float32 ``(lo + hi) * 0.5``, promoted to float64 afterwards, as
    the host computes them."""
    dim = soa.shape[0] // 2
    centers = ((soa[:dim] + soa[dim:]) * 0.5).T         # (P, dim) float32
    ext = torch.as_tensor(np.asarray(extent, np.float64), device=soa.device)
    code = _morton_code_torch(centers, ext[:dim], ext[dim:])
    idx = torch.arange(soa.shape[1], dtype=torch.int64, device=soa.device)
    return (code << _CODE_SHIFT) | idx


def _tree_sort(key: torch.Tensor, tree_of_entry: torch.Tensor
               ) -> torch.Tensor:
    """(P,) int64 permutation equal to ``np.lexsort((code, tree))``:
    one sort of the unique keys orders by (code, entry index), the index
    read back from the key's low bits; a stable sort by tree then keeps
    that order inside each tree."""
    srt = torch.sort(key).values
    by_code = srt & ((1 << _CODE_SHIFT) - 1)
    by_tree = torch.sort(tree_of_entry[by_code], stable=True).indices
    return by_code[by_tree]


def build_forest_device(
    boxes: np.ndarray,
    ids: np.ndarray,
    tree_of_entry: np.ndarray,
    n_trees: int,
    fanout: int = DEFAULT_FANOUT,
    extent: Optional[np.ndarray] = None,
    *,
    device: DeviceLike = None,
) -> RTreeForest:
    """Bulk-load a forest on ``device`` (``None``: the GPU) — the same
    contract, and the same resulting arrays bit for bit, as
    :func:`build_forest`.

    Morton encode (float64, as the host), the (tree, code) sort, then the
    segmented-MBR reduction (K8 on the card) for every R-tree level and
    for the serving tile pyramid.  The forest carries host mirrors of
    every array plus a :class:`DeviceForest` (``forest.device``) that an
    engine on the same device adopts without uploading.

    ``tree_of_entry`` must be non-decreasing (entries generated per tree
    in tree order, as ``build_2dreach`` makes them).

    The steps run in the spans ``build.forest.morton_sort``,
    ``build.forest.mbr_reduce`` and ``build.forest.pyramid``, which time
    the host up to the step's own wait for the device, if it has one:
    the sort ends in the copy of the permuted ids and boxes to the host,
    and each level of the reduction in the copy of its MBRs, so those
    two spans cover their device work; the pyramid's kernels are only
    launched in its span (``build_2dreach`` waits for them afterwards,
    inside ``build.forest``)."""
    dev = resolve_device(device)
    boxes = np.asarray(boxes, dtype=np.float32)
    P, two_dim = boxes.shape
    dim = two_dim // 2
    ids = np.asarray(ids, dtype=np.int32)
    tree_of_entry = np.asarray(tree_of_entry, dtype=np.int64)
    if P and (np.diff(tree_of_entry) < 0).any():
        raise ValueError(
            "build_forest_device requires tree-contiguous input entries "
            "(tree_of_entry non-decreasing)")
    if P >= 2 ** _CODE_SHIFT:
        raise ValueError(f"{P} entries: the sort key holds the entry index "
                         f"in {_CODE_SHIFT} bits")
    if extent is None:
        if P:
            extent = np.concatenate(
                [boxes[:, :dim].min(0), boxes[:, dim:].max(0)])
        else:
            extent = np.zeros(2 * dim, dtype=np.float32)

    counts = np.bincount(tree_of_entry, minlength=n_trees).astype(np.int64)
    entry_off = np.zeros(n_trees + 1, dtype=np.int64)
    np.cumsum(counts, out=entry_off[1:])

    # ---- sort: Morton keys, then the (tree, code) order ------------------
    with span("build.forest.morton_sort", cat="build", entries=int(P)):
        Pp = max(TP, -(-P // TP) * TP)
        soa_ext = torch.cat([
            torch.as_tensor(np.ascontiguousarray(boxes.T), device=dev),
            torch.as_tensor(np_inert_plane(dim, 1), device=dev),  # padding
        ], dim=1)                                            # (2*dim, P+1)
        if P:
            key = _morton_keys(soa_ext[:, :P], extent)
            order = _tree_sort(key, torch.as_tensor(tree_of_entry,
                                                    device=dev))
            # one gather builds the permuted AND padded serving plane
            order_pad = torch.cat([order, torch.full(
                (Pp - P,), P, dtype=torch.int64, device=dev)])
            plane = soa_ext[:, order_pad]                    # (2*dim, Pp)
            ids_host = ids[order.cpu().numpy()]
        else:
            plane = torch.as_tensor(np_inert_plane(dim, Pp), device=dev)
            ids_host = ids
        boxes_host = np.ascontiguousarray(plane[:, :P].cpu().numpy().T)

    # ---- level loop: one segmented-MBR reduction per R-tree level --------
    level_mbrs: List[np.ndarray] = []
    tree_off: List[np.ndarray] = []
    cur_soa = plane           # level 0 gathers only indices < P
    cur_counts = counts
    with span("build.forest.mbr_reduce", cat="build", entries=int(P)):
        while True:
            node_counts = -(-cur_counts // fanout)   # ceil div; 0 stays 0
            off = np.zeros(n_trees + 1, dtype=np.int64)
            np.cumsum(node_counts, out=off[1:])
            n_nodes = int(off[-1])
            if n_nodes:
                child_off = np.zeros(n_trees + 1, dtype=np.int64)
                np.cumsum(cur_counts, out=child_off[1:])
                node_tree = np.repeat(np.arange(n_trees), node_counts)
                local = _ragged_arange(node_counts)
                starts = child_off[node_tree] + local * fanout
                ends = np.minimum(starts + fanout, child_off[node_tree + 1])
                mbr_soa = level_mbr(cur_soa, starts, ends, fanout, dim,
                                    device=dev)
            else:
                mbr_soa = torch.zeros((2 * dim, 0), dtype=torch.float32,
                                      device=dev)
            level_mbrs.append(
                np.ascontiguousarray(mbr_soa[:, :n_nodes].cpu().numpy().T))
            tree_off.append(off)
            if np.all(node_counts <= 1):
                break
            cur_soa = mbr_soa  # padded tail columns are inert, never read
            cur_counts = node_counts

    # ---- the serving arrays (adopted by an engine on this device) -------
    with span("build.forest.pyramid", cat="build", entries=int(P)):
        fine, coarse, nt = tile_pyramid_device(
            plane, dim, tp=TP, tpt=TPT, group=COARSE_GROUP, device=dev)
    return RTreeForest(
        dim=dim,
        fanout=fanout,
        entries=boxes_host,
        entry_ids=ids_host,
        entry_off=entry_off,
        level_mbr=level_mbrs,
        tree_off=tree_off,
        device=DeviceForest(
            entries=plane,
            fine=fine,
            coarse=coarse,
            entry_off=torch.as_tensor(entry_off.astype(np.int32),
                                      device=dev),
            n_tiles=nt,
        ),
    )


def intersects(boxes: np.ndarray, rect: np.ndarray, dim: int) -> np.ndarray:
    """boxes (..., 2*dim) vs rect broadcastable (..., 2*dim) AABB test."""
    lo_ok = boxes[..., :dim] <= rect[..., dim:]
    hi_ok = boxes[..., dim:] >= rect[..., :dim]
    return np.all(lo_ok & hi_ok, axis=-1)


# --------------------------------------------------------------------------
# Host batched query engine (ragged wavefront)
# --------------------------------------------------------------------------

def query_host(
    forest: RTreeForest,
    tree_ids: np.ndarray,
    rects: np.ndarray,
) -> np.ndarray:
    """Batched "does tree contain any entry intersecting rect" probe.

    tree_ids: (B,) int; rects: (B, 2*dim). Returns (B,) bool. Trees with
    id < 0 answer False (empty reachable set).
    """
    dim = forest.dim
    F = forest.fanout
    B = len(tree_ids)
    tree_ids = np.asarray(tree_ids, dtype=np.int64)
    rects = np.asarray(rects, dtype=np.float32).reshape(B, 2 * dim)
    hit = np.zeros(B, dtype=bool)

    valid = tree_ids >= 0
    if forest.depth == 0 or not valid.any():
        return hit
    top = forest.depth - 1
    top_off = forest.tree_off[top]
    has_root = np.zeros(B, dtype=bool)
    has_root[valid] = (
        top_off[tree_ids[valid] + 1] - top_off[tree_ids[valid]]
    ) > 0
    q = np.nonzero(has_root)[0]
    node = top_off[tree_ids[q]]  # global root index (one root per tree)

    for l in range(top, -1, -1):
        if q.size == 0:
            break
        ok = intersects(forest.level_mbr[l][node], rects[q], dim) & ~hit[q]
        q, node = q[ok], node[ok]
        if q.size == 0:
            break
        t = tree_ids[q]
        if l > 0:
            below_off = forest.tree_off[l - 1]
            local = node - forest.tree_off[l][t]
            c_start = below_off[t] + local * F
            c_end = np.minimum(c_start + F, below_off[t + 1])
        else:
            local = node - forest.tree_off[0][t]
            c_start = forest.entry_off[t] + local * F
            c_end = np.minimum(c_start + F, forest.entry_off[t + 1])
        cnt = (c_end - c_start).astype(np.int64)
        nq = np.repeat(q, cnt)
        child = np.repeat(c_start, cnt) + _ragged_arange(cnt)
        if l > 0:
            q, node = nq, child
        else:
            leaf_ok = intersects(forest.entries[child], rects[nq], dim)
            np.logical_or.at(hit, nq[leaf_ok], True)
            q = np.zeros(0, dtype=np.int64)
    return hit


def query_host_collect(
    forest: RTreeForest, tree_id: int, rect: np.ndarray
) -> np.ndarray:
    """Single-tree probe returning the payload ids of ALL hits (used by
    tests and the GeoReach grid tier)."""
    if tree_id < 0:
        return np.zeros(0, dtype=np.int32)
    dim = forest.dim
    rect = np.asarray(rect, dtype=np.float32)
    s, e = forest.entry_off[tree_id], forest.entry_off[tree_id + 1]
    boxes = forest.entries[s:e]
    ok = intersects(boxes, rect, dim)
    return forest.entry_ids[s:e][ok]


def _descend_leaves(forest: RTreeForest, tree_ids: np.ndarray,
                    rects: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Shared ragged-wavefront descent (no early exit): returns
    ``(qi, leaf)`` — for every (query, leaf entry) pair whose leaf box
    intersects the query rect, the query index and global entry index.
    Each pair appears exactly once (trees are proper trees), which is
    what makes the count/collect variants exact."""
    dim = forest.dim
    F = forest.fanout
    B = len(tree_ids)
    tree_ids = np.asarray(tree_ids, dtype=np.int64)
    rects = np.asarray(rects, dtype=np.float32).reshape(B, 2 * dim)
    empty = (np.zeros(0, dtype=np.int64),) * 2
    valid = tree_ids >= 0
    if forest.depth == 0 or not valid.any():
        return empty
    top = forest.depth - 1
    top_off = forest.tree_off[top]
    has_root = np.zeros(B, dtype=bool)
    has_root[valid] = (
        top_off[tree_ids[valid] + 1] - top_off[tree_ids[valid]]
    ) > 0
    q = np.nonzero(has_root)[0]
    node = top_off[tree_ids[q]]

    for l in range(top, -1, -1):
        if q.size == 0:
            return empty
        ok = intersects(forest.level_mbr[l][node], rects[q], dim)
        q, node = q[ok], node[ok]
        if q.size == 0:
            return empty
        t = tree_ids[q]
        if l > 0:
            below_off = forest.tree_off[l - 1]
            local = node - forest.tree_off[l][t]
            c_start = below_off[t] + local * F
            c_end = np.minimum(c_start + F, below_off[t + 1])
        else:
            local = node - forest.tree_off[0][t]
            c_start = forest.entry_off[t] + local * F
            c_end = np.minimum(c_start + F, forest.entry_off[t + 1])
        cnt = (c_end - c_start).astype(np.int64)
        nq = np.repeat(q, cnt)
        child = np.repeat(c_start, cnt) + _ragged_arange(cnt)
        if l > 0:
            q, node = nq, child
        else:
            leaf_ok = intersects(forest.entries[child], rects[nq], dim)
            return nq[leaf_ok], child[leaf_ok]
    return empty


def query_host_count(
    forest: RTreeForest,
    tree_ids: np.ndarray,
    rects: np.ndarray,
) -> np.ndarray:
    """Batched "how many entries of tree t intersect rect" descent.

    tree_ids: (B,) int (< 0 answers 0); rects (B, 2*dim).  Returns (B,)
    int64 exact counts — the host oracle for the device count kernel.
    """
    qi, _ = _descend_leaves(forest, tree_ids, rects)
    counts = np.zeros(len(tree_ids), dtype=np.int64)
    if qi.size:
        np.add.at(counts, qi, 1)
    return counts


def query_host_collect_batch(
    forest: RTreeForest,
    tree_ids: np.ndarray,
    rects: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched collect descent: all hit payload ids per query.

    Returns ``(indptr (B+1,) int64, ids int32)`` in CSR form — query
    b's hits are ``ids[indptr[b]:indptr[b+1]]``, sorted ascending by
    payload id (the canonical collect order every engine reproduces).
    """
    B = len(tree_ids)
    qi, leaf = _descend_leaves(forest, tree_ids, rects)
    indptr = np.zeros(B + 1, dtype=np.int64)
    if qi.size == 0:
        return indptr, np.zeros(0, dtype=np.int32)
    ids = forest.entry_ids[leaf]
    order = np.lexsort((ids, qi))
    qi, ids = qi[order], ids[order]
    np.cumsum(np.bincount(qi, minlength=B), out=indptr[1:])
    return indptr, ids.astype(np.int32)


def _mindist2(box: np.ndarray, p: np.ndarray, dim: int) -> float:
    """Squared Euclidean point-to-box distance, float64."""
    d2 = 0.0
    for a in range(dim):
        lo, hi = float(box[a]), float(box[dim + a])
        dx = lo - p[a] if p[a] < lo else (p[a] - hi if p[a] > hi else 0.0)
        d2 += dx * dx
    return d2


def query_host_knn(
    forest: RTreeForest,
    tree_id: int,
    point: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest entries of one tree to ``point`` — best-first
    branch-and-bound with a node priority queue (mindist² lower bounds).

    Returns ``(ids (<=k,) int32, dist2 (<=k,) float64)`` ordered by
    ``(dist², id)`` ascending — distances in float64 over the float32
    coordinates, the canonical kNN order every engine reproduces.  Ties
    at the kth distance resolve by payload id, so the heap keeps
    popping until the next lower bound strictly exceeds the running
    kth-smallest distance before the final sort.
    """
    import heapq

    if tree_id < 0 or k <= 0 or forest.depth == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.float64)
    dim = forest.dim
    F = forest.fanout
    p = np.asarray(point, dtype=np.float64).reshape(dim)
    top = forest.depth - 1
    top_off = forest.tree_off[top]
    if top_off[tree_id + 1] - top_off[tree_id] <= 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.float64)

    # heap items: (mindist2, seq, level, global node index); level -1
    # marks a leaf entry (exact distance)
    seq = 0
    heap = [(0.0, seq, top, int(top_off[tree_id]))]
    got: list = []          # (dist2, id) of popped entries
    kth = np.inf            # running kth-smallest entry distance
    while heap:
        d2, _, l, node = heapq.heappop(heap)
        if len(got) >= k and d2 > kth:
            break           # no remaining node/entry can enter the top-k
        if l == -1:
            got.append((d2, int(forest.entry_ids[node])))
            if len(got) >= k:
                kth = np.partition(
                    np.array([g[0] for g in got]), k - 1)[k - 1]
            continue
        t = tree_id
        if l > 0:
            below_off = forest.tree_off[l - 1]
            local = node - forest.tree_off[l][t]
            c_start = below_off[t] + local * F
            c_end = min(c_start + F, below_off[t + 1])
            boxes = forest.level_mbr[l - 1]
            nl = l - 1
        else:
            local = node - forest.tree_off[0][t]
            c_start = forest.entry_off[t] + local * F
            c_end = min(c_start + F, forest.entry_off[t + 1])
            boxes = forest.entries
            nl = -1
        for c in range(int(c_start), int(c_end)):
            cd2 = _mindist2(boxes[c], p, dim)
            if len(got) >= k and cd2 > kth:
                continue
            seq += 1
            heapq.heappush(heap, (cd2, seq, nl, c))
    if not got:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.float64)
    arr_d = np.array([g[0] for g in got], dtype=np.float64)
    arr_i = np.array([g[1] for g in got], dtype=np.int64)
    order = np.lexsort((arr_i, arr_d))[:k]
    return arr_i[order].astype(np.int32), arr_d[order]


# --------------------------------------------------------------------------
# Device batched query engine (fixed-capacity wavefront)
# --------------------------------------------------------------------------

def _isect(boxes: torch.Tensor, rect: torch.Tensor, dim: int) -> torch.Tensor:
    """boxes (B, K, 2*dim) vs rect (B, 2*dim) -> (B, K) bool."""
    lo_ok = boxes[..., :dim] <= rect[:, None, dim:]
    hi_ok = boxes[..., dim:] >= rect[:, None, :dim]
    return (lo_ok & hi_ok).all(dim=-1)


def _wavefront_arrays(forest: RTreeForest, dev: torch.device):
    """``device_arrays`` plus the leaf entries (one inert box appended,
    so that a masked gather has a row to read even where P = 0) and the
    entry offsets on ``dev``, memoised on the immutable forest: one
    upload per forest and device."""
    cached = getattr(forest, "_wavefront_cache", None)
    if cached is not None and same_device(cached[0].device, dev):
        return cached
    dim = forest.dim
    inert = np.concatenate([np.ones(dim), np.zeros(dim)]).astype(np.float32)
    mbr, off = forest.device_arrays(dev)
    cached = (mbr, off,
              torch.as_tensor(np.concatenate([forest.entries, inert[None]]),
                              device=dev),
              torch.as_tensor(np.asarray(forest.entry_off, np.int64),
                              device=dev))
    forest._wavefront_cache = cached
    return cached


def query_wavefront(
    forest: RTreeForest,
    tree_ids: np.ndarray,
    rects: np.ndarray,
    capacity: int = 128,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-capacity wavefront probe on ``device`` (``None``: the GPU);
    the port of ``repro.core.rtree.query_jax_wavefront``.  Returns
    ``(hit, overflow)`` as (B,) NumPy bools.  Each level keeps at most
    ``capacity`` frontier nodes per query; a query whose children at
    some level exceed it is flagged in ``overflow`` (set before the cut)
    and its ``hit`` must be recomputed on the host."""
    dev = resolve_device(device)
    dim, F = forest.dim, forest.fanout
    B = len(tree_ids)
    mbr, off, ent, eoff = _wavefront_arrays(forest, dev)
    D = mbr.shape[0]
    tid = torch.as_tensor(np.asarray(tree_ids, np.int64), device=dev)
    r = torch.as_tensor(np.asarray(rects, np.float32).reshape(B, 2 * dim),
                        device=dev)
    hit = torch.zeros(B, dtype=torch.bool, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    if D == 0:
        return hit.cpu().numpy(), overflow.cpu().numpy()
    valid = tid >= 0
    t = tid.clamp(min=0)
    root = off[D - 1][t]
    has_root = (off[D - 1][t + 1] - root) > 0
    # (B, capacity) global node ids at the current level, -1 = empty
    frontier = torch.full((B, capacity), -1, dtype=torch.int64, device=dev)
    frontier[:, 0] = torch.where(valid & has_root, root, -1)
    fan = torch.arange(F, device=dev)
    for l in range(D - 1, -1, -1):
        node = frontier.clamp(min=0)
        ok = _isect(mbr[l][node], r, dim) & (frontier >= 0)   # (B, C)
        local = node - off[l][t][:, None]
        if l == 0:
            base, bound = eoff[t][:, None], eoff[t + 1][:, None]
        else:
            base, bound = off[l - 1][t][:, None], off[l - 1][t + 1][:, None]
        c_start = base + local * F
        c_end = torch.minimum(c_start + F, bound)
        child = c_start[..., None] + fan                      # (B, C, F)
        cmask = ok[..., None] & (child < c_end[..., None])
        child_flat = torch.where(cmask, child, -1).reshape(B, -1)
        if l == 0:
            eb = ent[child_flat.clamp(min=0)]
            hit |= (_isect(eb, r, dim) & (child_flat >= 0)).any(dim=1)
        else:
            overflow |= (child_flat >= 0).sum(dim=1) > capacity
            # the descending sort puts the valid children first; where
            # they fit in ``capacity`` nothing is lost
            frontier = child_flat.sort(dim=1, descending=True).values[
                :, :capacity]
    return hit.cpu().numpy(), overflow.cpu().numpy()
