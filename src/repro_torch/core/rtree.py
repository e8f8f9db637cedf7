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
per-query early exit.  The device bulk load waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


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

