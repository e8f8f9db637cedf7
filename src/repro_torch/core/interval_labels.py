"""Agrawal-Borgida-Jagadish interval labelling over the SCC condensation.

A copy of ``repro.core.interval_labels`` (host NumPy).

This is the 3DReach baseline's reachability encoding (the part the paper
eliminates).  Each component c gets

* a DFS spanning-forest **post-order number** ``post[c]``, and
* a merged list of **intervals** such that c' is reachable from c iff
  ``post[c']`` lies inside one of c's intervals.

Built host-side with an iterative DFS (the condensation is a DAG so every
edge (u, v) satisfies ``post[v] < post[u]``; processing components by
ascending post order is therefore a reverse-topological traversal and each
component's label is own-tree-interval ∪ children's labels, merged).

The paper's observation that this labelling "is costly, and can amount to
millions of intervals in large graphs" is reproduced by ``total_intervals``
(benchmarks report it as 3DReach's labelling storage).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .condensation import Condensation


@dataclasses.dataclass
class IntervalLabels:
    post: np.ndarray        # (d,) int32 post-order number per comp
    indptr: np.ndarray      # (d+1,) int64 — intervals of comp c at
    lo: np.ndarray          # (I,) int32      indptr[c]:indptr[c+1]
    hi: np.ndarray          # (I,) int32

    @property
    def total_intervals(self) -> int:
        return int(len(self.lo))

    def nbytes(self) -> int:
        return int(
            self.post.nbytes + self.indptr.nbytes + self.lo.nbytes
            + self.hi.nbytes
        )

    def covers(self, c: int, z: int) -> bool:
        s, e = self.indptr[c], self.indptr[c + 1]
        if s == e:
            return False
        j = np.searchsorted(self.lo[s:e], z, side="right") - 1
        return j >= 0 and z <= self.hi[s + j]


def _dag_csr(d: int, dag_edges: np.ndarray):
    if dag_edges.size == 0:
        return (np.zeros(d + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))
    order = np.argsort(dag_edges[:, 0], kind="stable")
    src = dag_edges[order, 0]
    dst = dag_edges[order, 1].astype(np.int32)
    indptr = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=d), out=indptr[1:])
    return indptr, dst


def build_interval_labels(cond: Condensation) -> IntervalLabels:
    d = cond.n_comps
    indptr, adj = _dag_csr(d, cond.dag_edges)

    # ---- iterative DFS post-order over the spanning forest --------------
    post = np.full(d, -1, dtype=np.int64)
    indeg = np.zeros(d, dtype=np.int64)
    if cond.dag_edges.size:
        np.add.at(indeg, cond.dag_edges[:, 1], 1)
    roots = np.nonzero(indeg == 0)[0]

    counter = 0
    visited = np.zeros(d, dtype=bool)
    # stack of (node, next-child-cursor)
    for r in roots:
        if visited[r]:
            continue
        stack: List[List[int]] = [[int(r), int(indptr[r])]]
        visited[r] = True
        while stack:
            node, cur = stack[-1]
            end = indptr[node + 1]
            advanced = False
            while cur < end:
                ch = adj[cur]
                cur += 1
                if not visited[ch]:
                    visited[ch] = True
                    stack[-1][1] = cur
                    stack.append([int(ch), int(indptr[ch])])
                    advanced = True
                    break
            if not advanced:
                stack[-1][1] = cur
                post[node] = counter
                counter += 1
                stack.pop()
    assert counter == d, "DFS must visit every component of the DAG"

    # ---- merge labels in ascending post order (children first) ----------
    order = np.argsort(post, kind="stable")
    labels: List[List[Tuple[int, int]]] = [[] for _ in range(d)]
    for c in order:
        ivs: List[Tuple[int, int]] = []
        s, e = indptr[c], indptr[c + 1]
        for ch in adj[s:e]:
            ivs.extend(labels[ch])
            # note: tree-vs-non-tree does not matter once children's labels
            # are complete; own subtree interval is implied by merging
            # [post[c], post[c]] with the children's intervals when the DFS
            # numbering is contiguous, but cross edges break contiguity, so
            # we merge explicitly.
        ivs.append((int(post[c]), int(post[c])))
        ivs.sort()
        merged: List[Tuple[int, int]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1] + 1:
                if b > merged[-1][1]:
                    merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        labels[c] = merged

    counts = np.array([len(l) for l in labels], dtype=np.int64)
    out_indptr = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    total = int(out_indptr[-1])
    lo = np.empty(total, dtype=np.int32)
    hi = np.empty(total, dtype=np.int32)
    for c in range(d):
        s = out_indptr[c]
        for k, (a, b) in enumerate(labels[c]):
            lo[s + k] = a
            hi[s + k] = b
    return IntervalLabels(
        post=post.astype(np.int32), indptr=out_indptr, lo=lo, hi=hi
    )


def labels_reachable(lbl: IntervalLabels, u_comp: int, v_comp: int) -> bool:
    """Oracle helper: is v_comp reachable from u_comp per the labels."""
    return lbl.covers(u_comp, int(lbl.post[v_comp]))
