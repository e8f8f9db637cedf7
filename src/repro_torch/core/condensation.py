"""SCC condensation: collapse components into a DAG + topological layering.

The condensation D = (V_D, E_D) has one super-vertex per SCC and an edge
(C_u -> C_v) iff G has an edge between members of distinct components.

Downstream (reachability closure, Alg. 1 of the paper) only needs:

  comp          (n,)  int32   dense component id per vertex
  n_comps       int
  dag_edges     (e, 2) int32  deduplicated inter-component edges
  level         (d,)  int32   longest-path depth from sources; for every
                              DAG edge (u, v): level[u] < level[v].
                              Processing levels in descending order is the
                              reverse-topological traversal of Alg. 1.

Levels (rather than a single topological permutation) are the data-parallel
form of "reverse topological order": all components on one level can be
processed in a single vectorised sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .scc import compact_labels


@dataclasses.dataclass
class Condensation:
    comp: np.ndarray        # (n,)   vertex -> dense comp id
    n_comps: int
    dag_edges: np.ndarray   # (e, 2) comp -> comp, deduped, no self loops
    level: np.ndarray       # (d,)   longest-path level from sources
    comp_sizes: np.ndarray  # (d,)   member counts

    @property
    def n_levels(self) -> int:
        return int(self.level.max()) + 1 if self.n_comps else 0

    def edges_by_level_desc(self) -> np.ndarray:
        """DAG edges sorted by level[src] descending — the order in which
        the reverse-topological closure consumes them."""
        if self.dag_edges.size == 0:
            return self.dag_edges
        order = np.argsort(-self.level[self.dag_edges[:, 0]], kind="stable")
        return self.dag_edges[order]


def condense(
    n: int,
    edges: np.ndarray,
    labels: np.ndarray,
    include_mask: Optional[np.ndarray] = None,
) -> Condensation:
    """Build the condensation from per-vertex SCC labels (any labelling).

    ``include_mask`` (n,) bool excludes vertices from the decomposition —
    the compressed 2DReach variants build the condensation on the social
    subgraph only; excluded vertices get ``comp == -1`` and the supplied
    ``edges`` must already be restricted to included endpoints.
    """
    if include_mask is not None:
        include_mask = np.asarray(include_mask, dtype=bool)
        inc_ids = np.nonzero(include_mask)[0]
        sub, d = compact_labels(np.asarray(labels)[inc_ids])
        comp = np.full(n, -1, dtype=np.int32)
        comp[inc_ids] = sub
    else:
        comp, d = compact_labels(labels)
    edges = np.asarray(edges).reshape(-1, 2)
    if edges.size:
        ce = comp[edges]                      # (m, 2) comp ids
        ce = ce[ce[:, 0] != ce[:, 1]]         # drop intra-component edges
        if ce.size:
            key = ce[:, 0].astype(np.int64) << 32 | ce[:, 1].astype(np.int64)
            uniq = np.unique(key)
            dag_edges = np.stack(
                [uniq >> 32, uniq & 0xFFFFFFFF], axis=1
            ).astype(np.int32)
        else:
            dag_edges = np.zeros((0, 2), dtype=np.int32)
    else:
        dag_edges = np.zeros((0, 2), dtype=np.int32)

    level = _longest_path_levels(d, dag_edges)
    comp_sizes = np.bincount(comp[comp >= 0], minlength=d).astype(np.int64)
    return Condensation(
        comp=comp, n_comps=d, dag_edges=dag_edges, level=level,
        comp_sizes=comp_sizes,
    )


def _longest_path_levels(d: int, dag_edges: np.ndarray) -> np.ndarray:
    """Longest-path-from-source levels via Kahn-style sweeps.

    O(E) per level using a frontier queue; NumPy implementation (the build
    is host-side; the jit path recomputes levels only if the DAG changed,
    which it never does after build).
    """
    level = np.zeros(d, dtype=np.int32)
    if dag_edges.size == 0 or d == 0:
        return level
    indeg = np.bincount(dag_edges[:, 1], minlength=d).astype(np.int64)
    # CSR over DAG out-edges
    order = np.argsort(dag_edges[:, 0], kind="stable")
    src_sorted = dag_edges[order, 0]
    dst_sorted = dag_edges[order, 1]
    indptr = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_sorted, minlength=d), out=indptr[1:])

    frontier = np.nonzero(indeg == 0)[0]
    seen = 0
    while frontier.size:
        seen += frontier.size
        # gather all out-edges of the frontier
        starts = indptr[frontier]
        ends = indptr[frontier + 1]
        counts = (ends - starts).astype(np.int64)
        if counts.sum() == 0:
            break
        # ragged gather of edge slots
        slot = np.repeat(starts, counts) + _ragged_arange(counts)
        dsts = dst_sorted[slot]
        srcs = src_sorted[slot]
        np.maximum.at(level, dsts, level[srcs] + 1)
        np.subtract.at(indeg, dsts, 1)
        cand = np.unique(dsts)
        frontier = cand[indeg[cand] == 0]
    if seen != d:
        # cycle in "DAG" — impossible after SCC condensation
        raise AssertionError("condensation contained a cycle")
    return level


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
