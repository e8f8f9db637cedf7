"""Delta overlay: the mutable side of a `DynamicIndex` (the port of
``repro.dynamic.overlay``; host NumPy over the port's packed R-tree).

The overlay absorbs online mutations between compactions:

* **edge buffer** — append-only list of delta edges (src, dst) over both
  base and newly added vertices.
* **spatial staging set** — vertices that acquired a coordinate since the
  last compaction (new venues / check-ins), indexed by its own small
  packed R-tree (rebuilt lazily; the set is bounded by the compaction
  policy so the rebuild is O(overlay), not O(graph)).
* **union-find over condensation components** — DAGGER-style (Yildirim
  et al.) incremental SCC maintenance: when a delta edge (s, t) closes a
  cycle (t already reached s), the two endpoint components collapse into
  one group.  Groups are *sound* (members are mutually reachable in the
  mutated graph) but lazily completed: components strictly inside the
  new cycle merge when a later delta edge touches them.  Queries treat a
  reached group as "every member reached", which is all correctness
  needs.

Elements of the union-find are ``0 .. d_base-1`` for base condensation
components and ``d_base + (v - n_base)`` for vertices added after the
base snapshot (each new vertex starts as its own pseudo-component).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.rtree import RTreeForest, build_forest, intersects


class UnionFind:
    """Union-find with path halving, union by size and explicit group
    member lists (needed to expand "reached group -> reached members")."""

    def __init__(self, n: int) -> None:
        self.parent = list(range(n))
        self.size = [1] * n
        # member lists only materialised for non-singleton groups
        self._members: Dict[int, List[int]] = {}
        self.n_unions = 0

    def add(self) -> int:
        e = len(self.parent)
        self.parent.append(e)
        self.size.append(1)
        return e

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        ma = self._members.pop(ra, [ra])
        mb = self._members.pop(rb, [rb])
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        self._members[ra] = ma + mb
        self.n_unions += 1
        return True

    def group(self, x: int) -> List[int]:
        """All elements in x's group (x itself when singleton)."""
        return self._members.get(self.find(x), [x])


class SpatialStaging:
    """Per-update spatial staging set with its own small R-tree.

    ``add`` is O(1); the packed tree is rebuilt lazily on the next probe
    (the staging set is small by construction — the compaction policy
    bounds it)."""

    def __init__(self) -> None:
        self.ids: List[int] = []
        self.xs: List[float] = []
        self.ys: List[float] = []
        self._id_set: set = set()
        self._forest: Optional[RTreeForest] = None
        self._dirty = False

    def __len__(self) -> int:
        return len(self.ids)

    def __contains__(self, v: int) -> bool:
        return int(v) in self._id_set

    def add(self, v: int, x: float, y: float) -> None:
        self.ids.append(int(v))
        self.xs.append(float(x))
        self.ys.append(float(y))
        self._id_set.add(int(v))
        self._dirty = True

    def coords_of(self) -> np.ndarray:
        return np.stack(
            [np.asarray(self.xs, np.float32), np.asarray(self.ys, np.float32)],
            axis=1,
        ) if self.ids else np.zeros((0, 2), np.float32)

    def _tree(self) -> Optional[RTreeForest]:
        if self._dirty:
            pts = self.coords_of()
            boxes = np.concatenate([pts, pts], axis=1)
            self._forest = build_forest(
                boxes,
                np.asarray(self.ids, np.int32),
                np.zeros(len(self.ids), np.int64),
                n_trees=1,
            )
            self._dirty = False
        return self._forest

    def candidates_in(self, rect: np.ndarray) -> np.ndarray:
        """Staged vertex ids whose coordinate lies inside ``rect``."""
        if not self.ids:
            return np.zeros(0, dtype=np.int32)
        forest = self._tree()
        rect = np.asarray(rect, dtype=np.float32)
        s, e = forest.entry_off[0], forest.entry_off[1]
        ok = intersects(forest.entries[s:e], rect, dim=2)
        return forest.entry_ids[s:e][ok]

    def nbytes(self) -> int:
        fixed = 16 * len(self.ids)  # id + 2 coords + slack
        return fixed + (self._forest.nbytes_total() if self._forest else 0)


class DeltaOverlay:
    """Mutable overlay state between two compactions."""

    def __init__(self, n_base: int, d_base: int) -> None:
        self.n_base = n_base          # vertices in the base snapshot
        self.d_base = d_base          # components in the base condensation
        self.n_nodes = n_base         # grows with add_vertex
        self.edges: List[Tuple[int, int]] = []
        self.staging = SpatialStaging()
        self.uf = UnionFind(d_base)
        self.n_scc_merges = 0

    # -- element mapping ---------------------------------------------------
    def elem_of_vertex(self, v: int, base_comp: np.ndarray) -> int:
        """Union-find element for vertex v."""
        if v < self.n_base:
            return int(base_comp[v])
        return self.d_base + (v - self.n_base)

    def add_vertex(self) -> int:
        v = self.n_nodes
        self.n_nodes += 1
        self.uf.add()
        return v

    def add_edge(self, s: int, t: int) -> None:
        self.edges.append((int(s), int(t)))

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_staged(self) -> int:
        return len(self.staging)

    @property
    def n_new_vertices(self) -> int:
        return self.n_nodes - self.n_base

    def is_empty(self) -> bool:
        return not self.edges and not len(self.staging) \
            and self.n_nodes == self.n_base

    def nbytes(self) -> int:
        return 16 * len(self.edges) + self.staging.nbytes() \
            + 16 * len(self.uf.parent)
