"""Geosocial graph container and CSR utilities.

A geosocial graph G = (V, E, delta) is a directed graph where a subset of
vertices carry a 2-D coordinate (the *spatial* vertices, "venues" in LBSN
terms) and the rest are purely social ("users").

Everything is stored as dense arrays so the structure is jit-able,
shardable and checkpointable:

  n_nodes        int
  edges          (m, 2) int32   directed (src, dst)
  coords         (n, 2) float32 coordinates; undefined rows for non-spatial
  spatial_mask   (n,)   bool    True where delta(v) != bottom

CSR adjacency is built host-side (NumPy) once and reused by every index
build; the arrays themselves can be moved to device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed sparse row adjacency: neighbours of u are
    ``indices[indptr[u]:indptr[u+1]]``."""

    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (m,)  int32

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return len(self.indices)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def build_csr(n: int, edges: np.ndarray, reverse: bool = False) -> CSR:
    """Build CSR adjacency from an (m, 2) edge array.

    ``reverse=True`` builds the transpose (in-edges).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src = edges[:, 1] if reverse else edges[:, 0]
    dst = edges[:, 0] if reverse else edges[:, 1]
    order = np.argsort(src, kind="stable")
    src_sorted = src[order]
    indices = dst[order].astype(np.int32)
    counts = np.bincount(src_sorted, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=indptr, indices=indices)


@dataclasses.dataclass
class GeosocialGraph:
    """Dense-array geosocial graph.

    Attributes
    ----------
    n_nodes:      number of vertices.
    edges:        (m, 2) int32 directed edges (src, dst). Deduplicated,
                  no self-loops required (they are harmless).
    coords:       (n, 2) float32; rows of non-spatial vertices are 0 and
                  must not be read (mask with ``spatial_mask``).
    spatial_mask: (n,) bool.
    """

    n_nodes: int
    edges: np.ndarray
    coords: np.ndarray
    spatial_mask: np.ndarray
    _csr: Optional[CSR] = dataclasses.field(default=None, repr=False)
    _csr_rev: Optional[CSR] = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.edges = np.asarray(self.edges, dtype=np.int32).reshape(-1, 2)
        self.coords = np.asarray(self.coords, dtype=np.float32).reshape(-1, 2)
        self.spatial_mask = np.asarray(self.spatial_mask, dtype=bool).reshape(-1)
        assert self.coords.shape[0] == self.n_nodes, (self.coords.shape, self.n_nodes)
        assert self.spatial_mask.shape[0] == self.n_nodes
        if self.edges.size:
            assert self.edges.min() >= 0 and self.edges.max() < self.n_nodes

    # -- derived views -------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n_spatial(self) -> int:
        return int(self.spatial_mask.sum())

    @property
    def spatial_ids(self) -> np.ndarray:
        return np.nonzero(self.spatial_mask)[0].astype(np.int32)

    @property
    def csr(self) -> CSR:
        if self._csr is None:
            self._csr = build_csr(self.n_nodes, self.edges)
        return self._csr

    @property
    def csr_rev(self) -> CSR:
        if self._csr_rev is None:
            self._csr_rev = build_csr(self.n_nodes, self.edges, reverse=True)
        return self._csr_rev

    def out_degree(self) -> np.ndarray:
        deg = np.zeros(self.n_nodes, dtype=np.int64)
        if self.edges.size:
            np.add.at(deg, self.edges[:, 0], 1)
        return deg

    def spatial_extent(self) -> np.ndarray:
        """Global MBR of all spatial vertices: [xmin, ymin, xmax, ymax]."""
        pts = self.coords[self.spatial_mask]
        if pts.size == 0:
            return np.array([0.0, 0.0, 0.0, 0.0], dtype=np.float32)
        return np.array(
            [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()],
            dtype=np.float32,
        )

    # -- subgraphs -----------------------------------------------------
    def social_subgraph_edges(self) -> np.ndarray:
        """Edges whose endpoints are both non-spatial (the social subgraph).

        Used by the compressed variants: the SCC decomposition runs on this
        subgraph only; spatial sinks never participate in cycles in the LBSN
        data model (venues have no outgoing edges), and in the general data
        model only spatial vertices *without outgoing edges* are excluded
        (see ``spatial_sink_mask``).
        """
        keep = ~(
            self.spatial_mask[self.edges[:, 0]]
            | self.spatial_mask[self.edges[:, 1]]
        )
        return self.edges[keep]

    def spatial_sink_mask(self) -> np.ndarray:
        """Spatial vertices with no outgoing edges (safe to exclude from the
        SCC decomposition — they can never be on a cycle and their
        reachable set is exactly themselves)."""
        return self.spatial_mask & (self.out_degree() == 0)

    def validate(self) -> None:
        assert np.isfinite(self.coords[self.spatial_mask]).all()


def dedup_edges(edges: np.ndarray) -> np.ndarray:
    """Sort + dedup an (m, 2) edge array; drops exact duplicates."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        return edges.astype(np.int32)
    key = edges[:, 0] << 32 | edges[:, 1]
    uniq = np.unique(key)
    out = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1)
    return out.astype(np.int32)


def make_graph(
    n_nodes: int,
    edges: np.ndarray,
    coords: Optional[np.ndarray] = None,
    spatial_mask: Optional[np.ndarray] = None,
) -> GeosocialGraph:
    if coords is None:
        coords = np.zeros((n_nodes, 2), dtype=np.float32)
    if spatial_mask is None:
        spatial_mask = np.zeros(n_nodes, dtype=bool)
    return GeosocialGraph(
        n_nodes=n_nodes,
        edges=dedup_edges(edges),
        coords=coords,
        spatial_mask=spatial_mask,
    )
