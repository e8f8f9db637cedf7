"""Strongly connected component decomposition (host path).

A copy of the host half of ``repro.core.scc``: ``scc_np`` (scipy's
Tarjan-class C code, used by every index build) and ``compact_labels``.
The device trim + colouring SCC is not part of the port yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


def scc_np(n: int, edges: np.ndarray) -> np.ndarray:
    """SCC labels via scipy (Tarjan-class). Returns (n,) int32 labels in
    [0, n_comps); no ordering of the labels is relied upon downstream."""
    edges = np.asarray(edges).reshape(-1, 2)
    if edges.size == 0:
        return np.arange(n, dtype=np.int32)
    data = np.ones(len(edges), dtype=np.int8)
    adj = sp.csr_matrix((data, (edges[:, 0], edges[:, 1])), shape=(n, n))
    _, labels = csgraph.connected_components(adj, directed=True, connection="strong")
    return labels.astype(np.int32)


def compact_labels(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    """Renumber arbitrary labels to dense [0, d). Returns (labels, d)."""
    uniq, dense = np.unique(np.asarray(labels), return_inverse=True)
    return dense.astype(np.int32), int(len(uniq))
