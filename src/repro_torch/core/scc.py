"""Strongly connected component decomposition.

Two implementations, tested against each other (the port of
``repro.core.scc``):

* ``scc_np``    — host-side (scipy.sparse.csgraph, Tarjan-class C code),
  a copy of the reference's.  Every index build runs it, as the
  reference's builds do.
* ``scc_torch`` — the reference's device ``scc_jax`` in torch: the
  data-parallel **trim + colouring** algorithm (Orzan 2004 / Slota et
  al. 2014 family):

    1. *Trim*: repeatedly deactivate vertices whose active in-degree or
       out-degree is zero (two ``index_add_`` degree counts a sweep);
       each is a singleton SCC.
    2. *Colouring*: every active vertex starts with its own id as
       colour; forward max-propagation to a fixpoint (a
       ``scatter_reduce`` "amax" a sweep) makes colour[v] the largest id
       that reaches v.  Vertices whose colour is their own id are roots;
       backward propagation restricted to equal colours marks each
       root's SCC (an int32 "amax" scatter: CUDA has no bool one).
       Marked vertices take the root's id as label and leave; trim;
       repeat.

  Each ``lax.while_loop`` of the reference becomes a Python loop whose
  stop test (nothing changed) is one host sync a sweep.

Labels are *representative ids*, not contiguous: ``scc_np``'s are
scipy's component numbers, ``scc_torch``'s the largest vertex id of the
SCC (a trimmed vertex keeps its own id), as ``scc_jax``'s are.  Use
``compact_labels`` for a dense renumbering and ``same_partition`` to
compare two labelings.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

from ..device import DeviceLike, resolve_device


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


# --------------------------------------------------------------------------
# Device path: trim + colouring
# --------------------------------------------------------------------------

def _changed(new: torch.Tensor, old: torch.Tensor) -> bool:
    """The loops' stop test: one host sync."""
    return bool(torch.any(new != old))


def _trim(active, src, dst, edge_valid, counts):
    """Deactivate vertices with zero active in- or out-degree until none
    is left; trimmed vertices keep their own id as label."""
    n = active.shape[0]
    while True:
        counts["trim_sweeps"] += 1
        w = (edge_valid & active[src] & active[dst]).to(torch.int32)
        outd = torch.zeros(n, dtype=torch.int32,
                           device=w.device).index_add_(0, src, w)
        ind = torch.zeros(n, dtype=torch.int32,
                          device=w.device).index_add_(0, dst, w)
        new = active & (outd > 0) & (ind > 0)
        if not _changed(new, active):
            return new
        active = new


def _propagate_max(color, src, dst, live, counts):
    """Forward max-propagation to fixpoint: color[v] = max over live
    in-edges (u, v) of color[u]."""
    while True:
        counts["propagate_sweeps"] += 1
        contrib = torch.where(live, color[src], -1)
        new = color.scatter_reduce(0, dst, contrib, "amax")
        if not _changed(new, color):
            return new
        color = new


def _mark_backward(mark, color, src, dst, live, counts):
    """Backward closure within colour classes: if (u, v) is live, their
    colours are equal and v is marked, mark u; to fixpoint.  ``mark`` is
    int32 0/1."""
    same = live & (color[src] == color[dst])
    while True:
        counts["mark_sweeps"] += 1
        ok = (same & (mark[dst] > 0)).to(torch.int32)
        new = mark.scatter_reduce(0, src, ok, "amax")
        if not _changed(new, mark):
            return new
        mark = new


def scc_torch(n: int, edges: np.ndarray, device: DeviceLike = None,
              counts: Optional[Dict[str, int]] = None) -> np.ndarray:
    """SCC labels on ``device`` (``None``: the GPU), equal to
    ``repro.core.scc.scc_jax``'s: (n,) int32, each the largest vertex id
    of its SCC.  ``counts``, where given, receives the sweeps of each
    loop (``trim_sweeps``, ``propagate_sweeps``, ``mark_sweeps``) and
    the colouring ``rounds``."""
    dev = resolve_device(device)
    c = {"trim_sweeps": 0, "propagate_sweeps": 0, "mark_sweeps": 0,
         "rounds": 0}
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        labels = np.arange(n, dtype=np.int32)
    else:
        e = torch.as_tensor(edges, device=dev)
        src, dst = e[:, 0], e[:, 1]
        edge_valid = src != dst   # self loops are irrelevant to SCCs
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        lab = ids.clone()         # default: singleton = own id
        active = _trim(torch.ones(n, dtype=torch.bool, device=dev), src,
                       dst, edge_valid, c)
        while c["rounds"] < n and bool(torch.any(active)):
            live = edge_valid & active[src] & active[dst]
            color = _propagate_max(torch.where(active, ids, -1), src, dst,
                                   live, c)
            # roots: active vertices whose colour is their own id
            mark = _mark_backward((active & (color == ids)).to(torch.int32),
                                  color, src, dst, live, c) > 0
            # marked vertices join the SCC labelled by their root's id
            lab = torch.where(mark, color, lab)
            active = _trim(active & ~mark, src, dst, edge_valid, c)
            c["rounds"] += 1
        labels = lab.cpu().numpy()
    if counts is not None:
        counts.update(c)
    return labels


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two labelings induce the same partition of [0, n)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    # map each a-label to the b-label of its first occurrence and compare
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    # partitions equal iff the pairing (ai, bi) is a bijection
    pairs = np.unique(np.stack([ai, bi], axis=1), axis=0)
    return (
        len(np.unique(pairs[:, 0])) == len(pairs)
        and len(np.unique(pairs[:, 1])) == len(pairs)
    )
