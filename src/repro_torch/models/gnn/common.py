"""Shared GNN substrate (the port of ``repro.models.gnn.common``):
segment message passing, radial bases, the batch format.

Message passing is built on segment reductions over edge-index arrays:
a segment sum is ``index_add`` onto zeros (out of place, so autograd
follows it), a segment max ``scatter_reduce("amax")`` onto ``-inf``
(the reference's ``jax.ops.segment_max`` value for an empty segment).
Unlike ``jax.ops.segment_sum``, which drops an id outside ``[0, n)``,
``index_add`` raises on one; every padding the batches make points
inside the range (a masked edge at node 0 or at the last node, a masked
triplet at edge 0).

Single-graph batch format (a dict of tensors on one device):

    pos       (N, 3) float32 | feat (N, F) float32 | species (N,) int
    edge_src  (E,) int
    edge_dst  (E,) int
    edge_mask (E,) bool       padding edges
    node_mask (N,) bool

Batched molecules, ``(B, n, ...)`` arrays, are flattened by
:func:`flatten_molecules` into one disjoint graph of ``B * n`` nodes
with ``graph`` (N,) naming each node's molecule; the reference
``jax.vmap``s the single-graph model over the molecules instead.

**A graph split over the data ranks** (:class:`GraphSplit`).  The
reference places a full graph's node and edge arrays ``P(data)`` and
leaves GSPMD to move what each step needs; here the moves are explicit.
Each rank holds its block of the nodes and its block of the edges (and
of DimeNet's triplets); the edge ids stay global node ids (``id_kj``
and ``id_ji`` global edge ids):

* ``gather``: the node rows a rank's edges read, and one level down
  the edge rows (geometry, messages) DimeNet's triplets read, are
  gathered over ``data`` (``collectives.gather_sum``: backward, each
  rank's cotangent summed and cut back to the blocks);
* ``to_nodes`` / ``to_edges``: each rank sums its edges into all nodes
  (its triplets into all edges), and a reduce-scatter returns the sums
  to the blocks (backward, the blocks' cotangents gathered);
* ``softmax``: an edge softmax over destinations takes its maximum over
  ``data`` (no gradient: the softmax does not depend on it) and sums
  the ranks' partial denominators;
* ``total``: a readout's or a masked mean's partial sums completed over
  ``data`` before anything divides them.

A batch of molecules split over ``data`` holds whole molecules on each
rank, so its graph is local (``GraphSplit`` with no axes) and only its
loss's mean crosses.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ...distributed import collectives as CO
from ..nn import DATA

# keys of a batched-molecule dict that hold node ids, edge ids, and
# per-node or per-edge values
_NODE_IDS = ("edge_src", "edge_dst")
_EDGE_IDS = ("id_kj", "id_ji")


def seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, idx, x)


def seg_mean(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    s = seg_sum(x, idx, n)
    c = seg_sum(x.new_ones((x.shape[0], 1)), idx, n)
    return s / torch.clamp(c, min=1.0)


def seg_max(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    index = idx.long().view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return x.new_full((n,) + tuple(x.shape[1:]), float("-inf")) \
        .scatter_reduce(0, index, x, "amax", include_self=False)


def seg_softmax(scores: torch.Tensor, idx: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Edge-softmax (GAT-style): normalise scores within each dst
    segment."""
    m = seg_max(scores, idx, n)
    e = torch.exp(scores - m[idx])
    z = seg_sum(e, idx, n)
    return e / torch.clamp(z[idx], min=1e-9)


def edge_vectors(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """(vec (E,3), dist (E,)): r_ji = x_j - x_i for edge j->i (message
    direction src -> dst)."""
    vec = pos[src] - pos[dst]
    dist = torch.sqrt(torch.clamp(torch.sum(vec * vec, -1), min=1e-12))
    return vec, dist


def gaussian_rbf(dist: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """(E, n) Gaussian radial basis on [0, cutoff] (SchNet-style)."""
    mu = torch.linspace(0.0, cutoff, n, dtype=dist.dtype, device=dist.device)
    gamma = n / cutoff
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


def bessel_rbf(dist: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """(E, n) spherical Bessel basis (DimeNet-style) with envelope."""
    d = torch.clamp(dist, min=1e-6)
    freq = torch.arange(1, n + 1, dtype=torch.float32,
                        device=dist.device) * torch.pi
    rb = (2.0 / cutoff) ** 0.5 * torch.sin(freq[None] * d[:, None] / cutoff) \
        / d[:, None]
    return rb * smooth_cutoff(dist, cutoff)[:, None]


def smooth_cutoff(dist: torch.Tensor, cutoff: float, p: int = 6
                  ) -> torch.Tensor:
    """DimeNet polynomial envelope u(d) -> 0 smoothly at d = cutoff."""
    x = torch.clamp(dist / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * x**p + b * x ** (p + 1) + c * x ** (p + 2)


class GraphSplit:
    """How one graph's nodes and edges lie over the ``axes`` of ``mesh``:
    this rank holds ``n_local`` nodes and ``e_local`` edges, the same
    block of each on every rank (no mesh, or no axes: the whole graph)."""

    def __init__(self, mesh, n_local: int, e_local: int,
                 axes: Sequence[str] = DATA):
        self.pm, self.axes = CO.process_mesh(mesh), tuple(axes)
        self.k = CO.axis_size(self.pm, self.axes)       # ranks it spans
        self.n_nodes, self.n_edges = n_local * self.k, e_local * self.k

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every node's (or edge's) row of ``x``, this rank's block of
        them."""
        return CO.gather_sum(x, self.pm, self.axes, 0)

    def to_nodes(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """This rank's node block of the sums of every rank's rows ``x``
        into their (global) node ids ``idx``."""
        return CO.reduce_scatter(seg_sum(x, idx, self.n_nodes), self.pm,
                                 self.axes, 0)

    def to_edges(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The same into (global) edge ids: this rank's edge block."""
        return CO.reduce_scatter(seg_sum(x, idx, self.n_edges), self.pm,
                                 self.axes, 0)

    def softmax(self, scores: torch.Tensor, idx: torch.Tensor
                ) -> torch.Tensor:
        """:func:`seg_softmax` of this rank's edges' ``scores`` within
        each destination node ``idx``, whose edges may lie on every
        rank."""
        m = CO.max_over(seg_max(scores, idx, self.n_nodes), self.pm,
                        self.axes)
        e = torch.exp(scores - m[idx])
        z = self.gather(self.to_nodes(e, idx))
        return e / torch.clamp(z[idx], min=1e-9)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a partial sum of this rank's rows, summed over the
        ranks (backward: the identity)."""
        return CO.reduce_from(x, self.pm, self.axes)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        """A partial count summed over the ranks, no gradient."""
        return CO.all_reduce(x.detach().clone(), self.pm, self.axes)


def masked_graph_readout(node_out: torch.Tensor, node_mask) -> torch.Tensor:
    if node_mask is None:
        return node_out.sum(0)
    return (node_out * node_mask[:, None].to(node_out.dtype)).sum(0)


def graph_readout(node_out: torch.Tensor, batch: Dict, split: GraphSplit
                  ) -> torch.Tensor:
    """The masked sum of ``node_out`` (N, 1) per graph: a scalar for one
    graph (summed over the ranks of ``split``), (B,) for flattened
    molecules (a segment sum over ``batch["graph"]``)."""
    nmask = batch.get("node_mask")
    if nmask is not None:
        node_out = node_out * nmask[:, None].to(node_out.dtype)
    if "graph" not in batch:
        return split.total(node_out.sum())
    return seg_sum(node_out, batch["graph"], batch["n_graphs"])[:, 0]


def graph_split(batch: Dict, mesh) -> GraphSplit:
    """The split of a batch's graph: over the data axes for one graph,
    local for flattened molecules (each rank's molecules are whole)."""
    axes = () if "graph" in batch else DATA
    return GraphSplit(mesh, batch["pos"].shape[0],
                      batch["edge_src"].shape[0], axes)


def flatten_molecules(batch: Dict) -> Dict:
    """B molecules of n nodes and e edges (``(B, n, ...)`` and ``(B, e)``
    tensors) as one disjoint graph: node ids offset by b * n, edge ids
    of triplets (``id_kj``, ``id_ji``) by b * e, every other per-node,
    per-edge or per-triplet array flattened over its first two dims;
    ``graph`` (B * n,) names each node's molecule and ``n_graphs`` is B.
    Per-molecule values (``energy``) stay (B,)."""
    B, n = batch["pos"].shape[:2]
    e = batch["edge_src"].shape[1]
    dev = batch["pos"].device
    out = {"graph": torch.arange(B, device=dev).repeat_interleave(n),
           "n_graphs": B}
    for k, v in batch.items():
        if v.dim() < 2:
            out[k] = v
        elif k in _NODE_IDS:
            out[k] = (v.long() + torch.arange(B, device=dev)[:, None] * n
                      ).reshape(-1)
        elif k in _EDGE_IDS:
            out[k] = (v.long() + torch.arange(B, device=dev)[:, None] * e
                      ).reshape(-1)
        else:
            out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
    return out
