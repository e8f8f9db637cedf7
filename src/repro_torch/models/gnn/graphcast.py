"""GraphCast-style encoder-processor-decoder mesh GNN (Lam et al.,
2022), the port of ``repro.models.gnn.graphcast``.

Assigned config: 16 processor layers, d_hidden=512, sum aggregation,
n_vars=227, mesh refinement 6.  Node/edge MLP encoders with LayerNorm,
interaction-network processor blocks (edge update from [e, h_src,
h_dst], node update from [h, sum_e]), residual connections, an MLP
decoder back to n_vars.  The processor's parameters ``proc`` are stacked
on a leading dim of ``n_layers`` (the reference's ``jax.vmap`` init);
the reference's ``lax.scan`` over them is a loop over that dim.

Under a process mesh (``mesh``) every MLP follows ``mlp_param_spec``'s
blocks over ``model`` (``nn``: its output, and so each LayerNorm's
input, replicated), and one graph's nodes and edges are split over
``data`` (``common.GraphSplit``): the node rows each rank's edges read
gathered, the edges' sums returned to the node blocks, and the masked
loss's sum and count each summed over the ranks before the division.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ...device import DeviceLike, resolve_device
from ..nn import Params, data_mean, layernorm, local_tree, mlp, mlp_init
from ..nn import norm_init, tree_index, tree_to
from .common import GraphSplit, edge_vectors, flatten_molecules
from .common import graph_split


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    aggregator: str = "sum"


def _mlp_ln_init(generator, dims):
    return {"mlp": mlp_init(generator, dims), "ln": norm_init(dims[-1])}


def _mlp_ln(p, x, act="silu", mesh=None):
    return layernorm(p["ln"], mlp(p["mlp"], x, act=act, mesh=mesh))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _draw(generator: torch.Generator, cfg: GraphCastConfig) -> Params:
    d = cfg.d_hidden
    p: Params = {
        "enc_node": _mlp_ln_init(generator, (cfg.n_vars + 3, d, d)),
        "enc_edge": _mlp_ln_init(generator, (4, d, d)),
        "dec": {"mlp": mlp_init(generator, (d, d, cfg.n_vars))},
    }
    p["proc"] = _stack([{
        "edge": _mlp_ln_init(generator, (3 * d, d, d)),
        "node": _mlp_ln_init(generator, (2 * d, d, d)),
    } for _ in range(cfg.n_layers)])
    return p


def init_params(generator: torch.Generator, cfg: GraphCastConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn on the CPU from ``generator``, then moved
    to ``device`` (``None``: the GPU)."""
    return tree_to(_draw(generator, cfg), resolve_device(device))


def param_shapes(cfg: GraphCastConfig) -> Params:
    """The parameters as ``meta`` tensors (no storage)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


def apply(params: Params, batch: Dict, cfg: GraphCastConfig, mesh=None
          ) -> torch.Tensor:
    """feat (N, n_vars), pos (N, 3) -> next-state prediction (N,
    n_vars); under a mesh this rank's nodes'."""
    return _apply(local_tree(params), batch, graph_split(batch, mesh),
                  mesh)


def _apply(params: Params, batch: Dict, g: GraphSplit, mesh):
    pos = batch["pos"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    vec, dist = edge_vectors(g.gather(pos), src, dst)
    efeat = torch.cat([vec, dist[:, None]], dim=-1)
    h = _mlp_ln(params["enc_node"], torch.cat([batch["feat"], pos], -1),
                mesh=mesh)
    e = _mlp_ln(params["enc_edge"], efeat, mesh=mesh)
    fmask = None if emask is None else emask[:, None].to(e.dtype)
    if fmask is not None:
        e = e * fmask
    for i in range(params["proc"]["edge"]["ln"]["scale"].shape[0]):
        lp = tree_index(params["proc"], i)
        hn = g.gather(h)
        eu = _mlp_ln(lp["edge"], torch.cat([e, hn[src], hn[dst]], -1),
                     mesh=mesh)
        if fmask is not None:
            eu = eu * fmask
        e = e + eu
        agg = g.to_nodes(e, dst)
        h = h + _mlp_ln(lp["node"], torch.cat([h, agg], -1), mesh=mesh)
    return batch["feat"] + mlp(params["dec"]["mlp"], h, mesh=mesh)


def loss_fn(params: Params, batch: Dict, cfg: GraphCastConfig, mesh=None
            ) -> torch.Tensor:
    """One graph's masked MSE against ``target`` (under a mesh the
    whole graph's, from this rank's nodes)."""
    g = graph_split(batch, mesh)
    pred = _apply(local_tree(params), batch, g, mesh)
    tgt = batch["target"]
    mask = batch.get("node_mask")
    err = (pred - tgt) ** 2
    if mask is not None:
        err = err * mask[:, None].to(err.dtype)
        count = g.count(mask.sum().to(err.dtype))
        return g.total(err.sum()) / torch.clamp(count * tgt.shape[-1],
                                                 min=1.0)
    return g.total(err.sum()) / (g.n_nodes * tgt.shape[-1])


def molecule_loss(params: Params, batch: Dict, cfg: GraphCastConfig,
                  mesh=None) -> torch.Tensor:
    """The mean over B molecules (``(B, n, ...)`` tensors with ``feat``
    and ``target``) of each one's :func:`loss_fn` (the reference's
    batched loss, ``jax.vmap`` of ``loss_fn``, then the mean); under a
    mesh this rank's molecules, the mean over all of them."""
    B, n = batch["pos"].shape[:2]
    flat = flatten_molecules(batch)
    err = (apply(params, flat, cfg, mesh) - flat["target"]) ** 2
    err = err.reshape(B, n, -1)
    mask = batch.get("node_mask")
    if mask is None:
        return data_mean(err.mean(dim=(1, 2)), mesh)
    err = err * mask[..., None].to(err.dtype)
    return data_mean(err.sum(dim=(1, 2)) / torch.clamp(
        mask.sum(1) * err.shape[-1], min=1.0), mesh)
