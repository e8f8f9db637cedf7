"""SchNet (Schütt et al., 2017) — continuous-filter convolutions (the
port of ``repro.models.gnn.schnet``).

n_interactions=3, d_hidden=64, rbf=300 Gaussians, cutoff=10 (the assigned
config).  cfconv: filter W(r_ij) from an RBF-MLP, message h_j * W(r_ij),
segment-sum aggregation, atom-wise dense layers with shifted softplus.

A masked edge's RBF is zeroed, as the reference zeroes it; its filter is
``mlp(0)``, zero only while the filter's biases are (ROADMAP R11).

Under a process mesh (``mesh``) the MLPs and the species table follow
``mlp_param_spec``'s blocks over ``model`` (``nn``), and one graph's
nodes and edges are split over ``data`` (``common.GraphSplit``): the
``in2f`` rows a rank's edges read are gathered, each rank's messages
summed back to the node blocks, the readout summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ...device import DeviceLike, resolve_device
from ..nn import Params, data_mean, dense, dense_init, embed_init
from ..nn import local_tree, lookup, mlp, mlp_init, tree_to
from .common import edge_vectors, flatten_molecules, gaussian_rbf
from .common import graph_readout, graph_split


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    d_feat: Optional[int] = None   # set for feature-input graphs (no species)


def _draw(generator: torch.Generator, cfg: SchNetConfig) -> Params:
    d = cfg.d_hidden
    p: Params = {}
    if cfg.d_feat is not None:
        p["enc"] = dense_init(generator, cfg.d_feat, d)
    else:
        p["embed"] = embed_init(generator, cfg.n_species, d)
    for i in range(cfg.n_interactions):
        p[f"int{i}"] = {
            "filter": mlp_init(generator, (cfg.n_rbf, d, d)),
            "in2f": dense_init(generator, d, d, bias=False),
            "f2out": mlp_init(generator, (d, d, d)),
        }
    p["out"] = mlp_init(generator, (d, d // 2, 1))
    return p


def init_params(generator: torch.Generator, cfg: SchNetConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn on the CPU from ``generator``, then moved
    to ``device`` (``None``: the GPU)."""
    return tree_to(_draw(generator, cfg), resolve_device(device))


def param_shapes(cfg: SchNetConfig) -> Params:
    """The parameters as ``meta`` tensors (no storage)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


def apply(params: Params, batch: Dict, cfg: SchNetConfig, mesh=None
          ) -> torch.Tensor:
    """The graph's scalar (energy); (B,) for flattened molecules."""
    params = local_tree(params)
    g = graph_split(batch, mesh)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    if cfg.d_feat is not None:
        h = dense(params["enc"], batch["feat"])
    else:
        h = lookup(params["embed"]["emb"], batch["species"], cfg.n_species,
                   mesh)
    pos = g.gather(batch["pos"])
    _, dist = edge_vectors(pos, src, dst)
    rbf = gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff)
    if emask is not None:
        rbf = rbf * emask[:, None].to(rbf.dtype)
    for i in range(cfg.n_interactions):
        ip = params[f"int{i}"]
        w = mlp(ip["filter"], rbf, act="ssp", final_act="ssp",
                mesh=mesh)                                        # (E, d)
        m = g.gather(dense(ip["in2f"], h))[src] * w
        agg = g.to_nodes(m, dst)
        h = h + mlp(ip["f2out"], agg, act="ssp", mesh=mesh)
    out = mlp(params["out"], h, act="ssp", mesh=mesh)             # (N, 1)
    return graph_readout(out, batch, g)


def loss_fn(params: Params, batch: Dict, cfg: SchNetConfig, mesh=None
            ) -> torch.Tensor:
    """Batched-molecule MSE over ``(B, n, ...)`` molecules (under a mesh
    this rank's molecules, the mean over all of them)."""
    pred = apply(params, flatten_molecules(batch), cfg, mesh)
    return data_mean((pred - batch["energy"]) ** 2, mesh)
