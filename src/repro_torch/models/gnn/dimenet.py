"""DimeNet (Klicpera et al., 2020) — directional message passing (the
port of ``repro.models.gnn.dimenet``).

Assigned config: 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6.  For each pair of incident edges (k->j, j->i) the angle
∠(kji) feeds a spherical basis that modulates message m_kj before it is
aggregated into m_ji.  Triplet index lists (id_kj, id_ji) are built on
the host (``build_triplets``) to a static padded budget.

The output block sums every edge's message into its destination, masked
edges included, as the reference's does (ROADMAP R11): a masked edge's
message comes from ``msg_init`` and is not zero.  Split over ``data``,
a masked edge on any rank still adds its message, as it does there.

Under a process mesh (``mesh``) the MLPs and the species table follow
``mlp_param_spec``'s blocks over ``model`` (``nn``; ``bilin`` and the
projections stay whole), and one graph's nodes, edges and triplets are
split over ``data`` (``common.GraphSplit``): the node rows and the
edge rows (geometry, ``down``'s messages) that a rank's edges and
triplets read are gathered, the triplets' sums returned to the edge
blocks and the edges' sums to the node blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..nn import Params, data_mean, dense, dense_init, embed_init
from ..nn import local_tree, lookup, mlp, mlp_init, tree_to
from .common import bessel_rbf, edge_vectors, flatten_molecules
from .common import graph_readout, graph_split


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 10.0
    n_species: int = 100
    d_feat: Optional[int] = None


def build_triplets(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, budget: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side triplet enumeration: pairs (edge kj, edge ji) with
    kj.dst == ji.src and kj.src != ji.dst, ordered by ji, then kj (the
    reference's loop order).  Returns (id_kj, id_ji, mask) padded with
    (0, 0) or truncated to ``budget``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    E = len(src)
    by_dst = np.argsort(dst, kind="stable")          # edges grouped by dst
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    count = np.bincount(dst, minlength=n)
    start = np.cumsum(count) - count
    per_ji = count[src]                              # e_kj candidates of e_ji
    ji = np.repeat(np.arange(E), per_ji)
    offs = np.arange(len(ji)) - np.repeat(np.cumsum(per_ji) - per_ji, per_ji)
    kj = by_dst[start[src[ji]] + offs]
    keep = src[kj] != dst[ji]
    kj, ji = kj[keep][:budget], ji[keep][:budget]
    mask = np.zeros(budget, dtype=bool)
    mask[: len(kj)] = True
    out_kj = np.zeros(budget, dtype=np.int32)
    out_ji = np.zeros(budget, dtype=np.int32)
    out_kj[: len(kj)] = kj
    out_ji[: len(ji)] = ji
    return out_kj, out_ji, mask


def _angular_basis(cos_angle: torch.Tensor, dist_kj: torch.Tensor,
                   cfg: DimeNetConfig) -> torch.Tensor:
    """(T, n_spherical * n_radial) joint basis: Chebyshev in the angle x
    Bessel in the radius."""
    t = torch.clamp(cos_angle, -1.0, 1.0)
    cheb = [torch.ones_like(t), t]
    for _ in range(cfg.n_spherical - 2):
        cheb.append(2 * t * cheb[-1] - cheb[-2])
    ang = torch.stack(cheb[: cfg.n_spherical], dim=-1)         # (T, S)
    rad = bessel_rbf(dist_kj, cfg.n_radial, cfg.cutoff)        # (T, R)
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        -1, cfg.n_spherical * cfg.n_radial)


def _draw(generator: torch.Generator, cfg: DimeNetConfig) -> Params:
    d = cfg.d_hidden
    nsr = cfg.n_spherical * cfg.n_radial
    p: Params = {
        "embed": embed_init(generator, cfg.n_species, d),
        "rbf_proj": dense_init(generator, cfg.n_radial, d, bias=False),
        "msg_init": mlp_init(generator, (3 * d, d)),
        "out_final": mlp_init(generator, (d, d // 2, 1)),
    }
    if cfg.d_feat is not None:
        p["enc"] = dense_init(generator, cfg.d_feat, d)
    for b in range(cfg.n_blocks):
        p[f"blk{b}"] = {
            "sbf_proj": dense_init(generator, nsr, cfg.n_bilinear,
                                   bias=False),
            "down": dense_init(generator, d, cfg.n_bilinear, bias=False),
            "bilin": torch.randn((cfg.n_bilinear, cfg.n_bilinear, d),
                                 generator=generator)
            * (1.0 / cfg.n_bilinear),
            "msg_mlp": mlp_init(generator, (d, d, d)),
            "out": mlp_init(generator, (d, d)),
        }
    return p


def init_params(generator: torch.Generator, cfg: DimeNetConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn on the CPU from ``generator``, then moved
    to ``device`` (``None``: the GPU)."""
    return tree_to(_draw(generator, cfg), resolve_device(device))


def param_shapes(cfg: DimeNetConfig) -> Params:
    """The parameters as ``meta`` tensors (no storage)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


def dense0(p, x, mesh=None):
    return mlp(p, x, act="silu", final_act="silu", mesh=mesh)


def apply(params: Params, batch: Dict, cfg: DimeNetConfig, mesh=None
          ) -> torch.Tensor:
    """The graph's scalar (energy); (B,) for flattened molecules."""
    params = local_tree(params)
    g = graph_split(batch, mesh)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    id_kj, id_ji = batch["id_kj"].long(), batch["id_ji"].long()
    tmask = batch["triplet_mask"]

    vec, dist = edge_vectors(g.gather(batch["pos"]), src, dst)
    rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff)
    if emask is not None:
        rbf = rbf * emask[:, None].to(rbf.dtype)
    rbf_h = dense(params["rbf_proj"], rbf)      # (E, d)

    if cfg.d_feat is not None:
        hnode = dense(params["enc"], batch["feat"])
    else:
        hnode = lookup(params["embed"]["emb"], batch["species"],
                       cfg.n_species, mesh)
    hnode = g.gather(hnode)
    m = mlp(
        params["msg_init"],
        torch.cat([hnode[src], hnode[dst], rbf_h], -1),
        act="silu", final_act="silu", mesh=mesh,
    )                                            # (E, d)

    # triplet geometry: angle between edge ji (j->i) and kj (k->j)
    vec_all, dist_all = g.gather(vec), g.gather(dist)
    v_ji = vec_all[id_ji]
    v_kj = -vec_all[id_kj]                      # orient k->j at node j
    cosang = torch.sum(v_ji * v_kj, -1) / torch.clamp(
        torch.linalg.vector_norm(v_ji, dim=-1)
        * torch.linalg.vector_norm(v_kj, dim=-1), min=1e-9)
    sbf = _angular_basis(cosang, dist_all[id_kj], cfg)
    sbf = sbf * tmask[:, None].to(sbf.dtype)

    nb = cfg.n_bilinear
    out_acc = m.new_zeros((batch["pos"].shape[0], cfg.d_hidden))
    for b in range(cfg.n_blocks):
        bp = params[f"blk{b}"]
        sb = dense(bp["sbf_proj"], sbf)                   # (T, nb)
        mk = g.gather(dense(bp["down"], m))[id_kj]         # (T, nb)
        # einsum("tb,tc,bcd->td"): the outer product, then one matmul
        tr = (sb[:, :, None] * mk[:, None, :]).reshape(-1, nb * nb) \
            @ bp["bilin"].reshape(nb * nb, -1)
        agg = g.to_edges(tr, id_ji)                       # (E, d)
        m = m + mlp(bp["msg_mlp"], m * rbf_h + agg, act="silu", mesh=mesh)
        out_acc = out_acc + g.to_nodes(dense0(bp["out"], m, mesh), dst)
    out = mlp(params["out_final"], out_acc, act="silu", mesh=mesh)  # (N, 1)
    return graph_readout(out, batch, g)


def loss_fn(params: Params, batch: Dict, cfg: DimeNetConfig, mesh=None
            ) -> torch.Tensor:
    """Batched-molecule MSE over ``(B, n, ...)`` molecules (under a mesh
    this rank's molecules, the mean over all of them)."""
    pred = apply(params, flatten_molecules(batch), cfg, mesh)
    return data_mean((pred - batch["energy"]) ** 2, mesh)
