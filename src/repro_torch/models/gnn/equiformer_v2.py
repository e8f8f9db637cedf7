"""EquiformerV2 (Liao et al., 2023) — equivariant graph attention via
eSCN SO(2) convolutions (the port of ``repro.models.gnn.equiformer_v2``).

Assigned config: 12 layers, d_hidden=128 channels, l_max=6, m_max=2,
8 heads.  Node features are real-SH irrep stacks (N, (l_max+1)^2, C).
Per edge, features are rotated into the edge-aligned frame (Wigner-D from
``so3``), mixed by an SO(2) linear map that couples only equal |m| and
truncates at m_max, gated by invariant attention weights (segment
softmax over destinations), rotated back and aggregated.  Node update =
equivariant RMS norm + scalar-gated FFN.

The reference's in-place updates (``.at[...].set`` in the SO(2)
convolution, ``.at[:, 0, :].add`` in the FFN) are out-of-place writes
here (``index_copy``, a concatenation), which autograd follows.  A
masked edge's attention logit is -1e30, as the reference's.

Under a process mesh (``mesh``) the MLPs (``rad``, ``attn``,
``ffn_gate``, ``ffn_scalar``, ``out``) and the species table follow
``mlp_param_spec``'s blocks over ``model`` (``nn``; the ``so2_*`` maps
stay whole, as the rule keeps them), and one graph's nodes and edges
are split over ``data`` (``common.GraphSplit``): the normed node
features each rank's edges read are gathered, the attention's softmax
takes its maximum and denominators over the ranks, and the messages are
summed back to the node blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..nn import Params, data_mean, dense, dense_init, embed_init
from ..nn import local_tree, lookup, mlp, mlp_init, tree_to
from .common import bessel_rbf, edge_vectors, flatten_molecules
from .common import graph_readout, graph_split
from .so3 import rot_to_z, wigner_d_stack


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 10.0
    n_species: int = 100
    d_feat: Optional[int] = None

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


def _l_slices(l_max: int):
    """[(start, l)] offsets of each l block in the (l_max+1)^2 stack."""
    out, s = [], 0
    for l in range(l_max + 1):
        out.append((s, l))
        s += 2 * l + 1
    return out


def _m0_index(l_max: int) -> np.ndarray:
    """Coefficient indices with m == 0 (one per l)."""
    return np.array([s + l for s, l in _l_slices(l_max)], dtype=np.int64)


def _m_pairs(l_max: int, m: int) -> np.ndarray:
    """(n_l, 2) index pairs (+m, -m) over all l >= m."""
    idx = []
    for s, l in _l_slices(l_max):
        if l >= m:
            idx.append((s + l + m, s + l - m))
    return np.array(idx, dtype=np.int64)


def _draw(generator: torch.Generator, cfg: EquiformerV2Config) -> Params:
    C, L = cfg.d_hidden, cfg.l_max
    n_l = L + 1
    p: Params = {}
    if cfg.d_feat is not None:
        p["enc"] = dense_init(generator, cfg.d_feat, C)
    else:
        p["embed"] = embed_init(generator, cfg.n_species, C)
    for i in range(cfg.n_layers):
        lp: Params = {
            # SO(2) m=0 block: mixes (l, C) jointly
            "so2_m0": dense_init(generator, n_l * C, n_l * C, bias=False,
                                 scale=(1.0 / (n_l * C)) ** 0.5),
            "rad": mlp_init(generator, (cfg.n_rbf, C, C)),
            "attn": mlp_init(generator, (C + C, C, cfg.n_heads)),
            "ffn_gate": mlp_init(generator, (C, C, n_l * C)),
            "ffn_scalar": mlp_init(generator, (C, C, C)),
        }
        for m in range(1, cfg.m_max + 1):
            nl = L + 1 - m
            for part in ("r", "i"):
                lp[f"so2_m{m}_{part}"] = dense_init(
                    generator, nl * C, nl * C, bias=False,
                    scale=(1.0 / (nl * C)) ** 0.5)
        p[f"layer{i}"] = lp
    p["out"] = mlp_init(generator, (C, C, 1))
    return p


def init_params(generator: torch.Generator, cfg: EquiformerV2Config,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn on the CPU from ``generator``, then moved
    to ``device`` (``None``: the GPU)."""
    return tree_to(_draw(generator, cfg), resolve_device(device))


def param_shapes(cfg: EquiformerV2Config) -> Params:
    """The parameters as ``meta`` tensors (no storage)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


def _equiv_norm(x: torch.Tensor, l_max: int, eps: float = 1e-6):
    """RMS-normalise each l block over (m, C)."""
    outs = []
    for s, l in _l_slices(l_max):
        blk = x[:, s: s + 2 * l + 1, :]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True)
                         + eps)
        outs.append(blk / rms)
    return torch.cat(outs, dim=1)


def _rotate(x: torch.Tensor, D: List[torch.Tensor], l_max: int,
            transpose: bool = False) -> torch.Tensor:
    """x (E, K, C) rotated per l-block by D[l] (E, 2l+1, 2l+1)."""
    outs = []
    for s, l in _l_slices(l_max):
        blk = x[:, s: s + 2 * l + 1, :]
        d = D[l].transpose(1, 2) if transpose else D[l]
        outs.append(torch.bmm(d, blk))
    return torch.cat(outs, dim=1)


def _so2_conv(lp: Params, x: torch.Tensor, cfg: EquiformerV2Config):
    """SO(2) linear in the edge-aligned frame; zero output for m >
    m_max."""
    E, K, C = x.shape
    L = cfg.l_max

    def idx(a):
        return torch.as_tensor(a, device=x.device)

    # m = 0
    i0 = idx(_m0_index(L))
    y0 = dense(lp["so2_m0"], x[:, i0, :].reshape(E, -1))
    out = torch.zeros_like(x).index_copy(1, i0, y0.reshape(E, L + 1, C))
    # m >= 1 pairs
    for m in range(1, cfg.m_max + 1):
        pairs = _m_pairs(L, m)
        ip, im = idx(pairs[:, 0]), idx(pairs[:, 1])
        xp = x[:, ip, :].reshape(E, -1)
        xm = x[:, im, :].reshape(E, -1)
        wr, wi = lp[f"so2_m{m}_r"], lp[f"so2_m{m}_i"]
        yp = dense(wr, xp) - dense(wi, xm)
        ym = dense(wi, xp) + dense(wr, xm)
        out = out.index_copy(1, ip, yp.reshape(E, len(pairs), C))
        out = out.index_copy(1, im, ym.reshape(E, len(pairs), C))
    return out


def apply(params: Params, batch: Dict, cfg: EquiformerV2Config, mesh=None
          ) -> torch.Tensor:
    """The graph's scalar (energy); (B,) for flattened molecules."""
    params = local_tree(params)
    g = graph_split(batch, mesh)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    N = batch["pos"].shape[0]
    K, C, L = cfg.n_coef, cfg.d_hidden, cfg.l_max

    if cfg.d_feat is not None:
        scal = dense(params["enc"], batch["feat"])
    else:
        scal = lookup(params["embed"]["emb"], batch["species"],
                      cfg.n_species, mesh)
    x = torch.cat([scal[:, None, :], scal.new_zeros((N, K - 1, C))], 1)

    vec, dist = edge_vectors(g.gather(batch["pos"]), src, dst)
    dirs = vec / torch.clamp(dist[:, None], min=1e-9)
    rot = rot_to_z(dirs)
    D = wigner_d_stack(rot, L)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
    if emask is not None:
        rbf = rbf * emask[:, None].to(rbf.dtype)

    Hh = cfg.n_heads
    for i in range(cfg.n_layers):
        lp = params[f"layer{i}"]
        xn = g.gather(_equiv_norm(x, L))
        # message in edge frame
        xe = _rotate(xn[src], D, L)                       # (E, K, C)
        radial = mlp(lp["rad"], rbf, act="silu", mesh=mesh)   # (E, C)
        xe = xe * radial[:, None, :]
        me = _so2_conv(lp, xe, cfg)
        # invariant attention (m=0 scalars of message + receiver scalars)
        inv = torch.cat([me[:, 0, :], xn[dst][:, 0, :]], -1)
        logits = mlp(lp["attn"], inv, act="silu", mesh=mesh)  # (E, H)
        if emask is not None:
            logits = torch.where(emask[:, None], logits, -1e30)
        alpha = g.softmax(logits, dst)                     # (E, H)
        me = me.reshape(me.shape[0], K, Hh, C // Hh)
        me = me * alpha[:, None, :, None]
        me = me.reshape(me.shape[0], K, C)
        if emask is not None:
            me = me * emask[:, None, None].to(me.dtype)
        me = _rotate(me, D, L, transpose=True)             # back to global
        x = x + g.to_nodes(me, dst)
        # scalar-gated equivariant FFN
        xn = _equiv_norm(x, L)
        s = mlp(lp["ffn_scalar"], xn[:, 0, :], act="silu", mesh=mesh)
        gates = torch.sigmoid(
            mlp(lp["ffn_gate"], xn[:, 0, :], act="silu", mesh=mesh)
        ).reshape(N, L + 1, C)
        gate_full = torch.repeat_interleave(
            gates, torch.as_tensor([2 * l + 1 for l in range(L + 1)],
                                   device=gates.device),
            dim=1, output_size=K)
        x = x + xn * gate_full
        x = torch.cat([x[:, :1, :] + s[:, None, :], x[:, 1:, :]], 1)

    out = mlp(params["out"], x[:, 0, :], act="silu", mesh=mesh)  # (N, 1)
    return graph_readout(out, batch, g)


def loss_fn(params: Params, batch: Dict, cfg: EquiformerV2Config,
            mesh=None) -> torch.Tensor:
    """Batched-molecule MSE over ``(B, n, ...)`` molecules (under a mesh
    this rank's molecules, the mean over all of them)."""
    pred = apply(params, flatten_molecules(batch), cfg, mesh)
    return data_mean((pred - batch["energy"]) ** 2, mesh)
