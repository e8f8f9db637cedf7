"""Mixture-of-Experts FFN with expert parallelism (the port of
``repro.models.lm.moe``).

* Routing: softmax over the router's logits in float32, the top ``k``
  experts per token (ties to the lower expert id, as ``lax.top_k``
  breaks them), weights renormalised, and the Switch-style load-balance
  loss.
* Expert compute uses **capacity-packed batched matmuls**: assignments
  are sorted by expert (a stable sort, so capacity drops fall on the
  same assignments as the reference's), each expert gets a fixed row
  budget (``balance_factor`` x its fair share; overflow assignments are
  dropped, as in GShard/Switch), and the expert FFN is one pair of
  ``bmm``.  No (T, E, C) one-hot dispatch tensor is built: packing is a
  scatter of rows, every dropped assignment written to one overflow row
  that is then cut off, and the combine an ``index_add`` of weighted
  rows per token.

Under a process mesh (``launch.mesh.make_process_mesh``) with a
``model`` axis of size tp, the layer is the reference's ``shard_map``
arm, one process a rank: routing is replicated; rank m runs experts
``[m E/tp, (m+1) E/tp)`` and its slice of the shared expert's hidden
dim; one sum over ``model`` completes both partial outputs.  The
crossings carry their own autograd rules (``distributed.collectives``):
``x`` and the router enter by ``copy_to`` and the output and aux leave
by ``reduce_from``, so attention and the residual stream get the same
gradient on every model rank.  With ``data_axes``, ``x`` holds this
rank's rows of a batch split over those axes: capacity comes from the
whole batch's tokens, and the aux loss is data rank 0's, its gradient
that of the ranks' mean (both as the reference computes them, ROADMAP
R13).  Without a mesh, or on a mesh of one device, the local path runs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...distributed import collectives as CO
from ..nn import ACT, Params
from .config import MoESpec


def moe_init(generator: torch.Generator, d_model: int, d_ff_default: int,
             spec: MoESpec, dtype, lead=()) -> Params:
    """Router (float32), packed gate+up ``w_gu`` (E, d, 2f), down ``w_d``
    (E, f, d) and, with shared experts, ``sh_gu`` (d, 2, fs) and
    ``sh_d`` (fs, d); every leaf with the leading shape ``lead``."""
    E, f = spec.n_experts, spec.d_expert
    s = (1.0 / d_model) ** 0.5

    def randn(*shape, dt=dtype):
        return torch.randn((*lead, *shape), generator=generator, dtype=dt)

    p: Params = {
        "router": randn(d_model, E, dt=torch.float32) * s,
        "w_gu": randn(E, d_model, 2 * f) * s,
        "w_d": randn(E, f, d_model) * (1.0 / f) ** 0.5,
    }
    if spec.n_shared:
        fs = (spec.d_shared or d_ff_default) * spec.n_shared
        # gate/up stacked on axis 1, as the reference lays them out for a
        # model-axis split of the last dim
        p["sh_gu"] = randn(d_model, 2, fs) * s
        p["sh_d"] = randn(fs, d_model) * (1.0 / fs) ** 0.5
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The k largest per row, ties to the lower index (a stable sort)."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], e[..., :k]


def _routing(x, router, spec: MoESpec):
    """x (T, d) -> (weights (T, k), experts (T, k), aux_loss)."""
    logits = x.to(torch.float32) @ router                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, e = _top_k(probs, spec.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    E = spec.n_experts
    frac = torch.mean(
        torch.nn.functional.one_hot(e[:, 0], E).to(torch.float32), dim=0)
    imp = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac * imp) * spec.aux_loss_weight
    return w, e, aux


def _expert_ffn_local(x, w, e, w_gu, w_d, spec: MoESpec, e_start: int,
                      e_local: int, cap: int, act: str):
    """Capacity-packed expert compute.

    x (T, d); w/e (T, k) routing; w_gu (E_loc, d, 2f); returns (T, d),
    the contribution of experts ``[e_start, e_start + e_local)``."""
    T, d = x.shape
    k = spec.top_k
    dev = x.device
    flat_e = e.reshape(-1) - e_start                        # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = w.reshape(-1)
    mine = (flat_e >= 0) & (flat_e < e_local)
    sort_key = torch.where(mine, flat_e, e_local)
    order = torch.argsort(sort_key, stable=True)
    se = sort_key[order]
    st = flat_t[order]
    sw = flat_w[order]
    # position within the expert's group -> capacity slot
    # a scatter of ones, not ``bincount``: it has a meta kernel, and
    # integer atomics give the same counts on every device
    group_sizes = torch.zeros(e_local + 1, dtype=torch.int64,
                              device=dev).scatter_add_(
        0, se, torch.ones_like(se))[:e_local]
    group_start = torch.cumsum(group_sizes, 0) - group_sizes
    pos = torch.arange(T * k, device=dev) - group_start[
        torch.clamp(se, max=e_local - 1)]
    keep = (se < e_local) & (pos < cap)
    slot = torch.where(keep, se * cap + pos, e_local * cap)  # overflow row
    # pack: every kept slot is written once; the dropped ones all land
    # on the overflow row, which is cut off
    xb = x.new_zeros((e_local * cap + 1, d)).index_put((slot,), x[st])
    xb = xb[:-1].reshape(e_local, cap, d)
    # expert FFN (GLU)
    gu = torch.bmm(xb, w_gu)
    f = spec.d_expert
    h = ACT[act](gu[..., :f]) * gu[..., f:]
    yb = torch.bmm(h, w_d)
    # unpack + weighted combine
    yflat = yb.reshape(e_local * cap, d)
    contrib = torch.where(
        keep[:, None], yflat[torch.clamp(slot, max=e_local * cap - 1)],
        0.0) * sw[:, None].to(x.dtype)
    return x.new_zeros((T, d)).index_add(0, st, contrib)


def _shared_ffn(x, sh_gu, sh_d, act):
    d, _, fs = sh_gu.shape
    gu = (x @ sh_gu.reshape(d, 2 * fs)).reshape(-1, 2, fs)
    return (ACT[act](gu[:, 0]) * gu[:, 1]) @ sh_d


def _block(w, dim: int, tp: int, m: int, whole: bool) -> torch.Tensor:
    """Rank m's block of ``w`` along ``dim``: cut from ``w`` when it is
    whole, else ``w`` itself (a DTensor's local shard)."""
    w = CO.local(w)
    if not whole:
        return w
    n = w.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} does not split "
                         f"over {tp} ranks")
    return w.narrow(dim, m * (n // tp), n // tp)


def moe_ffn(p: Params, x: torch.Tensor, spec: MoESpec, *, act: str = "silu",
            mesh=None, model_axis: str = "model",
            data_axes: Sequence[str] = ()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (T, d), aux_loss) for x (T, d) tokens.  Under a
    process mesh with ``model_axis``: expert parallelism over it, ``x``
    this rank's rows of a batch split over ``data_axes`` (none: the
    whole batch on every rank)."""
    pm = CO.process_mesh(mesh)
    T, d = x.shape
    E, k = spec.n_experts, spec.top_k
    if pm is None or model_axis not in pm.mesh_dim_names:
        w, e, aux = _routing(x, p["router"], spec)
        cap = max(1, int(spec.balance_factor * T * k / E))
        out = _expert_ffn_local(x, w, e, p["w_gu"], p["w_d"], spec, 0, E,
                                cap, act)
        if "sh_gu" in p:
            out = out + _shared_ffn(x, p["sh_gu"], p["sh_d"], act)
        return out, aux

    tp = CO.axis_size(pm, model_axis)
    m = CO.axis_index(pm, model_axis)
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} ranks")
    e_local = E // tp
    # the parameters come whole (each rank cuts its block) or as this
    # rank's blocks (DTensors, or a trainer's local shards)
    rows = CO.local(p["w_gu"]).shape[0]
    if rows not in (E, e_local):
        raise ValueError(f"w_gu has {rows} experts: neither {E} nor "
                         f"{E}/{tp}")
    whole = rows == E
    if "sh_gu" in p and spec.d_shared:
        want = spec.n_shared * spec.d_shared // (1 if whole else tp)
        got = CO.local(p["sh_d"]).shape[0]
        if got != want:
            raise ValueError(f"sh_d has {got} rows, not {want}: the shared "
                             f"expert comes whole or as this rank's "
                             f"block, as the routed experts do")
    n_rows = T
    for a in data_axes:
        n_rows *= CO.axis_size(pm, a)
    cap = max(1, int(spec.balance_factor * n_rows * k / E))
    x = CO.copy_to(x, pm, model_axis)
    w, e, aux = _routing(
        x, CO.copy_to(CO.local(p["router"]), pm, model_axis), spec)
    out = _expert_ffn_local(
        x, w, e, _block(p["w_gu"], 0, tp, m, whole),
        _block(p["w_d"], 0, tp, m, whole), spec, m * e_local, e_local, cap,
        act)
    if "sh_gu" in p:
        # tensor-parallel shared expert: rank m's slice of the hidden
        # dim; its partial sums complete in the routed output's sum
        out = out + _shared_ffn(x, _block(p["sh_gu"], 2, tp, m, whole),
                                _block(p["sh_d"], 0, tp, m, whole), act)
    out = CO.reduce_from(out, pm, model_axis)
    aux = CO.reduce_from(aux, pm, model_axis) / tp
    for a in data_axes:
        aux = CO.first_of(aux, pm, a)
    return out, aux
