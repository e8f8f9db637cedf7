"""Decoder-only transformer covering the five assigned LM architectures
(the port of ``repro.models.lm.model``).

Structure:

* Layers are grouped into **segments** (``config.scan_segments``): the
  parameters of a segment's repeating unit (e.g. gemma3's [L,L,L,L,L,G],
  llama4's [dense, MoE]) are stacked on a leading dim of its repeats,
  the layout of the reference's ``jax.vmap`` init, and the forward pass
  loops over that dim where the reference scans.  A segment with one
  repeat has no leading dim.
* Attention: GQA or MLA; global layers use the blockwise flash
  attention, 'L' layers the banded one (O(S*w)); gemma2 softcaps.
* FFN: GLU dense or the MoE of moe.py.
* Loss: chunked cross-entropy (the (B, S, V) logits are never built).
* Decode: per-layer KV caches (ring buffers for SWA layers, the compact
  (c_kv, k_pe) for MLA with weight absorption), ``prefill`` +
  ``decode_step``.  The reference updates its cache functionally and
  leaves XLA to donate the buffers; here the cache is written **in
  place** (a functional copy would move the whole cache, 28 GB at
  long_500k, every step).  The cache's length lives on the host, so a
  step never waits for the card to learn where to write.

Under a process mesh (``launch.mesh.make_process_mesh``, or a
``collectives.CountingMesh``) the layers follow the parameters' layout
leaf by leaf, as ``distributed.sharding.lm_param_spec`` places them:
a split leaf arrives as this rank's block (a DTensor's local shard, or
the block itself), a replicated one whole, and each layer reads which
from the leaf's width.  The Megatron pairing over ``model``:

* attention: the column-split projections (``wq``/``wk``/``wv``, MLA's
  ``wq_b``/``wkv_b``) give this rank's columns.  Where they fall on
  whole heads (``H`` and ``KV`` divide by tp; MLA: ``H``), attention
  runs on this rank's heads; where they do not (a head split between
  ranks), their outputs are gathered over ``model`` and attention runs
  on all heads, replicated.  Either way ``o``'s columns for this rank
  meet the row-split ``wo`` and ``reduce_from`` completes the sum.
  The split projections' input enters by ``copy_to``; the replicated
  ones (``wq_a``, ``wkv_a``, the norms) take it as it is.
* the dense FFN: ``w_gu`` split on ``f``, ``w_d`` on its rows, then
  ``reduce_from``.  The MoE layers run expert-parallel (``moe.py``).
* the embedding split on the vocabulary: each rank looks up the ids in
  its range, zeros for the rest, and ``reduce_from`` sums the parts.
* the head (``lm_head/w`` split on the vocabulary, or tied to the
  embedding): a vocab-parallel cross-entropy (the maximum over
  ``model`` with no gradient, the sum of ``exp`` and the gold logit
  through ``reduce_from``); ``logits`` are gathered whole.

``forward`` and ``lm_loss`` take this rank's rows of a batch split over
the data axes, and the loss is the reference's global mean: the summed
NLL and the token count are summed over them before the division (each
rank's backward gives its rows' share of the gradient).  ``prefill`` and
``decode_step`` serve the rows they are given (the whole batch, or a
data rank's rows) and return whole logits on every rank.  The cache
under a mesh: where the heads fall whole on a rank, each rank keeps its
KV heads' slice of ``k``/``v`` (``KV / tp`` heads); otherwise, and for
MLA's latent ``ckv``/``kpe``, the cache stays whole on every rank
(``init_cache(..., mesh=...)``).  With whole leaves, no mesh, or a
model axis of one, no crossing of ``model`` is made.

Token ids outside ``[-V, V)`` embed as NaN rows and ids in ``[-V, 0)``
wrap, as the reference's ``jnp.take`` answers (``nn.take_rows``).  A
tree's device is its tensors' device; ``init_params`` and
``init_cache`` take ``device`` (``None``: the GPU).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ...device import DeviceLike, resolve_device
from ...distributed import collectives as CO
from ..nn import (ACT, DATA, MODEL, Params, dense, dense_init, embed_init,
                  lookup, norm_init, rmsnorm, scan_blocks, stack_init,
                  take_rows, tree_index, tree_to)
from ..nn import is_block as _is_block
from ..nn import local_tree as _locals
from ..nn import model_of as _model
from ..nn import softcap as _softcap
from .attention import (banded_attention, decode_attention, flash_attention,
                        rope)
from .config import LMConfig
from .moe import moe_ffn, moe_init


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _attn_init(g: torch.Generator, cfg: LMConfig, lead=()) -> Params:
    dt = _dtype(cfg)
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = (1.0 / d) ** 0.5

    def randn(*shape):
        return torch.randn((*lead, *shape), generator=g, dtype=dt)

    if cfg.attn == "mla":
        m = cfg.mla
        qk = m.qk_nope + m.qk_rope
        return {
            "wq_a": randn(d, m.q_lora) * s,
            "q_norm": norm_init(m.q_lora, dt, lead),
            "wq_b": randn(m.q_lora, H * qk) * (1.0 / m.q_lora) ** 0.5,
            "wkv_a": randn(d, m.kv_lora + m.qk_rope) * s,
            "kv_norm": norm_init(m.kv_lora, dt, lead),
            "wkv_b": randn(m.kv_lora, H * (m.qk_nope + m.v_head))
            * (1.0 / m.kv_lora) ** 0.5,
            "wo": randn(H * m.v_head, d) * (1.0 / (H * m.v_head)) ** 0.5,
        }
    return {
        "wq": randn(d, H * dh) * s,
        "wk": randn(d, KV * dh) * s,
        "wv": randn(d, KV * dh) * s,
        "wo": randn(H * dh, d) * (1.0 / (H * dh)) ** 0.5,
    }


def _ffn_init(g: torch.Generator, cfg: LMConfig, lead=()) -> Params:
    dt = _dtype(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gu": torch.randn((*lead, d, 2, f), generator=g, dtype=dt)
        * (1.0 / d) ** 0.5,
        "w_d": torch.randn((*lead, f, d), generator=g, dtype=dt)
        * (1.0 / f) ** 0.5,
    }


def _block_init(g: torch.Generator, cfg: LMConfig, is_moe: bool, lead=()
                ) -> Params:
    dt = _dtype(cfg)
    p = {
        "ln_attn": norm_init(cfg.d_model, dt, lead),
        "attn": _attn_init(g, cfg, lead),
        "ln_ffn": norm_init(cfg.d_model, dt, lead),
    }
    if is_moe:
        p["moe"] = moe_init(g, cfg.d_model, cfg.d_ff, cfg.moe, dt, lead)
    else:
        p["ffn"] = _ffn_init(g, cfg, lead)
    return p


def _draw(g: torch.Generator, cfg: LMConfig) -> Params:
    dt = _dtype(cfg)
    params: Params = {
        "embed": embed_init(g, cfg.vocab, cfg.d_model, dt),
        "ln_f": norm_init(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "w": torch.randn((cfg.d_model, cfg.vocab), generator=g,
                             dtype=dt) * (1.0 / cfg.d_model) ** 0.5}
    for si, (unit, n_rep) in enumerate(cfg.scan_segments()):
        def unit_init(gen, lead=(), unit=unit):
            return {f"u{j}": _block_init(gen, cfg, unit[j][1], lead)
                    for j in range(len(unit))}
        params[f"seg{si}"] = (unit_init(g) if n_rep == 1
                              else stack_init(unit_init, g, n_rep))
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": dense_init(g, 2 * cfg.d_model, cfg.d_model, dt,
                               bias=False),
            "block": _block_init(g, cfg, False),
            "ln": norm_init(cfg.d_model, dt),
        }
    return params


def init_params(generator: torch.Generator, cfg: LMConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device`` (``None``: the GPU).  A CPU generator gives the
    same values for either device; a CUDA generator draws on the card
    (for widths the host should not hold twice)."""
    dev = resolve_device(device)
    with torch.device(generator.device):
        params = _draw(generator, cfg)
    return tree_to(params, dev)


def param_shapes(cfg: LMConfig) -> Params:
    """The parameters as ``meta`` tensors: shapes and dtypes, no storage
    (what ``jax.eval_shape(init_params)`` gives the reference; nothing
    is drawn, at any width)."""
    with torch.device("meta"):
        return _draw(torch.Generator(), cfg)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                  mesh=None):
    x = lookup(params["embed"]["emb"], tokens, cfg.vocab, mesh)
    if cfg.embed_scale:
        # the factor rounded to the activations' dtype first, as the
        # reference's jnp.asarray(sqrt(d), x.dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _dense_ffn(p: Params, x: torch.Tensor, act: str, d_ff: int,
               mesh=None) -> torch.Tensor:
    """The GLU FFN; under a mesh ``w_gu`` split on ``f`` and ``w_d`` on
    its rows (both or neither), the partial sums completed over
    ``model``."""
    pm, tp, _ = _model(mesh)
    d, _, f = p["w_gu"].shape
    split = _is_block(p["w_gu"], -1, d_ff, tp, "ffn/w_gu")
    if split != _is_block(p["w_d"], -2, d_ff, tp, "ffn/w_d"):
        raise ValueError("ffn: w_gu and w_d must be split over model "
                         "together")
    if split:
        x = CO.copy_to(x, pm, MODEL)
    gu = (x @ p["w_gu"].reshape(d, 2 * f)).unflatten(-1, (2, f))
    h = ACT[act](gu[..., 0, :]) * gu[..., 1, :]
    out = h @ p["w_d"]
    return CO.reduce_from(out, pm, MODEL) if split else out


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _heads(p, cfg: LMConfig, tp: int):
    """Attention's layout under ``tp`` model ranks: (which projections
    arrive as this rank's columns, whether ``wo`` arrives as its rows,
    whether they fall on whole heads, so that each rank runs its own)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attn == "mla":
        m = cfg.mla
        cols = {"wq_b": H * (m.qk_nope + m.qk_rope),
                "wkv_b": H * (m.qk_nope + m.v_head)}
        rows, divides = H * m.v_head, H % tp == 0
    else:
        cols = {"wq": H * dh, "wk": KV * dh, "wv": KV * dh}
        rows, divides = H * dh, H % tp == 0 and KV % tp == 0
    split = {k: _is_block(p[k], -1, n, tp, f"attn/{k}")
             for k, n in cols.items()}
    split_o = _is_block(p["wo"], -2, rows, tp, "attn/wo")
    return split, split_o, divides and split_o and all(split.values())


def _gathered(t: torch.Tensor, split: bool, pm) -> torch.Tensor:
    """A column-split projection's output joined over ``model``."""
    return CO.all_gather(t, pm, MODEL, -1) if split else t


def _out_proj(o: torch.Tensor, wo: torch.Tensor, split_o: bool,
              own_heads: bool, pm, m: int) -> torch.Tensor:
    """``o @ wo``: with ``wo`` split on its rows, this rank's columns of
    ``o`` (its heads' own, or cut from all heads, which enter by
    ``copy_to``) meet them and ``reduce_from`` completes the sum."""
    if not split_o:
        return o @ wo
    if not own_heads:
        n = wo.shape[-2]
        o = CO.copy_to(o, pm, MODEL).narrow(-1, m * n, n)
    return CO.reduce_from(o @ wo, pm, MODEL)


def _attn_train(p, x, cfg: LMConfig, is_local: bool, positions, mesh=None):
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pm, tp, mi = _model(mesh)
    split, split_o, own = _heads(p, cfg, tp)
    if cfg.attn == "mla":
        m = cfg.mla
        qk = m.qk_nope + m.qk_rope
        q_a = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
        if split["wq_b"]:
            q_a = CO.copy_to(q_a, pm, MODEL)
        kv_a = x @ p["wkv_a"]
        ckv = rmsnorm(p["kv_norm"], kv_a[..., : m.kv_lora], cfg.norm_eps)
        kpe = kv_a[..., m.kv_lora:]
        if split["wkv_b"]:
            ckv = CO.copy_to(ckv, pm, MODEL)
        if own:
            # k_pe feeds only this rank's heads
            kpe = CO.copy_to(kpe, pm, MODEL)
        q, kv = q_a @ p["wq_b"], ckv @ p["wkv_b"]
        h = H // tp if own else H
        if not own:
            q = _gathered(q, split["wq_b"], pm)
            kv = _gathered(kv, split["wkv_b"], pm)
        q = q.reshape(B, S, h, qk)
        kv = kv.reshape(B, S, h, m.qk_nope + m.v_head)
        k_nope, v = kv[..., : m.qk_nope], kv[..., m.qk_nope:]
        q_pe = rope(q[..., m.qk_nope:], positions, cfg.rope_theta)
        k_pe = rope(kpe[:, :, None, :], positions, cfg.rope_theta)
        q = torch.cat([q[..., : m.qk_nope], q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, h, m.qk_rope)], dim=-1)
        scale = (m.qk_nope + m.qk_rope) ** -0.5
        o = flash_attention(
            q, k, v, causal=True, softcap=cfg.attn_softcap,
            blk_q=cfg.blk_q, blk_k=cfg.blk_k, scale=scale,
            block_skip=cfg.attn_block_skip,
        )
        return _out_proj(o.reshape(B, S, h * m.v_head), p["wo"], split_o,
                         own, pm, mi)
    xc = CO.copy_to(x, pm, MODEL) if any(split.values()) else x
    q, k, v = ((xc if split[n] else x) @ p[n] for n in ("wq", "wk", "wv"))
    h, kvh = (H // tp, KV // tp) if own else (H, KV)
    if not own:
        q, k, v = (_gathered(t, split[n], pm)
                   for t, n in ((q, "wq"), (k, "wk"), (v, "wv")))
    q = rope(q.reshape(B, S, h, dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, kvh, dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, kvh, dh)
    if is_local and cfg.window is not None and cfg.window < S:
        o = banded_attention(q, k, v, window=cfg.window,
                             softcap=cfg.attn_softcap,
                             blk=min(cfg.blk_q, S))
    else:
        o = flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap,
                            blk_q=cfg.blk_q, blk_k=cfg.blk_k,
                            block_skip=cfg.attn_block_skip)
    return _out_proj(o.reshape(B, S, h * dh), p["wo"], split_o, own, pm, mi)


def _ffn(p, h, cfg: LMConfig, is_moe: bool, mesh, data_axes=()):
    """(FFN output, aux loss or None) of the normed activations h."""
    if not is_moe:
        return _dense_ffn(p["ffn"], h, cfg.act, cfg.d_ff, mesh), None
    B, S, d = h.shape
    out, a = moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe, act=cfg.act,
                     mesh=mesh, data_axes=data_axes)
    return out.reshape(B, S, d), a


def _block_train(p, x, aux, cfg: LMConfig, flags, positions, mesh):
    is_local, is_moe = flags
    h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    x = x + _attn_train(p["attn"], h, cfg, is_local, positions, mesh)
    h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
    out, a = _ffn(p, h, cfg, is_moe, mesh, DATA)
    x = x + out
    if a is not None:
        aux = aux + a
    return x, aux


def _units(params: Params, cfg: LMConfig):
    """(segment index, repeat, unit, the unit's parameters) for every
    repeat of every segment, in layer order (the serving path's walk,
    which also indexes the cache by segment and repeat)."""
    for si, (unit, n_rep) in enumerate(cfg.scan_segments()):
        seg = params[f"seg{si}"]
        for r in range(n_rep):
            yield si, r, unit, seg if n_rep == 1 else tree_index(seg, r)


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------

def forward(
    params: Params,
    tokens: torch.Tensor,           # (B, S) int
    cfg: LMConfig,
    *,
    mesh=None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, d), aux_loss).  ``remat`` recomputes each
    unit's activations in the backward pass (``torch.utils.checkpoint``
    per unit, the reference's ``jax.checkpoint`` of the scan body)."""
    B, S = tokens.shape
    params = _locals(params)
    x = _embed_tokens(params, tokens, cfg, mesh)
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    for si, (unit, n_rep) in enumerate(cfg.scan_segments()):
        def unit_body(up, carry, unit=unit):
            x, aux = carry
            for j, flags in enumerate(unit):
                x, aux = _block_train(up[f"u{j}"], x, aux, cfg, flags,
                                      positions, mesh)
            return x, aux

        body = unit_body
        if remat and torch.is_grad_enabled():
            def body(up, carry, unit_body=unit_body):
                return torch.utils.checkpoint.checkpoint(
                    unit_body, up, carry, use_reentrant=False)
        seg_p = params[f"seg{si}"]
        x, aux = (body(seg_p, (x, aux)) if n_rep == 1
                  else scan_blocks(body, seg_p, (x, aux)))

    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, aux


def _head_weight(params, cfg: LMConfig, tp: int = 1):
    """(the head's (d, V) weight or this rank's columns of it, whether
    it is split over ``model``)."""
    if cfg.tie_embeddings:
        w = CO.local(params["embed"]["emb"]).T
    else:
        w = CO.local(params["lm_head"]["w"])
    return w, _is_block(w, -1, cfg.vocab, tp, "the head")


def logits(params: Params, hidden: torch.Tensor, cfg: LMConfig, mesh=None
           ) -> torch.Tensor:
    """Float32 logits of hidden states (..., d), final softcap applied;
    whole on every rank (a head split on the vocabulary is gathered)."""
    pm, tp, _ = _model(mesh)
    w, split = _head_weight(params, cfg, tp)
    if split:
        hidden = CO.copy_to(hidden, pm, MODEL)
    out = _softcap((hidden @ w).to(torch.float32), cfg.final_softcap)
    return _gathered(out, split, pm)


def _nll_split(lg: torch.Tensor, labels: torch.Tensor, vocab: int, pm,
               m: int) -> torch.Tensor:
    """-log p(label) from this rank's columns ``lg`` of the logits (split
    on the vocabulary over ``model``): the maximum over the ranks with
    no gradient, the sum of ``exp`` and the gold logit (from the rank
    that holds it) through one ``reduce_from``.  A label outside
    ``[-V, V)`` gives NaN, ``[-V, 0)`` wraps."""
    n = lg.shape[-1]
    mx = CO.max_over(lg.amax(-1), pm, MODEL)
    se = torch.exp(lg - mx[..., None]).sum(-1)
    safe = labels.clamp(-vocab, vocab - 1)
    loc = safe % vocab - m * n
    mine = (loc >= 0) & (loc < n)
    gold = torch.gather(lg, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(mine, gold, 0.0)
    se, gold = CO.reduce_from(torch.stack([se, gold]), pm, MODEL)
    gold = gold.masked_fill(safe != labels, float("nan"))
    return torch.log(se) + mx - gold


def chunked_ce_loss(
    params: Params,
    hidden: torch.Tensor,      # (B, S, d)
    labels: torch.Tensor,      # (B, S) int
    cfg: LMConfig,
    chunk: int = 512,
    label_mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Cross-entropy without building (B, S, V): one chunk of the
    sequence at a time, the sums carried as the reference's scan carries
    them.  A label outside ``[-V, V)`` gives a NaN term, as the
    reference's ``take_along_axis`` does.  Under a process mesh the sums
    are the whole batch's, over the data axes, and a head split on the
    vocabulary gives the vocab-parallel cross-entropy (``_nll_split``)."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the loss "
                         f"chunk {chunk}")
    pm, tp, m = _model(mesh)
    w, split = _head_weight(params, cfg, tp)
    if split:
        hidden = CO.copy_to(hidden, pm, MODEL)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        lg = _softcap((hidden[:, c:c + chunk] @ w).to(torch.float32),
                      cfg.final_softcap)
        lab = labels[:, c:c + chunk].long()
        if split:
            nll = _nll_split(lg, lab, cfg.vocab, pm, m)
        else:
            nll = torch.logsumexp(lg, dim=-1) - take_rows(
                lg, lab[..., None], dim=-1)[..., 0]
        mc = (torch.ones_like(nll) if label_mask is None
              else label_mask[:, c:c + chunk].to(torch.float32))
        tot = tot + (nll * mc).sum()
        cnt = cnt + mc.sum()
    if pm is not None:
        tot = CO.reduce_from(tot, pm, DATA)
        cnt = CO.all_reduce(cnt.detach(), pm, DATA)
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: LMConfig,
    *,
    mesh=None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    params = _locals(params)
    hidden, aux = forward(params, batch["tokens"], cfg, mesh=mesh,
                          remat=remat)
    loss = chunked_ce_loss(params, hidden, batch["labels"], cfg,
                           chunk=cfg.loss_chunk, mesh=mesh)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth > 0:
        # MTP(1): predict t+2 from [h_t ; emb(label_t)] through one block
        mp = params["mtp"]
        emb_next = lookup(params["embed"]["emb"], batch["labels"],
                          cfg.vocab, mesh)
        h2 = dense(mp["proj"], torch.cat([hidden, emb_next], -1))
        pos = _positions(h2.shape[0], h2.shape[1], h2.device)
        h2, _ = _block_train(
            mp["block"], h2, torch.zeros((), dtype=torch.float32,
                                         device=h2.device),
            cfg, (False, False), pos, mesh)
        h2 = rmsnorm(mp["ln"], h2, cfg.norm_eps)
        # labels shifted one more step; the last column masked
        lab = batch["labels"]
        mtp_labels = torch.cat([lab[:, 1:], lab[:, -1:]], dim=1)
        mask = torch.ones(mtp_labels.shape, dtype=torch.float32,
                          device=lab.device)
        mask[:, -1] = 0.0
        mtp = chunked_ce_loss(params, h2, mtp_labels, cfg, label_mask=mask,
                              mesh=mesh)
        metrics["mtp"] = mtp
        loss = loss + 0.3 * mtp
    loss = loss + aux
    return loss, metrics


# --------------------------------------------------------------------------
# decode (serve path)
# --------------------------------------------------------------------------

def _cache_len_for(cfg: LMConfig, is_local: bool, max_len: int) -> int:
    if is_local and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def _kv_heads(cfg: LMConfig, mesh, attn: Optional[Params] = None) -> int:
    """The KV heads a rank's cache holds under ``mesh``: ``KV / tp``
    where the heads fall whole on a rank, else all ``KV``.  Whole heads:
    those of the attention parameters ``attn`` where given, else
    ``lm_param_spec``'s layout (it splits every projection where ``H``
    and ``KV`` divide by tp)."""
    _, tp, _ = _model(mesh)
    if cfg.attn == "mla":
        return cfg.n_kv_heads
    if attn is not None:
        own = _heads(attn, cfg, tp)[2]
    else:
        own = cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    return cfg.n_kv_heads // tp if own else cfg.n_kv_heads


def _cache_tree(cfg: LMConfig, batch: int, max_len: int, kv_heads: int
                ) -> Dict[str, Any]:
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                                device="cpu")}
    for si, (unit, n_rep) in enumerate(cfg.scan_segments()):
        # a segment with one repeat carries no leading rep dim, as its
        # parameters carry none
        lead = () if n_rep == 1 else (n_rep,)
        seg = {}
        for j, (is_local, _) in enumerate(unit):
            L = _cache_len_for(cfg, is_local, max_len)
            if cfg.attn == "mla":
                m = cfg.mla
                seg[f"u{j}"] = {
                    "ckv": torch.zeros((*lead, batch, L, m.kv_lora),
                                       dtype=dt),
                    "kpe": torch.zeros((*lead, batch, L, m.qk_rope),
                                       dtype=dt),
                }
            else:
                shape = (*lead, batch, L, kv_heads, cfg.head_dim)
                seg[f"u{j}"] = {"k": torch.zeros(shape, dtype=dt),
                                "v": torch.zeros(shape, dtype=dt)}
        cache[f"seg{si}"] = seg
    return cache


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None, mesh=None) -> Dict[str, Any]:
    """The reference's cache tree, zeroed on ``device`` (``None``: the
    GPU): ``len`` (a 0-d int32 tensor, kept on the host) and per segment
    and unit ``k``/``v`` (B, L, KV, dh) or MLA's ``ckv``/``kpe`` (B, L,
    ·), with the segment's leading rep dim.  L is ``max_len``, or the
    window on SWA layers (a ring).  Under ``mesh`` a rank's ``k``/``v``
    hold its ``KV / tp`` heads where the heads fall whole on a rank."""
    dev = resolve_device(device)
    with torch.device(dev):
        return _cache_tree(cfg, batch, max_len, _kv_heads(cfg, mesh))


def cache_shapes(cfg: LMConfig, batch: int, max_len: int, mesh=None
                 ) -> Dict[str, Any]:
    """``init_cache``'s tree as ``meta`` tensors (``len`` stays a host
    tensor)."""
    with torch.device("meta"):
        return _cache_tree(cfg, batch, max_len, _kv_heads(cfg, mesh))


def _check_cache(own: bool, cfg: LMConfig, tp: int, kv: int) -> None:
    want = cfg.n_kv_heads // tp if own else cfg.n_kv_heads
    if kv != want:
        raise ValueError(f"a cache of {kv} KV heads where this rank's "
                         f"attention keeps {want} (init_cache(..., "
                         f"mesh=...) for the parameters' layout)")


def _attn_decode(p, x, cfg: LMConfig, is_local: bool, lc, pos: int,
                 mesh=None):
    """Single-token attention against a cache slice ``lc`` (no leading
    rep dim), whose row for this token is written in place.  Returns
    the attention output (B, 1, d)."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pm, tp, mi = _model(mesh)
    split, split_o, own = _heads(p, cfg, tp)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.attn == "mla":
        m = cfg.mla
        h = H // tp if own else H
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
        wkv_b = p["wkv_b"]
        if not own:
            q = _gathered(q, split["wq_b"], pm)
            wkv_b = _gathered(wkv_b, split["wkv_b"], pm)
        q = q.reshape(B, 1, h, m.qk_nope + m.qk_rope)
        q_pe = rope(q[..., m.qk_nope:], positions, cfg.rope_theta)
        q_nope = q[..., : m.qk_nope]
        kv_a = x @ p["wkv_a"]
        ckv_t = rmsnorm(p["kv_norm"], kv_a[..., : m.kv_lora], cfg.norm_eps)
        kpe_t = rope(kv_a[:, :, None, m.kv_lora:], positions,
                     cfg.rope_theta)[:, :, 0, :]
        ckv, kpe = lc["ckv"], lc["kpe"]
        slot = pos % ckv.shape[1]
        ckv[:, slot] = ckv_t[:, 0]
        kpe[:, slot] = kpe_t[:, 0]
        # weight absorption: score = q_nope . (W_uk^T) . ckv
        wkv_b = wkv_b.reshape(m.kv_lora, h, m.qk_nope + m.v_head)
        w_uk = wkv_b[..., : m.qk_nope]          # (kv_lora, h, qk_nope)
        w_uv = wkv_b[..., m.qk_nope:]           # (kv_lora, h, v_head)
        q_abs = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)
        s = torch.einsum("bthl,bsl->bhs", q_abs, ckv)
        s = s + torch.einsum("bthr,bsr->bhs", q_pe, kpe)
        s = s * ((m.qk_nope + m.qk_rope) ** -0.5)
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, -1e30)
        pr = torch.softmax(s.to(torch.float32), dim=-1)
        ctx = torch.einsum("bhs,bsl->bhl", pr, ckv.to(torch.float32))
        o = torch.einsum("bhl,lhv->bhv", ctx, w_uv.to(torch.float32))
        o = o.reshape(B, 1, h * m.v_head).to(x.dtype)
        return _out_proj(o, p["wo"], split_o, own, pm, mi)
    q, k_t, v_t = (x @ p[n] for n in ("wq", "wk", "wv"))
    h, kvh = (H // tp, KV // tp) if own else (H, KV)
    if not own:
        q, k_t, v_t = (_gathered(t, split[n], pm)
                       for t, n in ((q, "wq"), (k_t, "wk"), (v_t, "wv")))
    q = rope(q.reshape(B, 1, h, dh), positions, cfg.rope_theta)
    k_t = rope(k_t.reshape(B, 1, kvh, dh), positions, cfg.rope_theta)
    v_t = v_t.reshape(B, 1, kvh, dh)
    k, v = lc["k"], lc["v"]
    _check_cache(own, cfg, tp, k.shape[2])
    L = k.shape[1]
    ring = is_local and cfg.window is not None
    slot = min(pos % L if ring else pos, L - 1)
    k[:, slot] = k_t[:, 0]
    v[:, slot] = v_t[:, 0]
    o = decode_attention(q, k, v, cache_len=pos + 1,
                         softcap=cfg.attn_softcap, ring=ring)
    return _out_proj(o.reshape(B, 1, h * dh), p["wo"], split_o, own, pm, mi)


def _seg_cache(cache, si: int, r: int, n_rep: int):
    seg = cache[f"seg{si}"]
    return seg if n_rep == 1 else tree_index(seg, r)


@torch.no_grad()
def decode_step(
    params: Params,
    cache: Dict[str, Any],
    token: torch.Tensor,       # (B,) int
    cfg: LMConfig,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step: returns (logits (B, V) float32, cache).
    The cache is written in place (its ``len`` moves on by one) and
    returned."""
    pos = int(cache["len"])
    params = _locals(params)
    x = _embed_tokens(params, token[:, None], cfg, mesh)
    segs = cfg.scan_segments()
    for si, r, unit, up in _units(params, cfg):
        uc = _seg_cache(cache, si, r, segs[si][1])
        for j, (is_local, is_moe) in enumerate(unit):
            p = up[f"u{j}"]
            h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
            x = x + _attn_decode(p["attn"], h, cfg, is_local, uc[f"u{j}"],
                                 pos, mesh)
            h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + _ffn(p, h, cfg, is_moe, mesh)[0]
    cache["len"] = torch.tensor(pos + 1, dtype=torch.int32)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits(params, x[:, 0], cfg, mesh), cache


@torch.no_grad()
def prefill(
    params: Params,
    tokens: torch.Tensor,      # (B, S)
    cfg: LMConfig,
    max_len: int,
    *,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a prompt, building the cache; returns (last-token logits,
    cache).  The train-path forward plus the cache filled from each
    layer's projections: one pass, no per-token loop."""
    B, S = tokens.shape
    params = _locals(params)
    x = _embed_tokens(params, tokens, cfg, mesh)
    # the cache in the layout of the first layer's attention; a meta
    # prompt (the dry run's prefill cell) gets a meta cache
    first = next(_units(params, cfg))[3]["u0"]["attn"]
    with torch.device(x.device):
        cache = _cache_tree(cfg, B, max_len, _kv_heads(cfg, mesh, first))
    positions = _positions(B, S, x.device)
    segs = cfg.scan_segments()
    for si, r, unit, up in _units(params, cfg):
        uc = _seg_cache(cache, si, r, segs[si][1])
        for j, (is_local, is_moe) in enumerate(unit):
            p = up[f"u{j}"]
            h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
            x = x + _attn_train(p["attn"], h, cfg, is_local, positions,
                                mesh)
            _extract_cache(p["attn"], h, cfg, is_local, positions,
                           uc[f"u{j}"], mesh)
            h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + _ffn(p, h, cfg, is_moe, mesh)[0]
    cache["len"] = torch.tensor(S, dtype=torch.int32)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits(params, x[:, -1], cfg, mesh), cache


def _extract_cache(p, h, cfg: LMConfig, is_local: bool, positions, lc,
                   mesh=None):
    """Recompute a prompt's (cheap) KV projections into the cache slice
    ``lc``, in place: its last min(S, L) tokens, in slots 0.. on linear
    layers and in slot ``position % L`` on ring layers.  Under a mesh,
    this rank's KV heads where the heads fall whole on a rank, else all
    of them (a split projection's output gathered)."""
    B, S, _ = h.shape
    if cfg.attn == "mla":
        m = cfg.mla
        kv_a = h @ p["wkv_a"]
        ckv = rmsnorm(p["kv_norm"], kv_a[..., : m.kv_lora], cfg.norm_eps)
        kpe = rope(kv_a[:, :, None, m.kv_lora:], positions,
                   cfg.rope_theta)[:, :, 0, :]
        n = min(S, lc["ckv"].shape[1])
        lc["ckv"][:, :n] = ckv[:, S - n:]
        lc["kpe"][:, :n] = kpe[:, S - n:]
        return
    pm, tp, _ = _model(mesh)
    split, _, own = _heads(p, cfg, tp)
    dh = cfg.head_dim
    kvh = cfg.n_kv_heads // tp if own else cfg.n_kv_heads
    _check_cache(own, cfg, tp, lc["k"].shape[2])
    k, v = h @ p["wk"], h @ p["wv"]
    if not own:
        k, v = _gathered(k, split["wk"], pm), _gathered(v, split["wv"], pm)
    k = rope(k.reshape(B, S, kvh, dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, kvh, dh)
    L = lc["k"].shape[1]
    n = min(S, L)
    if is_local and cfg.window is not None:
        # ring layout: absolute position p lives in slot p % L
        slots = torch.arange(S - n, S, device=h.device) % L
        lc["k"][:, slots] = k[:, S - n:]
        lc["v"][:, slots] = v[:, S - n:]
    else:
        lc["k"][:, :n] = k[:, S - n:]
        lc["v"][:, :n] = v[:, S - n:]
