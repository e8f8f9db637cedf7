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

Token ids outside ``[-V, V)`` embed as NaN rows and ids in ``[-V, 0)``
wrap, as the reference's ``jnp.take`` answers (``nn.embed``).  A tree's
device is its tensors' device; ``init_params`` and ``init_cache`` take
``device`` (``None``: the GPU).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ...device import DeviceLike, resolve_device
from ..nn import (ACT, Params, dense, dense_init, embed, embed_init,
                  norm_init, rmsnorm, scan_blocks, stack_init, take_rows,
                  tree_index, tree_to)
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

def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        # the factor rounded to the activations' dtype first, as the
        # reference's jnp.asarray(sqrt(d), x.dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _dense_ffn(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    d, _, f = p["w_gu"].shape
    gu = (x @ p["w_gu"].reshape(d, 2 * f)).unflatten(-1, (2, f))
    h = ACT[act](gu[..., 0, :]) * gu[..., 1, :]
    return h @ p["w_d"]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _attn_train(p, x, cfg: LMConfig, is_local: bool, positions):
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attn == "mla":
        m = cfg.mla
        qk = m.qk_nope + m.qk_rope
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
        q = q.reshape(B, S, H, qk)
        kv_a = x @ p["wkv_a"]
        ckv = rmsnorm(p["kv_norm"], kv_a[..., : m.kv_lora], cfg.norm_eps)
        kpe = kv_a[..., m.kv_lora:]
        kv = (ckv @ p["wkv_b"]).reshape(B, S, H, m.qk_nope + m.v_head)
        k_nope, v = kv[..., : m.qk_nope], kv[..., m.qk_nope:]
        q_pe = rope(q[..., m.qk_nope:], positions, cfg.rope_theta)
        k_pe = rope(kpe[:, :, None, :], positions, cfg.rope_theta)
        q = torch.cat([q[..., : m.qk_nope], q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, m.qk_rope)], dim=-1)
        scale = (m.qk_nope + m.qk_rope) ** -0.5
        o = flash_attention(
            q, k, v, causal=True, softcap=cfg.attn_softcap,
            blk_q=cfg.blk_q, blk_k=cfg.blk_k, scale=scale,
            block_skip=cfg.attn_block_skip,
        )
        return o.reshape(B, S, H * m.v_head) @ p["wo"]
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if is_local and cfg.window is not None and cfg.window < S:
        o = banded_attention(q, k, v, window=cfg.window,
                             softcap=cfg.attn_softcap,
                             blk=min(cfg.blk_q, S))
    else:
        o = flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap,
                            blk_q=cfg.blk_q, blk_k=cfg.blk_k,
                            block_skip=cfg.attn_block_skip)
    return o.reshape(B, S, H * dh) @ p["wo"]


def _ffn(p, h, cfg: LMConfig, is_moe: bool, mesh):
    """(FFN output, aux loss or None) of the normed activations h."""
    if not is_moe:
        return _dense_ffn(p["ffn"], h, cfg.act), None
    B, S, d = h.shape
    out, a = moe_ffn(p["moe"], h.reshape(B * S, d), cfg.moe, act=cfg.act,
                     mesh=mesh)
    return out.reshape(B, S, d), a


def _block_train(p, x, aux, cfg: LMConfig, flags, positions, mesh):
    is_local, is_moe = flags
    h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    x = x + _attn_train(p["attn"], h, cfg, is_local, positions)
    h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
    out, a = _ffn(p, h, cfg, is_moe, mesh)
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
    x = _embed_tokens(params, tokens, cfg)
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


def _head_weight(params, cfg: LMConfig):
    if cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["lm_head"]["w"]


def logits(params: Params, hidden: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """Float32 logits of hidden states (..., d), final softcap applied."""
    out = (hidden @ _head_weight(params, cfg)).to(torch.float32)
    return _softcap(out, cfg.final_softcap)


def chunked_ce_loss(
    params: Params,
    hidden: torch.Tensor,      # (B, S, d)
    labels: torch.Tensor,      # (B, S) int
    cfg: LMConfig,
    chunk: int = 512,
    label_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-entropy without building (B, S, V): one chunk of the
    sequence at a time, the sums carried as the reference's scan carries
    them.  A label outside ``[-V, V)`` gives a NaN term, as the
    reference's ``take_along_axis`` does."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the loss "
                         f"chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        lg = logits(params, hidden[:, c:c + chunk], cfg)
        logz = torch.logsumexp(lg, dim=-1)
        gold = take_rows(lg, labels[:, c:c + chunk, None].long(), dim=-1
                         )[..., 0]
        mc = (torch.ones_like(logz) if label_mask is None
              else label_mask[:, c:c + chunk].to(torch.float32))
        tot = tot + ((logz - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: LMConfig,
    *,
    mesh=None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    hidden, aux = forward(params, batch["tokens"], cfg, mesh=mesh,
                          remat=remat)
    loss = chunked_ce_loss(params, hidden, batch["labels"], cfg,
                           chunk=cfg.loss_chunk)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth > 0:
        # MTP(1): predict t+2 from [h_t ; emb(label_t)] through one block
        mp = params["mtp"]
        emb_next = embed(params["embed"], batch["labels"])
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
        mtp = chunked_ce_loss(params, h2, mtp_labels, cfg, label_mask=mask)
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


def _cache_tree(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, Any]:
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
                shape = (*lead, batch, L, cfg.n_kv_heads, cfg.head_dim)
                seg[f"u{j}"] = {"k": torch.zeros(shape, dtype=dt),
                                "v": torch.zeros(shape, dtype=dt)}
        cache[f"seg{si}"] = seg
    return cache


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's cache tree, zeroed on ``device`` (``None``: the
    GPU): ``len`` (a 0-d int32 tensor, kept on the host) and per segment
    and unit ``k``/``v`` (B, L, KV, dh) or MLA's ``ckv``/``kpe`` (B, L,
    ·), with the segment's leading rep dim.  L is ``max_len``, or the
    window on SWA layers (a ring)."""
    dev = resolve_device(device)
    with torch.device(dev):
        return _cache_tree(cfg, batch, max_len)


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """``init_cache``'s tree as ``meta`` tensors (``len`` stays a host
    tensor)."""
    with torch.device("meta"):
        return _cache_tree(cfg, batch, max_len)


def _attn_decode(p, x, cfg: LMConfig, is_local: bool, lc, pos: int):
    """Single-token attention against a cache slice ``lc`` (no leading
    rep dim), whose row for this token is written in place.  Returns
    the attention output (B, 1, d)."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.attn == "mla":
        m = cfg.mla
        q = rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps) @ p["wq_b"]
        q = q.reshape(B, 1, H, m.qk_nope + m.qk_rope)
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
        wkv_b = p["wkv_b"].reshape(m.kv_lora, H, m.qk_nope + m.v_head)
        w_uk = wkv_b[..., : m.qk_nope]          # (kv_lora, H, qk_nope)
        w_uv = wkv_b[..., m.qk_nope:]           # (kv_lora, H, v_head)
        q_abs = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)
        s = torch.einsum("bthl,bsl->bhs", q_abs, ckv)
        s = s + torch.einsum("bthr,bsr->bhs", q_pe, kpe)
        s = s * ((m.qk_nope + m.qk_rope) ** -0.5)
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, -1e30)
        pr = torch.softmax(s.to(torch.float32), dim=-1)
        ctx = torch.einsum("bhs,bsl->bhl", pr, ckv.to(torch.float32))
        o = torch.einsum("bhl,lhv->bhv", ctx, w_uv.to(torch.float32))
        o = o.reshape(B, 1, H * m.v_head).to(x.dtype)
        return o @ p["wo"]
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    k_t = (x @ p["wk"]).reshape(B, 1, KV, dh)
    v_t = (x @ p["wv"]).reshape(B, 1, KV, dh)
    q = rope(q, positions, cfg.rope_theta)
    k_t = rope(k_t, positions, cfg.rope_theta)
    k, v = lc["k"], lc["v"]
    L = k.shape[1]
    ring = is_local and cfg.window is not None
    slot = min(pos % L if ring else pos, L - 1)
    k[:, slot] = k_t[:, 0]
    v[:, slot] = v_t[:, 0]
    o = decode_attention(q, k, v, cache_len=pos + 1,
                         softcap=cfg.attn_softcap, ring=ring)
    return o.reshape(B, 1, H * dh) @ p["wo"]


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
    x = _embed_tokens(params, token[:, None], cfg)
    segs = cfg.scan_segments()
    for si, r, unit, up in _units(params, cfg):
        uc = _seg_cache(cache, si, r, segs[si][1])
        for j, (is_local, is_moe) in enumerate(unit):
            p = up[f"u{j}"]
            h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
            x = x + _attn_decode(p["attn"], h, cfg, is_local, uc[f"u{j}"],
                                 pos)
            h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + _ffn(p, h, cfg, is_moe, mesh)[0]
    cache["len"] = torch.tensor(pos + 1, dtype=torch.int32)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits(params, x[:, 0], cfg), cache


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
    x = _embed_tokens(params, tokens, cfg)
    # a meta prompt (the dry run's prefill cell) gets a meta cache
    cache = (cache_shapes(cfg, B, max_len) if x.device.type == "meta"
             else init_cache(cfg, B, max_len, device=x.device))
    positions = _positions(B, S, x.device)
    segs = cfg.scan_segments()
    for si, r, unit, up in _units(params, cfg):
        uc = _seg_cache(cache, si, r, segs[si][1])
        for j, (is_local, is_moe) in enumerate(unit):
            p = up[f"u{j}"]
            h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
            x = x + _attn_train(p["attn"], h, cfg, is_local, positions)
            _extract_cache(p["attn"], h, cfg, is_local, positions,
                           uc[f"u{j}"])
            h = rmsnorm(p["ln_ffn"], x, cfg.norm_eps)
            x = x + _ffn(p, h, cfg, is_moe, mesh)[0]
    cache["len"] = torch.tensor(S, dtype=torch.int32)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits(params, x[:, -1], cfg), cache


def _extract_cache(p, h, cfg: LMConfig, is_local: bool, positions, lc):
    """Recompute a prompt's (cheap) KV projections into the cache slice
    ``lc``, in place: its last min(S, L) tokens, in slots 0.. on linear
    layers and in slot ``position % L`` on ring layers."""
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
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    k = rope((h @ p["wk"]).reshape(B, S, KV, dh), positions, cfg.rope_theta)
    v = (h @ p["wv"]).reshape(B, S, KV, dh)
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
