"""Attention (the port of ``repro.models.lm.attention``): blockwise
online-softmax attention, banded sliding-window attention, GQA, and the
decode step against a KV cache, in plain torch with the reference's
arithmetic: float32 scores, ``NEG_INF = -1e30`` for masked entries, the
online-softmax carry ``(m, l, acc)`` over key blocks and ``max(l,
1e-20)`` in the final division.

* ``flash_attention``  — query blocks against key blocks of ``blk_k``,
  causal masking, an optional score softcap (gemma2).  The reference
  maps one query block at a time (``lax.map``); here as many query
  blocks as fit ``SCORE_BUDGET`` bytes of float32 scores go at once,
  each with the reference's carry.  Under a causal mask a key block
  that lies wholly past every query of a chunk is not computed: it
  would leave ``m``, ``l`` and ``acc`` exactly as they are (its scores
  are all ``NEG_INF``, so ``p`` is 0 and the correction is 1), which is
  why the reference's ``block_skip`` is exact.
* ``banded_attention`` — sliding-window layers gather only the key
  blocks inside the band (``ceil(w/blk) + 1`` per query block), so local
  layers cost O(S*w), not O(S^2).
* ``decode_attention`` — one query token against a KV cache (a ring
  buffer for SWA layers, linear for global ones).

All take (B, S, H, dh) q and (B, S, KV, dh) k/v and handle GQA by
reshaping q to (KV, H/KV) groups: query head h reads key head h // (H/KV).
No attention library is called: ``scaled_dot_product_attention`` has no
score softcap.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# float32 bytes of one (query blocks x key block) score tensor; query
# blocks are taken together up to this size
SCORE_BUDGET = 256 << 20


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding; x (..., S, H, dh), positions (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap is not None else x


def _chunk(n: int, per_block: int) -> int:
    """Query blocks taken together: as many as SCORE_BUDGET allows."""
    return max(1, min(n, SCORE_BUDGET // max(per_block, 1)))


def _blocks(S: int, blk: int, what: str) -> int:
    if S % blk:
        raise ValueError(f"{what}: sequence {S} is not a multiple of the "
                         f"block {blk}")
    return S // blk


def _grouped_q(q: torch.Tensor, nq: int, blk: int, G: int) -> torch.Tensor:
    """(B, S, H, dh) -> (nq, B, G, H/G, blk, dh)."""
    B, S, H, dh = q.shape
    return q.reshape(B, nq, blk, G, H // G, dh).permute(1, 0, 3, 4, 2, 5)


def _ungroup(out: torch.Tensor, B: int, S: int, H: int) -> torch.Tensor:
    """(nq, B, G, Hg, blk, dv) -> (B, S, H, dv)."""
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, out.shape[-1])


def flash_attention(
    q: torch.Tensor,          # (B, S, H, dh)
    k: torch.Tensor,          # (B, Sk, KV, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (prefill chunks)
    softcap: Optional[float] = None,
    blk_q: int = 512,
    blk_k: int = 512,
    scale: Optional[float] = None,
    block_skip: bool = False,
) -> torch.Tensor:
    """Causal (or full) attention over key blocks with the reference's
    online softmax.  ``block_skip`` is accepted for the reference's
    signature; the result is the same either way (see the module
    docstring)."""
    del block_skip
    B, S, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    dv = v.shape[-1]          # MLA: v head dim differs from qk head dim
    G, Hg = KV, H // KV
    scale = dh ** -0.5 if scale is None else scale
    blk_q = min(blk_q, S)
    blk_k = min(blk_k, Sk)
    nq = _blocks(S, blk_q, "flash_attention queries")
    nk = _blocks(Sk, blk_k, "flash_attention keys")
    dev = q.device

    qr = _grouped_q(q, nq, blk_q, G)                       # (nq,B,G,Hg,bq,dh)
    kr = k.reshape(B, nk, blk_k, G, dh).permute(1, 0, 3, 4, 2)  # (nk,B,G,dh,bk)
    vr = v.reshape(B, nk, blk_k, G, dv).permute(1, 0, 3, 2, 4)  # (nk,B,G,bk,dv)
    q_pos = q_offset + torch.arange(S, device=dev).reshape(nq, blk_q)
    k_pos = torch.arange(Sk, device=dev).reshape(nk, blk_k)

    cq = _chunk(nq, B * H * blk_q * blk_k * 4)
    outs = []
    for c0 in range(0, nq, cq):
        qb = qr[c0:c0 + cq].to(torch.float32)
        c = qb.shape[0]
        qp = q_pos[c0:c0 + c]
        n_kv = nk
        if causal:      # key blocks with a key at or before the last query
            last = q_offset + (c0 + c) * blk_q - 1
            n_kv = min(nk, max(0, last // blk_k + 1))
        m = torch.full((c, B, G, Hg, blk_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((c, B, G, Hg, blk_q, dv), dtype=torch.float32,
                          device=dev)
        for j in range(n_kv):
            s = torch.matmul(qb, kr[j].to(torch.float32).unsqueeze(2)
                             ) * scale                  # (c,B,G,Hg,bq,bk)
            s = _softcap(s, softcap)
            if causal:
                mask = qp[:, None, None, None, :, None] >= k_pos[j]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(
                p, vr[j].to(torch.float32).unsqueeze(2))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = _ungroup(torch.cat(outs), B, S, H)
    return out.to(q.dtype)


def banded_attention(
    q: torch.Tensor,          # (B, S, H, dh)
    k: torch.Tensor,          # (B, S, KV, dh)
    v: torch.Tensor,
    *,
    window: int,
    softcap: Optional[float] = None,
    blk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal sliding-window attention touching only in-band key blocks.

    Query at position i attends to j in (i - window, i]."""
    B, S, H, dh = q.shape
    _, _, KV, _ = k.shape
    G, Hg = KV, H // KV
    scale = dh ** -0.5 if scale is None else scale
    blk = min(blk, S)
    nq = _blocks(S, blk, "banded_attention")
    nw = min(-(-window // blk) + 1, nq)   # key blocks per band
    W = nw * blk
    dev = q.device

    qr = _grouped_q(q, nq, blk, G)                         # (nq,B,G,Hg,blk,dh)
    band = torch.arange(W, device=dev)
    cq = _chunk(nq, B * H * blk * W * 4)
    outs = []
    for c0 in range(0, nq, cq):
        qb = qr[c0:c0 + cq].to(torch.float32)
        c = qb.shape[0]
        i = torch.arange(c0, c0 + c, device=dev)
        # the nw key blocks ending at block i (clamped at 0)
        kp = (torch.clamp(i - (nw - 1), min=0) * blk)[:, None] + band
        kb = k[:, kp].permute(1, 0, 3, 4, 2)          # (c, B, G, dh, W)
        vb = v[:, kp].permute(1, 0, 3, 2, 4)          # (c, B, G, W, dh)
        qp = i[:, None] * blk + torch.arange(blk, device=dev)
        d = qp[:, :, None] - kp[:, None, :]                # (c, blk, W)
        mask = ((d >= 0) & (d < window))[:, None, None, None]
        s = torch.matmul(qb, kb.to(torch.float32).unsqueeze(3)) * scale
        s = _softcap(s, softcap)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = torch.matmul(p, vb.to(torch.float32).unsqueeze(3))
        outs.append(out / torch.clamp(p.sum(-1, keepdim=True), min=1e-20))
    out = _ungroup(torch.cat(outs), B, S, H)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, dh)
    k_cache: torch.Tensor,    # (B, Sc, KV, dh)
    v_cache: torch.Tensor,
    cache_len: int,           # number of valid cache rows
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    ring: bool = False,       # SWA ring buffer: all Sc rows valid once full
) -> torch.Tensor:
    B, _, H, dh = q.shape
    _, Sc, KV, _ = k_cache.shape
    G, Hg = KV, H // KV
    scale = dh ** -0.5 if scale is None else scale
    qr = q.reshape(B, G, Hg, dh).to(torch.float32)
    s = torch.matmul(qr, k_cache.to(torch.float32).permute(0, 2, 3, 1)
                     ) * scale                              # (B, G, Hg, Sc)
    s = _softcap(s, softcap)
    n = min(cache_len, Sc) if ring else cache_len
    valid = torch.arange(Sc, device=q.device) < n
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v_cache.to(torch.float32).permute(0, 2, 1, 3))
    return out.reshape(B, 1, H, -1).to(q.dtype)
