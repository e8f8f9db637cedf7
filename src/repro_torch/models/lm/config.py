"""LM transformer configuration covering the five assigned architectures
(a copy of ``repro.models.lm.config``).

One flexible block implementation instantiates llama4-maverick (GQA +
interleaved MoE, top-1, 128 experts + shared), deepseek-v3 (MLA + 256
routed top-8 + shared + MTP), gemma3 (GQA 5:1 local:global), h2o-danube
(all-SWA GQA) and gemma2 (alternating local/global + logit softcaps).

``layer_schedule`` is a repeating pattern of 'L' (sliding-window) and 'G'
(global attention); MoE placement is ``first_dense`` dense layers then
MoE every ``interleave`` layers.  Layers are grouped into segments of one
repeating unit (see model.py), whose parameters are stacked on a
leading dim as the reference's are.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLASpec:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: Optional[int] = None    # shared-expert ff dim (default d_ff)
    first_dense: int = 0              # leading dense-FFN layers
    interleave: int = 1               # MoE every k-th layer (1 = all)
    balance_factor: float = 1.25      # per-expert capacity slack
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn: str = "gqa"                   # "gqa" | "mla"
    mla: Optional[MLASpec] = None
    window: Optional[int] = None        # SWA width for 'L' layers
    layer_schedule: str = "G"           # repeating 'L'/'G' pattern
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    moe: Optional[MoESpec] = None
    mtp_depth: int = 0                  # deepseek multi-token prediction
    act: str = "silu"
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma multiplies embed by sqrt(d)
    norm_eps: float = 1e-6
    dtype: str = "float32"
    # attention blocking
    blk_q: int = 512
    blk_k: int = 512
    attn_block_skip: bool = False   # causal block skipping (§Perf)
    loss_chunk: int = 512           # CE loss sequence chunking

    # ---- layer plan -----------------------------------------------------
    def layer_flags(self) -> List[Tuple[bool, bool]]:
        """[(is_local, is_moe)] per layer."""
        out = []
        for i in range(self.n_layers):
            is_local = self.layer_schedule[
                i % len(self.layer_schedule)
            ] == "L"
            is_moe = False
            if self.moe is not None and i >= self.moe.first_dense:
                is_moe = (i - self.moe.first_dense) % self.moe.interleave == 0
            out.append((is_local, is_moe))
        return out

    def scan_segments(self) -> List[Tuple[Tuple[Tuple[bool, bool], ...], int]]:
        """Group layers into (unit, n_repeats) segments with identical
        per-unit structure; each segment's parameters stack on a leading
        dim of n_repeats (none where it is 1)."""
        flags = self.layer_flags()
        segments: List[Tuple[Tuple[Tuple[bool, bool], ...], int]] = []
        # unit length: repeat period of (schedule, moe pattern)
        import math
        period = len(self.layer_schedule)
        if self.moe is not None and self.moe.interleave > 1:
            period = math.lcm(period, self.moe.interleave)
        fd = self.moe.first_dense if self.moe is not None else 0
        if fd:
            segments.append((tuple(flags[:fd]), 1))
        rest = flags[fd:]
        n_units = len(rest) // period
        if n_units:
            segments.append((tuple(rest[:period]), n_units))
        tail = rest[n_units * period:]
        if tail:
            segments.append((tuple(tail), 1))
        return segments

    # ---- parameter counting --------------------------------------------
    def param_counts(self) -> dict:
        d, f, V = self.d_model, self.d_ff, self.vocab
        H, KV, dh = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer_attn = (
            d * (self.mla.q_lora + self.mla.kv_lora + self.mla.qk_rope)
            + self.mla.q_lora * H * (self.mla.qk_nope + self.mla.qk_rope)
            + self.mla.kv_lora * H * (self.mla.qk_nope + self.mla.v_head)
            + H * self.mla.v_head * d
            if self.attn == "mla"
            else d * H * dh + 2 * d * KV * dh + H * dh * d
        )
        dense_ffn = 3 * d * f
        n_active = 0
        n_total = 0
        for (_, is_moe) in self.layer_flags():
            n_total += per_layer_attn + 2 * d
            n_active += per_layer_attn + 2 * d
            if is_moe:
                m = self.moe
                exp = 3 * d * m.d_expert
                shared = m.n_shared * 3 * d * (m.d_shared or f)
                n_total += m.n_experts * exp + shared + d * m.n_experts
                n_active += m.top_k * exp + shared + d * m.n_experts
            else:
                n_total += dense_ffn
                n_active += dense_ffn
        emb = V * d * (1 if self.tie_embeddings else 2)
        return {
            "total": n_total + emb,
            "active": n_active + emb,
            "embed": emb,
        }
