"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, 256 routed experts top-8
+ 1 shared, first 3 layers dense, MTP. [arXiv:2412.19437]"""
from ..models.lm import LMConfig, MLASpec, MoESpec
from .base import ArchSpec, lm_cells

NAME = "deepseek-v3-671b"


def make_config(reduced: bool = False, dtype: str = "bfloat16") -> LMConfig:
    if reduced:
        return LMConfig(
            name=NAME + "-reduced", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, attn="mla",
            mla=MLASpec(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8,
                        v_head=16),
            moe=MoESpec(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                        d_shared=64, first_dense=1),
            mtp_depth=1, dtype="float32",
        )
    return LMConfig(
        name=NAME, n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18432, vocab=129280, attn="mla",
        mla=MLASpec(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                    v_head=128),
        moe=MoESpec(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                    d_shared=2048, first_dense=3),
        mtp_depth=1, dtype=dtype,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="lm", make_config=make_config,
        cells=lm_cells(NAME, make_config),
        notes="MLA compact KV: long_500k cache = 500k*(512+64)*2B = 0.6 GB"
              " per layer-stack at bs=1 — decode-friendly by construction",
    )
