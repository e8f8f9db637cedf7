"""gemma2-2b [dense]: 26L d=2304 8H (kv=4, head_dim=256) d_ff=9216
vocab=256000, alternating local/global, logit softcaps. [arXiv:2408.00118]"""
from ..models.lm import LMConfig
from .base import ArchSpec, lm_cells

NAME = "gemma2-2b"


def make_config(reduced: bool = False, dtype: str = "bfloat16") -> LMConfig:
    if reduced:
        return LMConfig(
            name=NAME + "-reduced", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, window=16,
            layer_schedule="LG", attn_softcap=50.0, final_softcap=30.0,
            embed_scale=True, dtype="float32",
        )
    return LMConfig(
        name=NAME, n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab=256000, window=4096,
        layer_schedule="LG", attn_softcap=50.0, final_softcap=30.0,
        embed_scale=True, dtype=dtype,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="lm", make_config=make_config,
        cells=lm_cells(NAME, make_config),
        notes="global layers hold full 500k KV at bs=1 (26/2 layers * "
              "500k * 4kv * 256dh * 2 * 2B = 27 GB, beside 5.2 GB of bf16 "
              "weights on one 80 GB card); "
              "8 heads < model=16 so attention projections replicate, "
              "FFN/vocab still shard",
    )
