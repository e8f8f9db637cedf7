"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, 128 experts top-1 + shared, MoE interleaved every other
layer.  [hf:meta-llama/Llama-4 family; unverified]  Text backbone only
(early-fusion frontend is a stub per the assignment)."""
from ..models.lm import LMConfig, MoESpec
from .base import ArchSpec, lm_cells

NAME = "llama4-maverick-400b-a17b"


def make_config(reduced: bool = False, dtype: str = "bfloat16") -> LMConfig:
    if reduced:
        return LMConfig(
            name=NAME + "-reduced", n_layers=4, d_model=64, n_heads=8,
            n_kv_heads=2, head_dim=8, d_ff=128, vocab=512,
            layer_schedule="G", dtype="float32",
            moe=MoESpec(n_experts=8, top_k=1, d_expert=128, n_shared=1,
                        d_shared=128, interleave=2),
        )
    return LMConfig(
        name=NAME, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=202048, layer_schedule="G",
        dtype=dtype,
        moe=MoESpec(n_experts=128, top_k=1, d_expert=8192, n_shared=1,
                    d_shared=8192, interleave=2),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="lm", make_config=make_config,
        cells=lm_cells(NAME, make_config),
        notes="full attention; long_500k's KV is 48L*500k*8*128*2*2B = "
              "98 GB, more than one card holds: it needs model-sharded "
              "KV",
    )
