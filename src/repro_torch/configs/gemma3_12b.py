"""gemma3-12b [dense]: 48L d=3840 16H (kv=8, head_dim=256) d_ff=15360
vocab=262144, 5:1 local:global, window 1024, 128k+ context.
[hf:google/gemma-3; unverified]"""
from ..models.lm import LMConfig
from .base import ArchSpec, lm_cells

NAME = "gemma3-12b"


def make_config(reduced: bool = False, dtype: str = "bfloat16") -> LMConfig:
    if reduced:
        return LMConfig(
            name=NAME + "-reduced", n_layers=6, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, window=16,
            layer_schedule="LLLLLG", embed_scale=True, dtype="float32",
        )
    return LMConfig(
        name=NAME, n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=15360, vocab=262144, window=1024,
        layer_schedule="LLLLLG", embed_scale=True, dtype=dtype,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="lm", make_config=make_config,
        cells=lm_cells(NAME, make_config),
        notes="5:1 SWA keeps long_500k sub-quadratic: only every 6th "
              "layer holds full 500k KV",
    )
