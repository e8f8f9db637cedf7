"""h2o-danube-1.8b [dense]: 24L d=2560 32H (kv=8, head_dim=80) d_ff=6912
vocab=32000, llama+mistral mix, all-layer SWA window 4096.
[arXiv:2401.16818]"""
from ..models.lm import LMConfig
from .base import ArchSpec, lm_cells

NAME = "h2o-danube-1.8b"


def make_config(reduced: bool = False, dtype: str = "bfloat16") -> LMConfig:
    if reduced:
        return LMConfig(
            name=NAME + "-reduced", n_layers=4, d_model=64, n_heads=8,
            n_kv_heads=2, head_dim=8, d_ff=128, vocab=512, window=16,
            layer_schedule="L", dtype="float32",
        )
    return LMConfig(
        name=NAME, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        head_dim=80, d_ff=6912, vocab=32000, window=4096,
        layer_schedule="L", dtype=dtype,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        name=NAME, family="lm", make_config=make_config,
        cells=lm_cells(NAME, make_config),
        notes="pure SWA: 500k decode touches only a 4096-token ring per "
              "layer; head_dim=80 is not a multiple of 64",
    )
