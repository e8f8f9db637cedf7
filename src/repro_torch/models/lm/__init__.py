"""The LM family (the port of ``repro.models.lm``): one decoder-only
transformer covering gemma2, gemma3, h2o-danube, llama4-maverick and
deepseek-v3."""
from .config import LMConfig, MLASpec, MoESpec
from .model import (
    cache_shapes,
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    param_shapes,
    prefill,
)

__all__ = ["LMConfig", "MLASpec", "MoESpec", "cache_shapes", "decode_step",
           "forward", "init_cache", "init_params", "lm_loss",
           "param_shapes", "prefill"]
