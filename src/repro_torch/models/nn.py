"""Minimal NN substrate (the port of ``repro.models.nn``, the part DIN
needs): parameters are nested dicts of tensors, layers are plain
functions, initialisers draw from an explicit ``torch.Generator``.

The layout is the reference's: a dense layer holds ``w`` of shape
``(d_in, d_out)`` and ``b`` of shape ``(d_out,)`` and computes
``y = x @ w + b``, so converted JAX parameters need no transpose.
Initialisers draw on the default device (the CPU, or ``meta`` under
``torch.device("meta")`` for shapes only); callers move the tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None,
               bias: bool = True) -> Params:
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    p = {"w": torch.randn((d_in, d_out), generator=generator, dtype=dtype)
         * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def embed_init(generator: torch.Generator, n: int, d: int,
               dtype=torch.float32, scale: float = 0.02) -> Params:
    return {"emb": torch.randn((n, d), generator=generator, dtype=dtype)
            * scale}


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype=torch.float32, bias: bool = True) -> Params:
    return {
        f"l{i}": dense_init(generator, dims[i], dims[i + 1], dtype,
                            bias=bias)
        for i in range(len(dims) - 1)
    }


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


ACT: Dict[str, Callable] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "silu": F.silu,
    "tanh": torch.tanh,
    "ssp": lambda x: F.softplus(x) - math.log(2.0),     # shifted softplus
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def mlp(p: Params, x: torch.Tensor, act: str = "silu",
        final_act: str = "identity") -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        x = ACT[act](x) if i < n - 1 else ACT[final_act](x)
    return x


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, torch.Tensor):
        yield params


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def param_bytes(params: Params) -> int:
    return sum(int(x.numel() * x.element_size()) for x in _leaves(params))


def tree_to(params: Params, device) -> Params:
    """The same tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: tree_to(v, device) for k, v in params.items()}
    return params.to(device)
