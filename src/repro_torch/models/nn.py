"""Minimal NN substrate (the port of ``repro.models.nn``, the parts DIN
and the LM family need): parameters are nested dicts of tensors, layers
are plain functions, initialisers draw from an explicit
``torch.Generator``.

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


def norm_init(d: int, dtype=torch.float32, lead=()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype)}


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


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``p["emb"]``, as the reference's ``jnp.take``
    gives them: ids in ``[-V, 0)`` wrap, and an id outside ``[-V, V)``
    gives a row of NaN.  The ids are clamped and the rows of those that
    moved filled in place, on the device, so a bad id neither syncs with
    the host nor fires a device-side assert."""
    return take_rows(p["emb"], ids)


def take_rows(table: torch.Tensor, ids: torch.Tensor, dim: int = 0
              ) -> torch.Tensor:
    """``jnp.take(table, ids, axis=dim)`` for ``dim`` 0, or
    ``jnp.take_along_axis(table, ids, axis=-1)`` for ``dim`` -1, with
    the reference's rule for ids outside ``[-n, n)`` (see
    :func:`embed`)."""
    n = table.shape[dim]
    safe = ids.clamp(-n, n - 1)
    bad = safe != ids
    if dim == 0:
        return table[safe].masked_fill_(bad[..., None], float("nan"))
    return torch.gather(table, -1, safe % n).masked_fill_(
        bad, float("nan"))


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The mean of squares in float32, ``x * rsqrt(var + eps)`` with the
    factor cast to ``x``'s dtype first, then the scale: the reference's
    order of casts."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"]


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


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


# --------------------------------------------------------------------------
# stacked parameter helpers
# --------------------------------------------------------------------------

def stack_init(init_fn: Callable[..., Params], generator: torch.Generator,
               n: int) -> Params:
    """``n`` copies of a block's parameters stacked on a leading dim (the
    layout the reference's ``jax.vmap(init_fn)`` gives): ``init_fn
    (generator, lead)`` draws every leaf with the leading shape
    ``lead``, here ``(n,)``."""
    return init_fn(generator, (n,))


def tree_index(params: Params, i: int) -> Params:
    """Layer ``i`` of stacked parameters: a view of every leaf."""
    if isinstance(params, dict):
        return {k: tree_index(v, i) for k, v in params.items()}
    return params[i]


def scan_blocks(body: Callable, params: Params, x):
    """``body(layer_params, x) -> x`` over stacked parameters, layer by
    layer (the reference's ``lax.scan``)."""
    n = next(_leaves(params)).shape[0]
    for i in range(n):
        x = body(tree_index(params, i), x)
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
