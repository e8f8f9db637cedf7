"""Minimal NN substrate (the port of ``repro.models.nn``, the parts DIN,
the GNN and the LM families need): parameters are nested dicts of
tensors, layers are plain functions, initialisers draw from an explicit
``torch.Generator``.

The layout is the reference's: a dense layer holds ``w`` of shape
``(d_in, d_out)`` and ``b`` of shape ``(d_out,)`` and computes
``y = x @ w + b``, so converted JAX parameters need no transpose.
Initialisers draw on the default device (the CPU, or ``meta`` under
``torch.device("meta")`` for shapes only); callers move the tree.

**Under a process mesh** (``mesh``: a ``DeviceMesh`` or a counting
mesh) ``mlp`` and ``lookup`` take the leaves as
``distributed.sharding.mlp_param_spec`` places them, this rank's blocks
(a DTensor's local shard, or the block itself), and read which each is
from its width, the Megatron pairing over ``model`` (the rule splits
only an MLP's ``l{k}/w`` and a table's rows, so ``dense`` takes whole
leaves):

* a column-split ``w`` (its ``d_out`` a block of its bias's, which the
  rule never splits) takes its input, replicated over ``model``, by
  ``copy_to`` and adds its slice of the bias (which enters by
  ``copy_to`` too, so its gradient is whole on every rank);
* a row-split ``w`` takes the previous layer's column block where the
  two pair (an ``mlp``'s ``l{k}`` after ``l{k-1}``), or cuts its own
  slice of a replicated input (after ``copy_to``); ``reduce_from``
  completes the sum and the bias is added once;
* a column block with no row-split partner (a one-layer MLP, or the
  last layer's) is gathered over ``model``;
* a row-split table is looked up vocabulary-parallel (:func:`lookup`).

Every layer's output is replicated over ``model``.  With whole leaves,
no mesh, or a model axis of one rank, nothing crosses.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..distributed import collectives as CO

Params = Dict[str, Any]
MODEL = "model"     # the mesh axis the tensor-parallel leaves split over
DATA = ("pod", "data")     # the axes a batch's rows are split over


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

def model_of(mesh):
    """(process mesh or None, tp, this rank's coordinate on ``model``)."""
    pm = CO.process_mesh(mesh)
    return pm, CO.axis_size(pm, MODEL), CO.axis_index(pm, MODEL)


def is_block(w: torch.Tensor, dim: int, full: int, tp: int, what: str
             ) -> bool:
    """Whether ``w`` holds this rank's block of ``full`` entries on
    ``dim`` (split over ``model``) rather than all of them; any other
    width raises."""
    n = w.shape[dim]
    if n == full:
        return False
    if tp > 1 and n * tp == full:
        return True
    raise ValueError(f"{what}: dim {dim} of {tuple(w.shape)} is neither "
                     f"{full} nor its block over {tp} model ranks")


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x``, this rank's rows of a batch split evenly over
    the data axes: the local sum completed over them (backward: the
    identity), over the global count."""
    pm = CO.process_mesh(mesh)
    if pm is None:
        return x.mean()
    return CO.reduce_from(x.sum(), pm, DATA) / (x.numel()
                                                 * CO.axis_size(pm, DATA))


def local_tree(params: Params) -> Params:
    """Every leaf as this rank holds it (a DTensor's local shard)."""
    if isinstance(params, dict):
        return {k: local_tree(v) for k, v in params.items()}
    return CO.local(params)


def _cols(p: Params, tp: int) -> bool:
    """Whether ``p["w"]`` arrives as this rank's block of its columns:
    its width against its bias's, which the rule keeps whole.  The rule
    splits columns only of an MLP's ``l0``, which has a bias; a layer
    without one (a projection) is whole."""
    if "b" not in p:
        return False
    return is_block(p["w"], -1, p["b"].shape[-1], tp, "dense w")


def _col_layer(p: Params, x: torch.Tensor, pm, m: int) -> torch.Tensor:
    """A column-split layer on a replicated input: this rank's columns."""
    n = p["w"].shape[-1]
    y = CO.copy_to(x, pm, MODEL) @ p["w"]
    if "b" in p:
        y = y + CO.copy_to(p["b"], pm, MODEL).narrow(-1, m * n, n)
    return y


def _row_layer(p: Params, x: torch.Tensor, pm, m: int, paired: bool
               ) -> torch.Tensor:
    """A row-split layer: ``x`` this rank's block of the input columns
    (``paired``) or the replicated input, cut here; one sum over
    ``model``, then the bias."""
    if not paired:
        n = p["w"].shape[-2]
        x = CO.copy_to(x, pm, MODEL).narrow(-1, m * n, n)
    y = CO.reduce_from(x @ p["w"], pm, MODEL)
    if "b" in p:
        y = y + p["b"]
    return y


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def lookup(emb: torch.Tensor, ids: torch.Tensor, rows: int, mesh=None
           ) -> torch.Tensor:
    """Rows ``ids`` of a table of ``rows`` rows (``take_rows``' rule:
    ``[-V, 0)`` wraps, outside ``[-V, V)`` a row of NaN), whole (no
    mesh, or the rule left it whole) or split on its rows over
    ``model``, where each rank contributes its range's rows and zeros
    for the rest, and ``reduce_from`` sums the parts.  An id outside
    this rank's range reads the row at its offset modulo the block (its
    value and gradient masked to zero): clamped to the block's ends, the
    ids of the other ranks would pile onto two rows, and the backward's
    accumulation serialises on a row that many ids share."""
    pm, tp, m = model_of(mesh)
    if not is_block(emb, -2, rows, tp, "emb"):
        return take_rows(emb, ids)
    n = emb.shape[-2]
    safe = ids.clamp(-rows, rows - 1)
    loc = safe % rows - m * n
    mine = (loc >= 0) & (loc < n)
    out = emb[loc % n].masked_fill(~mine[..., None], 0.0)
    out = CO.reduce_from(out, pm, MODEL)
    return out.masked_fill((safe != ids)[..., None], float("nan"))


def take_rows(table: torch.Tensor, ids: torch.Tensor, dim: int = 0
              ) -> torch.Tensor:
    """``jnp.take(table, ids, axis=dim)`` for ``dim`` 0, or
    ``jnp.take_along_axis(table, ids, axis=-1)`` for ``dim`` -1, as the
    reference gives them: ids in ``[-n, 0)`` wrap, and an id outside
    ``[-n, n)`` gives NaN.  The ids are clamped and the entries of those
    that moved filled in place, on the device, so a bad id neither syncs
    with the host nor fires a device-side assert."""
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
        final_act: str = "identity", mesh=None) -> torch.Tensor:
    """The layers ``l0 .. l{n-1}``; under a mesh in the Megatron pairing
    (a column-split layer's block feeds the next layer's row-split ``w``
    with no crossing between them), the output replicated."""
    n = len(p)
    pm, tp, m = model_of(mesh)
    if tp == 1:
        for i in range(n):
            x = dense(p[f"l{i}"], x)
            x = ACT[act](x) if i < n - 1 else ACT[final_act](x)
        return x
    blk = False         # x holds this rank's block of its columns
    for i in range(n):
        lp = p[f"l{i}"]
        if "b" not in lp:
            raise ValueError(f"mlp l{i}: under a model axis a layer needs "
                             f"its bias to read its split from")
        if blk and lp["w"].shape[-2] != x.shape[-1]:
            x, blk = CO.all_gather(x, pm, MODEL, -1), False
        if blk:
            x, blk = _row_layer(lp, x, pm, m, paired=True), False
        elif _cols(lp, tp):
            x, blk = _col_layer(lp, x, pm, m), True
        elif is_block(lp["w"], -2, x.shape[-1], tp, f"l{i}/w"):
            x = _row_layer(lp, x, pm, m, paired=False)
        else:
            x = dense(lp, x)
        x = ACT[act](x) if i < n - 1 else ACT[final_act](x)
    return CO.all_gather(x, pm, MODEL, -1) if blk else x


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
