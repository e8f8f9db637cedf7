"""Train and eval step factories (the port of ``repro.train.steps``):
gradients, clipping and AdamW, with optional gradient accumulation over
microbatches.

The returned step is a function ``(params, opt_state, batch) ->
(params, opt_state, metrics)`` over nested dicts of tensors.  Its
gradients come from ``torch.autograd.grad`` over the parameter leaves
(the reference's ``jax.value_and_grad``); with ``grad_accum > 1`` the
leading batch dimension is split into microbatches whose float32
gradients are summed, one microbatch at a time, as the reference's
``lax.scan`` sums them, so peak activation memory is one microbatch.

Under a process mesh (``mesh``) the step takes the whole batch on every
rank, cuts each microbatch's rows for this rank's ``data`` coordinate
(so ``grad_accum`` keeps its meaning), and runs ``loss_fn`` on them:
its loss must be the whole batch's, each rank's backward giving its
rows' share of the gradient, as ``lm_loss(..., mesh=mesh)`` does.
``batch_specs`` (``{key: spec}``, the reference's batch specs) cuts each
leaf by its own spec instead: a full graph's node and edge arrays each
into their blocks over the data axes, a ``()`` leaf (its energy) kept
whole.  The
parameters and moments are placed leaves (``distributed.elastic.
reshard``: DTensors on a process mesh, rank 0's blocks on a counting
mesh), e.g. the parameters by ``lm_param_spec`` and the moments by
``opt_state_specs`` (ZeRO-1).  The gradients are computed on the local
shards and summed over the data axes: where a leaf's moments are split
over them (ZeRO-1), as a ``reduce-scatter`` to the moments' block, else
by an ``all-reduce``.  AdamW then updates the block its moments cover
and gathers the parameter back over the data axes (``optim``); its clip
norm is global (``optim.global_norm``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..distributed import collectives as CO
from .optim import (AdamWConfig, AdamWState, adamw_update, tree_leaves,
                    zero1_dim)

DATA = ("pod", "data")     # the axes a batch's rows are split over

LossFn = Callable[[Any, Dict[str, torch.Tensor]], Any]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree`` with its leaves (in sorted key order) replaced."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def make_train_step(
    loss_fn: LossFn,
    opt_cfg: AdamWConfig,
    *,
    grad_accum: int = 1,
    has_metrics: bool = True,
    mesh=None,
    batch_specs: Optional[Dict[str, Any]] = None,
) -> Callable:
    """loss_fn(params, batch) -> scalar | (scalar, metrics dict)."""
    pm = CO.process_mesh(mesh)

    def rows(batch):
        if pm is None:
            return batch
        if batch_specs is not None:
            return {k: CO.block(v, pm, batch_specs[k])
                    for k, v in batch.items()}
        return {k: CO.rows_of(v, pm, DATA) for k, v in batch.items()}

    def full_loss(params, batch):
        out = loss_fn(params, batch)
        if has_metrics:
            loss, metrics = out
        else:
            loss, metrics = out, {}
        return loss, metrics

    def grad_fn(params, batch):
        xs = [CO.local(p).detach().requires_grad_(True)
              for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = full_loss(_rebuild(params, iter(xs)),
                                      rows(batch))
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(xs, gs)]
        return loss.detach(), metrics, _rebuild(params, iter(gs))

    def step(params, opt_state: AdamWState, batch):
        if grad_accum == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            # split the leading batch dim into microbatches and sum
            def micro(x, i):
                b = x.shape[0]
                if b % grad_accum:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{grad_accum} microbatches")
                n = b // grad_accum
                return x[i * n:(i + 1) * n]

            acc = [torch.zeros(CO.local(p).shape, dtype=torch.float32,
                               device=p.device)
                   for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=acc[0].device if acc else None)
            for i in range(grad_accum):
                mb = {k: micro(v, i) for k, v in batch.items()}
                l, _, g = grad_fn(params, mb)
                acc = [a + x for a, x in zip(acc, tree_leaves(g))]
                loss_sum = loss_sum + l
            grads = _rebuild(params, iter([a / grad_accum for a in acc]))
            loss = loss_sum / grad_accum
            metrics = {}
        if pm is not None:
            grads = _rebuild(params, iter([
                _data_sum(p, g, m, pm) for p, g, m in zip(
                    tree_leaves(params), tree_leaves(grads),
                    tree_leaves(opt_state.m))]))
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params
        )
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics.update(opt_metrics)
        return new_params, new_opt, metrics

    return step


def _data_sum(p, g: torch.Tensor, m, pm):
    """A gradient's sum over the data axes, placed as its moment ``m``:
    the moment's block by a reduce-scatter where ZeRO-1 splits it over
    them, else whole by an all-reduce."""
    z = zero1_dim(p, m)
    if z is None:
        return CO.like(m, CO.all_reduce(g, pm, DATA))
    dim, axes = z
    return CO.like(m, CO.reduce_scatter(g, pm, axes, dim))


def make_eval_step(loss_fn: LossFn, has_metrics: bool = True) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            out = loss_fn(params, batch)
        return out[0] if has_metrics else out

    return step
