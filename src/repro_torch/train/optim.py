"""Hand-rolled optimizer substrate (the port of ``repro.train.optim``).

AdamW with decoupled weight decay, global-norm gradient clipping, and
warmup-cosine / linear / constant schedules.  The update is a plain
function over nested dicts of tensors (the parameter trees of
``repro_torch.models``), run under ``torch.no_grad()``; the optimizer
state mirrors the parameters: a step counter and float32 moments.

The order of operations is the reference's: clip by the global norm,
step + 1, the schedule at the new step, bias correction, then the
update with decoupled weight decay on float32 copies, cast back to
each parameter's dtype.  Leaves are visited in sorted key order, as
``jax.tree.leaves`` visits a dict.

Under a process mesh the parameters, gradients and moments are placed
leaves (``distributed.elastic.reshard``: DTensors, or a counting mesh's
blocks): the clip norm is the global one (a leaf split over mesh axes
sums its square over them, a replicated leaf counts once) and the update
runs on each rank's shards.  ZeRO-1 (``sharding.opt_state_specs``): where
a leaf's moments, and its gradient with them (``steps``), are split over
the data axes on a dim its parameter keeps whole, the rank updates the
block of the parameter they cover and gathers the parameter back over
those axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..distributed import collectives as CO


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # float32 tensors, the parameters' tree
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of
    ``rest``, as a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * t)
            )
        else:
            decay = 1.0 - (1.0 - cfg.min_lr_frac) * t
    return cfg.lr * warm * decay


def adamw_init(params: Any) -> AdamWState:
    """Step 0 and zero float32 moments beside each parameter (on its
    device; ``meta`` parameters give ``meta`` state)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  A placed
    leaf's square sum is its shard's, summed over the mesh axes it is
    split over (one sum a set of axes, one axis at a time); a replicated
    one counts once."""
    leaves = tree_leaves(tree)
    sq = [torch.sum(torch.square(CO.local(x).to(torch.float32)))
          for x in leaves]
    split = {}
    for i, x in enumerate(leaves):
        axes = CO.spec_axes(CO.spec_of(x))
        if axes:
            mesh = CO.mesh_of(x)
            split.setdefault((id(mesh), axes), (mesh, []))[1].append(i)
    for (_, axes), (mesh, idx) in split.items():
        v = torch.stack([sq[i] for i in idx])
        for a in axes:
            CO.all_reduce(v, mesh, a)
        for j, i in enumerate(idx):
            sq[i] = v[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def zero1_dim(p, m) -> Optional[Tuple[int, Any]]:
    """(dim, axes) where the moment ``m`` is split over ``axes`` and its
    parameter ``p`` whole (ZeRO-1), or ``None``."""
    ps, ms = CO.spec_of(p), CO.spec_of(m)
    for i, entry in enumerate(ms):
        if entry is not None and (i >= len(ps) or ps[i] is None):
            return i, entry
    return None


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """-> ``(new params, new state, {"grad_norm", "lr"})``; the inputs
    are left as they are."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = CO.local(state.step) + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        pl, gl, ml, vl = map(CO.local, (p, g, m, v))
        z = zero1_dim(p, m)
        if z is None:
            out = upd_local(pl, gl, ml, vl)
        else:
            # ZeRO-1: the block the moments cover, then the whole
            # parameter back over the data axes
            dim, axes = z
            mesh, b = CO.mesh_of(m), ml.shape[dim]
            blk = pl.narrow(dim, CO.axis_index(mesh, axes) * b, b)
            out = upd_local(blk, gl, ml, vl)
            out = (CO.all_gather(out[0], mesh, axes, dim), *out[1:])
        return tuple(CO.like(r, t) for r, t in zip((p, m, v), out))

    def upd_local(p, g, m, v):
        if scale is not None:
            g = g * scale
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * delta).to(p.dtype), m_new,
                v_new)

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step=CO.like(state.step, step),
                                     m=_pick(out, 1),
                                     v=_pick(out, 2)), {
        "grad_norm": gnorm, "lr": lr,
    }


def _pick(tree: Any, i: int) -> Any:
    """The ``i``-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
