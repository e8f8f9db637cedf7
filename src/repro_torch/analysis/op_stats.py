"""Operation counts of one step: FLOPs and traffic (the port of
``repro.analysis.hlo_stats``).

The reference parses the compiled XLA HLO of a cell and walks its call
graph, multiplying ``while`` bodies by their trip counts, because
``cost_analysis`` counts a scanned layer once.  The port has no compiled
program to read.  :func:`count_step` runs the step itself, usually on
``meta`` tensors, under a ``TorchDispatchMode`` that sees every aten op
the step dispatches (autograd's backward included), so a loop over
layers is counted once per iteration by construction:

    flops           — ``torch.utils.flop_counter``'s formulas (2·m·n·k a
                      product, the attention and convolution ops), the
                      reference's "2 * prod(result_dims) * contraction
                      for every dot"
    bytes           — operand and result bytes of every aten op that
                      materialises a result (views and ``detach`` move
                      nothing), unfused: eager PyTorch runs every op as
                      its own kernel, so this is what eager moves
    hbm_floor_bytes — the same, over the ops whose operands and results
                      must cross HBM even in a fused program
                      (``HBM_FLOOR_OPS``: products, embedding lookups,
                      gathers, scatters and index writes, and copies into
                      a view such as a cache slice), the counterpart of
                      the reference's dot / gather / scatter /
                      dynamic-(update-)slice set
    collective_bytes — the bytes of every crossing of a mesh axis the
                      step makes (``distributed.collectives``' tally:
                      each collective's result on this rank, the
                      reference's convention), ``collectives`` the same
                      by kind.  0 and ``{}`` for a step on one device;
                      a step on a ``CountingMesh`` counts rank 0's
                      share of a 256- or 512-way mesh, as the reference
                      reads all-gather / all-reduce / ... out of its
                      SPMD program

Validated against known-FLOPs programs in ``tests/test_torch_dryrun.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..distributed.collectives import Tally

aten = torch.ops.aten

HBM_FLOOR_OPS = {
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.embedding,
    aten.embedding_dense_backward, aten.index_select, aten.gather,
    aten.index, aten.index_add, aten.index_add_, aten.index_put,
    aten.index_put_, aten._index_put_impl_, aten.index_copy,
    aten.index_copy_, aten.scatter, aten.scatter_, aten.scatter_add,
    aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
    aten.slice_scatter, aten.select_scatter,
}


def _nbytes(x) -> int:
    """Bytes of the tensors in an op's arguments or results."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


class _NoMemo(Exception):
    """An op's inputs hold a tensor that is not on ``meta``."""


def _key(x):
    """A hashable stand-in for an argument: a meta tensor by its layout,
    a plain value by itself (``TypeError`` where it cannot be hashed,
    ``_NoMemo`` for a tensor off ``meta``)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoMemo
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    hash(x)
    return (type(x), x)


def _functional(func) -> bool:
    """An op whose results alias nothing and which mutates nothing."""
    s = func._schema
    return not (func.is_view or s.is_mutable
                or any(r.alias_info is not None for r in s.returns))


class OpStats(TorchDispatchMode):
    """Sums FLOPs and bytes over every aten op dispatched inside it.

    On ``meta`` tensors an op computes nothing but its result's layout,
    and many aten ops find that layout in Python (their meta functions),
    at ~0.1 ms an op: a prefill_32k cell dispatches millions.  So the
    layout of a functional op's results is remembered by the op and its
    inputs' layouts, and a repeat gets fresh ``meta`` tensors of that
    layout without the meta function."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.hbm_floor = 0.0
        self.n_ops = 0
        self.tally = Tally()
        self._memo: Dict[Any, Any] = {}

    def __enter__(self):
        self.tally.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.tally.__exit__(*exc)

    def _run(self, func, args, kwargs):
        if not _functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except (_NoMemo, TypeError):
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is not None:
            single, layouts = hit
            outs = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in layouts]
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        if isinstance(outs, (list, tuple)) and all(
                isinstance(t, torch.Tensor) and t.device.type == "meta"
                for t in outs):
            self._memo[key] = (single, [(tuple(t.shape), t.stride(),
                                         t.dtype) for t in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        packet = func._overloadpacket
        self.n_ops += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view:            # aliases move nothing (detach too)
            return out
        moved = _nbytes((args, kwargs)) + _nbytes(out)
        self.bytes += moved
        if packet in HBM_FLOOR_OPS or (
                packet is aten.copy_ and args[0]._is_view()):
            self.hbm_floor += moved
        return out


    def stats(self) -> Dict[str, Any]:
        """The reference's ``analyze_hlo`` keys: ``flops``, ``bytes``,
        ``hbm_floor_bytes`` and ``collective_bytes`` (0 on one device),
        plus ``collectives`` (bytes by kind) and ``n_ops``, the aten ops
        dispatched."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "hbm_floor_bytes": float(self.hbm_floor),
                "collective_bytes": float(self.tally.bytes.get("total", 0)),
                "collectives": dict(self.tally.bytes),
                "n_ops": self.n_ops}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def io_bytes(args, out) -> Dict[str, int]:
    """Bytes a step's inputs and outputs hold: ``argument`` (every input
    tensor) and ``output`` (every output tensor that is not one of the
    inputs: a cache written in place and returned counts once, as an
    input)."""
    ins = _tensors(args)
    seen = {id(t) for t in ins}
    return {"argument": sum(t.numel() * t.element_size() for t in ins),
            "output": sum(t.numel() * t.element_size()
                          for t in _tensors(out) if id(t) not in seen)}


def count_step(fn: Callable, *args: Any) -> Dict[str, float]:
    """One run of ``fn(*args)`` counted (:meth:`OpStats.stats`).  With
    ``meta`` inputs nothing is computed or allocated; a train step's
    autograd runs under the same count."""
    with OpStats() as st:
        fn(*args)
    return st.stats()
