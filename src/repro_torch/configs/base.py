"""Architecture/cell registry (the port of ``repro.configs.base``: the
LM and recsys families).

An ``ArchSpec`` names an architecture, its family, a config factory (full
or reduced), and its shape cells.  A ``Cell`` knows how to produce, for
one device:

    fn         — the step to run (train step / prefill / decode step /
                 serve / retrieval scoring)
    args       — its inputs as ``meta`` tensors: shapes and dtypes, no
                 storage (the reference's ``ShapeDtypeStruct``s); a train
                 cell's are the parameters, the AdamW state and a batch

The reference also attaches a mesh sharding to each input; the port
serves from one device, so a cell carries none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


def round_up(x: int, k: int = 512) -> int:
    return ((x + k - 1) // k) * k


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    builder: Callable[[], Tuple[Callable, Tuple]]

    def build(self):
        return self.builder()


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                       # lm | gnn | recsys
    make_config: Callable[..., Any]   # make_config(reduced=False)
    cells: Dict[str, Cell]
    notes: str = ""


# ==========================================================================
# LM family
# ==========================================================================

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _lm_train_builder(cfg_fn, seq, batch):
    def build():
        from ..models.lm import lm_loss, param_shapes
        from ..train import AdamWConfig, adamw_init, make_train_step

        cfg = cfg_fn()
        p_meta = param_shapes(cfg)
        o_meta = adamw_init(p_meta)
        b_meta = {"tokens": _meta((batch, seq), torch.int32),
                  "labels": _meta((batch, seq), torch.int32)}
        step = make_train_step(
            lambda p, b: lm_loss(p, b, cfg, remat=True), AdamWConfig())
        return step, (p_meta, o_meta, b_meta)

    return build


def _lm_prefill_builder(cfg_fn, seq, batch):
    def build():
        from ..models.lm import param_shapes, prefill

        cfg = cfg_fn()

        def fn(params, tokens):
            return prefill(params, tokens, cfg, max_len=seq)

        return fn, (param_shapes(cfg), _meta((batch, seq), torch.int32))

    return build


def _lm_decode_builder(cfg_fn, seq, batch):
    def build():
        from ..models.lm import cache_shapes, decode_step, param_shapes

        cfg = cfg_fn()

        def fn(params, cache, token):
            return decode_step(params, cache, token, cfg)

        return fn, (param_shapes(cfg), cache_shapes(cfg, batch, seq),
                    _meta((batch,), torch.int32))

    return build


def lm_cells(name: str, cfg_fn) -> Dict[str, Cell]:
    out = {}
    for shape, s in LM_SHAPES.items():
        if s["kind"] == "train":
            b = _lm_train_builder(cfg_fn, s["seq"], s["batch"])
        elif s["kind"] == "prefill":
            b = _lm_prefill_builder(cfg_fn, s["seq"], s["batch"])
        else:
            b = _lm_decode_builder(cfg_fn, s["seq"], s["batch"])
        out[shape] = Cell(arch=name, shape=shape, kind=s["kind"], builder=b)
    return out


# ==========================================================================
# RecSys family (DIN)
# ==========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


def _din_batch_meta(B, S, with_label=True):
    b = {
        "hist_items": _meta((B, S), torch.int32),
        "hist_mask": _meta((B, S), torch.bool),
        "target_item": _meta((B,), torch.int32),
    }
    if with_label:
        b["label"] = _meta((B,), torch.float32)
    return b


def _din_builder(cfg_fn, shape: str):
    s = RECSYS_SHAPES[shape]

    def build():
        from ..models.recsys import din

        cfg = cfg_fn()
        p_meta = din.param_shapes(cfg)
        if s["kind"] == "train":
            from ..train import AdamWConfig, adamw_init, make_train_step

            o_meta = adamw_init(p_meta)
            b_meta = _din_batch_meta(s["batch"], cfg.seq_len)
            step = make_train_step(
                lambda p, b: (din.loss_fn(p, b, cfg), {}), AdamWConfig())
            return step, (p_meta, o_meta, b_meta)
        if s["kind"] == "serve":
            b_meta = _din_batch_meta(s["batch"], cfg.seq_len,
                                     with_label=False)
            return (lambda p, b: din.apply(p, b, cfg)), (p_meta, b_meta)
        # retrieval: one user, C candidates
        C = s["n_candidates"]
        b_meta = {
            "hist_items": _meta((cfg.seq_len,), torch.int32),
            "hist_mask": _meta((cfg.seq_len,), torch.bool),
            "candidates": _meta((round_up(C, 8192),), torch.int32),
        }
        return ((lambda p, b: din.score_candidates(p, b, cfg)),
                (p_meta, b_meta))

    return build


def recsys_cells(name: str, cfg_fn) -> Dict[str, Cell]:
    return {
        shape: Cell(arch=name, shape=shape,
                    kind=RECSYS_SHAPES[shape]["kind"],
                    builder=_din_builder(cfg_fn, shape))
        for shape in RECSYS_SHAPES
    }
