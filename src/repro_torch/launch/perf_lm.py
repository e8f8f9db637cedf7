"""One LM cell counted with config overrides (the port of
``repro.launch.perf_lm``): the roofline terms of a variant beside the
recorded dry run.

    PYTHONPATH=src python -m repro_torch.launch.perf_lm --arch gemma3-12b \\
        --shape train_4k --set attn_block_skip=true --set loss_chunk=256 \\
        --tag blockskip

Nested overrides use dots: ``--set moe.balance_factor=1.0``.  The cell is
rebuilt through the dry run's builders with the overridden config and
counted on ``meta`` (:func:`repro_torch.analysis.count_step`); nothing
runs on a card.  Results: ``results/torch/perf/<arch>__<shape>__<tag>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..analysis import count_step
from ..configs import get_arch
from ..configs.base import (
    LM_SHAPES,
    _lm_decode_builder,
    _lm_prefill_builder,
    _lm_train_builder,
)
from ..benchmarks import RESULTS

RESULTS_DIR = os.path.join(RESULTS, "perf")


def parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def apply_overrides(cfg, overrides):
    nested = {}
    flat = {}
    for k, v in overrides.items():
        if "." in k:
            a, b = k.split(".", 1)
            nested.setdefault(a, {})[b] = v
        else:
            flat[k] = v
    for a, sub in nested.items():
        flat[a] = dataclasses.replace(getattr(cfg, a), **sub)
    return dataclasses.replace(cfg, **flat)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--tag", default="variant")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in getattr(args, "set"):
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)

    spec = get_arch(args.arch)
    base_cfg = spec.make_config()
    cfg_fn = lambda: apply_overrides(base_cfg, overrides)  # noqa: E731
    s = LM_SHAPES[args.shape]
    if s["kind"] == "train":
        builder = _lm_train_builder(cfg_fn, s["seq"], s["batch"])
    elif s["kind"] == "prefill":
        builder = _lm_prefill_builder(cfg_fn, s["seq"], s["batch"])
    else:
        builder = _lm_decode_builder(cfg_fn, s["seq"], s["batch"])

    t0 = time.perf_counter()
    fn, cell_args = builder()
    stats = count_step(fn, *cell_args)
    rec = {
        "arch": args.arch, "shape": args.shape, "tag": args.tag,
        "overrides": overrides, "hlo_stats": stats, "n_devices": 1,
        "t_total_s": round(time.perf_counter() - t0, 1),
        "ok": True,
    }
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(
        RESULTS_DIR, f"{args.arch}__{args.shape}__{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({
        "tag": args.tag,
        "flops": stats["flops"],
        "hbm_floor": stats["hbm_floor_bytes"],
        "coll": stats["collective_bytes"],
    }))
    return rec


if __name__ == "__main__":
    main()
