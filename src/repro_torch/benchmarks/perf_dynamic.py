"""Incremental RangeReach — query latency vs overlay size and compaction
amortisation, for all three 2DReach variants (the port of the
reference's ``benchmarks/perf_dynamic.py``).

A :class:`~repro_torch.dynamic.DynamicIndex` absorbs a stream of updates;
each query over the mutated graph pays the base probe plus overlay work
that grows with the delta buffer.  This benchmark measures

* **latency vs overlay size** — the same 1000-query workload timed at
  growing overlay sizes (updates drawn from ``streaming_workload``);
* **compaction restoration** — post-swap latency vs a *fresh* static
  build over the identical mutated graph;
* **amortised compaction cost** — rebuild seconds spread over the
  updates absorbed since the previous swap.

The reference's defaults (gowalla ×0.1, 1,000 queries, seed 7, the
``NEVER`` policy).  The base is built with the device backend on
``--device`` (the GPU by default; it raises where CUDA is absent) and
its probes are served there by the device engine, as is the fresh
index; the answers are checked against the BFS oracle before any swap
is timed.  Writes ``results/torch/perf_dynamic.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_dynamic
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np

from ..core import batch_query, build_index, rangereach_oracle_batch
from ..data import apply_stream_op, get_dataset, streaming_workload, workload
from ..device import DeviceLike, resolve_device
from ..dynamic import NEVER, DynamicIndex
from . import build_kernels, device_name, result_path

VARIANTS = ("2dreach", "2dreach-comp", "2dreach-pointer")
OVERLAY_CHECKPOINTS = (0, 64, 256, 1024)


def _t(fn, repeats: int = 5) -> float:
    fn()  # warmup
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def dynamic_sweep(dataset: str = "gowalla", scale: float = 0.1,
                  n_q: int = 1000, seed: int = 7,
                  verify_sample: int = 32, device: DeviceLike = None,
                  variants=VARIANTS) -> Dict[str, List[dict]]:
    dev = resolve_device(device)
    g = get_dataset(dataset, scale=scale)
    us, rects = workload(g, n_q, extent_ratio=0.05, seed=seed)

    # update-only stream (queries come from the fixed workload so latency
    # numbers are comparable across overlay sizes)
    ops = list(streaming_workload(
        g, n_steps=3 * max(OVERLAY_CHECKPOINTS), seed=seed,
        p_query=0.0, p_edge=0.6, p_vertex=0.2, p_spatial=0.2,
    ))

    out: Dict[str, List[dict]] = {v: [] for v in variants}
    for variant in variants:
        dyn = DynamicIndex(g, variant, policy=NEVER, engine="device",
                           device=dev)
        it = iter(ops)
        for target in OVERLAY_CHECKPOINTS:
            while dyn.overlay_size < target:
                apply_stream_op(dyn, next(it))
            dt = _t(lambda: dyn.query_batch(us, rects))
            out[variant].append(dict(
                phase="overlay", overlay_size=dyn.overlay_size,
                us_per_q=dt / n_q * 1e6,
            ))
            print(f"[{variant}] overlay={dyn.overlay_size:5d}  "
                  f"{dt / n_q * 1e6:8.2f} us/q")

        # correctness spot-check on the mutated graph before timing swaps
        gm = dyn.snapshot_graph()
        want = rangereach_oracle_batch(
            gm, us[:verify_sample], rects[:verify_sample]
        )
        got = dyn.query_batch(us[:verify_sample], rects[:verify_sample])
        assert (got == want).all(), f"{variant}: overlay answers wrong"

        # compaction swap
        t0 = time.perf_counter()
        dyn.compact(background=False)
        t_compact = time.perf_counter() - t0
        dt_post = _t(lambda: dyn.query_batch(us, rects), repeats=15)

        # fresh static build over the identical mutated graph
        t0 = time.perf_counter()
        fresh = build_index(gm, variant, backend="device", device=dev)
        t_fresh_build = time.perf_counter() - t0
        dt_fresh = _t(lambda: batch_query(fresh, us, rects, engine="device",
                                          device=dev), repeats=15)
        assert (dyn.query_batch(us[:verify_sample], rects[:verify_sample])
                == want).all(), f"{variant}: post-swap answers wrong"

        rep = dyn.report()
        n_upd = max(1, int(rep["n_updates"]))
        out[variant].append(dict(
            phase="post_compaction",
            overlay_size=dyn.overlay_size,
            us_per_q=dt_post / n_q * 1e6,
            fresh_us_per_q=dt_fresh / n_q * 1e6,
            post_over_fresh=dt_post / dt_fresh,
            t_compaction_s=t_compact,
            t_fresh_build_s=t_fresh_build,
            amortized_compaction_us_per_update=t_compact / n_upd * 1e6,
            n_updates_absorbed=n_upd,
            n_scc_merges=int(rep["n_scc_merges"]),
        ))
        print(f"[{variant}] post-swap {dt_post / n_q * 1e6:8.2f} us/q   "
              f"fresh {dt_fresh / n_q * 1e6:8.2f} us/q   "
              f"ratio {dt_post / dt_fresh:5.2f}   "
              f"compaction {t_compact:6.2f}s over {n_upd} updates "
              f"({t_compact / n_upd * 1e6:7.1f} us/update amortized)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the base is built and probed (default: "
                         "the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)
    results = {"device": device_name(dev),
               "dynamic_sweep": dynamic_sweep(device=dev)}
    path = result_path("perf_dynamic.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[perf_dynamic] wrote {path}")


if __name__ == "__main__":
    main()
