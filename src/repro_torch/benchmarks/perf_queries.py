"""The analytics query classes per serving path (the port of the
reference's ``benchmarks/perf_queries.py``).

Per query class — boolean reach (baseline), RangeCount, RangeCollect,
KNNReach, convex-polygon reach — this bench measures wall-clock per
query on the host NumPy descents and on the device engine (on
``--device``, the GPU by default): the fused path (one launch of K1 a
batch; polygons have only the two-phase path, K2 + K6) and, for reach,
count, collect and kNN, the retained two-phase path (K2 + K3/K4/K5),
after verifying every path answers bit-identically to the host.

Outputs: ``results/torch/perf_queries.json`` (full rows) and
``results/torch/BENCH_queries.json``, a summary with per-class host and
device latency and the steady-state compile counts (the shapes the
engines serve), gated to zero: after the warm pass no class may serve a
new shape.  ``--smoke`` runs a seconds-scale subset.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from .. import obs
from ..core import QueryEngine, build_2dreach
from ..core.engine import engine_for
from ..data import get_dataset, knn_workload, polygon_workload, workload
from ..device import DeviceLike, resolve_device
from ..queries import (
    knn_reach_host,
    polygon_reach_host,
    range_collect_host,
    range_count_host,
)
from . import build_kernels, device_name, result_path

CLASSES = ("reach", "count", "collect", "knn", "polygon")


def _t(fn, repeats=5):
    fn()  # warmup
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _same(kind, a, b) -> bool:
    if kind in ("reach", "count", "polygon"):
        return bool((a == b).all())
    if kind == "collect":
        return bool((a.ids == b.ids).all() and (a.counts == b.counts).all()
                    and (a.overflow == b.overflow).all())
    return bool((a.ids == b.ids).all() and (a.dist2 == b.dist2).all())


def class_workload(g, n_q: int) -> Dict[str, tuple]:
    """Each class's seeded queries over ``g``: rects (reach, count,
    collect), kNN focus points, 6-gons."""
    us, rects = workload(g, n_q, extent_ratio=0.05, seed=5)
    kus, pts = knn_workload(g, n_q, seed=6)
    pus, polys = polygon_workload(g, n_q, extent_ratio=0.05, seed=7)
    return {"rect": (us, rects), "knn": (kus, pts),
            "polygon": (pus, list(polys))}


def class_cases(idx, eng, two, work, k: int
                ) -> Dict[str, Tuple[Callable, Dict[str, Callable]]]:
    """{class: (host call, {path: device call})} over ``work``
    (:func:`class_workload`): ``eng`` serves the fused path (polygons:
    its only, two-phase path), ``two`` is an engine on the two-phase
    path, for kNN, whose radius-doubling loop runs on its engine's
    path."""
    us, rects = work["rect"]
    kus, pts = work["knn"]
    pus, polys = work["polygon"]
    return {
        "reach": (
            lambda: idx.query_batch(us, rects),
            {"fused": lambda: eng.query_batch(us, rects),
             "two_phase": lambda: eng.query_batch_two_phase(us, rects)},
        ),
        "count": (
            lambda: range_count_host(idx, us, rects),
            {"fused": lambda: eng.count_batch(us, rects),
             "two_phase": lambda: eng.count_batch_two_phase(us, rects)},
        ),
        "collect": (
            lambda: range_collect_host(idx, us, rects, k),
            {"fused": lambda: eng.collect_batch(us, rects, k),
             "two_phase": lambda: eng.collect_batch_two_phase(
                 us, rects, k)},
        ),
        "knn": (
            lambda: knn_reach_host(idx, kus, pts, k),
            {"fused": lambda: eng.knn_batch(kus, pts, k),
             "two_phase": lambda: two.knn_batch(kus, pts, k)},
        ),
        "polygon": (
            lambda: polygon_reach_host(idx, pus, polys),
            {"two_phase": lambda: eng.polygon_batch(pus, polys)},
        ),
    }


def class_sweep(dataset="gowalla", scale=0.5, n_q=2000, k=10,
                repeats=5, variant="comp",
                device: DeviceLike = None) -> List[Dict]:
    dev = resolve_device(device)
    g = get_dataset(dataset, scale=scale)
    idx = build_2dreach(g, variant=variant)
    eng = engine_for(idx, device=dev)
    two = QueryEngine(idx, device=dev, path="two_phase")
    cases = class_cases(idx, eng, two, class_workload(g, n_q), k)

    def compiles():
        return eng.n_compiles + two.n_compiles

    # warm every class and path (the candidate/collect-cap high-water
    # marks), checking each against the host, then gate on flat compiles
    for kind, (host_fn, paths) in cases.items():
        host_ans = host_fn()
        for path, dev_fn in paths.items():
            assert _same(kind, host_ans, dev_fn()), \
                f"{kind}: {path} answers diverge from host"
    warm = compiles()

    def _stage_pass(fn):
        """One instrumented pass after the timed one: per-stage span
        attribution without skewing the us_per_q numbers."""
        was = obs.enabled()
        obs.enable()
        sub0 = obs.stage_totals("engine.")
        fn()
        sub1 = obs.stage_totals("engine.")
        if not was:
            obs.disable()
        return {k2: round(sub1.get(k2, 0.0) - sub0.get(k2, 0.0), 3)
                for k2 in sub1
                if sub1.get(k2, 0.0) > sub0.get(k2, 0.0)}

    rows = []
    for kind, (host_fn, paths) in cases.items():
        compiles0 = compiles()
        dev_fn = paths.get("fused", paths["two_phase"])
        t_host = _t(host_fn, repeats=repeats)
        t_dev = _t(dev_fn, repeats=repeats)
        row = dict(
            query_class=kind, variant=variant, n_queries=n_q, k=k,
            device_path="fused" if "fused" in paths else "two_phase",
            host_us_per_q=t_host / n_q * 1e6,
            device_us_per_q=t_dev / n_q * 1e6,
            device_stage_us=_stage_pass(dev_fn),
        )
        if "fused" in paths:
            t_tp = _t(paths["two_phase"], repeats=repeats)
            row["two_phase_us_per_q"] = t_tp / n_q * 1e6
            row["two_phase_stage_us"] = _stage_pass(paths["two_phase"])
        row["steady_state_recompiles"] = compiles() - compiles0
        rows.append(row)
    rows.append(dict(query_class="_all", variant=variant, n_queries=n_q,
                     k=k, host_us_per_q=None, device_us_per_q=None,
                     steady_state_recompiles=compiles() - warm,
                     device=device_name(dev)))
    return rows


def bench_summary(rows: List[Dict]) -> Dict:
    classes = {}
    for r in rows:
        if r["query_class"] == "_all":
            continue
        cls = {
            "host_us_per_q": r["host_us_per_q"],
            "device_path": r["device_path"],
            "device_us_per_q": r["device_us_per_q"],
            "device_stage_us": r.get("device_stage_us"),
        }
        if r.get("two_phase_us_per_q") is not None:
            cls["two_phase_us_per_q"] = r["two_phase_us_per_q"]
            cls["two_phase_stage_us"] = r.get("two_phase_stage_us")
            cls["fusion_speedup_x"] = (
                r["two_phase_us_per_q"] / r["device_us_per_q"]
                if r["device_us_per_q"] else None)
        classes[r["query_class"]] = cls
    total_rec = int(sum(r["steady_state_recompiles"] for r in rows
                        if r["query_class"] != "_all"))
    return {
        "schema_version": 2,
        "unit": "us_per_query",
        "device": next(r["device"] for r in rows
                       if r["query_class"] == "_all"),
        "classes": classes,
        "device_bit_identical_to_host": True,   # asserted before timing
        "steady_state_recompiles": total_rec,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale subset for CI")
    ap.add_argument("--device", default=None,
                    help="where the engines serve (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)

    if args.smoke:
        rows = class_sweep(dataset="yelp", scale=0.1, n_q=256, k=8,
                           repeats=2, device=dev)
    else:
        rows = class_sweep(device=dev)
    with open(result_path("perf_queries.json"), "w") as f:
        json.dump({"class_sweep": rows}, f, indent=1)
    summary = bench_summary(rows)
    with open(result_path("BENCH_queries.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for r in rows:
        print(r)
    print(json.dumps(summary, indent=1))
    assert summary["steady_state_recompiles"] == 0, \
        "analytics steady-state recompile"
    assert set(summary["classes"]) == set(CLASSES), \
        "missing query class in the bench summary"


if __name__ == "__main__":
    main()
