"""CI gate: disabled ``repro_torch.obs`` instrumentation costs <2% (the
port of the reference's ``benchmarks/obs_overhead.py``, on the port's
engine on ``--device``, the GPU by default).

The observability layer promises that, when disabled, its hot-path hooks
are a single attribute check returning a shared no-op context manager.
A naive A/B wall-clock comparison of instrumented-vs-stripped serving is
too noisy to gate on (the effect is well under run-to-run variance), so
this bench gates **analytically**:

1. measure the per-call cost of a *disabled* ``span()`` directly, by
   timing a tight loop of them (amortising the loop overhead away);
2. serve a real smoke batch stream with obs disabled and measure the
   per-batch wall time;
3. count how many ``span()``/``_obs_batch`` hook sites one batch
   actually crosses (from one *enabled* batch's event count);
4. assert  hooks_per_batch x cost_per_disabled_hook  <  2% of the
   measured per-batch time.

This bounds the disabled overhead with the measured per-hook cost while
staying deterministic enough for CI.  The enabled-path cost is reported
too (informational — enabling obs is an explicit opt-in).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import obs
from ..core import QueryEngine, build_2dreach
from ..data import get_dataset, workload
from ..device import resolve_device
from ..obs import trace_context
from ..obs.audit import ExactnessAuditor
from ..resilience.faults import INJECTOR, FaultPlan, fault_point, inject
from . import build_kernels, device_name, result_path

GATE = 0.02          # disabled instrumentation must stay under 2%
SPAN_CALLS = 200_000


def disabled_span_cost_s() -> float:
    """Per-call seconds of a disabled ``span()`` (enter + exit)."""
    assert not obs.enabled()
    # amortise timer + loop overhead over a large call count; take the
    # best of several rounds (minimum filters scheduler noise)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(SPAN_CALLS):
            with obs.span("overhead.probe"):
                pass
        best = min(best, (time.perf_counter() - t0) / SPAN_CALLS)
    return best


def batch_time_s(eng, us, rects, repeats=20) -> float:
    """Median per-batch seconds with obs disabled (warm shapes)."""
    eng.query_batch(us, rects)   # warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        eng.query_batch(us, rects)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def hooks_per_batch(eng, us, rects) -> int:
    """Span events one engine batch records when enabled — every one of
    them is a disabled-path hook site (the registry recordings in
    ``_obs_batch`` sit behind the same gate, counted via +1)."""
    obs.enable()
    n0 = len(obs.TRACER)
    eng.query_batch(us, rects)
    n = len(obs.TRACER) - n0
    obs.disable()
    return n + 1          # + the gated _obs_batch metrics block


def disabled_fault_point_cost_s() -> float:
    """Per-call seconds of a disabled ``fault_point()`` — the same
    single-attribute-check promise the obs spans make."""
    assert not INJECTOR.enabled
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(SPAN_CALLS):
            fault_point("overhead.probe")
        best = min(best, (time.perf_counter() - t0) / SPAN_CALLS)
    return best


def fault_hooks_per_batch(eng, us, rects) -> int:
    """Fault-point crossings one engine batch makes, counted by running
    a batch with an *empty* plan installed (every hit is a no-op but
    still counted by the injector)."""
    with inject(FaultPlan()):
        n0 = INJECTOR.hits_total
        eng.query_batch(us, rects)
        n = INJECTOR.hits_total - n0
    return n


def disabled_trace_cost_s(batch: int) -> float:
    """Per-batch seconds of the frontend's *disabled-path* causal-trace
    plumbing: one tracer-enabled check per submit returning the shared
    null context (minting and the scope push only happen enabled).
    Measured differentially — the same list build without the gate is
    subtracted — so loop machinery cancels and only the branch +
    attribute read remain."""
    assert not obs.enabled()
    tr = obs.TRACER
    null = trace_context.NULL
    rounds = max(SPAN_CALLS // max(batch, 1), 50)

    def best_of(body):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _i in range(rounds):
                body()
            best = min(best, (time.perf_counter() - t0) / rounds)
        return best

    gated = best_of(lambda: [trace_context.mint(u=j) if tr.enabled
                             else null for j in range(batch)])
    base = best_of(lambda: [null for _j in range(batch)])
    return max(0.0, gated - base)


def enabled_mint_cost_s(batch: int) -> float:
    """Per-batch seconds of minting ``batch`` contexts + one scope
    push/pop — the *enabled* (opted-in) cost, reported informationally
    next to the enabled span cost."""
    rounds = max(SPAN_CALLS // max(batch, 1), 50)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(rounds):
            ctxs = [trace_context.mint(u=j) for j in range(batch)]
            with trace_context.scope(ctxs):
                pass
        best = min(best, (time.perf_counter() - t0) / rounds)
    return best


def disabled_observe_cost_s(idx, us, rects) -> float:
    """Per-batch seconds of a *disabled* auditor ``observe`` (sampling
    off — the default), offered the whole batch."""
    aud = ExactnessAuditor(idx, sample=0.0)
    ans = np.zeros(len(us), dtype=bool)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _i in range(2000):
            aud.observe(us, rects, ans)
        best = min(best, (time.perf_counter() - t0) / 2000)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="same scale either way — flag kept for CI "
                         "symmetry with the perf benches")
    ap.add_argument("--device", default=None,
                    help="where the engine serves (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)

    g = get_dataset("yelp", scale=0.1)
    idx = build_2dreach(g, variant="comp")
    eng = QueryEngine(idx, device=dev)
    us, rects = workload(g, 256, extent_ratio=0.05, seed=11)

    obs.disable()
    per_hook = disabled_span_cost_s()
    per_batch = batch_time_s(eng, us, rects)
    hooks = hooks_per_batch(eng, us, rects)
    overhead = hooks * per_hook / per_batch
    fp_hook = disabled_fault_point_cost_s()
    fp_hooks = fault_hooks_per_batch(eng, us, rects)
    fp_overhead = fp_hooks * fp_hook / per_batch
    trace_batch = disabled_trace_cost_s(len(us))
    mint_batch = enabled_mint_cost_s(len(us))
    observe_batch = disabled_observe_cost_s(idx, us, rects)
    trace_overhead = (trace_batch + observe_batch) / per_batch

    report = {
        "device": device_name(dev),
        "disabled_span_cost_ns": per_hook * 1e9,
        "hooks_per_batch": hooks,
        "batch_time_us_disabled": per_batch * 1e6,
        "disabled_overhead_fraction": overhead,
        "disabled_fault_point_cost_ns": fp_hook * 1e9,
        "fault_hooks_per_batch": fp_hooks,
        "disabled_fault_overhead_fraction": fp_overhead,
        "disabled_trace_gate_us_per_batch": trace_batch * 1e6,
        "enabled_mint_us_per_batch": mint_batch * 1e6,
        "disabled_audit_observe_us_per_batch": observe_batch * 1e6,
        "trace_overhead_fraction": trace_overhead,
        "gate": GATE,
        "passed": bool(overhead < GATE and fp_overhead < GATE
                       and trace_overhead < GATE),
    }
    with open(result_path("obs_overhead.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    assert overhead < GATE, (
        f"disabled obs instrumentation costs {overhead * 100:.2f}% of a "
        f"batch ({hooks} hooks x {per_hook * 1e9:.0f}ns vs "
        f"{per_batch * 1e6:.0f}us) — over the {GATE * 100:.0f}% gate")
    assert fp_overhead < GATE, (
        f"disabled fault hooks cost {fp_overhead * 100:.2f}% of a batch "
        f"({fp_hooks} hooks x {fp_hook * 1e9:.0f}ns vs "
        f"{per_batch * 1e6:.0f}us) — over the {GATE * 100:.0f}% gate")
    assert trace_overhead < GATE, (
        f"disabled trace gate + disabled audit observe cost "
        f"{trace_overhead * 100:.2f}% of a batch "
        f"({(trace_batch + observe_batch) * 1e6:.1f}us vs "
        f"{per_batch * 1e6:.0f}us) — over the {GATE * 100:.0f}% gate")


if __name__ == "__main__":
    main()
