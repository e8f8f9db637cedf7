"""Gate: a chaos-driven SLO burn freezes a replayable flight bundle (the
port of the reference's ``benchmarks/chaos_flight.py``).

The flight recorder's promise is end to end: when a burn-rate monitor
fires mid-serve, the frozen bundle must be self-contained (all six
artifacts present) and causally complete: every request in the
window's p99 latency bucket, reached either through the manifest's
worst-trace table or through the queue-wait histogram's p99 exemplars,
must resolve to a full causal chain (admission record, engine and
kernel spans carrying its trace id, retries and degradation events,
completion status).  This bench stages that incident and asserts all of
it, exiting nonzero on any gap:

1. serve a clean warm phase through ``ResilientEngine`` + ``Frontend``
   over a ``QueryEngine`` on ``--device`` (the GPU by default), with
   tracing on and the recorder armed (the SLO monitor ticking on the
   time-series cadence, short windows so the run stays short);
2. inject deterministic device faults (raises, then retries, then the
   exact host degradation) until the ``degraded`` burn rate fires;
3. assert a burn-triggered bundle exists, replays through
   :func:`repro_torch.obs.flight.replay` with every worst trace
   complete, and that the CLI (``python -m repro_torch.obs.flight
   <bundle>``) agrees.

The bundles go under ``--out`` (default ``results/torch/chaos_flight``).

    PYTHONPATH=src python -m repro_torch.benchmarks.chaos_flight
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from .. import obs
from ..cluster import Frontend
from ..core import QueryEngine, build_2dreach, make_graph
from ..device import resolve_device
from ..obs import flight as obs_flight
from ..resilience import ResilientEngine
from ..resilience.faults import FaultPlan, FaultSpec, inject
from ..resilience.retry import RetryPolicy
from . import RESULTS, build_kernels

BUNDLE_FILES = ("manifest.json", "trace.json", "spans.jsonl",
                "querylog.jsonl", "events.jsonl", "metrics.json")
# the package root, for the replay CLI's subprocess
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _graph(n=400, m=1200, seed=0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2))
    spatial = rng.random(n) < 0.4
    coords = (rng.random((n, 2)) * 100).astype(np.float32)
    return make_graph(n, edges, coords, spatial)


def _queries(g, n_q, seed=1):
    rng = np.random.default_rng(seed)
    us = rng.integers(0, g.n_nodes, size=n_q)
    lo = rng.random((n_q, 2)).astype(np.float32) * 70
    return us, np.hstack([lo, lo + 30]).astype(np.float32)


def _drive(fe, us, rects):
    futs = [fe.submit(int(u), r) for u, r in zip(us, rects)]
    fe.flush(timeout=60)
    return [f.result(timeout=60) for f in futs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="output root (default: results/torch/"
                         "chaos_flight, emptied first)")
    ap.add_argument("--device", default=None,
                    help="where the engine serves (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)
    out_dir = args.out or os.path.join(RESULTS, "chaos_flight")
    dump_dir = os.path.join(out_dir, "flightdump")
    shutil.rmtree(dump_dir, ignore_errors=True)   # bundles of this run only
    os.makedirs(out_dir, exist_ok=True)

    g = _graph()
    idx = build_2dreach(g, variant="comp")
    eng = QueryEngine(idx, device=dev)
    us, rects = _queries(g, 512)

    obs.reset()
    obs.enable()
    obs.FLIGHT.arm(dump_dir, min_interval_s=0.0)
    mon = obs.default_slos(obs.SLOMonitor(clock=time.time),
                           windows=(0.2, 0.8))
    ts = obs.start_timeseries(interval=0.05)
    ts.add_hook(lambda t, _s: mon.tick(t))

    ren = ResilientEngine(eng, idx, name="chaos",
                          retry=RetryPolicy(max_attempts=2, base_s=1e-4,
                                            cap_s=1e-3))
    fe = Frontend(ren, max_batch=64, max_delay=1e-3)
    try:
        fe.warmup(us[:64], rects[:64])
        # phase 1: clean traffic sets the burn-rate baseline
        t_end = time.time() + 1.0
        while time.time() < t_end:
            _drive(fe, us[:64], rects[:64])
        assert not any(e["kind"] == "fired" for e in mon.events), \
            "SLO fired during the clean phase"

        # phase 2: every device batch raises, then retries, then the
        # exact host degradation; the degraded fraction burns through
        # its budget.  (The breaker opens within a few batches and
        # freezes its own bundle: keep driving until the burn-rate
        # monitor fires, which needs the long window to fill with
        # degraded traffic.)
        plan = FaultPlan(
            FaultSpec("engine.query_batch", kind="raise", p=1.0,
                      max_fires=None),
            seed=7,
        )
        with inject(plan):
            t_end = time.time() + 5.0
            while time.time() < t_end and not any(
                    e["kind"] == "fired" for e in mon.events):
                _drive(fe, us[64:128], rects[64:128])
    finally:
        fe.close()
        obs.stop_timeseries()

    fired = [e for e in mon.events if e["kind"] == "fired"]
    assert fired, f"no SLO fired under chaos (events: {mon.events})"
    assert plan.total_fires > 0, "no faults actually fired"

    snap = obs.FLIGHT.snapshot()
    assert snap["dumps"] >= 1, f"burn fired but no bundle frozen: {snap}"
    # several triggers may have frozen bundles (the breaker opening is
    # one): the gate takes the burn-triggered bundle
    manifests = {}
    for b in sorted(os.listdir(dump_dir)):
        with open(os.path.join(dump_dir, b, "manifest.json")) as f:
            manifests[b] = json.load(f)
    slo_bundles = [b for b, m in manifests.items()
                   if m["reason"].startswith("slo-")]
    assert slo_bundles, (
        f"burn fired but no slo-* bundle among "
        f"{[m['reason'] for m in manifests.values()]}")
    bundle = os.path.join(dump_dir, slo_bundles[0])
    manifest = manifests[slo_bundles[0]]
    print(f"[chaos-flight] SLO(s) fired: "
          f"{sorted({e['slo'] for e in fired})}; bundle {bundle}")

    # -- self-contained: every artifact present and parseable ----------
    for fname in BUNDLE_FILES:
        path = os.path.join(bundle, fname)
        assert os.path.exists(path), f"bundle missing {fname}"
    assert manifest["counts"]["spans"] > 0
    assert manifest["counts"]["querylog"] > 0

    # -- causally complete: p99 traces resolve end to end --------------
    rep = obs_flight.replay(bundle, top=8)
    assert rep["stories"], "no worst traces resolvable in the bundle"
    incomplete = [s["trace_id"] for s in rep["stories"]
                  if not s["complete"]]
    assert not incomplete, (
        f"p99 traces without a full causal chain: {incomplete}")
    # the p99 exemplars of the queue-wait histogram must be resolvable
    # requests too
    assert "frontend.queue_wait_us" in manifest["exemplars"], \
        "no queue-wait exemplars retained"
    assert rep["exemplar_ids"], "no exemplar trace ids to resolve"
    data = obs_flight.load_bundle(bundle)
    for tid in rep["exemplar_ids"]:
        story = obs_flight.resolve_trace(data, tid)
        assert story["complete"], (
            f"p99 exemplar trace {tid} does not resolve to a full "
            f"causal chain")
    # retries and degradation made it into the frozen story
    assert any(e.get("kind") in ("engine.retry", "engine.degraded",
                                 "fault.injected")
               for e in data["events"]), "no chaos events in black box"
    assert any(r.get("status") == "degraded" for r in data["querylog"]), \
        "no degraded records in the frozen querylog window"

    # -- and the CLI agrees --------------------------------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.flight", bundle, "--top",
         "8"], capture_output=True, text=True, env=env, timeout=300)
    print(proc.stdout)
    assert proc.returncode == 0, (
        f"replay CLI failed ({proc.returncode}):\n{proc.stderr}")

    n_ex = sum(len(v) for b in manifest["exemplars"].values()
               for v in b.values())
    print(f"[chaos-flight] PASS: bundle self-contained, "
          f"{len(rep['stories'])} p99 traces + "
          f"{len(rep['exemplar_ids'])} exemplar traces causally "
          f"complete, {n_ex} exemplars retained, "
          f"{plan.total_fires} faults fired")
    obs.disable()
    obs.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
