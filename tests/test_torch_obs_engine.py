"""The port's observability hooks on its build and serving path against
the JAX package's, on the CPU.

Both packages build the same yelp x0.05 graph, or serve the same index
(carried across with ``repro_torch.convert``), with their tracers on:
the same span names with the same parent/child nesting for the same
calls, the same metric names and counts (all but the value of the
``engine.n_compiles`` gauge: the reference counts jit caches, the port
the shapes it has served), and ``engine_cost_model`` equal term for
term.  Then the reference's engine-side tests of ``tests/test_obs.py``,
``test_trace.py`` and ``test_flight.py`` that need no frontend,
dynamic index or cluster, on the port's engine (those of the resilience
layer through ``repro_torch.resilience``); and ``device_trace`` writing
a CPU trace.  Both packages' obs state is reset
before and after every test, and no tracer is left on.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

import repro.core as R
import repro.data as RD
from repro import obs as ROBS
from repro_torch import obs
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    batch_query,
    build_2dreach,
    build_index,
    rangereach_oracle_batch,
)
from repro_torch.data import get_dataset, polygon_workload, workload
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import trace_context
from repro_torch.obs.audit import ExactnessAuditor
from repro_torch.obs.flight import FLIGHT
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.querylog import QUERY_LOG
from repro_torch.resilience import (
    BreakerPolicy,
    CircuitBreaker,
    FaultPlan,
    FaultSpec,
    ResilientEngine,
    RetryPolicy,
    inject,
)
from test_torch_obs import check_openmetrics

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
BOTH = (ROBS, obs)
PATHS = ("fused", "two_phase")


@pytest.fixture(autouse=True)
def _obs_clean():
    for o in BOTH:
        o.disable()
        o.reset()
    yield
    for o in BOTH:
        o.disable()
        o.reset()


@pytest.fixture(scope="module")
def graphs():
    return RD.get_dataset("yelp", scale=0.05), get_dataset("yelp", scale=0.05)


@pytest.fixture(scope="module")
def ref_index(graphs):
    return R.build_2dreach(graphs[0], variant="comp")


@pytest.fixture(scope="module")
def built(graphs, ref_index):
    """A port index and engine (CPU), and a workload over its graph."""
    g = graphs[1]
    idx = index_from_arrays(index_to_arrays(ref_index))
    eng = QueryEngine(idx, device="cpu")
    us, rects = workload(g, 128, extent_ratio=0.05, seed=7)
    return g, idx, eng, us, rects


def _fresh_pair(ref_index, path):
    """A reference engine and a port engine over fresh copies of one
    index (no memoised transposition or planes), made while the tracers
    record."""
    ref = dataclasses.replace(ref_index,
                              forest=dataclasses.replace(ref_index.forest))
    port = index_from_arrays(index_to_arrays(ref_index))
    return (R.QueryEngine(ref, interpret=True, fused_impl="xla", path=path),
            QueryEngine(port, device="cpu", path=path))


def nesting(events):
    """The recorded spans as ``[(depth, name)]`` in start order; a
    span's depth counts the spans of its thread that enclose it."""
    out, stacks = [], {}
    for t0, neg, name, tid in sorted((e[3], -e[4], e[0], e[2])
                                     for e in events):
        st = stacks.setdefault(tid, [])
        while st and st[-1] <= t0:
            st.pop()
        out.append((len(st), name))
        st.append(t0 - neg)
    return out


def _calls(eng, us, rects, polys):
    eng.query_batch(us, rects)
    eng.count_batch(us, rects)
    eng.collect_batch(us, rects, 5)
    eng.query_batch(us[:5], rects[:5])
    pts = ((rects[:32, :2] + rects[:32, 2:]) / 2).astype(np.float32)
    eng.knn_batch(us[:32], pts, 4)
    eng.polygon_batch(*polys)


def _metrics(o):
    """The metrics that moved since the last reset (``reset`` keeps the
    names earlier tests registered, at 0): counter values, histogram
    counts and gauge names."""
    snap = o.REGISTRY.snapshot()
    return ({k: v for k, v in snap["counters"].items() if v},
            {k: v["count"] for k, v in snap["histograms"].items()
             if v["count"]},
            sorted(k for k, v in snap["gauges"].items() if v["max"]))


# ------------------------------------------------------- parity

@pytest.mark.parametrize("path", PATHS)
def test_engine_spans_and_metrics_match_reference(graphs, ref_index, path):
    us, rects = workload(graphs[1], 40, extent_ratio=0.06, seed=3)
    polys = polygon_workload(graphs[1], 24, n_edges=5, extent_ratio=0.05,
                             seed=1)
    trees, metrics = [], []
    for o in BOTH:
        o.enable()
    ref, eng = _fresh_pair(ref_index, path)
    for e in (ref, eng):
        _calls(e, us, rects, polys)
    for o in BOTH:
        o.disable()
    for o in (ROBS, obs):
        trees.append(nesting(o.TRACER.events()))
        metrics.append(_metrics(o))
    assert trees[1] == trees[0]
    names = {n for _, n in trees[1]}
    assert {"engine.soa_upload", "build.soa_transpose", "engine.pad_batch",
            "engine.query_batch", "engine.count_batch",
            "engine.collect_batch", "engine.knn_batch",
            "engine.polygon_batch", "engine.scan", "engine.sync",
            "engine.route_prune"} <= names
    assert ("engine.fused" in names) == (path == "fused")
    assert metrics[1] == metrics[0]
    assert metrics[1][0]["engine.upload.host_uploads"] == 1
    assert metrics[1][0]["range_query.soa_builds"] == 1
    assert REGISTRY.gauge("engine.n_compiles").value == eng.n_compiles > 0


@pytest.mark.parametrize("backend", ["host", "device"])
def test_build_spans_match_reference(graphs, backend):
    trees = []
    for o, build in ((ROBS, R.build_2dreach), (obs, build_2dreach)):
        o.enable()
        kw = {"device": "cpu"} if o is obs and backend == "device" else {}
        build(graphs[o is obs], variant="comp", backend=backend, **kw)
        o.disable()
        trees.append(nesting(o.TRACER.events()))
    assert trees[1] == trees[0]
    names = [n for _, n in trees[1]]
    assert names[:4] == ["build.scc", "build.closure", "build.assign",
                         "build.forest"]
    if backend == "device":
        assert (1, "build.forest.morton_sort") in trees[1]
        assert (1, "build.forest.pyramid") in trees[1]
    assert names[-1] == "build.pointers"


@pytest.mark.parametrize("path", PATHS)
def test_engine_cost_model_matches_reference(graphs, ref_index, path):
    ref, eng = _fresh_pair(ref_index, path)
    for seed in range(2):
        us, rects = workload(graphs[1], 70, extent_ratio=0.06, seed=seed)
        for e in (ref, eng):
            e.query_batch(us, rects)
            e.count_batch(us, rects)
    for k in ("batches", "queries", "tiles_scanned", "tiles_grid",
              "tiles_full_scan"):
        assert eng.stats[k] == ref.stats[k], k
    assert obs.engine_cost_model(eng) == ROBS.engine_cost_model(ref)


def test_host_fallback_counts_match_reference(graphs):
    """The unsupported-index half of the reference's
    ``test_host_fallback_warns_once_per_reason_and_counts``: one warning
    per (reason, index type), every fallback counted, in both packages
    alike (the host-engine wrapper half waits for the dynamic index)."""
    import repro.core.api as rapi
    import repro_torch.core.api as api

    us, rects = workload(graphs[1], 4, extent_ratio=0.05, seed=1)
    geo = (R.build_index(graphs[0], "georeach"),
           build_index(graphs[1], "georeach"))
    counts = []
    for o, mod, bq, idx, kw in ((ROBS, rapi, R.batch_query, geo[0], {}),
                                (obs, api, batch_query, geo[1],
                                 {"device": "cpu"})):
        mod._FALLBACK_WARNED.discard(("unsupported-index", "GeoReachIndex"))
        c = o.REGISTRY.counter("api.host_fallback.unsupported-index")
        with pytest.warns(RuntimeWarning, match="unsupported-index"):
            bq(idx, us, rects, engine="device", **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            bq(idx, us, rects, engine="device", **kw)
        counts.append(c.value)
    assert counts == [2, 2]


# ------------------------------------------- engine (reference test_obs)

def test_engine_batch_metrics_gated(built):
    _, _, eng, us, rects = built
    eng.query_batch(us, rects)
    h = REGISTRY.histogram("engine.batch_us")
    c0 = h.snapshot()["count"]
    obs.enable()
    eng.query_batch(us, rects)
    obs.disable()
    assert h.snapshot()["count"] == c0 + 1
    assert REGISTRY.counter("engine.reach.queries").value >= len(us)
    assert REGISTRY.gauge("engine.n_compiles").value == eng.n_compiles
    eng.query_batch(us, rects)
    assert h.snapshot()["count"] == c0 + 1


def test_mixed_serve_coverage_at_least_95pct(built):
    """The engine half of the reference's coverage gate (its frontend
    half waits for the cluster's ``Frontend``): spans cover >= 95% of a
    mixed engine pass."""
    _, _, eng, us, rects = built
    polys = polygon_workload(built[0], 32, n_edges=6, extent_ratio=0.05,
                             seed=2)
    pts = ((rects[:16, :2] + rects[:16, 2:]) / 2).astype(np.float32)
    obs.enable()
    t0 = time.perf_counter()
    with obs.span("serve.mixed_pass", cat="serve"):
        eng.query_batch(us, rects)
        eng.count_batch(us, rects)
        eng.collect_batch_two_phase(us, rects, 4)
        eng.knn_batch(us[:16], pts, 4)
        eng.polygon_batch(*polys)
    t1 = time.perf_counter()
    obs.disable()
    assert obs.coverage(t0, t1) >= 0.95
    layers = {name.split(".")[0] for name in obs.stage_totals()}
    assert {"serve", "engine"} <= layers
    snap = obs.snapshot()
    assert snap["schema_version"] == 2
    assert "engine.fused" in snap["spans"]
    assert "engine.route_prune" in snap["spans"]


def test_obs_dump_writes_artifacts(tmp_path, built):
    _, _, eng, us, rects = built
    obs.enable()
    eng.query_batch(us, rects)
    obs.disable()
    paths = obs.dump(str(tmp_path))
    trace = json.load(open(paths["trace"]))
    assert any(e["name"] == "engine.query_batch"
               for e in trace["traceEvents"])
    snap = json.load(open(paths["metrics"]))
    assert "engine.batch_us" in snap["metrics"]["histograms"]
    qlines = open(paths["querylog"]).read().splitlines()
    assert len(qlines) == 1
    prom = open(paths["prom"]).read()
    lines = check_openmetrics(prom)
    assert "repro_engine_batch_us_count 1" in lines


def test_engine_cost_model_sanity(built):
    _, _, eng, us, rects = built
    eng.query_batch(us, rects)
    cm = obs.engine_cost_model(eng)
    assert cm["batches"] >= 1
    assert 0 < cm["candidate_tiles_per_batch"] <= \
        cm["full_scan_tiles_per_batch"]
    assert 0 < cm["scan_fraction"] <= 1.0
    assert cm["scan_bytes_per_batch"] > 0
    assert cm["prune_bytes_per_batch"] > 0
    assert cm["tile_shape"] == {"TB": 8, "TP": 128, "planes": 4}


def test_n_compiles_flat_in_steady_state(built):
    g, idx, _, us, rects = built
    eng = QueryEngine(idx, device="cpu")
    polys = polygon_workload(g, 64, n_edges=6, extent_ratio=0.05, seed=4)
    seen = []
    for _ in range(3):
        for s in range(0, len(us), 32):
            u, r = us[s:s + 32], rects[s:s + 32]
            eng.query_batch(u, r)
            eng.count_batch_two_phase(u, r)
            eng.collect_batch(u, r, 6)
        eng.polygon_batch(polys[0][:32], polys[1][:32])
        seen.append(eng.n_compiles)
    assert seen[0] > 0 and seen[1] == seen[2]
    eng.query_batch(us[:3], rects[:3])            # a new batch bucket
    assert eng.n_compiles == seen[2] + 1


def test_device_trace_writes_a_cpu_trace(tmp_path, built):
    _, _, eng, us, rects = built
    logdir = str(tmp_path / "prof")
    with obs.device_trace(logdir, device="cpu"):
        with obs.annotate("unit.annotated"):
            eng.query_batch(us, rects)
    path = os.path.join(logdir, obs.profiler.TRACE_FILE)
    trace = json.load(open(path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "unit.annotated" in names
    off = str(tmp_path / "off")
    with obs.device_trace(off, enabled=False):
        eng.query_batch(us, rects)
    assert not os.path.exists(off)


# --------------------------------------- trace ids (reference test_trace)

def test_padder_bucketing_spans_carry_trace_ids(built):
    _, _, eng, us, rects = built
    B = 5
    ctxs = [trace_context.mint(u=int(u)) for u in us[:B]]
    eng.query_batch(us[:B], rects[:B])
    obs.enable()
    with trace_context.scope(ctxs):
        eng.query_batch(us[:B], rects[:B])
    want = [c.trace_id for c in ctxs]
    by_name = {e[0]: e[5] for e in obs.TRACER.events()}
    for name in ("engine.query_batch", "engine.pad_batch"):
        assert name in by_name, sorted(by_name)
        assert by_name[name]["trace_ids"] == want, name


def test_retry_and_two_phase_degradation_attribution(built):
    """Injected device failures: last_report names the specific trace
    ids that were retried and then degraded (two_phase target)."""
    _, idx, eng, us, rects = built
    ren = ResilientEngine(
        eng, idx, name="trace-attrib", degraded_path="two_phase",
        retry=RetryPolicy(max_attempts=2, base_s=1e-4, cap_s=1e-3),
        sleep=lambda s: None)
    B = 8
    ctxs = [trace_context.mint(u=int(u)) for u in us[:B]]
    want = [c.trace_id for c in ctxs]
    # exactly the two device attempts fail; the two_phase degradation
    # target crosses the same fault point, so it must stay unpoisoned
    plan = FaultPlan(FaultSpec("engine.query_batch", kind="raise",
                               max_fires=2), seed=5)
    with inject(plan):
        with trace_context.scope(ctxs):
            out = ren.query_batch(us[:B], rects[:B])
    rep = ren.last_report
    assert rep["trace_ids"] == want
    assert rep["retries"] == 1
    assert rep["retried_trace_ids"] == want      # whole batch retried
    assert rep["degraded_trace_ids"] == want     # ... then degraded
    assert rep["degraded"].all()
    assert (rep["attempts"] == 2).all()          # both device attempts
    # degradation is exact: two_phase answers match the host truth
    assert (out == idx.query_batch(us[:B], rects[:B])).all()


def test_partial_failure_attributes_only_failed_ids(built):
    """One poisoned attempt then success: attempts reflects per-query
    device cost and nothing is degraded."""
    _, idx, eng, us, rects = built
    ren = ResilientEngine(
        eng, idx, name="trace-partial",
        retry=RetryPolicy(max_attempts=3, base_s=1e-4, cap_s=1e-3),
        sleep=lambda s: None)
    B = 4
    ctxs = [trace_context.mint(u=int(u)) for u in us[:B]]
    with inject(FaultPlan(FaultSpec("engine.query_batch", kind="raise",
                                    max_fires=1), seed=2)):
        with trace_context.scope(ctxs):
            ren.query_batch(us[:B], rects[:B])
    rep = ren.last_report
    assert rep["retried_trace_ids"] == [c.trace_id for c in ctxs]
    assert rep["degraded_trace_ids"] == []
    assert not rep["degraded"].any()
    assert (rep["attempts"] == 2).all()


# ------------------------------------------ flight (reference test_flight)

def _populate_window(eng, us, rects, n=32):
    obs.enable()
    ctxs = [trace_context.mint(u=int(u)) for u in us[:n]]
    with trace_context.scope(ctxs):
        ans = eng.query_batch(us[:n], rects[:n])
    QUERY_LOG.record_batch(
        "reach", ["member"] * n, rects[:n], [0] * n,
        np.full(n, 250e-6), np.zeros(n, dtype=np.int64),
        us=us[:n], trace_ids=[c.trace_id for c in ctxs],
        attempts=[1] * n)
    h = REGISTRY.histogram("frontend.queue_wait_us")
    for c in ctxs:
        h.record(250.0 + c.trace_id, exemplar=c.trace_id)
    return ctxs, ans


def test_manual_dump_bundle_contents(built, tmp_path):
    _, _, eng, us, rects = built
    ctxs, _ = _populate_window(eng, us, rects)
    bundle = obs.dump_flight(reason="manual", dirpath=str(tmp_path))
    assert bundle is not None and os.path.isdir(bundle)
    assert os.path.basename(bundle) == "000-manual"
    for fname in ("manifest.json", "trace.json", "spans.jsonl",
                  "querylog.jsonl", "events.jsonl", "metrics.json"):
        assert os.path.exists(os.path.join(bundle, fname)), fname
    with open(os.path.join(bundle, "manifest.json")) as f:
        man = json.load(f)
    assert man["schema_version"] == 1
    assert man["reason"] == "manual"
    assert man["counts"]["spans"] > 0
    assert man["counts"]["querylog"] == len(ctxs)
    assert man["worst_traces"]
    assert "frontend.queue_wait_us" in man["exemplars"]
    with open(os.path.join(bundle, "spans.jsonl")) as f:
        assert json.loads(f.readline())["fields"][0] == "name"


def test_rate_limit_and_force(built, tmp_path):
    _, _, eng, us, rects = built
    _populate_window(eng, us, rects, n=4)
    FLIGHT.arm(str(tmp_path), min_interval_s=3600.0)
    assert FLIGHT.trigger("first") is not None
    assert FLIGHT.trigger("second") is None
    assert REGISTRY.counter("flight.suppressed").value == 1
    assert FLIGHT.trigger("forced", force=True) is not None
    assert FLIGHT.snapshot()["dumps"] == 2


def test_max_dumps_budget(built, tmp_path):
    _, _, eng, us, rects = built
    _populate_window(eng, us, rects, n=4)
    FLIGHT.arm(str(tmp_path), min_interval_s=0.0, max_dumps=2)
    assert FLIGHT.trigger("a") is not None
    assert FLIGHT.trigger("b") is not None
    assert FLIGHT.trigger("c") is None
    assert FLIGHT.trigger("d", force=True) is None
    assert len(os.listdir(tmp_path)) == 2


def test_slo_fired_freezes_bundle(built, tmp_path):
    _, _, eng, us, rects = built
    _populate_window(eng, us, rects, n=8)
    FLIGHT.arm(str(tmp_path), min_interval_s=0.0)
    t = [0.0]
    mon = obs.SLOMonitor(clock=lambda: t[0])
    mon.add("latency", "bad", "total", budget=0.01, windows=(1.0,))
    bad, tot = REGISTRY.counter("bad"), REGISTRY.counter("total")
    tot.inc(100)
    mon.tick()
    t[0] = 2.0
    bad.inc(50)
    tot.inc(50)
    assert [e["kind"] for e in mon.tick()] == ["fired"]
    assert FLIGHT.snapshot()["dumps"] == 1
    (bundle,) = os.listdir(tmp_path)
    assert bundle == "000-slo-latency"
    with open(os.path.join(tmp_path, bundle, "manifest.json")) as f:
        assert json.load(f)["detail"]["slo"] == "latency"


def test_breaker_open_freezes_bundle(built, tmp_path):
    _, _, eng, us, rects = built
    _populate_window(eng, us, rects, n=4)
    FLIGHT.arm(str(tmp_path), min_interval_s=0.0)
    br = CircuitBreaker("unit", BreakerPolicy(failure_threshold=3))
    br.record_failure()
    br.record_failure()
    assert FLIGHT.snapshot()["dumps"] == 0           # not yet open
    br.record_failure()                              # threshold: opens
    assert br.state_name == "open"
    assert FLIGHT.snapshot()["dumps"] == 1
    (bundle,) = os.listdir(tmp_path)
    assert bundle.startswith("000-breaker-open")
    assert any(e["kind"] == "breaker.opened" and e["name"] == "unit"
               for e in FLIGHT.events())


def test_auditor_clean_run_zero_divergences(built):
    _, idx, eng, us, rects = built
    aud = ExactnessAuditor(idx, sample=1.0, seed=3)
    ans = eng.query_batch(us, rects)
    assert aud.observe(us, rects, ans,
                       trace_ids=list(range(len(us)))) == len(us)
    assert aud.drain() == len(us)
    rep = aud.report()
    assert rep["divergences"] == 0 and rep["kept"] == []
    assert rep["checked"] == len(us)


def test_auditor_oracle_subsample_clean(built):
    g, idx, eng, us, rects = built
    aud = ExactnessAuditor(idx, graph=g, sample=1.0, oracle_sample=0.5,
                           seed=3)
    aud.observe(us[:32], rects[:32], eng.query_batch(us[:32], rects[:32]))
    aud.drain()
    rep = aud.report()
    assert rep["divergences"] == 0
    assert 0 < rep["oracle_checked"] <= 32


def test_auditor_flags_a_flipped_answer(built, tmp_path):
    """The reference's ``test_auditor_flags_injected_wrong_answer``
    with the answer flipped by hand, and the BFS oracle checking every
    answer: one divergence within one drain, and one
    ``audit-divergence`` bundle naming the flipped query's trace."""
    g, idx, eng, us, rects = built
    ctxs, _ = _populate_window(eng, us, rects, n=16)
    FLIGHT.arm(str(tmp_path), min_interval_s=0.0)
    aud = ExactnessAuditor(idx, graph=g, sample=1.0, oracle_sample=1.0,
                           seed=0)
    ans = eng.query_batch(us[:16], rects[:16]).copy()
    ans[0] = not ans[0]
    aud.observe(us[:16], rects[:16], ans,
                trace_ids=[c.trace_id for c in ctxs])
    assert aud.drain() == 16
    rep = aud.report()
    assert rep["divergences"] == 1 and rep["oracle_checked"] == 16
    (d,) = rep["kept"]
    assert d["served"] != d["expected"]
    assert d["trace_id"] == ctxs[0].trace_id
    (bundle,) = os.listdir(tmp_path)
    assert bundle == "000-audit-divergence"
    assert obs_flight.load_bundle(os.path.join(tmp_path, bundle))[
        "manifest"]["detail"]["trace_id"] == ctxs[0].trace_id
    assert any(e["kind"] == "audit.divergence" for e in FLIGHT.events())


def test_auditor_flags_injected_wrong_answer(built, tmp_path):
    """The e2e proof: a corrupt fault flips one served answer; the
    auditor catches it within one drain and freezes an
    ``audit-divergence`` bundle naming the poisoned trace."""
    _, idx, eng, us, rects = built
    ctxs, _ = _populate_window(eng, us, rects, n=16)
    FLIGHT.arm(str(tmp_path), min_interval_s=0.0)
    aud = ExactnessAuditor(idx, sample=1.0, seed=0)
    plan = FaultPlan(FaultSpec("engine.answer", kind="corrupt",
                               max_fires=1), seed=1)
    with inject(plan):
        with trace_context.scope(ctxs):
            ans = eng.query_batch(us[:16], rects[:16])
    assert plan.fires_at("engine.answer") == 1
    aud.observe(us[:16], rects[:16], ans,
                trace_ids=[c.trace_id for c in ctxs])
    assert aud.drain() == 16                 # one drain suffices
    rep = aud.report()
    assert rep["divergences"] == 1
    (d,) = rep["kept"]
    assert d["served"] != d["expected"]
    assert d["trace_id"] == ctxs[0].trace_id     # mutator flips flat[0]
    # bundle frozen with the offender in the manifest detail
    assert FLIGHT.snapshot()["dumps"] == 1
    (bundle,) = os.listdir(tmp_path)
    assert bundle == "000-audit-divergence"
    with open(os.path.join(tmp_path, bundle, "manifest.json")) as f:
        man = json.load(f)
    assert man["detail"]["trace_id"] == ctxs[0].trace_id
    assert any(e["kind"] == "audit.divergence" for e in FLIGHT.events())
    # the injected fault sits next to the divergence in the black box
    assert any(e["kind"] == "fault.injected"
               and e["point"] == "engine.answer"
               for e in FLIGHT.events())


def test_auditor_sample_zero_is_noop(built):
    _, idx, _, us, rects = built
    aud = ExactnessAuditor(idx, sample=0.0)
    assert aud.observe(us, rects, np.zeros(len(us), bool)) == 0
    assert aud.drain() == 0 and aud.pending() == 0


def test_auditor_sampling_deterministic_and_matches_reference(
        built, ref_index):
    from repro.obs.audit import ExactnessAuditor as RA

    _, idx, _, us, rects = built
    ans = np.zeros(len(us), dtype=bool)

    def taken(A, index, seed):
        a = A(index, sample=0.3, seed=seed)
        a.observe(us, rects, ans, trace_ids=list(range(len(us))))
        with a._lock:
            return [it[3] for it in a._pending]

    assert taken(ExactnessAuditor, idx, 5) == taken(ExactnessAuditor, idx, 5)
    assert 0 < len(taken(ExactnessAuditor, idx, 5)) < len(us)
    assert taken(ExactnessAuditor, idx, 5) == taken(RA, ref_index, 5)


def test_auditor_background_drain_stop_final(built):
    _, idx, eng, us, rects = built
    aud = ExactnessAuditor(idx, sample=1.0, interval=30.0).start()
    try:
        aud.observe(us[:8], rects[:8], eng.query_batch(us[:8], rects[:8]))
    finally:
        aud.stop(final_drain=True)
    assert aud._thread is None
    assert aud.report()["checked"] == 8
    assert aud.pending() == 0


def _frozen_bundle(built, tmp_path):
    _, _, eng, us, rects = built
    ctxs, _ = _populate_window(eng, us, rects)
    return obs.dump_flight(dirpath=str(tmp_path)), ctxs


def test_resolve_trace_complete_story(built, tmp_path):
    bundle, ctxs = _frozen_bundle(built, tmp_path)
    data = obs_flight.load_bundle(bundle)
    story = obs_flight.resolve_trace(data, ctxs[0].trace_id)
    assert story["complete"]
    assert story["record"]["trace_id"] == ctxs[0].trace_id
    assert any(s["name"].startswith("engine.") for s in story["spans"])
    missing = obs_flight.resolve_trace(data, 10**9)
    assert not missing["complete"] and missing["record"] is None


def test_replay_targets_worst_and_exemplars(built, tmp_path):
    bundle, _ = _frozen_bundle(built, tmp_path)
    rep = obs_flight.replay(bundle, top=8)
    assert rep["stories"] and rep["resolved"] == len(rep["stories"])
    assert rep["exemplar_ids"]
    assert set(rep["exemplar_ids"]) <= set(rep["targets"])


def test_cli_main_smoke(built, tmp_path, capsys):
    bundle, _ = _frozen_bundle(built, tmp_path)
    assert obs_flight.main([bundle, "--top", "4"]) == 0
    out = capsys.readouterr().out
    assert "full causal chain" in out
    assert "trace " in out and "span " in out


def test_cli_runs_as_a_module(built, tmp_path):
    bundle, _ = _frozen_bundle(built, tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.flight", bundle, "--top",
         "2"], env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "full causal chain" in res.stdout


def test_auditor_oracle_is_the_ports(built):
    """The auditor's oracle sub-sample runs the port's BFS oracle, which
    agrees with the served answers."""
    g, idx, eng, us, rects = built
    assert (rangereach_oracle_batch(g, us[:16], rects[:16])
            == eng.query_batch(us[:16], rects[:16])).all()
