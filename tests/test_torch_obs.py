"""The port's observability package ``repro_torch.obs`` against the JAX
package's ``repro.obs``, module by module, with no engine.

The parity tests feed the same seeded NumPy inputs to both packages and
hold the outputs equal: histogram percentiles, merges, windows and
exemplars bit for bit, ``SpaceSaving`` estimates and error bounds,
``gini``, the placement report, the OpenMetrics text string for string,
the SLO fire/clear sequence on a fake clock, the time-series samples,
the query log's JSONL, and ``stage_totals`` / ``coverage`` over the same
recorded spans.  The rest mirror the reference's own tests of these
modules (``tests/test_obs.py``, ``test_workload.py``, ``test_trace.py``,
``test_flight.py``) on the port.  Both packages keep module-global
state (``REGISTRY``, ``TRACER``, ``QUERY_LOG``, ``FLIGHT``): every test
starts and ends with both disabled and reset.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro import obs as ROBS
from repro_torch import obs
from repro_torch.obs import trace_context
from repro_torch.obs.export import metric_name, to_openmetrics
from repro_torch.obs.flight import FLIGHT, FlightRecorder
from repro_torch.obs.metrics import (
    REGISTRY,
    CounterDict,
    Histogram,
    Registry,
)
from repro_torch.obs.querylog import (
    FIELDS,
    QueryLog,
    SCHEMA_VERSION,
    rect_bucket,
)
from repro_torch.obs.slo import (
    SLOMonitor,
    default_slos,
    hist_count,
    latency_above,
)
from repro_torch.obs.timeseries import TimeSeriesCollector
from repro_torch.obs.tracer import Tracer
from repro_torch.obs.workload import SpaceSaving, WorkloadAnalytics, gini

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
BOTH = (ROBS, obs)


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with both packages' obs disabled and
    empty, so no test leaves a tracer on for the next module."""
    for o in BOTH:
        o.disable()
        o.reset()
    yield
    for o in BOTH:
        o.disable()
        o.reset()


def _samples(seed):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(3.0, 1.0, 5000), rng.random(1000) * 1e6,
            np.array([42.0]), rng.exponential(10.0, 257))


# ------------------------------------------------------------ parity

def test_public_names_and_layer_prefixes_match_reference():
    assert sorted(obs.__all__) == sorted(ROBS.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name
    assert obs.LAYER_PREFIXES == ROBS.LAYER_PREFIXES
    for mod in ("metrics", "trace_context", "tracer", "querylog",
                "workload", "export", "timeseries", "slo", "flight",
                "audit", "profiler"):
        port, ref = getattr(obs, mod), getattr(ROBS, mod)
        # the functions and classes defined there, and its constants
        public = {n for n, v in vars(ref).items() if not n.startswith("_")
                  and (getattr(v, "__module__", None) == ref.__name__
                       or n.isupper())}
        assert public <= set(vars(port)), (mod, public - set(vars(port)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_percentiles_bit_for_bit_with_reference(seed):
    from repro.obs.metrics import Histogram as RH

    for sample in _samples(seed):
        for kw in ({}, {"max_samples": 128, "sub": 16}):
            a = Histogram.from_samples(sample, **kw)
            b = RH.from_samples(sample, **kw)
            assert a.saturated == b.saturated
            for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
                assert a.percentile(p) == b.percentile(p)
            assert a.snapshot() == b.snapshot()
            assert a.count_above(float(np.median(sample))) == \
                b.count_above(float(np.median(sample)))


def test_histogram_merge_since_and_exemplars_match_reference():
    from repro.obs.metrics import Histogram as RH

    rng = np.random.default_rng(9)
    x, y = rng.lognormal(3.0, 1.0, 700), rng.exponential(50.0, 300)
    out = []
    for H in (Histogram, RH):
        ha = H.from_samples(x, max_samples=2000)
        ha.merge(H.from_samples(y))
        h = H("t", exemplar_cap=3, seed=4)
        for i, v in enumerate(x):
            h.record(float(v), exemplar=i)
        st = h.state()
        h.record_many(y)
        win = h.since(st)
        out.append((ha.snapshot(), [ha.percentile(p) for p in (5, 50, 99)],
                    win.count, win.percentile(50), h.exemplars(),
                    h.exemplars_near(h.percentile(99))))
    assert out[0] == out[1]


def test_space_saving_estimates_and_bounds_match_reference():
    from repro.obs.workload import SpaceSaving as RSS

    rng = np.random.default_rng(3)
    p = np.arange(1, 2001, dtype=np.float64) ** -1.3
    stream = rng.choice(2000, size=20000, p=p / p.sum())
    a, b = SpaceSaving(64), RSS(64)
    for k in stream:
        a.offer(int(k))
        b.offer(int(k))
    assert sorted(a.items()) == sorted(b.items())
    assert a.top(10) == b.top(10)
    assert a.heavy_hitters(0.02) == b.heavy_hitters(0.02)
    assert a.n == b.n


def test_gini_matches_reference():
    from repro.obs.workload import gini as rgini

    rng = np.random.default_rng(4)
    for x in (rng.random(50), rng.lognormal(0, 2, 200), [5.0], [],
              [0.0, 0.0], [1.0] + [0.0] * 9):
        assert gini(x) == rgini(x)


def _fill(log, seed, n=1500):
    rng = np.random.default_rng(seed)
    p = np.arange(1, 301, dtype=np.float64) ** -1.4
    us = rng.choice(300, size=n, p=p / p.sum())
    shards = rng.choice(4, size=n, p=[0.55, 0.25, 0.15, 0.05])
    for i in range(n):
        log.record("reach", "user", int(rng.integers(-2, 3)),
                   int(shards[i]), float(rng.exponential(1e-4)), 1,
                   u=int(us[i]),
                   status="degraded" if i % 10 == 0 else "ok",
                   retries=1 if i % 50 == 0 else 0)


def test_workload_placement_report_matches_reference():
    from repro.obs.querylog import QueryLog as RQL
    from repro.obs.workload import WorkloadAnalytics as RWA

    reps = []
    for QL, WA in ((QueryLog, WorkloadAnalytics), (RQL, RWA)):
        log = QL(capacity=4000)
        wa = WA()
        log.add_sink(wa.observe)
        _fill(log, 17)
        reps.append((wa.placement_report(top_k=5, query_log=log),
                     wa.top_table(top_k=3)))
    assert reps[0] == reps[1]


def _registry(reg):
    reg.counter("frontend.requests").inc(42)
    reg.gauge("frontend.queue_depth").set(7)
    reg.gauge("frontend.queue_depth").set(3)
    reg.histogram("engine.batch_us").record_many(
        np.random.default_rng(0).lognormal(3, 1, 500))
    reg.histogram("empty_us")
    reg.counter("weird-name.с")
    return reg


def test_openmetrics_text_matches_reference_string_for_string():
    from repro.obs.export import to_openmetrics as rto
    from repro.obs.metrics import Registry as RR

    a, b = to_openmetrics(_registry(Registry())), rto(_registry(RR()))
    assert a == b
    assert a.endswith("# EOF\n")
    for name in ("a.b-c d", "engine.batch_us", "9lives"):
        assert metric_name(name) == ROBS.export.metric_name(name)


def _slo_run(Reg, Mon):
    reg = Reg()
    bad, tot = reg.counter("bad"), reg.counter("total")
    mon = Mon(registry=reg)
    mon.add("avail", "bad", "total", budget=0.01, windows=(5.0, 60.0))
    events, t = [], 0.0
    for i in range(100):
        tot.inc(100)
        if 61 <= i < 71:
            bad.inc(50)
        events += mon.tick(t)
        t += 1.0
    return events, mon.snapshot(), reg.snapshot()


def test_slo_fire_clear_sequence_matches_reference_on_fake_clock():
    from repro.obs.metrics import Registry as RR
    from repro.obs.slo import SLOMonitor as RM

    got, want = _slo_run(Registry, SLOMonitor), _slo_run(RR, RM)
    assert [e["kind"] for e in got[0]] == ["fired", "cleared"]
    assert got == want


def _ts_run(Reg, TS):
    reg = Reg()
    c, h = reg.counter("served"), reg.histogram("lat")
    t = [100.0]
    ts = TS(registry=reg, clock=lambda: t[0], capacity=3)
    out = []
    for i, vals in enumerate(([5.0, 10.0, 20.0], [100.0, 200.0],
                              [], [7.0] * 9, [1.0])):
        c.inc(10 * i)
        h.record_many(vals)
        out.append(ts.sample())
        t[0] += 2.0
    return out, ts.series("counters", "served", "rate"), ts.dropped


def test_timeseries_samples_match_reference():
    from repro.obs.metrics import Registry as RR
    from repro.obs.timeseries import TimeSeriesCollector as RTS

    assert _ts_run(Registry, TimeSeriesCollector) == _ts_run(RR, RTS)


def test_querylog_jsonl_roundtrip_matches_reference(tmp_path):
    from repro.obs.querylog import QueryLog as RQL

    rng = np.random.default_rng(5)
    rects = rng.uniform(0, 50, (12, 4)).astype(np.float32)
    rects[:, 2:] += rects[:, :2]
    lat = rng.exponential(1e-3, 12)
    out = []
    for QL, name in ((QueryLog, "port"), (RQL, "ref")):
        log = QL(capacity=8)
        log.record_batch(
            "reach", ["user", "sink"] * 6, rects, np.arange(12) % 3,
            lat, np.arange(12), us=np.arange(12),
            statuses=["ok"] * 11 + ["degraded"], retries=1,
            trace_ids=list(range(100, 112)), attempts=[1] * 12)
        path = log.to_jsonl(str(tmp_path / f"{name}.jsonl"))
        lines = [json.loads(ln) for ln in open(path)]
        for rec in lines[1:]:
            assert rec.pop("t") > 0          # the wall clock of the call
        snap = log.snapshot()
        assert snap["total"] == 12 and snap["dropped"] == 4
        out.append((lines, snap))
    assert out[0] == out[1]
    assert [rect_bucket(r) for r in rects] == \
        [ROBS.querylog.rect_bucket(r) for r in rects]


def _spans(tr):
    base = 1_000_000_000
    for name, t0, dur in (("engine.a", 0.10, 0.05), ("engine.b", 0.12, 0.2),
                          ("l.c", 0.5, 0.1), ("engine.a", 0.7, 0.01),
                          ("zz.d", 0.9, 0.05)):
        tr.record(name, "", int(t0 * base), int(dur * base), None)
    return tr


def test_stage_totals_and_coverage_match_reference_on_same_spans():
    from repro.obs.tracer import Tracer as RT

    a, b = _spans(Tracer()), _spans(RT())
    assert a.stage_totals() == b.stage_totals()
    assert a.stage_totals("engine.") == b.stage_totals("engine.")
    for pre in ((), ("engine.",), ("l.", "zz.")):
        assert a.coverage(0.0, 1.0, prefixes=pre) == \
            b.coverage(0.0, 1.0, prefixes=pre)
    assert a.summary() == b.summary()
    assert a.chrome_trace() == b.chrome_trace()


def test_snapshot_schema_matches_reference():
    for o in BOTH:
        o.enable()
        with o.span("serve.x", cat="serve"):
            o.REGISTRY.counter("c").inc()
        o.disable()
    a, b = obs.snapshot(), ROBS.snapshot()
    assert a["schema_version"] == b["schema_version"] == 2
    assert set(a) == set(b)
    assert set(a["tracer"]) == set(b["tracer"])
    assert set(a["flight"]) == set(b["flight"])
    assert a["metrics"]["counters"]["c"] == b["metrics"]["counters"]["c"]
    assert set(a["spans"]) == set(b["spans"]) == {"serve.x"}


def test_trace_context_scopes_match_reference():
    from repro.obs import trace_context as RTC

    for tc in (trace_context, RTC):
        a, b = tc.mint(u=1), tc.mint(u=2)
        assert b.trace_id > a.trace_id
        with tc.scope([a, b]):
            assert tc.current_ids() == [a.trace_id, b.trace_id]
        assert tc.current() is None


def test_obs_imports_neither_torch_nor_jax_nor_repro():
    """The package loads nothing of ``torch`` (nor CUDA) at import, nor
    ``jax`` or the reference."""
    code = ("import sys\n"
            "import repro_torch.obs, repro_torch.obs.profiler\n"
            "import repro_torch.obs.flight, repro_torch.obs.audit\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('torch', 'jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------- metrics (reference test_obs)

def test_histogram_bit_for_bit_percentiles():
    for sample in _samples(3):
        h = Histogram.from_samples(sample)
        assert not h.saturated
        for p in (0, 25, 50, 90, 95, 99, 99.9, 100):
            assert h.percentile(p) == float(np.percentile(sample, p))


def test_histogram_legacy_key_shapes():
    lat = np.random.default_rng(0).lognormal(2, 1, 500)
    assert set(obs.latency_percentiles(lat)) == {"p50", "p95", "p99"}
    got = obs.latency_percentiles(lat, prefix="lat_p", suffix="_us")
    assert set(got) == {"lat_p50_us", "lat_p95_us", "lat_p99_us"}
    assert got["lat_p99_us"] == float(np.percentile(lat, 99))


def test_histogram_saturated_degrades_gracefully():
    sample = np.random.default_rng(5).lognormal(3.0, 0.5, 20000)
    h = Histogram(max_samples=128, sub=16)
    h.record_many(sample)
    assert h.saturated
    for p in (50, 95, 99):
        exact = float(np.percentile(sample, p))
        assert abs(h.percentile(p) - exact) / exact < 0.10
    assert h.snapshot()["count"] == 20000


def test_histogram_monotone_and_stats():
    h = Histogram.from_samples([1.0, 2.0, 3.0, 10.0])
    ps = [h.percentile(p) for p in (10, 50, 90, 99)]
    assert ps == sorted(ps)
    snap = h.snapshot()
    assert snap["min"] == 1.0 and snap["max"] == 10.0
    assert snap["count"] == 4


def test_histogram_merge_golden():
    rng = np.random.default_rng(9)
    a = rng.lognormal(3.0, 1.0, 700)
    b = rng.exponential(50.0, 300)
    ha = Histogram.from_samples(a, max_samples=2000)
    assert ha.merge(Histogram.from_samples(b)) is ha
    both = np.concatenate([a, b])
    assert ha.count == 1000 and not ha.saturated
    for p in (0, 50, 95, 99, 100):
        assert ha.percentile(p) == float(np.percentile(both, p))
    snap = ha.snapshot()
    assert snap["min"] == both.min() and snap["max"] == both.max()
    assert snap["sum"] == pytest.approx(both.sum())
    with pytest.raises(ValueError, match="bucket layouts"):
        ha.merge(Histogram(sub=8))


def test_histogram_since_windowed_view():
    rng = np.random.default_rng(13)
    h = Histogram()
    h.record_many(rng.lognormal(2.0, 0.7, 400))
    st = h.state()
    second = rng.lognormal(4.0, 0.3, 300)
    h.record_many(second)
    win = h.since(st)
    assert win.count == 300 and win.sum == pytest.approx(second.sum())
    for p in (50, 95, 99):
        assert win.percentile(p) == float(np.percentile(second, p))
    assert win.min == second.min() and win.max == second.max()
    whole = h.since(None)
    assert whole.count == 700
    assert whole.percentile(50) == h.percentile(50)
    empty = h.since(h.state())
    assert empty.count == 0 and np.isnan(empty.percentile(50))


def test_histogram_count_above():
    h = Histogram.from_samples([1.0, 5.0, 10.0, 50.0, 100.0])
    assert h.count_above(10.0) == 3
    assert h.count_above(1000.0) == 0
    assert h.count_above(0.5) == 5


def test_counter_gauge_registry():
    reg = Registry()
    c = reg.counter("c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert reg.counter("c") is c
    g = reg.gauge("g")
    g.set(7)
    g.set(3)
    assert g.value == 3 and g.max == 7
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"]["max"] == 7
    reg.reset()
    assert c.value == 0 and g.max == 0


def test_counterdict_is_live_registry_view():
    reg = Registry()
    d = CounterDict("up.", ("a", "b"), registry=reg)
    d["a"] += 2
    d["b"] = 9
    assert dict(d) == {"a": 2, "b": 9}
    assert reg.counter("up.a").value == 2
    reg.counter("up.b").inc()
    assert d["b"] == 10


def test_upload_counters_absorbed():
    """The port's ``UPLOAD_COUNTERS`` (the engine's, from the layout
    module) is a registry view, as the reference's is."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels.range_query import layout

    assert engine_mod.UPLOAD_COUNTERS is layout.UPLOAD_COUNTERS
    before = dict(engine_mod.UPLOAD_COUNTERS)
    assert set(before) == {"host_uploads", "device_adoptions"}
    assert REGISTRY.counter("engine.upload.host_uploads").value == \
        before["host_uploads"]


# ----------------------------------------- tracer (reference test_obs)

def test_span_disabled_records_nothing():
    t0 = len(obs.TRACER)
    with obs.span("x.y", cat="t", detail=1):
        pass
    assert len(obs.TRACER) == t0
    # disabled spans share one no-op object, allocated once
    assert obs.span("a") is obs.span("b") is obs.tracer._NULL


def test_span_enabled_records_chrome_events():
    obs.enable()
    with obs.span("layer.stage", cat="test", n=3):
        time.sleep(0.002)
    obs.disable()
    trace = obs.TRACER.chrome_trace()
    ev = [e for e in trace["traceEvents"] if e["name"] == "layer.stage"]
    assert len(ev) == 1
    e = ev[0]
    assert e["ph"] == "X" and e["cat"] == "test"
    assert e["dur"] >= 2e3
    assert e["args"] == {"n": 3}
    assert {"ts", "pid", "tid"} <= set(e)
    json.dumps(trace)


def test_traced_decorator():
    calls = []

    @obs.traced("deco.fn", cat="t")
    def fn(x):
        calls.append(x)
        return x * 2

    assert fn(2) == 4
    obs.enable()
    assert fn(3) == 6
    obs.disable()
    assert calls == [2, 3]
    assert obs.stage_totals("deco.")["deco.fn"] >= 0.0


def test_tracer_thread_safety_and_bound():
    tr = Tracer(max_events=5000)
    tr.start()

    def work():
        for _ in range(1000):
            tr.record("t.span", "", 0, 10, None)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(tr) == 5000
    assert tr.dropped == 3000
    assert tr.summary()["t.span"]["count"] == 5000


def test_stage_totals_and_summary():
    obs.enable()
    for _ in range(3):
        with obs.span("eng.a"):
            pass
    with obs.span("eng.b"):
        pass
    with obs.span("other.c"):
        pass
    obs.disable()
    assert set(obs.stage_totals("eng.")) == {"eng.a", "eng.b"}
    s = obs.TRACER.summary()
    assert s["eng.a"]["count"] == 3
    assert s["eng.a"]["mean_us"] == pytest.approx(
        s["eng.a"]["total_us"] / 3)


def test_coverage_interval_union():
    tr = Tracer()
    base = 1_000_000_000
    tr.record("l.a", "", int(0.1 * base), int(0.15 * base), None)
    tr.record("l.b", "", int(0.2 * base), int(0.10 * base), None)
    tr.record("l.c", "", int(0.5 * base), int(0.10 * base), None)
    tr.record("zz.d", "", int(0.7 * base), int(0.10 * base), None)
    assert tr.coverage(0.0, 1.0, prefixes=("l.",)) == pytest.approx(
        0.30, abs=1e-6)
    assert tr.coverage(0.0, 1.0) == pytest.approx(0.40, abs=1e-6)


# -------------------------------------- query log (reference test_obs)

def test_rect_bucket():
    assert rect_bucket([0, 0, 1, 1]) == 0
    assert rect_bucket([0, 0, 2, 2]) == 2
    assert rect_bucket([0, 0, 0, 5]) == -64
    assert rect_bucket([0, 0, 1e30, 1e30]) == 63
    assert rect_bucket([0, 0, 1e-30, 1e-30]) == -63


def test_querylog_bounded_with_aggregates():
    log = QueryLog(capacity=8)
    for i in range(20):
        log.record("reach", "user", 0, i % 3, 1e-3, i)
    assert len(log) == 8
    assert log.total == 20
    assert log.dropped == 12
    snap = log.snapshot()
    assert snap["by_class"]["reach"] == 20
    assert sum(snap["by_shard"].values()) == 20
    assert snap["latency_us"]["p50"] == pytest.approx(1000.0)


def test_querylog_jsonl_roundtrip(tmp_path):
    log = QueryLog(capacity=16)
    log.record_batch(
        "reach", ["user", "sink"],
        np.array([[0, 0, 1, 1], [0, 0, 2, 2]], dtype=np.float32),
        np.array([0, 1]), [1e-3, 2e-3], [1, 0])
    path = log.to_jsonl(str(tmp_path / "q.jsonl"))
    lines = [json.loads(ln) for ln in open(path)]
    header, recs = lines[0], lines[1:]
    assert header == {"schema_version": SCHEMA_VERSION,
                      "fields": list(FIELDS)}
    assert len(recs) == 2
    assert all(set(r) == set(FIELDS) for r in recs)
    assert recs[0]["vertex_class"] == "user"
    assert recs[1]["rect_bucket"] == 2
    assert recs[1]["shard"] == 1
    assert recs[0]["status"] == "ok" and recs[0]["retries"] == 0
    assert recs[0]["u"] == -1


def test_querylog_status_and_sinks():
    log = QueryLog(capacity=4)
    seen = []
    log.add_sink(seen.append)
    log.record_batch(
        "reach", ["user"] * 3, np.zeros((3, 4), dtype=np.float32),
        np.zeros(3), [1e-3] * 3, [0] * 3, us=np.array([7, 7, 9]),
        statuses=["ok", "degraded", "ok"], retries=2)
    for _ in range(6):
        log.record("reach", "user", 0, 0, 1e-3, 0, u=7)
    assert len(log) == 4 and log.dropped == 5
    assert len(seen) == 9
    snap = log.snapshot()
    assert snap["schema_version"] == SCHEMA_VERSION
    assert snap["by_status"] == {"ok": 8, "degraded": 1}


def test_device_trace_degrades_gracefully(tmp_path):
    with obs.device_trace(str(tmp_path / "prof"), enabled=True,
                          device="cpu"):
        pass
    with obs.device_trace("", enabled=False):
        pass


# -------------------------------------- workload (reference test_workload)

def zipf_keys(rng, n, n_keys=5000, s=1.3):
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -s
    p /= p.sum()
    return rng.choice(n_keys, size=n, p=p)


def test_space_saving_exact_below_capacity():
    ss = SpaceSaving(capacity=64)
    stream = [1, 2, 2, 3, 3, 3, 4] * 5
    for k in stream:
        ss.offer(k)
    assert ss.n == len(stream)
    assert ss.count(3) == (15, 0)
    assert ss.count(99) is None
    assert [k for k, _, _ in ss.top(2)] == [3, 2]


@pytest.mark.parametrize("s", [1.1, 1.5])
def test_space_saving_zipf_guarantees(s):
    rng = np.random.default_rng(int(s * 10))
    capacity = 64
    stream = zipf_keys(rng, 20000, n_keys=5000, s=s)
    ss = SpaceSaving(capacity)
    exact: dict = {}
    for k in stream:
        k = int(k)
        ss.offer(k)
        exact[k] = exact.get(k, 0) + 1
    n = len(stream)
    bound = n / capacity
    assert len(ss) == capacity
    for k, c in exact.items():
        if c > bound:
            assert ss.count(k) is not None, f"hot key {k} not monitored"
    for k, est, err in ss.items():
        t = exact.get(k, 0)
        assert t <= est <= t + bound
        assert est - err <= t
    phi = 2.0 / capacity
    hh = {k for k, _, _ in ss.heavy_hitters(phi)}
    assert {k for k, c in exact.items() if c >= phi * n} <= hh


def test_space_saving_adversarial_churn():
    ss = SpaceSaving(capacity=8)
    for k in range(1000):
        ss.offer(k)
    for _ in range(500):
        ss.offer("hot")
    est, err = ss.count("hot")
    assert est >= 500
    assert est - err <= 500
    assert ss.top(1)[0][0] == "hot"
    assert len(ss) == 8


def test_space_saving_validates_capacity():
    with pytest.raises(ValueError):
        SpaceSaving(0)


def exact_gini(x):
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n == 0 or x.sum() == 0:
        return 0.0
    return float(np.abs(x[:, None] - x[None, :]).sum()
                 / (2.0 * n * n * x.mean()))


def test_gini_matches_pairwise_definition():
    rng = np.random.default_rng(4)
    for x in (rng.random(50), rng.lognormal(0, 2, 200),
              np.array([5.0]), np.array([1.0, 1.0, 1.0])):
        assert gini(x) == pytest.approx(exact_gini(x), abs=1e-12)


def test_gini_extremes():
    assert gini([]) == 0.0
    assert gini([0.0, 0.0]) == 0.0
    assert gini([3.0, 3.0, 3.0, 3.0]) == pytest.approx(0.0)
    assert gini([1.0] + [0.0] * 9) == pytest.approx(0.9)


def _fill_log(log, rng, n=3000, n_shards=4):
    us = zipf_keys(rng, n, n_keys=500, s=1.4)
    shards = rng.choice(n_shards, size=n, p=[0.55, 0.25, 0.15, 0.05])
    for i in range(n):
        log.record("reach", "user", int(rng.integers(-2, 3)),
                   int(shards[i]), float(rng.exponential(1e-4)),
                   1, u=int(us[i]),
                   status="degraded" if i % 10 == 0 else "ok",
                   retries=1 if i % 50 == 0 else 0)
    return us, shards


def test_workload_analytics_report_and_verify():
    rng = np.random.default_rng(17)
    log = QueryLog(capacity=10000)
    wa = WorkloadAnalytics()
    log.add_sink(wa.observe)
    us, shards = _fill_log(log, rng)
    n = len(us)
    assert wa.total == n
    rep = wa.placement_report(top_k=5, query_log=log)
    skew = rep["skew"]
    assert skew["n_shards"] == 4
    per = skew["per_shard"].values()
    assert sum(v["query_share"] for v in per) == pytest.approx(1.0)
    assert sum(v["latency_share"] for v in per) == pytest.approx(1.0)
    assert sum(v["queries"] for v in per) == n
    counts = np.bincount(shards, minlength=4).astype(float)
    assert skew["gini_queries"] == pytest.approx(exact_gini(counts))
    assert skew["max_query_share"] == pytest.approx(counts.max() / n)
    ver = rep["verified"]
    assert ver["window_is_stream"] and ver["exact_match"]
    assert ver["all_exact_reported"]
    assert rep["heavy_hitters"]["vertices"][0]["key"] == \
        int(np.argmax(np.bincount(us)))
    assert rep["by_status"]["degraded"] == n // 10
    assert rep["degraded_fraction"] == pytest.approx(0.1, abs=0.01)
    assert rep["device_retries"] == n // 50
    table = wa.top_table(top_k=3)
    assert "vertex" in table and "shard" in table and "%" in table


def test_workload_analytics_sink_outlives_ring():
    rng = np.random.default_rng(23)
    log = QueryLog(capacity=64)
    wa = WorkloadAnalytics()
    log.add_sink(wa.observe)
    _fill_log(log, rng, n=2000)
    assert log.dropped == 2000 - 64
    assert wa.total == 2000
    assert wa.vertices.n == 2000
    ver = wa.verify(log)
    assert not ver["window_is_stream"]
    assert ver["window"] == 64


def test_slo_fires_and_clears_on_fake_clock():
    reg = Registry()
    bad, tot = reg.counter("bad"), reg.counter("total")
    mon = SLOMonitor(registry=reg)
    mon.add("avail", "bad", "total", budget=0.01,
            windows=(5.0, 60.0), threshold=1.0)
    t = 0.0
    for _ in range(61):
        tot.inc(100)
        assert mon.tick(t) == []
        t += 1.0
    assert not mon.slos[0].active
    fired_at = None
    for _ in range(10):
        tot.inc(100)
        bad.inc(50)
        for e in mon.tick(t):
            assert e["kind"] == "fired" and e["slo"] == "avail"
            fired_at = e["t"]
            assert e["burns"]["5s"] > 1.0 and e["burns"]["60s"] > 1.0
        t += 1.0
    assert fired_at is not None
    assert mon.slos[0].active
    assert reg.counter("slo.avail.fired").value == 1
    assert reg.gauge("slo.avail.active").value == 1
    cleared = []
    for _ in range(10):
        tot.inc(100)
        cleared += [e for e in mon.tick(t) if e["kind"] == "cleared"]
        t += 1.0
    assert len(cleared) == 1
    assert not mon.slos[0].active
    assert reg.gauge("slo.avail.active").value == 0
    snap = mon.snapshot()
    assert snap["active"] == []
    assert [e["kind"] for e in snap["events"]] == ["fired", "cleared"]


def test_slo_long_window_gates_blips():
    reg = Registry()
    bad, tot = reg.counter("b"), reg.counter("t")
    mon = SLOMonitor(registry=reg)
    mon.add("x", "b", "t", budget=0.01, windows=(5.0, 60.0))
    t = 0.0
    for i in range(120):
        tot.inc(100)
        if i == 100:
            bad.inc(60)
        assert mon.tick(t) == [], f"fired on a blip at t={t}"
        t += 1.0


def test_slo_latency_sources():
    reg = Registry()
    h = reg.histogram("lat_us")
    for v in [10.0] * 90 + [9000.0] * 10:
        h.record(v)
    assert latency_above("lat_us", 1000.0)(reg) == 10
    assert hist_count("lat_us")(reg) == 100


def test_default_slos_wiring():
    """The four default SLOs read ``frontend.*`` metrics that no ported
    module feeds yet; they resolve against an empty registry."""
    reg = Registry()
    mon = default_slos(SLOMonitor(registry=reg))
    assert {s.name for s in mon.slos} == {"availability", "degraded",
                                         "breaker", "latency"}
    assert mon.tick(0.0) == []
    with pytest.raises(ValueError):
        mon.add("zero-budget", "b", "t", budget=0.0)


_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
    r'(,[a-zA-Z0-9_]+="[^"]*")*\})? -?[0-9].*$|'
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? (NaN|[+-]Inf)$')
_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                   r"(counter|gauge|summary)$")


def check_openmetrics(text):
    """Parse OpenMetrics text line by line: every sample typed, ``# EOF``
    last.  Returns the lines."""
    lines = text.splitlines()
    assert lines[-1] == "# EOF"
    typed = set()
    for ln in lines[:-1]:
        if ln.startswith("# TYPE"):
            assert _TYPE.match(ln), f"bad TYPE line: {ln!r}"
            typed.add(ln.split()[2])
        else:
            assert _SAMPLE.match(ln), f"unparseable sample: {ln!r}"
            fam = re.split(r"[{ ]", ln)[0]
            base = re.sub(r"(_total|_sum|_count|_hwm)$", "", fam)
            assert fam in typed or base in typed, f"untyped: {ln!r}"
    return lines


def test_openmetrics_parses_line_by_line():
    reg = Registry()
    reg.counter("frontend.requests").inc(42)
    reg.gauge("frontend.queue_depth").set(7)
    lat = np.random.default_rng(0).lognormal(3, 1, 500)
    reg.histogram("engine.batch_us").record_many(lat)
    reg.counter("weird-name.с")
    text = to_openmetrics(reg)
    lines = check_openmetrics(text)
    assert "repro_frontend_requests_total 42" in lines
    assert "repro_frontend_queue_depth 7" in lines
    for q, p in ((0.5, 50), (0.99, 99)):
        want = float(np.percentile(lat, p))
        assert f'repro_engine_batch_us{{quantile="{q:g}"}} {want!r}' \
            in text or f'repro_engine_batch_us{{quantile="{q:g}"}} ' \
            f'{int(want)}' in text
    assert "repro_engine_batch_us_count 500" in lines


def test_metric_name_sanitisation():
    assert metric_name("a.b-c d") == "repro_a_b_c_d"
    assert metric_name("engine.batch_us") == "repro_engine_batch_us"
    assert metric_name("9lives", prefix="") == "_9lives"


def test_timeseries_deltas_and_windows_fake_clock():
    reg = Registry()
    c = reg.counter("served")
    h = reg.histogram("lat")
    clock_t = [100.0]
    ts = TimeSeriesCollector(registry=reg, clock=lambda: clock_t[0],
                             capacity=16)
    c.inc(10)
    first = np.array([5.0, 10.0, 20.0])
    h.record_many(first)
    s0 = ts.sample()
    assert s0["dt"] is None
    assert s0["counters"]["served"] == {"value": 10.0, "delta": 10.0}
    assert s0["histograms"]["lat"]["delta"] == 3
    assert s0["histograms"]["lat"]["p50"] == float(np.percentile(first, 50))
    clock_t[0] = 102.0
    c.inc(30)
    second = np.array([100.0, 200.0, 300.0, 400.0])
    h.record_many(second)
    s1 = ts.sample()
    assert s1["dt"] == pytest.approx(2.0)
    assert s1["counters"]["served"]["delta"] == 30.0
    assert s1["counters"]["served"]["rate"] == pytest.approx(15.0)
    win = s1["histograms"]["lat"]
    assert win["count"] == 7 and win["delta"] == 4
    assert win["p50"] == float(np.percentile(second, 50))
    assert win["sum_delta"] == pytest.approx(second.sum())
    tsx, vals = ts.series("counters", "served", "rate")
    assert tsx == [102.0] and vals == [15.0]


def test_timeseries_hooks_drive_slo(tmp_path):
    reg = Registry()
    bad, tot = reg.counter("b"), reg.counter("t")
    mon = SLOMonitor(registry=reg)
    mon.add("x", "b", "t", budget=0.01, windows=(2.0,))
    clock_t = [0.0]
    ts = TimeSeriesCollector(registry=reg, clock=lambda: clock_t[0])
    ts.add_hook(lambda t, _s: mon.tick(t))
    for i in range(8):
        tot.inc(100)
        if i >= 5:
            bad.inc(100)
        ts.sample()
        clock_t[0] += 1.0
    assert mon.slos[0].active
    path = ts.to_jsonl(str(tmp_path / "ts.jsonl"))
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["schema_version"] == 1
    assert lines[0]["samples"] == 8 == len(lines) - 1
    assert lines[4]["counters"]["t"]["value"] == 400.0


def test_timeseries_ring_bounded():
    reg = Registry()
    reg.counter("c").inc()
    clock_t = [0.0]
    ts = TimeSeriesCollector(registry=reg, clock=lambda: clock_t[0],
                             capacity=4)
    for _ in range(10):
        ts.sample()
        clock_t[0] += 1.0
    assert len(ts) == 4
    assert ts.dropped == 6


def test_background_timeseries_thread_stops():
    """The process-wide sampler's thread runs and stops within its own
    time limit; ``reset`` forgets it."""
    REGISTRY.counter("bg.c").inc(3)
    ts = obs.start_timeseries(interval=0.01)
    deadline = time.time() + 30
    while len(ts) < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert obs.stop_timeseries() is ts
    assert ts._thread is None or not ts._thread.is_alive()
    assert len(ts) >= 2
    obs.reset()
    assert obs._TIMESERIES is None


# ------------------------------------ trace context (reference test_trace)

def test_mint_ids_unique_and_monotone():
    ids = [trace_context.mint().trace_id for _ in range(100)]
    assert len(set(ids)) == 100
    assert ids == sorted(ids)


def test_scope_nesting_and_thread_isolation():
    a, b = trace_context.mint(u=1), trace_context.mint(u=2)
    assert trace_context.current() is None
    with trace_context.scope([a]):
        assert trace_context.current_ids() == [a.trace_id]
        with trace_context.scope([b]):
            assert trace_context.current_ids() == [b.trace_id]
        assert trace_context.current_ids() == [a.trace_id]
        seen = []
        t = threading.Thread(
            target=lambda: seen.append(trace_context.current()))
        t.start()
        t.join(timeout=30)
        assert seen == [None]
    assert trace_context.current() is None


def test_disabled_spans_record_nothing_under_scope():
    ctx = trace_context.mint()
    with trace_context.scope([ctx]):
        with obs.span("engine.query_batch", cat="engine"):
            pass
    assert len(obs.TRACER) == 0


def test_exemplar_reservoir_deterministic_under_seeded_stream():
    rng = np.random.default_rng(11)
    vals = rng.lognormal(3.0, 1.0, 2000)
    tids = np.arange(1, 2001)

    def fill(seed):
        h = Histogram("t", exemplar_cap=4, seed=seed)
        for t, v in zip(tids, vals):
            h.record(float(v), exemplar=int(t))
        return h

    a, b = fill(0), fill(0)
    assert a.exemplars() == b.exemplars()
    assert a.exemplars()
    for _bucket, res in a.exemplars().items():
        assert len(res) <= 4
        for tid, v in res:
            assert v == pytest.approx(vals[tid - 1])
    assert fill(1).exemplars().keys() == a.exemplars().keys()


def test_exemplars_near_percentile_and_reset():
    h = Histogram("t", exemplar_cap=2, seed=0)
    for i, v in enumerate([10.0] * 50 + [1e6] * 2):
        h.record(v, exemplar=i)
    near = h.exemplars_near(h.percentile(99))
    assert near and all(v == 1e6 for _t, v in near)
    h.reset()
    assert h.exemplars() == {}


def _fake_span(tracer, name, t0_ns, dur_ns):
    tracer.record(name, "x", t0_ns, dur_ns, None)


def test_stage_totals_union_per_thread_then_across():
    tr = Tracer()
    barrier = threading.Barrier(2, timeout=30)

    def worker(t0, dur):
        barrier.wait()
        _fake_span(tr, "engine.scan", t0, dur)

    ts = [threading.Thread(target=worker, args=(0, 100_000)),
          threading.Thread(target=worker, args=(50_000, 100_000))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len({e[2] for e in tr.events()}) == 2
    assert tr.stage_totals("engine.")["engine.scan"] == \
        pytest.approx(150.0)


def test_stage_totals_sequential_spans_still_sum():
    tr = Tracer()
    _fake_span(tr, "engine.scan", 0, 100_000)
    _fake_span(tr, "engine.scan", 200_000, 100_000)
    assert tr.stage_totals()["engine.scan"] == pytest.approx(200.0)


def test_coverage_capped_under_concurrent_flush_threads():
    tr = Tracer()
    done = threading.Barrier(3, timeout=30)

    def worker(t0_ns):
        _fake_span(tr, "frontend.flush", t0_ns, 80_000)
        done.wait()

    a = threading.Thread(target=worker, args=(0,))
    b = threading.Thread(target=worker, args=(40_000,))
    a.start()
    b.start()
    done.wait()
    a.join(timeout=30)
    b.join(timeout=30)
    cov = tr.coverage(0.0, 100_000 / 1e9, prefixes=("frontend.",))
    assert cov <= 1.0
    assert cov == pytest.approx(1.0)
    assert tr.coverage(0.0, 100_000 / 1e9) == pytest.approx(1.0)


def test_coverage_same_thread_nested_spans_not_double_counted():
    tr = Tracer()
    _fake_span(tr, "engine.outer", 0, 100_000)
    _fake_span(tr, "engine.inner", 10_000, 50_000)
    assert tr.coverage(0.0, 100_000 / 1e9) == pytest.approx(1.0)


def test_timeseries_flushes_partial_window_on_dump(tmp_path):
    reg = Registry()
    t = [100.0]
    ts = TimeSeriesCollector(registry=reg, interval=60.0,
                             clock=lambda: t[0])
    reg.counter("served").inc(7)
    reg.histogram("lat_us").record(123.0)
    assert ts.dirty()
    path = str(tmp_path / "ts.jsonl")
    ts.to_jsonl(path)
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert lines[0]["samples"] == 1
    sample = lines[1]
    assert sample["t"] == 100.0
    assert sample["counters"]["served"]["delta"] == 7.0
    assert sample["histograms"]["lat_us"]["delta"] == 1
    assert not ts.dirty()
    ts.to_jsonl(path)
    lines2 = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert lines2[0]["samples"] == 1


def test_timeseries_dirty_tracks_new_activity():
    reg = Registry()
    t = [0.0]
    ts = TimeSeriesCollector(registry=reg, clock=lambda: t[0])
    assert not ts.dirty()
    c = reg.counter("x")
    assert ts.dirty()
    ts.sample()
    assert not ts.dirty()
    c.inc()
    assert ts.dirty()
    t[0] = 1.0
    ts.sample()
    assert not ts.dirty()


# --------------------------------------- flight (reference test_flight)

def test_note_ring_bounded_and_counted():
    fr = FlightRecorder(capacity_events=8)
    for i in range(20):
        fr.note("x", i=i)
    assert fr.events_total == 20
    evts = fr.events()
    assert len(evts) == 8
    assert [e["i"] for e in evts] == list(range(12, 20))
    assert all("t" in e and e["kind"] == "x" for e in evts)
    fr.reset()
    assert fr.events() == [] and fr.events_total == 0


def test_unarmed_trigger_is_counted_noop(tmp_path):
    assert FLIGHT.trigger("unit-test") is None
    assert REGISTRY.counter("flight.unarmed").value == 1
    assert REGISTRY.counter("flight.trigger.unit-test").value == 1
    assert not os.listdir(tmp_path)
    assert FLIGHT.snapshot()["dumps"] == 0


def test_obs_snapshot_and_reset_include_flight(tmp_path):
    FLIGHT.note("x")
    FLIGHT.arm(str(tmp_path))
    snap = obs.snapshot()
    assert snap["flight"]["armed"] and snap["flight"]["events"] == 1
    obs.reset()
    fl = obs.snapshot()["flight"]
    assert not fl["armed"] and fl["events"] == 0


def test_slo_fired_freezes_bundle_without_traffic(tmp_path):
    """A burn-rate fire on a fake clock freezes a ``slo-<name>`` bundle
    (the reference's ``test_slo_fired_freezes_bundle`` without its
    served window)."""
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
    (bundle,) = os.listdir(tmp_path)
    assert bundle == "000-slo-latency"
    with open(os.path.join(tmp_path, bundle, "manifest.json")) as f:
        assert json.load(f)["detail"]["slo"] == "latency"
    assert any(e["kind"] == "slo.fired" for e in FLIGHT.events())
