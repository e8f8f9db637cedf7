"""``repro_torch.obs`` spans under a ``torch.profiler`` capture, on the
CPU: while a capture runs, every span is also a profiler range of its
name, nested as the spans nest and inside the caller's own range, and
records into ``TRACER`` whether or not the tracer is on; when the
capture stops, both stop, and a disabled span is the shared no-op
again.  ``engine.fused`` and ``engine.route_prune`` carry the host's
wait on the ratchet's read as ``wait_us``; ``device_trace`` exports the
spans.  Every test starts and ends with the tracer off and empty."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core import QueryEngine, build_index
from repro_torch.data import get_dataset, workload
from repro_torch.obs import tracer

STAGES = ("engine.pad_batch", "engine.fused", "engine.sync")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def served():
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    us, rects = workload(g, 200, extent_ratio=0.05, seed=4)
    return idx, us, rects


def _engine(served, path="fused"):
    eng = QueryEngine(served[0], device="cpu", path=path)
    eng.count_batch(served[1], served[2])     # ratchet the capacity
    return eng


def _capture(fn):
    """Run ``fn`` inside the caller's range ``caller`` under a CPU
    capture; returns the profiler's events as (name, start ns, end ns,
    thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def _one(events, name):
    found = [e for e in events if e[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] \
        and inner[3] == outer[3]


def test_disabled_span_is_the_shared_null():
    assert obs.span("x") is tracer._NULL
    obs.span("x").set(wait_us=1.0)           # a no-op on the null span
    with profile(activities=[ProfilerActivity.CPU]):
        live = obs.span("x")
    assert live is not tracer._NULL
    assert obs.span("x") is obs.span("y") is tracer._NULL
    assert len(obs.TRACER) == 0


def test_engine_spans_nest_in_the_profilers_timeline(served):
    eng = _engine(served)
    events = _capture(lambda: eng.count_batch(served[1], served[2]))
    caller = _one(events, "caller")
    batch = _one(events, "engine.count_batch")
    assert _inside(batch, caller)
    stages = [_one(events, s) for s in STAGES]
    for s in stages:
        assert _inside(s, batch)
    # in order, one after another
    assert [s[1] for s in stages] == sorted(s[1] for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


def test_tracer_records_the_same_spans_during_the_capture_only(served):
    eng = _engine(served)
    events = _capture(lambda: eng.count_batch(served[1], served[2]))
    got = [e[0] for e in obs.TRACER.events()]
    assert sorted(got) == sorted(STAGES + ("engine.count_batch",))
    assert sorted(got) == sorted(e[0] for e in events
                                 if e[0].startswith("engine."))
    eng.count_batch(served[1], served[2])
    eng.query_batch(served[1], served[2])
    assert len(obs.TRACER) == len(got)


def test_capture_and_tracer_together_record_once(served):
    eng = _engine(served)
    obs.enable()
    events = _capture(lambda: eng.query_batch(served[1], served[2]))
    obs.disable()
    got = sorted(e[0] for e in obs.TRACER.events())
    assert got == sorted(STAGES + ("engine.query_batch",))
    assert got == sorted(e[0] for e in events if e[0].startswith("engine."))


@pytest.mark.parametrize("path,span", [("fused", "engine.fused"),
                                       ("two_phase", "engine.route_prune")])
def test_the_ratchet_wait_is_a_span_argument(served, path, span):
    eng = _engine(served, path)
    obs.enable()
    eng.count_batch(served[1], served[2])
    obs.disable()
    (ev,) = [e for e in obs.TRACER.events() if e[0] == span]
    args = ev[5]
    assert args["batch"] == len(served[1])
    assert 0 <= args["wait_us"] * 1e3 <= ev[4]


def test_traced_decorator_opens_a_range_under_a_capture():
    @obs.traced("layer.fn")
    def fn():
        return 7

    assert fn() == 7 and len(obs.TRACER) == 0
    events = _capture(fn)
    assert _inside(_one(events, "layer.fn"), _one(events, "caller"))
    assert [e[0] for e in obs.TRACER.events()] == ["layer.fn"]


def test_device_trace_exports_the_spans(served, tmp_path):
    eng = _engine(served)
    with obs.device_trace(str(tmp_path), device="cpu"):
        eng.count_batch(served[1], served[2])
    with open(tmp_path / obs.profiler.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.count_batch", *STAGES} <= names
    assert obs.span("x") is tracer._NULL
