"""The two metrics read from inside the program: ``engine_host_ms`` from
the engine's spans that ``repro_torch.obs`` records under the traced
window's capture, and ``k1_tests_per_query`` from the engine's
``k1_scan_tests`` counter.  Each reader on synthetic spans and stats,
then a tiny traced run on the CPU whose result carries both."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys

import pytest

from rrbench.bench import spec
from rrbench.tests.test_rrbench_harness import CELLS, ROOT, RUN_TINY

MS = 1_000_000     # ns


def _metric_module(name):
    ms = importlib.util.spec_from_file_location(f"test_metric_{name}",
                                                spec.metric_path(name))
    mod = importlib.util.module_from_spec(ms)
    ms.loader.exec_module(mod)
    return mod


def _span(name, dur_ns, args=None):
    return (name, "engine", 1, 0, dur_ns, args)


def test_engine_host_ms_from_spans():
    from_events = _metric_module("engine_host_ms").from_events
    events = [
        _span("engine.pad_batch", MS // 2),
        _span("engine.fused", 45 * MS, {"batch": 8, "wait_us": 43_000.0}),
        _span("engine.sync", MS // 4),
        _span("engine.count_batch", 48 * MS, {"n": 8}),
        _span("engine.pad_batch", MS // 2),
        _span("engine.route_prune", 20 * MS, {"batch": 8,
                                               "wait_us": 19_000.0}),
        _span("engine.scan", MS),
        _span("engine.sync", 25 * MS),
        _span("engine.query_batch", 50 * MS, {"n": 8}),
    ]
    # (48 + 50 ms) less (43 + 19 ms) of waits, over two batches
    assert from_events(events) == pytest.approx(18.0)
    assert from_events(events[:4]) == pytest.approx(5.0)
    # waits without a batch span, or no spans at all: nothing to report
    assert from_events(events[:3]) is None
    assert from_events([]) is None


def test_engine_host_ms_reads_nothing_from_an_idle_tracer():
    from repro_torch import obs

    obs.reset()
    assert spec.metric_reader("engine_host_ms")({}) is None


def test_k1_tests_per_query_from_stats():
    read = spec.metric_reader("k1_tests_per_query")
    assert read({"stats": {"k1_scan_tests": 3 * 1024 * 40,
                           "queries": 16}}) == pytest.approx(7680.0)
    # a program without the counter, or a window with no query
    assert read({"stats": {"queries": 16, "tiles_scanned": 5}}) is None
    assert read({"stats": {"k1_scan_tests": 0, "queries": 0}}) is None
    assert read({"stats": {}}) is None


@pytest.mark.parametrize("cell_name", CELLS)
def test_tiny_traced_run_reports_both(cell_name):
    code = RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"),
                           cell=cell_name, traced=True)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    m = res["metrics"]
    assert {"engine_host_ms", "k1_tests_per_query"} <= set(m)
    assert m["engine_host_ms"]["unit"] == "ms"
    assert m["engine_host_ms"]["value"] > 0
    assert m["k1_tests_per_query"]["unit"] == "tests/query"
    assert m["k1_tests_per_query"]["value"] > 0
