"""The port's benchmark harness (``repro_torch.benchmarks``) on the CPU, at
a tiny scale, against the JAX package's data and scripts.

``knn_workload`` equal to the reference's; Tables 2 and 4 (graph
statistics, index bytes) equal to the reference's ``paper_tables`` row
by row, and the claims read the same from the same rows; Table 3 and
Figure 3's sweep with the right rows and keys, and Figure 3's oracle
gate firing on a wrong index; ``perf_build.bench_config`` (device build
equal to the host build, adoption counters flat) and
``perf_queries.class_sweep`` (every class and path equal to the host)
with ``device="cpu"``; the entry points writing under
``results/torch/`` only and asking for the card by default; and no
module of ``repro_torch.benchmarks`` or ``repro_torch.resilience``
importing ``jax`` or ``repro``.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.data as RD
import repro_torch.benchmarks as B
from repro_torch.benchmarks import (
    obs_overhead,
    paper_fig3,
    paper_tables,
    perf_build,
    perf_queries,
    run,
)
from repro_torch.core import METHODS, build_index
from repro_torch.data import (
    KNN_DEFAULT_K,
    get_dataset,
    knn_workload,
    workload,
)
from repro_torch.kernels.range_query import layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SCALE = 0.02          # every dataset at its 64-node floor or a little above
INDEX_METHODS = tuple(m for m in METHODS if m != "georeach")


def _reference(name):
    """The reference's ``benchmarks/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_tables():
    return _reference("paper_tables")


@pytest.fixture
def results(tmp_path, monkeypatch):
    """Point ``results/torch/`` at a temporary directory."""
    monkeypatch.setattr(B, "RESULTS", str(tmp_path))
    return tmp_path


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 6, 41])
def test_knn_workload_matches_reference(seed):
    g, rg = get_dataset("yelp", scale=0.05), RD.get_dataset("yelp",
                                                            scale=0.05)
    us, pts = knn_workload(g, 200, seed=seed)
    rus, rpts = RD.knn_workload(rg, 200, seed=seed)
    assert us.dtype == rus.dtype and np.array_equal(us, rus)
    assert pts.dtype == rpts.dtype and np.array_equal(pts, rpts)
    assert KNN_DEFAULT_K == RD.KNN_DEFAULT_K


# --------------------------------------------------------------- tables


def test_table2_matches_reference(ref_tables):
    assert paper_tables.DATASETS == ref_tables.DATASETS
    assert paper_tables.BENCH_SCALE == ref_tables.BENCH_SCALE
    got, want = paper_tables.table2(SCALE), ref_tables.table2(SCALE)
    assert [r["dataset"] for r in got] == list(paper_tables.DATASETS)
    assert got == want


def test_table4_matches_reference(ref_tables):
    raw, want = paper_tables.table4_raw(SCALE), ref_tables.table4_raw(SCALE)
    assert raw == want
    assert all(set(r) == {"dataset", *INDEX_METHODS} for r in raw)
    assert paper_tables.table4(raw=raw) == ref_tables.table4(SCALE)
    assert paper_tables.table4(SCALE) == paper_tables.table4(raw=raw)
    assert paper_tables.check_claims([], raw) == ref_tables.check_claims(
        [], want)


def test_table3_rows_and_claims(ref_tables):
    t3 = paper_tables.table3(SCALE, repeats=1)
    assert [r["dataset"] for r in t3] == list(paper_tables.DATASETS)
    for row in t3:
        assert set(row) == {"dataset", *INDEX_METHODS}
        assert all(row[m] >= 0 for m in INDEX_METHODS)
    # the claims read build times the same way the reference does,
    # whichever way they come out
    fast = [dict(r, **{m: 1.0 for m in INDEX_METHODS[:3]},
                 **{m: 2.0 for m in INDEX_METHODS[3:]}) for r in t3]
    slow = [dict(r, **{"2dreach": 3.0}) for r in fast]
    for rows in (t3, fast, slow):
        lines = paper_tables.check_claims(rows, [])
        assert lines == ref_tables.check_claims(rows, [])
        assert len(lines) == len(paper_tables.DATASETS)
    assert all(ln.endswith("PASS") for ln in
               paper_tables.check_claims(fast, []))
    assert all(ln.endswith("FAIL") for ln in
               paper_tables.check_claims(slow, []))


# ---------------------------------------------------------------- fig 3


def test_sweep_and_stability_rows():
    rows = paper_fig3.sweep("yelp", SCALE, n_queries=24, repeats=1,
                            device="cpu")
    params = [r["param"] for r in rows]
    assert params == ["extent"] * 5 + ["degree"] * 5 + ["selectivity"] * 4
    for r in rows:
        assert set(r) == {"dataset", "param", "value", *METHODS}
        assert r["dataset"] == "yelp"
        assert all(r[m] > 0 for m in METHODS)
    stab = paper_fig3.stability(rows)
    assert set(stab) == set(METHODS) and all(v >= 1.0 for v in
                                             stab.values())
    ref = _reference("paper_fig3")
    assert paper_fig3.stability(rows) == ref.stability(rows)


@pytest.mark.parametrize("wrong", ["host", "device"])
def test_fig3_oracle_gate_fires_on_a_wrong_index(wrong, monkeypatch):
    """The gate before timing: an index whose answers differ from the
    BFS oracle on the 32 checked queries stops the sweep, on its host
    path or on its device engine."""
    from repro_torch.core import engine as E

    g = get_dataset("yelp", scale=0.05)
    us, rects = workload(g, 64, extent_ratio=0.2, seed=17)
    good = build_index(g, "2dreach-comp")
    assert good.query_batch(us[:32], rects[:32]).any()
    paper_fig3._run({"2dreach-comp": good}, g, us, rects, repeats=1,
                    device="cpu")
    bad = build_index(g, "2dreach-comp")
    if wrong == "host":
        bad.vertex_tree[:] = -1             # every tree lookup misses
        match = "2dreach-comp wrong answers"
    else:
        eng = E.engine_for(bad, device="cpu")
        monkeypatch.setattr(eng, "query_batch",
                            lambda u, r: np.zeros(len(u), dtype=bool))
        match = "2dreach-comp device wrong answers"
    with pytest.raises(AssertionError, match=match):
        paper_fig3._run({"2dreach-comp": bad}, g, us, rects, repeats=1,
                        device="cpu")


def test_run_report_and_main(results, capsys):
    rep = run.report(SCALE, 16, skip_fig3=True, device="cpu")
    assert set(rep) == {"scale", "queries", "device", "seconds", "table2",
                        "table3", "table4_raw", "table4", "claims"}
    assert rep["device"] == "cpu" and len(rep["claims"]) == 8
    run.main(["--scale", str(SCALE), "--queries", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    for section in ("[table2", "[table3", "[table4", "[paper claims",
                    "[fig3", "stability max/min ratio"):
        assert section in out, section
    with open(results / "paper.json") as f:
        saved = json.load(f)
    assert len(saved["fig3"]["rows"]) == 4 * 14
    assert set(saved["fig3"]["stability"]) == set(paper_fig3.DATASETS)


# ---------------------------------------------------------- perf benches


def test_perf_build_bench_config_on_cpu(results):
    before = (dict(layout.UPLOAD_COUNTERS), layout.SOA_BUILDS)
    row = perf_build.bench_config("yelp", 0.05, n_check=128, device="cpu")
    assert set(row["variants"]) == set(perf_build.VARIANTS)
    for v in row["variants"].values():
        for side in ("host", "device_cold", "device_warm"):
            assert set(v[side]) == set(perf_build.STAGES)
        assert v["entries"] > 0 and v["trees"] > 0
    assert row["handoff"] == {"engine_adopted": True,
                              "host_uploads_delta": 0,
                              "retranspositions_delta": 0}
    # the host builds transposed nothing and the device builds were
    # adopted, never uploaded
    assert layout.UPLOAD_COUNTERS["host_uploads"] == before[0][
        "host_uploads"]
    assert layout.SOA_BUILDS == before[1]
    summary = perf_build.bench_summary([row])
    assert summary["handoff"]["engine_adopted"]
    assert isinstance(summary["largest_config"][
        "device_beats_host_closure_forest"], bool)
    assert "nvcc" in summary["device_cold"]
    table = perf_build.markdown_table([row]).splitlines()
    assert len(table) == 2 + len(perf_build.VARIANTS)


def test_perf_build_smoke_main_on_cpu(results):
    perf_build.main(["--smoke", "--device", "cpu"])
    with open(results / "BENCH_build.json") as f:
        summary = json.load(f)
    assert summary["device"] == "cpu" and summary["kernel_build_s"] == 0.0
    assert summary["configs"] == [{"dataset": "yelp", "scale": 0.12,
                                   "n_nodes": summary["configs"][0][
                                       "n_nodes"]}]
    assert os.path.exists(results / "perf_build.json")


def test_perf_queries_class_sweep_on_cpu(results):
    rows = perf_queries.class_sweep("yelp", 0.05, n_q=48, k=4, repeats=1,
                                    device="cpu")
    by = {r["query_class"]: r for r in rows}
    assert list(by) == [*perf_queries.CLASSES, "_all"]
    assert by["_all"]["steady_state_recompiles"] == 0
    for kind in perf_queries.CLASSES:
        r = by[kind]
        assert r["host_us_per_q"] > 0 and r["device_us_per_q"] > 0
        assert r["steady_state_recompiles"] == 0
        assert ("two_phase_us_per_q" in r) == (kind != "polygon")
        assert r["device_path"] == ("two_phase" if kind == "polygon"
                                    else "fused")
    summary = perf_queries.bench_summary(rows)
    assert set(summary["classes"]) == set(perf_queries.CLASSES)
    assert summary["steady_state_recompiles"] == 0
    assert summary["device"] == "cpu"


def test_perf_queries_cases_cover_every_class_and_path():
    """Each class answers on every path exactly as the host does (the
    check ``class_sweep`` gates on, one call each)."""
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    from repro_torch.core import QueryEngine

    eng = QueryEngine(idx, device="cpu")
    two = QueryEngine(idx, device="cpu", path="two_phase")
    cases = perf_queries.class_cases(
        idx, eng, two, perf_queries.class_workload(g, 40), 4)
    assert list(cases) == list(perf_queries.CLASSES)
    for kind, (host, paths) in cases.items():
        want = host()
        for path, fn in paths.items():
            assert perf_queries._same(kind, want, fn()), (kind, path)
    assert two.stats["batches"] > 0


def test_obs_overhead_gate_on_cpu(results, monkeypatch):
    monkeypatch.setattr(obs_overhead, "SPAN_CALLS", 20_000)
    obs_overhead.main(["--device", "cpu"])
    with open(results / "obs_overhead.json") as f:
        rep = json.load(f)
    assert rep["device"] == "cpu" and rep["passed"]
    assert rep["fault_hooks_per_batch"] == 3     # route_prune, entry, value
    assert rep["hooks_per_batch"] >= 4


def test_results_go_under_results_torch():
    assert B.RESULTS == os.path.join(REPO, "results", "torch")


# ------------------------------------------------------- entry points


@pytest.mark.parametrize("call", [
    lambda: paper_fig3.sweep("yelp", SCALE, n_queries=8),
    lambda: perf_build.bench_config("yelp", SCALE),
    lambda: perf_queries.class_sweep("yelp", SCALE, n_q=8),
    lambda: perf_queries.main(["--smoke"]),
    lambda: obs_overhead.main([]),
    lambda: run.main(["--skip-fig3"]),
])
def test_entry_points_ask_for_the_card(call):
    """With no device given each entry point runs on the GPU, and where
    there is none it raises; it never moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_no_jax_or_repro_import():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch.benchmarks as b, repro_torch.resilience as r\n"
        "for pkg in (b, r):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(f'{pkg.__name__}.{m.name}')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith(('repro_torch.benchmarks.',\n"
        "                            'repro_torch.resilience.'))]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 12      # 7 bench + 5 resilience
