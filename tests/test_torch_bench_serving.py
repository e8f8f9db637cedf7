"""The port's remaining serving benches on the CPU, against the JAX
package's: the dense closure product and the unscheduled closure
(``kernels.bitset_mm``: D3 ``bitset_mm_mxu``, D4 ``closure_fixpoint``),
the bench-regression sentinel (``benchmarks.regress``, the reference's
``tests/test_regress.py`` cases on the port), ``perf_rangereach
--smoke``, ``chaos_flight`` and ``run.py``'s ``[kernels]`` section, each
with ``--device cpu`` at a small size, writing under a temporary
``results/torch/``.

``bitset_mm_mxu`` must equal the reference's and K7's plain version;
``closure_fixpoint`` (both arms) the reference's MXU fixpoint and
``closure_np``'s sets.  ``regress.extract`` must equal the reference's
on the committed root ``BENCH_*.json``, which it reads and never
writes; the rest of the sentinel follows the reference's cases.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels.bitset_mm import ops as RBM
import repro_torch.benchmarks as B
from repro_torch import obs
from repro_torch.benchmarks import chaos_flight, perf_rangereach, regress
from repro_torch.benchmarks import run as port_run
from repro_torch.core import closure_np, condense, scc_np
from repro_torch.core.reachability import pack_rows, unpack_rows
from repro_torch.data import get_dataset
from repro_torch.kernels.bitset_mm import (
    bitset_mm_mxu,
    bitset_mm_torch,
    closure_fixpoint,
    uint32_bits,
)
from conftest import random_geosocial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name):
    """The reference's ``benchmarks/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_regress():
    return _reference("regress")


@pytest.fixture
def results(tmp_path, monkeypatch):
    """Point ``results/torch/`` at a temporary directory."""
    monkeypatch.setattr(B, "RESULTS", str(tmp_path))
    return tmp_path


def _bits(x):
    return x.numpy().view(np.uint32) if torch.is_tensor(x) else x


# ------------------------------------------------------------- D3 and D4

@pytest.mark.parametrize("d,dj,p", [(1, 1, 1), (8, 32, 128), (33, 40, 70),
                                    (65, 128, 257), (100, 300, 33)])
def test_bitset_mm_mxu_matches_reference(d, dj, p):
    """The reference's sweep (``tests/test_kernels.py``): the dense
    product equals the reference's MXU product, K7's plain version and
    the integer product, with R unpadded and padded to A's words."""
    rng = np.random.default_rng(d * 131 + dj + p)
    A = rng.random((d, dj)) < 0.15
    R = rng.random((dj, p)) < 0.25
    want = pack_rows((A.astype(np.int64) @ R.astype(np.int64)) > 0)
    a_bits, r_bits = pack_rows(A), pack_rows(R)
    rpad = np.zeros((a_bits.shape[1] * 32, r_bits.shape[1]), np.uint32)
    rpad[:dj] = r_bits
    a, r = uint32_bits(a_bits, "cpu"), uint32_bits(r_bits, "cpu")
    got = _bits(bitset_mm_mxu(a, r, device="cpu"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _bits(bitset_mm_mxu(a, uint32_bits(rpad, "cpu"), device="cpu")),
        want)
    np.testing.assert_array_equal(_bits(bitset_mm_torch(a, r)), want)
    np.testing.assert_array_equal(RBM.bitset_mm_mxu(a_bits, rpad)[:d], want)
    np.testing.assert_array_equal(
        RBM.bitset_mm(a_bits, r_bits, use_ref=True), want)


def test_bitset_mm_mxu_checks_its_operands(monkeypatch):
    a = uint32_bits(np.zeros((3, 1), np.uint32), "cpu")
    with pytest.raises(ValueError, match="rows"):
        bitset_mm_mxu(a, uint32_bits(np.zeros((33, 2), np.uint32), "cpu"),
                      device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        bitset_mm_mxu(a.to("meta"), a, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bitset_mm_mxu(a, a)


def _closure_operands(g):
    cond = condense(g.n_nodes, g.edges, scc_np(g.n_nodes, g.edges))
    clo = closure_np(cond, g.n_nodes, g.spatial_ids)
    d, p = cond.n_comps, clo.p
    own = np.zeros((d, p), dtype=bool)
    own[np.repeat(np.arange(d), np.diff(clo.own_indptr)),
        clo.own_cols] = True
    A = np.zeros((d, d), dtype=bool)
    if cond.dag_edges.size:
        A[cond.dag_edges[:, 0], cond.dag_edges[:, 1]] = True
    return cond, clo, pack_rows(own), pack_rows(A)


@pytest.mark.parametrize("graph", ["random35", "random120", "yelp"])
def test_closure_fixpoint_matches_reference_and_closure_np(graph):
    """Both arms of the port's fixpoint equal the reference's MXU
    fixpoint bit for bit and give ``closure_np``'s reachable sets."""
    if graph == "yelp":
        g = get_dataset("yelp", scale=0.02)
    else:
        n = int(graph[6:])
        g = random_geosocial(np.random.default_rng(n), n, 3 * n)
    cond, clo, ob, ab = _closure_operands(g)
    want = RBM.closure_fixpoint(ob, ab, n_iters=cond.n_levels + 1,
                                use_mxu=True)
    for use_mxu in (False, True):
        got = closure_fixpoint(ob, ab, cond.n_levels + 1, use_mxu=use_mxu,
                               device="cpu")
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    rows = unpack_rows(want, clo.p)
    for c in range(cond.n_comps):
        np.testing.assert_array_equal(np.nonzero(rows[c])[0],
                                      clo.comp_set_cols(c))


def test_closure_fixpoint_stops_when_no_row_changes(monkeypatch):
    """The early stop: a chain of 6 components settles after its depth,
    so n_iters far past it takes depth + 1 steps, the last unchanged;
    too few steps leave the far columns unset."""
    from repro_torch.kernels.bitset_mm import ops

    d = 6
    own = np.eye(d, dtype=bool)
    A = np.zeros((d, d), dtype=bool)
    A[np.arange(d - 1), np.arange(1, d)] = True      # i -> i + 1
    ob, ab = pack_rows(own), pack_rows(A)
    steps = []
    real = ops.bitset_mm
    monkeypatch.setattr(ops, "bitset_mm",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    got = closure_fixpoint(ob, ab, 100, device="cpu")
    np.testing.assert_array_equal(unpack_rows(got, d),
                                  np.triu(np.ones((d, d), dtype=bool)))
    assert len(steps) == d
    short = closure_fixpoint(ob, ab, 2, device="cpu")
    assert not unpack_rows(short, d)[0, d - 1]


# ----------------------------------------------------------- regress

def test_extract_equals_reference_on_committed_bench_files(ref_regress):
    """The port's extractors read the committed root BENCH files as the
    reference's do, and leave them as they were."""
    assert regress.BENCHES == ref_regress.BENCHES
    for name in regress.BENCHES:
        path = os.path.join(REPO, name)
        with open(path, "rb") as f:
            before = hashlib.sha256(f.read()).hexdigest()
        with open(path) as f:
            doc = json.load(f)
        metrics = regress.extract(name, doc)
        assert metrics and metrics == ref_regress.extract(name, doc)
        assert all(isinstance(v, float) and v > 0 for v in metrics.values())
        assert (regress.gate_rows(name, metrics)
                == ref_regress.gate_rows(name, metrics))
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == before
    with pytest.raises(ValueError, match="no extractor"):
        regress.extract("BENCH_unknown.json", {})
    assert regress.RATIO_GATES == ref_regress.RATIO_GATES
    assert regress.SCHEMA_VERSION == ref_regress.SCHEMA_VERSION


def _bench(tmp_path, name="BENCH_rangereach.json", scale=1.0):
    with open(os.path.join(REPO, name)) as f:
        doc = json.load(f)
    if scale != 1.0:
        for k in doc["engines"]:
            doc["engines"][k] *= scale
    os.makedirs(str(tmp_path), exist_ok=True)
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_seeded_history_covers_benches(results):
    """A history seeded by ``--no-check`` from the committed BENCH files
    parses and gives every tracked metric a baseline; it lands in
    ``results/torch/bench_history.jsonl`` by default."""
    paths = [_bench(results / "in", n) for n in regress.BENCHES]
    argv = ["--no-check", "--label", "seed", "--device", "cpu"]
    for p in paths:
        argv += ["--bench", p]
    assert regress.main(argv) == 0
    assert regress.default_history() == str(results / "bench_history.jsonl")
    history = regress.load_history()
    assert len(history) == len(regress.BENCHES)
    for run in history:
        assert run["schema_version"] == regress.SCHEMA_VERSION
        assert run["metrics"] and run["device"] == "cpu"
    for name in regress.BENCHES:
        with open(os.path.join(REPO, name)) as f:
            doc = json.load(f)
        for metric in regress.extract(name, doc):
            assert regress.baseline_for(history, name, metric,
                                        5) is not None, (name, metric)


def test_baseline_is_median_of_last_n(ref_regress):
    hist = [{"bench": "b.json", "metrics": {"m": v}}
            for v in (10.0, 10.0, 400.0, 12.0, 11.0)]
    for mod in (regress, ref_regress):
        # median of the last 3 (400, 12, 11) = 12: one outlier run
        # cannot poison the baseline
        assert mod.baseline_for(hist, "b.json", "m", 3) == 12.0
        assert mod.baseline_for(hist, "b.json", "m", 5) == 11.0
        assert mod.baseline_for(hist, "b.json", "m", 4) == 11.5
        assert mod.baseline_for(hist, "b.json", "missing", 3) is None
        assert mod.baseline_for(hist, "other.json", "m", 3) is None


@pytest.mark.parametrize("metrics,metric_tol,want", [
    ({"ok": 11.0, "slow": 20.0, "fast": 2.0, "fresh": 5.0}, None,
     {"ok": "ok", "slow": "REGRESSED", "fast": "improved", "fresh": "new"}),
    ({"noisy": 18.0}, {"noisy": 1.0}, {"noisy": "ok"}),
    ({"noisy": 18.0}, None, {"noisy": "REGRESSED"}),
])
def test_compare_verdicts_and_tolerances(ref_regress, metrics, metric_tol,
                                         want):
    hist = [{"bench": "b.json", "metrics": {"ok": 10.0, "slow": 10.0,
                                            "fast": 10.0, "noisy": 10.0}}]
    rows = regress.compare("b.json", metrics, hist, tol=0.25,
                           metric_tol=metric_tol)
    assert {r["metric"]: r["verdict"] for r in rows} == want
    assert rows == ref_regress.compare("b.json", metrics, hist, tol=0.25,
                                       metric_tol=metric_tol)
    by = {r["metric"]: r for r in rows}
    if "slow" in by:
        assert by["slow"]["ratio"] == pytest.approx(2.0)
        assert by["fresh"]["baseline"] is None


def test_ratio_gate_trips_on_a_doctored_slowdown():
    with open(os.path.join(REPO, "BENCH_queries.json")) as f:
        doc = json.load(f)
    m = regress.extract("BENCH_queries.json", doc)
    m["queries.reach.device_us_per_q"] = (
        m["queries.reach.host_us_per_q"] * 1.5)
    rows = regress.gate_rows("BENCH_queries.json", m)
    verdicts = {r["gate"]: r["verdict"] for r in rows}
    assert verdicts["reach.device_vs_host"] == regress.REGRESSED
    assert verdicts["count.device_vs_host"] == regress.OK
    # slack relaxes the ceiling
    rows = regress.gate_rows("BENCH_queries.json", m, slack=1.0)
    assert all(r["verdict"] == regress.OK for r in rows)


def test_cli_gate_failure_and_no_gates(tmp_path, capsys):
    hist = str(tmp_path / "hist.jsonl")
    name = "BENCH_queries.json"
    with open(os.path.join(REPO, name)) as f:
        doc = json.load(f)
    doc["classes"]["reach"]["device_us_per_q"] = (
        doc["classes"]["reach"]["host_us_per_q"] * 2.0)
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    base = ["--bench", path, "--history", hist, "--device", "cpu"]
    assert regress.main(base) == 1
    assert "ratio gate" in capsys.readouterr().out
    assert regress.main(base + ["--no-gates"]) == 0


def test_cli_seed_then_pass_then_fail(tmp_path, capsys):
    hist = str(tmp_path / "hist.jsonl")
    good = _bench(tmp_path)
    base = ["--history", hist, "--device", "cpu"]
    # seed (append only, no gating)
    assert regress.main(["--bench", good, "--no-check", "--label", "seed"]
                        + base) == 0
    runs = regress.load_history(hist)
    assert len(runs) == 1 and runs[0]["label"] == "seed"
    # an identical rerun passes and appends
    assert regress.main(["--bench", good] + base) == 0
    assert len(regress.load_history(hist)) == 2
    assert "verdict" in capsys.readouterr().out
    # a doctored 3x regression fails with exit 1 ...
    bad = _bench(tmp_path / "bad", scale=3.0)
    assert regress.main(["--bench", bad] + base) == 1
    out = capsys.readouterr().out
    assert "REGRESSED" in out and "engines.host" in out
    # ... and the bad run is still recorded
    assert len(regress.load_history(hist)) == 3
    # --no-append gates without recording
    assert regress.main(["--bench", good, "--no-append", "--baseline-n",
                         "2"] + base) == 0
    assert len(regress.load_history(hist)) == 3


@pytest.mark.parametrize("extra,rc", [
    ([], 1),                                  # 1.6x fails the tight default
    (["--tol", "1.0"], 0),                    # ... not the cross-machine one
    ([f"--metric-tol=engines.{e}=5.0" for e in (
        "host", "device", "wavefront", "cluster", "pallas_leafscan")], 0),
])
def test_cli_tolerances(tmp_path, extra, rc):
    """Scaling touches ``engines.*`` only: a wide global tolerance, or
    per-metric ones on those metrics, keep the run green."""
    hist = str(tmp_path / "hist.jsonl")
    regress.main(["--bench", _bench(tmp_path), "--history", hist,
                  "--no-check", "--device", "cpu"])
    wobbly = _bench(tmp_path / "w", scale=1.6)
    assert regress.main(["--bench", wobbly, "--history", hist, "--no-append",
                         "--device", "cpu"] + extra) == rc


def test_cli_reads_results_torch_only(results, capsys):
    """With no ``--bench`` it looks in ``results/torch/`` and nowhere
    else (the root BENCH files are the reference's); ``--metric-tol``
    wants NAME=FRAC; without a card and ``--device cpu`` it raises."""
    assert regress.main(["--device", "cpu"]) == 2
    assert "no BENCH_*.json" in capsys.readouterr().out
    _bench(results)
    assert regress.main(["--device", "cpu", "--no-append"]) == 0
    assert not os.path.exists(regress.default_history())
    with pytest.raises(SystemExit):
        regress.main(["--device", "cpu", "--metric-tol", "bad"])


# ------------------------------------------------------- the benches

def test_perf_rangereach_smoke_on_cpu(results, monkeypatch):
    monkeypatch.setattr(perf_rangereach, "SMOKE", dict(
        dataset="yelp", scale=0.05, n_q=128, fanouts=(16,),
        capacities=(64,), repeats=1))
    monkeypatch.setattr(perf_rangereach, "SMOKE_CLOSURE", (0.03,))
    out = perf_rangereach.main(["--smoke", "--degraded", "--device", "cpu"])
    assert sorted(os.listdir(results)) == ["BENCH_rangereach.json",
                                           "perf_rangereach.json"]
    with open(results / "BENCH_rangereach.json") as f:
        summary = json.load(f)
    assert summary == json.loads(json.dumps(out["summary"]))
    assert set(summary["engines"]) == {"host", "wavefront", "pallas_leafscan",
                                       "device", "cluster"}
    assert summary["device"] == "cpu" and summary["degraded"]["exact"]
    for key in ("hierarchical_device_engine", "cluster_engine"):
        assert summary[key]["steady_state_recompiles"] == 0
        assert summary[key]["steady_state_retranspositions"] == 0
    methods = [r["method"] for r in out["rows"]["closure"]]
    assert methods == ["scatter_or_levels", "bitset_mm_mxu", "bitset_mm_k7"]
    # the regression sentinel reads what the bench wrote
    assert regress.main(["--device", "cpu", "--no-append"]) in (0, 1)


def test_chaos_flight_on_cpu(tmp_path):
    assert chaos_flight.main(["--device", "cpu", "--out",
                              str(tmp_path)]) == 0
    bundles = os.listdir(tmp_path / "flightdump")
    assert any(b for b in bundles)
    assert not obs.enabled()


def test_run_kernel_section_on_cpu():
    rows = port_run.kernel_bench("cpu")
    assert [r["kernel"] for r in rows] == [
        "host_wavefront", "range_query_forest (K9)", "bitset_mm_mxu d=512"]
    assert rows[1]["us_per_query"] > 0 and rows[2]["ms_per_iter"] > 0


@pytest.mark.parametrize("call", [
    lambda: perf_rangereach.main(["--smoke"]),
    lambda: chaos_flight.main([]),
    lambda: regress.main([]),
    lambda: closure_fixpoint(np.zeros((1, 1), np.uint32),
                             np.zeros((1, 1), np.uint32), 1),
])
def test_entry_points_ask_for_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
