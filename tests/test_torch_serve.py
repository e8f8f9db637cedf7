"""The port's serving launcher (``repro_torch.launch.serve``) and its Zipf
workload against the JAX package's, on the CPU.

``zipf_workload`` must give the reference's arrays for the same graph,
exponent, seed and rank cap, and raise as it does for ``s <= 0``.
``serve_chunked`` warms the full chunk and the ragged tail, then serves
each chunk once.  Every ``--engine`` arm, driven through the launcher's
``main`` with ``--device cpu`` on ``tiny`` and yelp x0.05, answers as
the reference's host engine does on the same workload (the cluster arm
too: the reference's own sharded engine does not run here, ROADMAP R2).
Every ``--query-class`` gives the reference's ``run_queries(engine=
"host")`` answers.  R6 is decided: with a 3DReach index the reference's
``--engine kernel|wavefront`` raises ``AttributeError`` and the port
serves from the host arm.  ``--obs`` writes its artifacts under the
given directory, and the launcher asks for the card unless ``--device
cpu`` is given.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import json
import os
import sys

import numpy as np
import pytest
import torch

import repro.core as RCORE
import repro.data as RD
from repro import obs as ROBS
from repro.queries import QueryProgram as RQP
from repro_torch import obs
from repro_torch.data import ZIPF_DEFAULT_S, get_dataset, zipf_workload
from repro_torch.launch import serve, serve_chunked

DATASETS = (("tiny", 0.1, 40, 16), ("yelp", 0.05, 300, 64))
ENGINES = ("host", "wavefront", "kernel", "device", "cluster")
CLASSES = ("count", "collect", "knn", "polygon")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Both packages' obs disabled and empty before and after each test."""
    for o in (ROBS, obs):
        o.disable()
        o.reset()
    yield
    for o in (ROBS, obs):
        o.disable()
        o.reset()


def _argv(dataset, scale, n, batch, *extra):
    return ["--dataset", dataset, "--scale", str(scale), "--queries",
            str(n), "--batch", str(batch), "--verify", "16", "--device",
            "cpu", *extra]


# ------------------------------------------------------------------ zipf

@pytest.mark.parametrize("s,seed,max_ranks", [
    (ZIPF_DEFAULT_S, 0, 100_000), (0.6, 3, 50), (2.5, 11, 100_000)])
@pytest.mark.parametrize("dataset,scale", [("tiny", 0.1), ("yelp", 0.05)])
def test_zipf_workload_matches_reference(dataset, scale, s, seed,
                                         max_ranks):
    g = get_dataset(dataset, scale=scale)
    rg = RD.get_dataset(dataset, scale=scale)
    us, rects = zipf_workload(g, 500, s=s, seed=seed, max_ranks=max_ranks)
    rus, rrects = RD.zipf_workload(rg, 500, s=s, seed=seed,
                                   max_ranks=max_ranks)
    assert us.dtype == rus.dtype and rects.dtype == rrects.dtype
    np.testing.assert_array_equal(us, rus)
    np.testing.assert_array_equal(rects, rrects)
    assert ZIPF_DEFAULT_S == RD.ZIPF_DEFAULT_S


@pytest.mark.parametrize("s", [0, -1.0])
def test_zipf_workload_refuses_a_non_positive_exponent(s):
    g = get_dataset("tiny")
    with pytest.raises(ValueError, match="zipf exponent"):
        zipf_workload(g, 10, s=s)
    with pytest.raises(ValueError, match="zipf exponent"):
        RD.zipf_workload(RD.get_dataset("tiny"), 10, s=s)


# --------------------------------------------------------- serve_chunked

@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8)])
def test_serve_chunked_warms_then_serves_each_chunk(n, batch):
    calls = []

    def call(lo, hi):
        calls.append((lo, hi))
        return np.arange(lo, hi) % 3 == 0

    ans, lats, total = serve_chunked(call, n, batch)
    chunks = [(lo, min(lo + batch, n)) for lo in range(0, n, batch)]
    warm = [(0, min(batch, n))] + ([(n - n % batch, n)] if n % batch
                                   else [])
    assert calls == warm + chunks
    np.testing.assert_array_equal(ans, np.arange(n) % 3 == 0)
    assert lats.shape == (n,) and (lats >= 0).all()
    assert total == pytest.approx(sum(lats))


# ------------------------------------------------------------ the arms

def _reference_host(dataset, scale, n, method="2dreach-comp"):
    rg = RD.get_dataset(dataset, scale=scale)
    rus, rrects = RD.workload(rg, n_queries=n, extent_ratio=0.05, seed=1)
    ridx = RCORE.build_index(rg, method)
    return rus, rrects, RCORE.batch_query(ridx, rus, rrects)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dataset,scale,n,batch", DATASETS)
def test_engine_arm_answers_match_reference_host(dataset, scale, n, batch,
                                                 engine):
    rus, rrects, want = _reference_host(dataset, scale, n)
    got = serve.main(_argv(dataset, scale, n, batch, "--engine", engine))
    assert got["engine"] == engine
    np.testing.assert_array_equal(got["answers"], want)
    if engine != "host":
        np.testing.assert_array_equal(got["host"], want)
    if engine in ("wavefront", "kernel"):
        m = got["probe_mask"]
        np.testing.assert_array_equal(got["probed"][m], want[m])
    if engine == "cluster":
        assert got["cluster"]["n_compiles"] == got["cluster"][
            "n_compiles_warm"]
        assert got["cluster"]["mean_batch"] > 0
    assert set(got["percentiles"]) == {"p50", "p95", "p99"}


@pytest.mark.parametrize("kind", CLASSES)
@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("dataset,scale,n,batch", DATASETS)
def test_query_class_matches_reference_run_queries(dataset, scale, n,
                                                   batch, engine, kind):
    k = 5
    got = serve.main(_argv(dataset, scale, n, batch, "--engine", engine,
                           "--query-class", kind, "--k", str(k)))
    rg = RD.get_dataset(dataset, scale=scale)
    ridx = RCORE.build_index(rg, "2dreach-comp")
    if kind == "knn":
        us, pts = RD.knn_workload(rg, n, seed=1)
        prog = RQP.knn(us, pts, k)
    elif kind == "polygon":
        us, polys = RD.polygon_workload(rg, n, extent_ratio=0.05, seed=1)
        prog = RQP.polygon(us, polys)
    else:
        us, rects = RD.workload(rg, n_queries=n, extent_ratio=0.05, seed=1)
        prog = (RQP.count(us, rects) if kind == "count"
                else RQP.collect(us, rects, k))
    want = RCORE.run_queries(ridx, prog, engine="host")
    for ans in [got["host"]] + ([got["device"]] if engine == "device"
                                else []):
        if kind in ("count", "polygon"):
            np.testing.assert_array_equal(ans, want)
        elif kind == "collect":
            np.testing.assert_array_equal(ans.ids, want.ids)
            np.testing.assert_array_equal(ans.counts, want.counts)
            np.testing.assert_array_equal(ans.overflow, want.overflow)
        else:
            np.testing.assert_array_equal(ans.ids, want.ids)
            np.testing.assert_array_equal(ans.dist2, want.dist2)
    assert (got["device"] is None) == (engine == "host")


def test_query_class_refuses_the_cluster():
    with pytest.raises(SystemExit, match="host|device"):
        serve.main(_argv("tiny", 0.1, 10, 8, "--engine", "cluster",
                         "--query-class", "count"))


# ------------------------------------------------------------------- R6

@pytest.mark.parametrize("engine", ["kernel", "wavefront"])
@pytest.mark.parametrize("method", ["3dreach", "3dreach-rev"])
def test_r6_forest_probe_without_tree_lookup(method, engine, monkeypatch,
                                             capsys):
    """The reference's ``--engine kernel|wavefront`` on a 3DReach index
    raises ``AttributeError`` (its index has a forest but no per-vertex
    tree lookup); the port serves such an index from the host arm, says
    so in one line, and answers as the reference's host engine."""
    from repro.launch import serve as RS

    argv = ["--dataset", "tiny", "--method", method, "--queries", "30",
            "--batch", "16", "--verify", "8", "--engine", engine]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(AttributeError, match="lookup_tree"):
        RS.main()
    got = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert (f"{method} has no per-vertex tree lookup: --engine {engine} "
            f"serves from the host arm") in out
    _, _, want = _reference_host("tiny", 0.1, 30, method)
    np.testing.assert_array_equal(got["answers"], want)
    assert got["host"] is None and got["probed"] is None


def test_georeach_forest_probe_serves_the_host_arm_as_the_reference(
        monkeypatch):
    """GeoReach has no forest: both launchers take the host arm."""
    from repro.launch import serve as RS

    argv = ["--dataset", "tiny", "--method", "georeach", "--queries", "20",
            "--batch", "8", "--verify", "8", "--engine", "kernel"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    RS.main()
    got = serve.main(argv + ["--device", "cpu"])
    _, _, want = _reference_host("tiny", 0.1, 20, "georeach")
    np.testing.assert_array_equal(got["answers"], want)


# ------------------------------------------------------------ obs, card

def test_launcher_obs_writes_its_artifacts(tmp_path, capsys):
    out_dir = tmp_path / "obs"
    got = serve.main(_argv("yelp", 0.05, 256, 64, "--engine", "cluster",
                           "--zipf", "1.2", "--obs", "--obs-dir",
                           str(out_dir), "--audit-sample", "0.05"))
    out = capsys.readouterr().out
    assert "[serve] obs: span coverage" in out
    assert "zipf(s=1.2) workload" in out
    assert "heavy hitters" in out
    assert got["audit"]["divergences"] == 0 and got["audit"]["checked"] > 0
    for name in ("trace.json", "metrics.json", "metrics.prom",
                 "querylog.jsonl", "timeseries.jsonl",
                 "placement_report.json"):
        assert (out_dir / name).exists(), name
    with open(out_dir / "placement_report.json") as f:
        assert "slo" in json.load(f)
    # the launcher lets go of obs when it returns
    assert not obs.enabled() and not obs.FLIGHT.armed
    assert not obs.QUERY_LOG._sinks


def test_launcher_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--dataset", "tiny", "--queries", "8"])


def test_launcher_defaults_match_reference(monkeypatch):
    """The reference's flags and defaults, with ``--device`` added and
    the obs artifacts under ``results/torch/``."""
    import argparse

    from repro.launch import serve as RS

    port = vars(serve.parser().parse_args([]))
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["ref"] = vars(real(self, []))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        RS.main()
    assert port.pop("device") == "cuda"
    assert port.pop("obs_dir") == os.path.join("results", "torch", "obs")
    ref = seen["ref"]
    assert ref.pop("obs_dir") == os.path.join("results", "obs")
    assert port == ref
