"""The benchmark harness on the CPU: a tiny run end to end, its check
against the reference and faults that the check has to catch, the
reference against a plain BFS, the leaf-scan work count against a brute
force, the trace reduction, and ``BENCHMARK.json`` against its contract.
The cells themselves run only on the card (``test_cells_on_card``)."""

from __future__ import annotations

import ast
import copy
import json
import re
import shutil
import subprocess
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from rrbench.bench import cell, lbsn, queries, spec, trace, work
from rrbench.reference.rangereach import Reference

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_spec(cell_name: str, n_nodes: int = 3000, batch: int = 256
              ) -> dict:
    """A cell's files at a tiny size; every answer of the window kept and
    checked."""
    sp = copy.deepcopy(spec.cell_spec(cell_name))
    sp["config"]["graph"]["n_nodes"] = n_nodes
    sp["traffic"].update(batch=batch, vertex_blocks=3, region_blocks=4,
                         warm_batches=1, kept_per_batch=batch,
                         check_sample=10**9)
    return sp


# --------------------------------------------------------------------------
# a tiny run, end to end


RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from rrbench.bench import cell
from rrbench.tests.test_rrbench_harness import tiny_spec
rc = cell.report(cell.run({cell!r}, 2**31 + 11, 0.5, {traced}, device="cpu",
                          cell_spec=tiny_spec({cell!r})))
top = sorted({{m.split(".")[0] for m in sys.modules}})
print("MODULES " + json.dumps(top), file=sys.stderr)
sys.exit(rc)
"""


@pytest.mark.parametrize("cell_name,traced", [(CELLS[0], 0), (CELLS[1], 1)])
def test_tiny_run_prints_the_result_line(cell_name, traced):
    code = RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"),
                           cell=cell_name, traced=bool(traced))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    keys = list(res)
    # the compared numbers come last, under a key of their own
    assert keys[-1] == "limits"
    extra = {"breakdown"} if traced else set()
    assert set(keys[:-1]) - extra == set(RESULT_KEYS)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["limits"]["mismatched_answers"] == {"value": 0, "limit": 0}
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in BENCH[kind]}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not traced:
        assert set(res["metrics"]) == names
    else:    # what the CPU can read: the counter and the build time
        assert {"scan_slots_per_tile", "build_s"} <= set(res["metrics"])
    err = p.stderr.strip().splitlines()
    assert err[-1].startswith("MODULES ")
    loaded = set(json.loads(err[-1][len("MODULES "):]))
    # whole top-level names: repro_torch is the program, repro the JAX one
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    assert err[-3] == "check mismatched_answers = 0 (limit 0)"
    assert err[-2].startswith("check answers_checked = ")


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    p = subprocess.run([sys.executable, "rrbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rrbench", tmp_path / "rrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "rrbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


# --------------------------------------------------------------------------
# faults the check has to catch


def _planted(kind: str, mode: str):
    """A fused serve whose answers are broken where they are produced."""
    from repro_torch.kernels.range_query import fused

    def serve(*args, **kw):
        out, cnt = fused.fused_serve(*args, **kw)
        out = out.clone()
        if kind == "half":          # half of the batch left out
            out[out.shape[0] // 2:] = 0
        else:                       # one answer altered
            out[0] = 1 - out[0] if mode == "reach" else out[0] + 1
        return out, cnt
    return serve


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("cell_name", CELLS[:2])
def test_faults_make_the_run_incorrect(cell_name, kind, monkeypatch):
    from repro_torch.core import engine

    sp = tiny_spec(cell_name)
    monkeypatch.setattr(engine, "fused_serve",
                        _planted(kind, sp["traffic"]["mode"]))
    res = cell.run(cell_name, 5, 0.2, False, device="cpu", cell_spec=sp)
    assert res["correct"] is False
    assert res["limits"]["mismatched_answers"]["value"] > 0


def test_the_control_is_caught():
    """The reference with its region test in bfloat16, put in the
    program's place in a run, makes the run incorrect through the run's
    own limits (the control, at a size a test holds;
    ``rrbench/control.py`` runs it at the cells' sizes on the card)."""
    sp = tiny_spec(CELLS[0], n_nodes=20000, batch=512)
    res = cell.run(CELLS[0], 3, 0.2, False, device="cpu", cell_spec=sp,
                   control=True)
    assert res["correct"] is False
    assert res["limits"]["mismatched_answers"]["value"] > 0
    assert res["limits"]["answers_checked"]["value"] >= 512


# --------------------------------------------------------------------------
# the reference


def _bfs_counts(n, edges, coords, spatial, us, rects):
    adj = [[] for _ in range(n)]
    for s, t in edges:
        adj[int(s)].append(int(t))
    out = []
    for u, r in zip(us, rects):
        seen, todo = {int(u)}, deque([int(u)])
        while todo:
            for t in adj[todo.popleft()]:
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        out.append(sum(1 for v in seen if spatial[v]
                       and r[0] <= coords[v, 0] <= r[2]
                       and r[1] <= coords[v, 1] <= r[3]))
    return np.array(out)


def _graphs():
    from repro_torch.data.registry import get_dataset

    for name in ("tiny", "tiny_cyclic"):
        g = get_dataset(name)
        yield name, g.n_nodes, g.edges, g.coords, g.spatial_mask
    gr = lbsn.generate(tiny_spec(CELLS[0], n_nodes=400)["config"]["graph"],
                       9)
    yield "lbsn", gr.n_nodes, gr.edges, gr.coords, gr.spatial_mask


@pytest.mark.parametrize("graph", list(_graphs()), ids=lambda g: g[0])
def test_reference_matches_bfs(graph):
    _, n, edges, coords, spatial = graph
    rng = np.random.default_rng(4)
    us = rng.integers(0, n, 64)
    lo = rng.random((64, 2)) * 80
    rects = np.concatenate([lo, lo + 5 + rng.random((64, 2)) * 40],
                           axis=1).astype(np.float32)
    rects[:8] = [0, 0, 100, 100]           # whole world
    want = _bfs_counts(n, edges, coords, spatial, us, rects)
    got = Reference(n, edges, coords, spatial, sources_per_pass=7,
                    queries_per_pass=5).counts(us, rects)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "rrbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0 or not names[0].startswith("bench"), \
                    f"{path.name} imports the harness"
            for nm in names:
                top = nm.split(".")[0]
                assert top in ("numpy", "torch", "warnings", "__future__"), \
                    f"{path.name} imports {nm}"


# --------------------------------------------------------------------------
# the leaf-scan work count


def _brute_work(E, off, trees, rects, mode, grain):
    tests, touched = 0, set()
    for t, r in zip(trees, rects):
        if t < 0:
            continue
        a, b = off[t], off[t + 1]
        for lo in range(a, b, grain):      # leaf nodes from the tree's start
            hi = min(lo + grain, b)
            e = E[lo:hi]
            if not (e[:, 0].min() <= r[2] and e[:, 2].max() >= r[0]
                    and e[:, 1].min() <= r[3] and e[:, 3].max() >= r[1]):
                continue
            touched.add((lo, hi))
            hit = ((e[:, 0] <= r[2]) & (e[:, 2] >= r[0])
                   & (e[:, 1] <= r[3]) & (e[:, 3] >= r[1]))
            if mode == "reach" and hit.any():
                tests += int(np.argmax(hit)) + 1
                break
            tests += hi - lo
    nbytes = (sum(h - lo for lo, h in touched) * work.ENTRY_BYTES
              + len(trees) * (work.QUERY_BYTES + work.ANSWER_BYTES))
    return tests, nbytes


@pytest.mark.parametrize("grain", [16, 7])
@pytest.mark.parametrize("mode", ["count", "reach"])
def test_work_count_matches_brute_force(mode, grain):
    from repro_torch.core import build_index, make_graph

    gr = lbsn.generate(tiny_spec(CELLS[0], n_nodes=6000)["config"]["graph"],
                       7)
    g = make_graph(gr.n_nodes, gr.edges, gr.coords, gr.spatial_mask)
    idx = build_index(g, "2dreach-comp", backend="host", fanout=grain)
    rng = np.random.default_rng(0)
    us, rects = queries.pool(lbsn.out_degree(gr), lbsn.spatial_extent(gr),
                             (100, 149), 0.05, 200, rng)
    trees = np.where(idx.excluded[us], -1, idx.lookup_tree(us))
    trees[:5] = -1                         # queries that scan no tree
    E, off = idx.forest.entries, idx.forest.entry_off
    w = work.batch_work(work.Tiles(E, off, idx.forest.fanout, "cpu"), trees,
                        rects, mode)
    tests, nbytes = _brute_work(E, off, trees, rects, mode, grain)
    assert (w["tests"], w["bytes"]) == (tests, nbytes)
    assert tests > 0
    op_s = tests * work.CMPS_PER_TEST / work.F32_CMP_PER_S
    assert w["bound_s"] == max(op_s, nbytes / work.HBM_BYTES_PER_S)


# --------------------------------------------------------------------------
# the trace reduction


def test_trace_summary_busy_and_idle_gaps():
    W = trace.WINDOW_SPAN
    device = [("k1", 10, 40), ("copy", 35, 50), ("k1", 80, 90),
              ("outside", 200, 300)]
    host = [(W, 0, 60), ("aten::copy_", 5, 12), ("cudaLaunchKernel", 6, 8),
            (W, 62, 120), ("aten::item", 95, 118), ("stray", 130, 140)]
    s = trace.summarize(device, host, (0, 120))
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["window_s"] == pytest.approx(120e-6)
    assert s["device_s"] == pytest.approx({"k1": 40e-6, "copy": 15e-6})
    # gaps: [0, 10) in copy_ (its middle before the launch), [50, 80)
    # with its middle in the second batch's own code, [90, 120) in item
    assert s["idle_s"] == pytest.approx({
        f"{W} > aten::copy_": 10e-6, W: 30e-6,
        f"{W} > aten::item": 30e-6})
    assert trace.top(s["device_s"], 1) == [["k1", pytest.approx(40e-6)]]
    assert trace.kernel_seconds(s, "k1") == pytest.approx(40e-6)


# --------------------------------------------------------------------------
# BENCHMARK.json against its contract

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_files_and_moves():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("rrbench/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert spec.traffic_path(w["traffic"]).exists()
        assert 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert spec.metric_path(m["name"]).exists()
        assert callable(spec.metric_reader(m["name"]))
        for w in m.get("workloads", CELLS):
            # a cell that reports a per-layer metric reports what it moves
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in CELLS:
        sp = spec.cell_spec(w)
        assert sp["per_layer"] and len(sp["end_to_end"]) >= 2


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_cells_on_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "rrbench/run.py", "--workload",
                        cell_name, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


# --------------------------------------------------------------------------
# the frozen copies of the program's generators


@pytest.mark.parametrize("config", ["gowalla-comp"])
def test_generators_match_the_programs(config):
    """The harness's copies draw what ``repro_torch.data`` draws from the
    same parameters and seed (the copies are frozen: the program's may
    change later, and this test then says so).  The program's generator
    has no ``venue_min_checkins``: at 0 the harness's draw is its draw,
    and at 1 it only adds an edge into every venue."""
    import dataclasses

    from repro_torch.core import make_graph
    from repro_torch.data import lbsn as plbsn
    from repro_torch.data import queries as pq

    params = json.loads(
        (ROOT / f"rrbench/configs/{config}.json").read_text())["graph"]
    params["n_nodes"] = 2000
    extra = dict(params, venue_min_checkins=1)
    params["venue_min_checkins"] = 0
    params.pop("city_seed", None)
    pspec = dataclasses.replace(
        plbsn.SPECS[config.split("-")[0]], seed=41,
        **{k: v for k, v in params.items() if k != "venue_min_checkins"})
    extra.pop("city_seed", None)
    g = plbsn.generate_lbsn(pspec)
    mine = lbsn.generate(params, 41)
    more = lbsn.generate(extra, 41)
    np.testing.assert_array_equal(more.edges[:len(mine.edges)], mine.edges)
    np.testing.assert_array_equal(more.coords, mine.coords)
    fed = np.zeros(more.n_nodes, bool)
    fed[more.edges[len(mine.edges):, 1]] = True
    assert (fed == more.spatial_mask).all()
    # a city_seed keeps the cities in place from seed to seed
    fixed = [lbsn.generate(dict(extra, city_seed=12), s) for s in (1, 2)]
    hub = [np.median(f.coords[f.spatial_mask], axis=0) for f in fixed]
    free = [np.median(lbsn.generate(extra, s).coords[f.spatial_mask],
                      axis=0) for s, f in zip((1, 2), fixed)]
    assert np.abs(hub[0] - hub[1]).max() < 2.0
    assert np.abs(free[0] - free[1]).max() > 2.0
    mg = make_graph(mine.n_nodes, mine.edges, mine.coords, mine.spatial_mask)
    np.testing.assert_array_equal(mg.edges, g.edges)
    np.testing.assert_array_equal(mine.coords, g.coords)
    np.testing.assert_array_equal(lbsn.out_degree(mine), g.out_degree())
    np.testing.assert_array_equal(lbsn.spatial_extent(mine),
                                  g.spatial_extent())
    want = pq.workload(g, n_queries=300, seed=5)
    got = queries.pool(lbsn.out_degree(mine), lbsn.spatial_extent(mine),
                       pq.DEGREE_DEFAULT, pq.REGION_EXTENT_DEFAULT, 300,
                       np.random.default_rng(5))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
