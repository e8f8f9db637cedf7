"""The port's ``QueryEngine`` (on the CPU) against the JAX package's on
the *same* index, carried across with ``repro_torch.convert``: the fused
path against ``QueryEngine(fused_impl="xla")`` and the two-phase path
against ``QueryEngine(interpret=True, path="two_phase")`` — reach /
count / collect answers, the capacity ratchet's re-runs, the shared
high-water mark and the scanned-tile counts, exactly.  Also the device
contract and the port's import isolation.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
from conftest import random_geosocial, random_queries
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    batch_query,
    build_index,
    engine_for,
    make_graph,
)
from repro_torch.core.engine import DevicePadder
from repro_torch.data import get_dataset, workload
from repro_torch.kernels.range_query import analytics as A
from repro_torch.kernels.range_query import descent as D
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query.layout import TB

VARIANTS = ("base", "comp", "pointer")
METHOD = {"base": "2dreach", "comp": "2dreach-comp",
          "pointer": "2dreach-pointer"}
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def graphs():
    return RD.get_dataset("yelp", scale=0.05), get_dataset("yelp", scale=0.05)


@pytest.fixture(scope="module")
def ref_indexes(graphs):
    return {v: R.build_2dreach(graphs[0], variant=v) for v in VARIANTS}


def _pair(ref_idx, path="fused"):
    """(reference engine, port engine on the CPU) over one index, both
    on ``path`` (the reference's two-phase kernels interpreted)."""
    port_idx = index_from_arrays(index_to_arrays(ref_idx))
    return (R.QueryEngine(ref_idx, interpret=True, fused_impl="xla",
                          path=path),
            QueryEngine(port_idx, device="cpu", path=path))


def _check_modes(ref, eng, us, rects, k=7):
    assert (eng.query_batch(us, rects) == ref.query_batch(us, rects)).all()
    got, want = eng.count_batch(us, rects), ref.count_batch(us, rects)
    assert got.dtype == want.dtype and (got == want).all()
    gcol, wcol = eng.collect_batch(us, rects, k), ref.collect_batch(us, rects, k)
    for f in ("ids", "counts", "overflow"):
        a, b = getattr(gcol, f), getattr(wcol, f)
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), f


def _check_stats(ref, eng):
    for k in ("batches", "queries", "tiles_scanned", "tiles_grid",
              "tiles_full_scan", "fused_reruns"):
        assert eng.stats[k] == ref.stats[k], k


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_matches_reference(graphs, ref_indexes, variant):
    ref, eng = _pair(ref_indexes[variant])
    for seed in range(3):
        us, rects = workload(graphs[1], 150, extent_ratio=0.06, seed=seed)
        _check_modes(ref, eng, us, rects)
    _check_stats(ref, eng)
    assert eng.stats["fused_reruns"] >= 1     # the ratchet did run


@pytest.mark.parametrize("B", [1, TB, TB + 1])
def test_engine_bucket_boundaries(graphs, ref_indexes, B):
    ref, eng = _pair(ref_indexes["comp"])
    us, rects = workload(graphs[1], B, extent_ratio=0.05, seed=B)
    _check_modes(ref, eng, us, rects)
    _check_stats(ref, eng)


def test_device_padder_matches_pad_batch():
    """Each batch pads to the reference's pad_batch contents, and a
    smaller batch never sees a larger previous batch's stale tail."""
    from repro.core.engine import pad_batch as ref_pad_batch

    rng = np.random.default_rng(0)
    padder = DevicePadder(2, torch.device("cpu"))
    for B in (13, 16, 9, 1, 8, 5, 30):
        us = rng.integers(0, 1000, B)
        rects = rng.uniform(-5, 5, (B, 4)).astype(np.float32)
        Bb, us_d, r_d = padder.pad(us, rects)
        want = ref_pad_batch(us, rects, 2)
        assert Bb == want[0]
        for got, w in ((us_d.numpy(), want[1]), (r_d.numpy(), want[2])):
            assert got.dtype == w.dtype and np.array_equal(got, w)


def test_engine_empty_tree_and_excluded_edge_cases():
    """tid == -1 vertices, spatial-sink (excluded) query vertices and a
    graph without venues (empty forest)."""
    edges = np.array([[0, 1]], dtype=np.int64)
    coords = np.array([[0, 0], [1, 1], [0, 0], [5, 5]], dtype=np.float32)
    spatial = np.array([False, True, False, True])
    us = np.array([0, 2, 3, 1])
    rects = np.array([[0.5, 0.5, 1.5, 1.5]] * 4, dtype=np.float32)
    own = np.array([[4.5, 4.5, 5.5, 5.5]] * 4, dtype=np.float32)
    for sp in (spatial, np.zeros(4, bool)):
        rg = R.make_graph(4, edges, coords, sp)
        for variant in VARIANTS:
            ref, eng = _pair(R.build_2dreach(rg, variant=variant))
            _check_modes(ref, eng, us, rects, k=2)
            _check_modes(ref, eng, us, own, k=2)
            _check_stats(ref, eng)


def test_engine_exact_on_rect_edges():
    """Zero-area rects exactly on venue coordinates: the exact f32 leaf
    test decides, not the quantized prune."""
    rng = np.random.default_rng(3)
    n, nv = 80, 40
    coords = (np.round(rng.uniform(0, 50, (n, 2)) * 2) / 2).astype(np.float32)
    spatial = np.zeros(n, bool)
    spatial[:nv] = True
    edges = np.stack([np.arange(nv, n), rng.integers(0, nv, n - nv)], 1)
    ref, eng = _pair(R.build_2dreach(
        R.make_graph(n, edges.astype(np.int64), coords, spatial),
        variant="comp"))
    us = rng.integers(0, n, 3 * TB)
    c = coords[rng.integers(0, nv, 3 * TB)]
    _check_modes(ref, eng, us, np.concatenate([c, c], axis=1))


@pytest.mark.parametrize("variant", VARIANTS)
def test_batch_query_device_on_port_build(graphs, ref_indexes, variant):
    """build_index + batch_query(engine="device") on a port-built index
    answers like the host path and the reference engine."""
    idx = build_index(graphs[1], METHOD[variant])
    us, rects = workload(graphs[1], 200, extent_ratio=0.05, seed=7)
    got = batch_query(idx, us, rects, engine="device", device="cpu")
    assert (got == batch_query(idx, us, rects)).all()
    assert (got == R.batch_query(ref_indexes[variant], us, rects)).all()
    assert engine_for(idx, device="cpu") is engine_for(idx, device="cpu")
    assert (batch_query(idx, us, rects, engine="cluster", device="cpu")
            == got).all()
    tri = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    assert not QueryEngine(idx, device="cpu", path="two_phase").polygon_batch(
        us, [tri - 1e6] * len(us)).any()          # a region far away
    with pytest.raises(ValueError, match="path"):
        QueryEngine(idx, device="cpu", path="nope")


def test_no_gpu_raises(graphs, monkeypatch):
    """With no device given, every entry point asks for the GPU and
    raises where CUDA is absent — nothing moves to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = build_index(get_dataset("tiny"), "2dreach-comp")
    us, rects = np.array([0]), np.array([[0, 0, 10, 10]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_for(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_query(idx, us, rects, engine="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        F.fused_serve(*[None] * 9, mode="reach", kcap=1, nt=1)


# --------------------------------------------------------------------------
# The two-phase path
# --------------------------------------------------------------------------

def _mixed_workload(g, seed, B=32, extent_ratio=0.05):
    """Degree-bucket query vertices for even seeds, uniformly random ones
    (reaching larger trees, so more candidate tiles) for odd seeds."""
    us, rects = workload(g, B, extent_ratio=extent_ratio, seed=seed)
    if seed % 2:
        us = np.random.default_rng(seed).integers(0, g.n_nodes, B)
    return us, rects


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_phase_engine_matches_reference(graphs, ref_indexes, variant):
    ref, eng = _pair(ref_indexes[variant], path="two_phase")
    for seed in range(2):
        us, rects = _mixed_workload(graphs[1], seed)
        _check_modes(ref, eng, us, rects)
    _check_stats(ref, eng)
    assert eng._kb_hwm == ref._kb_hwm
    assert eng.stats["fused_reruns"] == 0     # two-phase never truncates


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_phase_methods_equal_fused(graphs, ref_indexes, variant):
    """The ``*_two_phase`` methods answer like the fused path and leave
    the engine on its own path."""
    _, eng = _pair(ref_indexes[variant])
    us, rects = _mixed_workload(graphs[1], 3)
    assert (eng.query_batch_two_phase(us, rects)
            == eng.query_batch(us, rects)).all()
    assert (eng.count_batch_two_phase(us, rects)
            == eng.count_batch(us, rects)).all()
    a, b = eng.collect_batch_two_phase(us, rects, 5), eng.collect_batch(
        us, rects, 5)
    for f in ("ids", "counts", "overflow"):
        assert (getattr(a, f) == getattr(b, f)).all(), f
    assert eng.path == "fused"


def test_route_prune_matches_reference(graphs, ref_indexes):
    """Phase 1 on both sides: padded rects, slices, Alg. 2 answers, the
    prune mask, the compacted candidates and their counts."""
    from repro.core.engine import compact_candidates as ref_compact
    from repro.kernels.range_query.descent import prune_tiles_pallas

    ref, eng = _pair(ref_indexes["base"], path="two_phase")
    for seed in range(3):
        us, rects = _mixed_workload(graphs[1], seed, B=20)
        got = eng._route_prune(us, rects)
        want = ref._route_prune(us, rects)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert np.array_equal(a.numpy(), np.asarray(b))
        rsoa, qs, qe = got[1], got[3], got[4]
        mask = D.prune_tiles(eng._arena.fine, eng._arena.coarse, rsoa, qs,
                             qe, device="cpu")
        rmask = prune_tiles_pallas(ref._arena.fine, ref._arena.coarse,
                                   *[np.asarray(x) for x in want[1:2]],
                                   *[np.asarray(x) for x in want[3:5]],
                                   interpret=True)
        assert np.array_equal(mask.numpy(), np.asarray(rmask))
        cand, cnt = F.compact_ascending(mask, eng.n_tiles)
        rcand, rcnt = ref_compact(rmask, ref.n_tiles)
        assert np.array_equal(cand.numpy(), np.asarray(rcand))
        assert np.array_equal(cnt.numpy(), np.asarray(rcnt))
        assert eng._kb_hwm == ref._kb_hwm
    _check_stats(ref, eng)


def test_mixed_sequence_shares_the_ratchet(graphs, ref_indexes):
    """Fused and two-phase batches on one engine share ``_kb_hwm``: after
    every step of a mixed sequence the mark and the stats equal the
    reference's."""
    ref, eng = _pair(ref_indexes["base"])
    steps = [("query_batch", 0, 0.01), ("count_batch_two_phase", 1, 0.05),
             ("collect_batch", 3, 0.2), ("query_batch_two_phase", 5, 0.6),
             ("count_batch", 7, 0.6), ("collect_batch_two_phase", 2, 0.2)]
    for name, seed, er in steps:
        us, rects = _mixed_workload(graphs[1], seed, extent_ratio=er)
        extra = (4,) if name.startswith("collect") else ()
        got = getattr(eng, name)(us, rects, *extra)
        want = getattr(ref, name)(us, rects, *extra)
        if extra:
            assert (got.ids == want.ids).all()
            assert (got.counts == want.counts).all()
        else:
            assert (got == want).all(), name
        assert eng._kb_hwm == ref._kb_hwm, name
        _check_stats(ref, eng)
    assert eng._kb_hwm > 2 and eng.stats["fused_reruns"] >= 1


def test_two_phase_edge_cases():
    """tid == -1 vertices, spatial-sink query vertices and a graph with no
    venue on the two-phase path (a candidate row with no active tile
    scans tile 0 and finds nothing)."""
    edges = np.array([[0, 1]], dtype=np.int64)
    coords = np.array([[0, 0], [1, 1], [0, 0], [5, 5]], dtype=np.float32)
    spatial = np.array([False, True, False, True])
    us = np.array([0, 2, 3, 1])
    rects = np.array([[0.5, 0.5, 1.5, 1.5]] * 4, dtype=np.float32)
    own = np.array([[4.5, 4.5, 5.5, 5.5]] * 4, dtype=np.float32)
    for sp in (spatial, np.zeros(4, bool)):
        rg = R.make_graph(4, edges, coords, sp)
        for variant in VARIANTS:
            ref, eng = _pair(R.build_2dreach(rg, variant=variant),
                             path="two_phase")
            _check_modes(ref, eng, us, rects, k=2)
            _check_modes(ref, eng, us, own, k=2)
            _check_stats(ref, eng)


def test_no_gpu_raises_for_the_new_kernels(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (D.prune_tiles, D.descent_scan, A.count_scan):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*[None] * 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.collect_scan(*[None] * 6)
    idx = build_index(get_dataset("tiny"), "2dreach")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(idx, path="two_phase")


# --------------------------------------------------------------------------
# Vertex ids out of range: IndexError on the host, before any upload
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f1_indexes():
    rg = random_geosocial(np.random.default_rng(7), 300, 900)
    g = make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask)
    return g, {v: build_index(g, METHOD[v]) for v in VARIANTS}


def _serve(eng, kind, us, rects):
    """One batch of ``kind`` through ``eng``: reach, count, collect (k=4),
    kNN (k=3) at the rects' centres, or the rects as 4-gons."""
    if kind == "reach":
        return eng.query_batch(us, rects)
    if kind == "count":
        return eng.count_batch(us, rects)
    if kind == "collect":
        return eng.collect_batch(us, rects, 4).ids
    if kind == "knn":
        return eng.knn_batch(us, (rects[:, :2] + rects[:, 2:]) / 2, 3).ids
    return eng.polygon_batch(us, [np.array(
        [[r[0], r[1]], [r[2], r[1]], [r[2], r[3]], [r[0], r[3]]], np.float32)
        for r in rects])


@pytest.mark.parametrize("ids", ["n_nodes", "below_minus_n"])
@pytest.mark.parametrize("kind", ["reach", "count", "collect", "knn",
                                  "polygon"])
@pytest.mark.parametrize("path", ["fused", "two_phase"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_out_of_range_vertex_ids_raise(f1_indexes, variant, path, kind, ids):
    """An id >= n_nodes or < -n_nodes raises IndexError, as the host
    index's NumPy gathers do (the reference's engine would clamp on its
    reach and count paths, ROADMAP R8; gathered on a card it would fire a
    device-side assert); the same engine then answers a good batch as
    the host index does.  kNN raises from its first host gather, NumPy's
    own, before its rounds reach the engine's check."""
    g, idxs = f1_indexes
    n = g.n_nodes
    bad = np.array([n] * 3) if ids == "n_nodes" else np.array([0, -n - 1, 5])
    us, rects = random_queries(np.random.default_rng(7), g, 3)
    eng = QueryEngine(idxs[variant], device="cpu", path=path)
    msg = (f"index {bad[1]} is out of bounds for axis 0 with size {n}"
           if kind == "knn"
           else f"vertex id {bad[1]} is out of bounds for a graph of {n}")
    with pytest.raises(IndexError, match=msg):
        _serve(eng, kind, bad, rects)
    with pytest.raises(IndexError):               # the host index agrees
        idxs[variant].query_batch(bad, rects)
    assert np.array_equal(_serve(eng, kind, us, rects),
                          _serve(QueryEngine(idxs[variant], device="cpu",
                                             path=path), kind, us, rects))
    assert np.array_equal(eng.query_batch(us, rects),
                          idxs[variant].query_batch(us, rects))


@pytest.mark.parametrize("path", ["fused", "two_phase"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_negative_vertex_ids_in_range_wrap(f1_indexes, variant, path):
    g, idxs = f1_indexes
    n = g.n_nodes
    us = np.array([-1, -n, 2, -n + 7])
    _, rects = random_queries(np.random.default_rng(8), g, len(us))
    eng = QueryEngine(idxs[variant], device="cpu", path=path)
    want = idxs[variant].query_batch(us % n, rects)
    assert np.array_equal(eng.query_batch(us, rects), want)
    assert np.array_equal(idxs[variant].query_batch(us, rects), want)
    assert np.array_equal(eng.count_batch(us, rects),
                          eng.count_batch(us % n, rects))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert {'repro_torch.obs', 'repro_torch.obs.profiler',\n"
        "        'repro_torch.obs.audit'} <= set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.path.dirname(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
