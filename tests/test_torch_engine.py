"""The port's ``QueryEngine`` (fused path, on the CPU) against the JAX
package's ``QueryEngine(fused_impl="xla")`` on the *same* index, carried
across with ``repro_torch.convert``: reach / count / collect answers,
the capacity ratchet's re-runs and the scanned-tile counts, exactly.
Also the device contract and the port's import isolation.
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
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    batch_query,
    build_index,
    engine_for,
)
from repro_torch.core.engine import DevicePadder
from repro_torch.data import get_dataset, workload
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


def _pair(ref_idx):
    """(reference engine, port engine on the CPU) over one index."""
    port_idx = index_from_arrays(index_to_arrays(ref_idx))
    return (R.QueryEngine(ref_idx, fused_impl="xla"),
            QueryEngine(port_idx, device="cpu"))


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
    with pytest.raises(NotImplementedError):
        batch_query(idx, us, rects, engine="cluster")
    with pytest.raises(NotImplementedError):
        QueryEngine(idx, device="cpu", path="two_phase")


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


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
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
