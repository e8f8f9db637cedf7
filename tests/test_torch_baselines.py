"""The port's baselines (3DReach, 3DReach-Rev, GeoReach), their interval
labels and MBR closure, the boolean sweep closure and the front door's
contract for index types without a device engine, against the JAX
package's.

Same graphs, same queries; every index array, answer and size equal,
and the answers equal to the BFS oracle.  Every comparison is exact.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import warnings

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.interval_labels as RIL
import repro.data as RD
from conftest import random_geosocial, random_queries
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    METHODS,
    GeoReachIndex,
    ThreeDReachIndex,
    batch_query,
    build_index,
    build_interval_labels,
    closure_mbr_np,
    closure_torch,
    condense,
    engine_for,
    index_nbytes,
    make_graph,
    rangereach_oracle_batch,
    run_queries,
    scc_np,
)
from repro_torch.core import api as port_api
from repro_torch.core.interval_labels import labels_reachable
from repro_torch.data import get_dataset, workload
from repro_torch.queries import QueryProgram

SOURCES = ("seed0", "seed1", "seed2", "tiny", "tiny_cyclic", "yelp")
BASELINES = ("3dreach", "3dreach-rev", "georeach")


def _graphs(source):
    """(reference graph, port graph) for a named source."""
    if source.startswith("seed"):
        rg = random_geosocial(np.random.default_rng(int(source[4:])), 80, 220)
        return rg, make_graph(rg.n_nodes, rg.edges, rg.coords,
                              rg.spatial_mask)
    if source == "yelp":
        return (RD.get_dataset("yelp", scale=0.05),
                get_dataset("yelp", scale=0.05))
    return RD.get_dataset(source), get_dataset(source)


def _conds(source):
    rg, g = _graphs(source)
    rc = R.condense(rg.n_nodes, rg.edges, R.scc_np(rg.n_nodes, rg.edges))
    c = condense(g.n_nodes, g.edges, scc_np(g.n_nodes, g.edges))
    return rg, g, rc, c


def _queries(source, g, n=120):
    if source == "yelp":
        return workload(g, n, extent_ratio=0.05, seed=3)
    return random_queries(np.random.default_rng(len(source)), g, n)


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("source", SOURCES)
def test_interval_labels_match(source, reverse):
    _, _, rc, c = _conds(source)
    if reverse and c.dag_edges.size:
        rc.dag_edges, c.dag_edges = rc.dag_edges[:, ::-1], c.dag_edges[:, ::-1]
    got, want = build_interval_labels(c), RIL.build_interval_labels(rc)
    for k in ("post", "indptr", "lo", "hi"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got.total_intervals == want.total_intervals
    assert got.nbytes() == want.nbytes()
    for u in range(0, c.n_comps, max(1, c.n_comps // 40)):
        for v in range(0, c.n_comps, max(1, c.n_comps // 40)):
            assert labels_reachable(got, u, v) == RIL.labels_reachable(
                want, u, v)


@pytest.mark.parametrize("source", SOURCES)
def test_closure_mbr_matches(source):
    rg, g, rc, c = _conds(source)
    got = closure_mbr_np(c, g.coords, g.spatial_mask)
    want = R.closure_mbr_np(rc, rg.coords, rg.spatial_mask)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("method", BASELINES)
@pytest.mark.parametrize("source", SOURCES)
def test_baseline_arrays_and_answers_match(source, method):
    """Every array of the index equal to the reference's; the answers
    equal to the reference's and the BFS oracle; GeoReach's explored
    count after each query equal too."""
    rg, g = _graphs(source)
    got, ref = build_index(g, method), R.build_index(rg, method)
    assert type(got) is (GeoReachIndex if method == "georeach"
                         else ThreeDReachIndex)
    _same_arrays(index_to_arrays(got), index_to_arrays(ref))
    for k in ("n_comps", "total_intervals"):
        assert got.stats.get(k) == ref.stats.get(k), k
    us, rects = _queries(source, g)
    ans = got.query_batch(us, rects)
    assert ans.dtype == bool
    assert np.array_equal(ans, ref.query_batch(us, rects))
    assert np.array_equal(ans, rangereach_oracle_batch(g, us, rects))
    if method == "georeach":
        for u, r in zip(us[:40], rects[:40]):
            assert got.query(int(u), r) == ref.query(int(u), r)
            assert got.stats["last_explored"] == ref.stats["last_explored"]
    else:
        assert np.array_equal(got.intervals_per_query_comp(us),
                              ref.intervals_per_query_comp(us))


@pytest.mark.parametrize("source", ["seed1", "tiny", "yelp"])
def test_index_nbytes_match(source):
    rg, g = _graphs(source)
    for method in METHODS:
        got = index_nbytes(build_index(g, method))
        assert got == R.index_nbytes(R.build_index(rg, method)), method
        assert got["total"] == got["rtree"] + got["aux"]
    with pytest.raises(ValueError, match="size"):
        index_nbytes(object())


def test_figure1_running_example():
    """The paper's Figure 1 on ``tiny``: a reaches h at (6, 2) through d;
    no method finds a venue in an empty region; the spatial sink f
    answers through its own point."""
    g = get_dataset("tiny")
    rect = np.array([5.5, 1.5, 6.5, 2.5], np.float32)
    for method in METHODS:
        idx = build_index(g, method)
        assert idx.query(0, rect), method
        assert not idx.query(0, np.array([90, 90, 95, 95], np.float32))
        assert idx.query(5, np.array([0.5, 0.5, 1.5, 1.5], np.float32))
        assert not idx.query(5, np.array([5, 1, 8, 6], np.float32))
    idx = build_index(g, "3dreach")
    assert idx.labels.total_intervals >= idx.cond.n_comps
    for c in range(idx.cond.n_comps):
        assert labels_reachable(idx.labels, c, c)


@pytest.mark.parametrize("method", METHODS)
def test_convert_round_trips(method):
    """A reference index carried into the port answers like the port's
    own build, and carries back array for array."""
    rg, g = _graphs("seed2")
    ref = R.build_index(rg, method)
    carried = index_from_arrays(index_to_arrays(ref))
    _same_arrays(index_to_arrays(carried), index_to_arrays(ref))
    us, rects = _queries("seed2", g)
    assert np.array_equal(carried.query_batch(us, rects),
                          build_index(g, method).query_batch(us, rects))
    with pytest.raises(ValueError, match="kind"):
        index_from_arrays({**index_to_arrays(ref), "kind": np.asarray("x")})


@pytest.mark.parametrize("source", SOURCES)
def test_closure_torch_matches_jax(source):
    """The boolean sweep closure equals the reference's ``closure_jax``
    after one sweep and after as many sweeps as the DAG has levels."""
    rg, g, rc, c = _conds(source)
    rng = np.random.default_rng(c.n_comps)
    own = rng.random((c.n_comps, 37)) < 0.1
    for sweeps in (1, max(c.n_levels, 1)):
        got = closure_torch(c.n_comps, c.dag_edges, own, sweeps,
                            device="cpu")
        want = R.closure_jax(rc.n_comps, rc.dag_edges, own, sweeps)
        assert got.dtype == bool and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n_edges", [0, 2])
def test_closure_torch_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch,
                                                            n_edges):
    """``device=None`` means the GPU and raises where CUDA is absent,
    also for a DAG without edges, which needs no sweep."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1], [1, 2]], dtype=np.int64)[:n_edges]
    own = np.eye(3, dtype=bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        closure_torch(3, edges, own, 2)
    got = closure_torch(3, edges, own, 2, device="cpu")
    want = np.eye(3, dtype=bool)
    want[:n_edges, 2] = True
    want[0, 1] = n_edges > 0
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# The front door for index types without a device engine
# --------------------------------------------------------------------------

def test_build_and_device_contract():
    """Baselines build; ``backend="device"`` on one raises a ValueError
    naming it; ``engine_for`` returns None for it, or raises with
    ``required=True``; ``run_queries`` reach on the device requires a
    device engine."""
    g = get_dataset("tiny")
    us, rects = _queries("tiny", g, 16)
    for method in BASELINES:
        idx = build_index(g, method)
        assert engine_for(idx) is None
        with pytest.raises(ValueError, match=type(idx).__name__):
            engine_for(idx, required=True)
        with pytest.raises(ValueError, match=type(idx).__name__):
            batch_query(idx, us, rects, engine="device", required=True)
        with pytest.raises(ValueError, match=type(idx).__name__):
            run_queries(idx, QueryProgram.reach(us, rects), engine="device")
        with pytest.raises(ValueError, match=method):
            build_index(g, method, backend="device")
        assert np.array_equal(
            run_queries(idx, QueryProgram.reach(us, rects)),
            idx.query_batch(us, rects))
        with pytest.raises(ValueError, match="count"):
            run_queries(idx, QueryProgram.count(us, rects))


def test_device_fallback_warns_once_per_cause(monkeypatch):
    """``batch_query(engine="device")`` on a baseline answers from the
    index's host path with one RuntimeWarning per (reason, index type),
    even with no GPU; a 2DReach index with no GPU still raises."""
    monkeypatch.setattr(port_api, "_FALLBACK_WARNED", set())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = get_dataset("tiny")
    us, rects = _queries("tiny", g, 16)
    i3, i3r, geo = (build_index(g, m) for m in BASELINES)
    with pytest.warns(RuntimeWarning, match="ThreeDReachIndex"):
        got = batch_query(i3, us, rects, engine="device")
    assert np.array_equal(got, i3.query_batch(us, rects))
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the same cause: no new warning
        assert np.array_equal(batch_query(i3r, us, rects, engine="device"),
                              i3r.query_batch(us, rects))
    with pytest.warns(RuntimeWarning, match="GeoReachIndex"):
        batch_query(geo, us, rects, engine="device")
    assert port_api._FALLBACK_WARNED == {
        ("unsupported-index", "ThreeDReachIndex"),
        ("unsupported-index", "GeoReachIndex")}
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_query(build_index(g, "2dreach-comp"), us, rects,
                    engine="device")
