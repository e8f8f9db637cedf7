"""The port's analytics classes (``repro_torch.queries``, the host
descents of ``repro_torch.core.rtree``, ``QueryEngine.knn_batch`` and
``run_queries``) against the JAX package's on the same index, carried
across with ``repro_torch.convert``.  kNN distances are float64 computed
on the host in the same order, so every comparison is exact.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

import repro.core as R
import repro.core.rtree as RR
import repro.data as RD
import repro.queries as RQ
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import QueryEngine, run_queries
from repro_torch.core import rtree as PR
from repro_torch.core.polygon import round_bounds_outward
from repro_torch.queries import (
    QUERY_KINDS,
    QueryProgram,
    knn_reach_host,
    range_collect_host,
    range_count_host,
)
from repro_torch.queries.knn import _MAX_DOUBLINGS, outward_rect

VARIANTS = ("base", "comp", "pointer")
PATHS = ("fused", "two_phase")


@pytest.fixture(scope="module")
def graph():
    return RD.get_dataset("yelp", scale=0.05)


@pytest.fixture(scope="module")
def pairs(graph):
    """variant -> (reference index, port index)."""
    out = {}
    for v in VARIANTS:
        ref = R.build_2dreach(graph, variant=v)
        out[v] = (ref, index_from_arrays(index_to_arrays(ref)))
    return out


def _tiny_pair():
    """0 -> 1 (venue), 2 isolated user, 3 isolated venue (a spatial sink
    under comp/pointer), 4 -> 1."""
    edges = np.array([[0, 1], [4, 1]], dtype=np.int64)
    coords = np.array([[0, 0], [1, 1], [0, 0], [5, 5], [0, 0]], np.float32)
    spatial = np.array([False, True, False, True, False])
    return R.make_graph(5, edges, coords, spatial)


def _same_collect(a, b):
    for f in ("ids", "counts", "overflow"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all(), f


def _same_knn(a, b):
    for f in ("ids", "dist2"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y), f


def _workload(graph, seed, B=24):
    us, rects = RD.workload(graph, B, extent_ratio=0.05, seed=seed)
    us[B // 2:] = np.random.default_rng(seed).integers(0, graph.n_nodes,
                                                       B - B // 2)
    return us, rects


# --------------------------------------------------------------- host paths
@pytest.mark.parametrize("variant", VARIANTS)
def test_host_descents_match_reference(graph, pairs, variant):
    ref, idx = pairs[variant]
    us, rects = _workload(graph, 1, B=40)
    tid = np.where(ref.excluded[us], -1, ref.lookup_tree(us))
    assert np.array_equal(PR.query_host_count(idx.forest, tid, rects),
                          RR.query_host_count(ref.forest, tid, rects))
    for a, b in zip(PR.query_host_collect_batch(idx.forest, tid, rects),
                    RR.query_host_collect_batch(ref.forest, tid, rects)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for t, r in zip(tid[:8], rects[:8]):
        assert np.array_equal(PR.query_host_collect(idx.forest, t, r),
                              RR.query_host_collect(ref.forest, t, r))
    _, pts = RD.knn_workload(graph, 12, seed=2)
    for t, p in zip(tid[:12], pts):
        for k in (1, 6):
            a = PR.query_host_knn(idx.forest, int(t), p, k)
            b = RR.query_host_knn(ref.forest, int(t), p, k)
            assert all(x.dtype == y.dtype and np.array_equal(x, y)
                       for x, y in zip(a, b))


@pytest.mark.parametrize("variant", VARIANTS)
def test_range_host_matches_reference(graph, pairs, variant):
    ref, idx = pairs[variant]
    us, rects = _workload(graph, 2, B=40)
    got, want = range_count_host(idx, us, rects), RQ.range_count_host(
        ref, us, rects)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for k in (1, 4):
        _same_collect(range_collect_host(idx, us, rects, k),
                      RQ.range_collect_host(ref, us, rects, k))
    g = _tiny_pair()
    rt = R.build_2dreach(g, variant=variant)
    pt = index_from_arrays(index_to_arrays(rt))
    us = np.array([0, 2, 3, 1, 4])
    rects = np.array([[0.5, 0.5, 1.5, 1.5]] * 4 + [[4, 4, 6, 6]], np.float32)
    assert np.array_equal(range_count_host(pt, us, rects),
                          RQ.range_count_host(rt, us, rects))
    _same_collect(range_collect_host(pt, us, rects, 2),
                  RQ.range_collect_host(rt, us, rects, 2))


def test_round_bounds_outward_matches_reference():
    from repro.core.polygon import round_bounds_outward as ref_round

    rng = np.random.default_rng(0)
    lo = rng.uniform(-1e3, 1e3, (50, 2))
    hi = lo + rng.uniform(0, 1e-3, (50, 2))
    for a, b in zip(round_bounds_outward(lo, hi), ref_round(lo, hi)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    lo32, hi32 = round_bounds_outward(lo, hi)
    assert (lo32 <= lo).all() and (hi32 >= hi).all()
    assert np.array_equal(outward_rect(lo, hi),
                          RQ.outward_rect(lo, hi))


# ---------------------------------------------------------------------- kNN
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_knn_matches_reference(graph, pairs, variant, path, monkeypatch):
    """``knn_batch`` on both paths against the reference engine's and the
    host descent, with a straggler: a query point far outside the venue
    extent, which the doubling loop cannot resolve within its cap and
    the exact host top-up answers."""
    import repro_torch.queries.knn as PK

    topups = []

    def counting_knn(forest, tid, point, k):
        topups.append(tid)
        return PR.query_host_knn(forest, tid, point, k)

    monkeypatch.setattr(PK, "query_host_knn", counting_knn)
    ref, idx = pairs[variant]
    us, pts = RD.knn_workload(graph, 16, seed=5)
    us[8:] = np.random.default_rng(5).integers(0, graph.n_nodes, 8)
    ext = graph.spatial_extent()
    far = ext[2] + (ext[2] - ext[0]) * 2.0 ** (_MAX_DOUBLINGS + 4)
    pts[3] = [far, far]
    eng = QueryEngine(idx, device="cpu", path=path)
    reng = R.QueryEngine(ref, interpret=True, fused_impl="xla", path=path)
    assert not ref.excluded[us[3]] and ref.lookup_tree(us[3:4])[0] >= 0
    for k in (1, 5):
        topups.clear()
        got = eng.knn_batch(us, pts, k)
        assert topups == [ref.lookup_tree(us[3:4])[0]]
        _same_knn(got, reng.knn_batch(us, pts, k))
        _same_knn(got, knn_reach_host(idx, us, pts, k))
        _same_knn(got, RQ.knn_reach_host(ref, us, pts, k))
    assert eng._knn_kcap_hwm == reng._knn_kcap_hwm
    for f in ("batches", "queries", "tiles_scanned", "fused_reruns"):
        assert eng.stats[f] == reng.stats[f], f


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_knn_sinks_and_empty_trees(variant, path):
    """Alg. 2 rows (vertex 3, an isolated venue, reaches only itself
    under comp/pointer), a vertex that reaches nothing, duplicate
    coordinates and an empty batch."""
    rg = _tiny_pair()
    ref = R.build_2dreach(rg, variant=variant)
    idx = index_from_arrays(index_to_arrays(ref))
    eng = QueryEngine(idx, device="cpu", path=path)
    reng = R.QueryEngine(ref, interpret=True, fused_impl="xla", path=path)
    us = np.array([0, 2, 3, 1, 4])
    pts = np.array([[0, 0], [0, 0], [1, 1], [5, 5], [1, 1]], np.float32)
    for k in (1, 2):
        got = eng.knn_batch(us, pts, k)
        _same_knn(got, reng.knn_batch(us, pts, k))
        _same_knn(got, RQ.knn_reach_host(ref, us, pts, k))
    assert got.row(1).size == 0
    z = eng.knn_batch(np.zeros(0, np.int64), np.zeros((0, 2), np.float32), 3)
    assert z.ids.shape == (0, 3) and z.dist2.shape == (0, 3)
    with pytest.raises(ValueError, match="k >= 1"):
        eng.knn_batch(us, pts, 0)


# ------------------------------------------------------------- front door
def test_query_program_matches_reference():
    us = np.array([1, 2, 3])
    rects = np.zeros((3, 4), np.float32)
    pts = np.zeros((3, 2), np.float32)
    assert QUERY_KINDS == RQ.QUERY_KINDS
    for make in (lambda Q: Q.reach(us, rects), lambda Q: Q.count(us, rects),
                 lambda Q: Q.collect(us, rects, 2),
                 lambda Q: Q.knn(us, pts, 3),
                 lambda Q: Q.polygon(us, [np.zeros((3, 2))] * 3)):
        a, b = make(QueryProgram), make(RQ.QueryProgram)
        assert a.kind == b.kind and a.k == b.k and a.n_queries == 3
        assert np.array_equal(a.us, b.us) and a.us.dtype == b.us.dtype
    for bad in (lambda Q: Q.collect(us, rects, 0), lambda Q: Q.knn(us, pts, 0),
                lambda Q: Q.polygon(us, [np.zeros((3, 2))] * 2),
                lambda Q: Q.polygon(us, [np.zeros((2, 2))] * 3)):
        with pytest.raises(ValueError) as got:
            bad(QueryProgram)
        with pytest.raises(ValueError) as want:
            bad(RQ.QueryProgram)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_queries_matches_reference(graph, pairs, engine):
    ref, idx = pairs["comp"]
    us, rects = _workload(graph, 4)
    _, pts = RD.knn_workload(graph, len(us), seed=4)
    kw = {"device": "cpu"} if engine == "device" else {}
    progs = [(QueryProgram.reach(us, rects), RQ.QueryProgram.reach(us, rects)),
             (QueryProgram.count(us, rects), RQ.QueryProgram.count(us, rects)),
             (QueryProgram.collect(us, rects, 3),
              RQ.QueryProgram.collect(us, rects, 3)),
             (QueryProgram.knn(us, pts, 4), RQ.QueryProgram.knn(us, pts, 4))]
    for prog, rprog in progs:
        got = run_queries(idx, prog, engine=engine, **kw)
        want = R.run_queries(ref, rprog, engine="host")
        if prog.kind == "collect":
            _same_collect(got, want)
        elif prog.kind == "knn":
            _same_knn(got, want)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    _, polys = RD.polygon_workload(graph, len(us), seed=4)
    got = run_queries(idx, QueryProgram.polygon(us, polys), engine=engine,
                      **kw)
    assert np.array_equal(got, R.run_queries(
        ref, RQ.QueryProgram.polygon(us, polys), engine="host"))
    with pytest.raises(ValueError, match="engine"):
        run_queries(idx, progs[0][0], engine="cluster")
    with pytest.raises(ValueError, match="kind"):
        run_queries(idx, QueryProgram(kind="nope", us=us), engine=engine,
                    **kw)
