"""The port's convex-polygon RangeReach against the JAX package's: the
region helpers of ``core.polygon`` (and their errors), the workload,
``polygon_scan_torch`` against the interpreted ``polygon_scan_pallas``
and the dense references on inputs with venues exactly on polygon
vertices and edges, ``polygon_reach_host``, ``QueryEngine.polygon_batch``
and ``run_queries(kind="polygon")`` against the reference and the BFS
oracle, for the three variants.  Every comparison is exact.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.oracle as RO
import repro.core.polygon as RP
import repro.data as RD
import repro.queries as RQ
from repro.kernels.range_query import analytics as RA
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import QueryEngine, build_index, make_graph, run_queries
from repro_torch.core import oracle as PO
from repro_torch.core import polygon as PP
from repro_torch.data import polygon_workload
from repro_torch.kernels.range_query import analytics as A
from repro_torch.kernels.range_query.descent import prune_tiles_torch
from repro_torch.kernels.range_query.fused import compact_ascending
from repro_torch.queries import QueryProgram, polygon_reach_host
from test_torch_analytics import KINDS, cut
from test_torch_cuda import polygon_case

VARIANTS = ("base", "comp", "pointer")
METHOD = {"base": "2dreach", "comp": "2dreach-comp",
          "pointer": "2dreach-pointer"}


@pytest.fixture(scope="module")
def graph():
    return RD.get_dataset("yelp", scale=0.05)


@pytest.fixture(scope="module")
def pairs(graph):
    """variant -> (reference index, port index carried across)."""
    return {v: (ref, index_from_arrays(index_to_arrays(ref)))
            for v in VARIANTS
            for ref in [R.build_2dreach(graph, variant=v)]}


def _mixed_polygons(rng, graph, B, lo=3, hi=12):
    """B convex polygons of lo..hi vertices over the graph's extent."""
    ext = graph.spatial_extent()
    polys = []
    for _ in range(B):
        k = int(rng.integers(lo, hi + 1))
        ang = np.sort(rng.random(k) * 2 * np.pi) + np.arange(k) * 1e-6
        c = ext[:2] + rng.random(2) * (ext[2:] - ext[:2])
        r = (ext[2:] - ext[:2]) * rng.uniform(0.02, 0.2, 2)
        polys.append(np.stack([c[0] + r[0] * np.cos(ang),
                               c[1] + r[1] * np.sin(ang)], 1
                              ).astype(np.float32))
    return tuple(polys)


# ------------------------------------------------------------ region helpers
def test_region_helpers_match_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (400, 2)).astype(np.float32)
    for k in (3, 4, 6, 12):
        ang = np.sort(rng.random(k) * 2 * np.pi)
        v = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
        for verts in (v, v[::-1]):                  # CCW and CW input
            assert np.array_equal(PP._ccw(verts), RP._ccw(verts))
            assert np.array_equal(PP.points_in_convex_polygon(pts, verts),
                                  RP.points_in_convex_polygon(pts, verts))
            bb, rbb = PP.polygon_bbox(verts), RP.polygon_bbox(verts)
            assert bb.dtype == rbb.dtype and np.array_equal(bb, rbb)
            for pad in (None, k, 16):
                hp = PP.convex_halfplanes(verts, pad_to=pad)
                rhp = RP.convex_halfplanes(verts, pad_to=pad)
                assert hp.dtype == rhp.dtype and np.array_equal(hp, rhp)
            region = np.concatenate([pts, verts])   # vertices on the edge
            got = PP.points_in_polygon_region(region, bb, hp)
            assert np.array_equal(
                got, RP.points_in_polygon_region(region, rbb, rhp))
            assert 0 < got.sum() < len(got)
    for bad in (lambda M: M.convex_halfplanes(np.zeros((2, 2))),
                lambda M: M.convex_halfplanes(np.eye(3, 2), pad_to=2)):
        with pytest.raises(ValueError) as got:
            bad(PP)
        with pytest.raises(ValueError) as want:
            bad(RP)
        assert str(got.value) == str(want.value)


def test_polygon_workload_matches_reference(graph):
    g = graph
    pg = make_graph(g.n_nodes, g.edges, g.coords, g.spatial_mask)
    for seed, n_edges in ((0, 6), (3, 3), (5, 12)):
        us, polys = polygon_workload(pg, 40, n_edges=n_edges, seed=seed)
        rus, rpolys = RD.polygon_workload(g, 40, n_edges=n_edges, seed=seed)
        assert us.dtype == rus.dtype and np.array_equal(us, rus)
        assert len(polys) == len(rpolys)
        for p, rp in zip(polys, rpolys):
            assert p.dtype == rp.dtype and np.array_equal(p, rp)


# ---------------------------------------------------------------- the scan
def _region_truth(d, ck):
    """(B,) int32 — the reference's canonical region test
    (``repro.core.polygon.points_in_polygon_region``, NumPy float32)
    over each query's arena slice in the tiles its candidate row names
    (all tiles where ``ck`` is None)."""
    B = len(d["qs"])
    pts = d["esoa"][:2].T
    out = np.zeros(B, np.int32)
    for b in range(B):
        g = np.arange(d["qs"][b], d["qe"][b])
        if ck is not None:
            g = g[np.isin(g // 128, ck[b // 8].numpy())]
        out[b] = RP.points_in_polygon_region(
            pts[g], d["rsoa"][:, b],
            RP.convex_halfplanes(d["polys"][b], pad_to=d["ne"])).any()
    return out


def _scan_case(B, ne, kind, plant):
    d = polygon_case(B + ne, B, 40, ne, plant=plant)
    T = {k: torch.as_tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    mask = prune_tiles_torch(T["fine"], T["coarse"], T["rsoa"], T["qs"],
                             T["qe"])
    cand, cnt = compact_ascending(mask, d["nt"])
    names = ("esoa", "rsoa", "lines", "qs", "qe")
    return d, cut(cand, int(cnt.max()), kind), [T[k] for k in names], \
        [jnp.asarray(d[k]) for k in names]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,ne", [(8, 4), (24, 8), (24, 12)])
def test_polygon_scan_matches_reference(B, ne, kind):
    """Venues off the polygons' edges: the plain version equals the
    interpreted Pallas kernel and both dense references."""
    d, ck, args, jargs = _scan_case(B, ne, kind, plant=False)
    got = A.polygon_scan_torch(ck, *args, ne=d["ne"])
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    want = RA.polygon_scan_pallas(jnp.asarray(ck.numpy()), *jargs,
                                  ne=d["ne"], interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), _region_truth(d, ck))
    dense = A.polygon_scan_ref(*args, ne=d["ne"])
    assert np.array_equal(dense.numpy(),
                          np.asarray(RA.polygon_scan_ref(*jargs, ne=d["ne"])))
    assert np.array_equal(dense.numpy(), _region_truth(d, None))
    assert 0 < int(dense.sum()) < B
    if kind in ("at", "above"):
        assert torch.equal(got, dense)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,ne", [(8, 4), (24, 8), (24, 12)])
def test_polygon_scan_on_edges_matches_region_test(B, ne, kind):
    """Venues planted on polygon vertices and edges: the plain version
    and its dense reference equal the reference's canonical float32
    region test, each product and the sum rounded on their own.  (The
    interpreted Pallas kernel is not the yardstick here: XLA on the CPU
    contracts ``A*x + B*y`` into a fused multiply-add, which rounds once
    and flips some of these answers.)"""
    d, ck, args, _ = _scan_case(B, ne, kind, plant=True)
    got = A.polygon_scan_torch(ck, *args, ne=d["ne"])
    assert np.array_equal(got.numpy(), _region_truth(d, ck))
    dense = A.polygon_scan_ref(*args, ne=d["ne"])
    assert np.array_equal(dense.numpy(), _region_truth(d, None))
    assert 0 < int(dense.sum()) < B


def test_polygon_scan_wrapper_on_cpu_runs_the_plain_version():
    d = polygon_case(1, 16, 6, 4)
    T = [torch.as_tensor(d[k]) for k in ("esoa", "rsoa", "lines", "qs",
                                           "qe")]
    ck = torch.arange(6, dtype=torch.int32).repeat(2, 1)
    before = A.polygon_scan.launches
    assert torch.equal(A.polygon_scan(ck, *T, ne=d["ne"], device="cpu"),
                       A.polygon_scan_torch(ck, *T, ne=d["ne"]))
    assert A.polygon_scan.launches == before


# ----------------------------------------------------- host, engine, oracle
@pytest.mark.parametrize("variant", VARIANTS)
def test_polygon_queries_match_reference(graph, pairs, variant):
    ref, idx = pairs[variant]
    us, polys = RD.polygon_workload(graph, 24, seed=11)
    mixed = _mixed_polygons(np.random.default_rng(7), graph, 24)
    us2 = np.random.default_rng(7).integers(0, graph.n_nodes, 24)
    eng = QueryEngine(idx, device="cpu", path="two_phase")
    reng = R.QueryEngine(ref, interpret=True, fused_impl="xla",
                         path="two_phase")
    for u, p in ((us, polys), (us2, mixed)):
        want = RQ.polygon_reach_host(ref, u, p)
        host = polygon_reach_host(idx, u, p)
        assert host.dtype == want.dtype and np.array_equal(host, want)
        dev = eng.polygon_batch(u, p)
        assert dev.dtype == want.dtype and np.array_equal(dev, want)
        assert np.array_equal(reng.polygon_batch(u, p), want)
        oracle = [PO.polygon_reach_oracle(graph, int(a), b)
                  for a, b in zip(u[:12], p[:12])]
        assert oracle == [RO.polygon_reach_oracle(graph, int(a), b)
                          for a, b in zip(u[:12], p[:12])]
        assert np.array_equal(want[:12], oracle)
    assert 0 < want.sum() < len(want)
    assert eng._kb_hwm == reng._kb_hwm
    for k in ("batches", "queries", "tiles_scanned", "tiles_grid",
              "tiles_full_scan"):
        assert eng.stats[k] == reng.stats[k], k
    assert np.array_equal(eng.polygon_batch(us[:0], ()), np.zeros(0, bool))
    with pytest.raises(ValueError, match="polygons"):
        eng.polygon_batch(us, polys[:-1])
    with pytest.raises(ValueError, match="polygons"):
        polygon_reach_host(idx, us, polys[:-1])


@pytest.mark.parametrize("variant", ["comp", "pointer"])
def test_sink_inside_bbox_outside_polygon(variant):
    """A spatial-sink query vertex is answered by its own point against
    the whole region: inside the bbox but outside the triangle is False,
    though the bbox alone would say True."""
    edges = np.array([[0, 1]], np.int64)
    coords = np.array([[0, 0], [5, 5], [0.9, 0.1]], np.float32)
    spatial = np.array([False, True, True])
    rg = R.make_graph(3, edges, coords, spatial)
    ref = R.build_2dreach(rg, variant=variant)
    idx = index_from_arrays(index_to_arrays(ref))
    assert idx.excluded[2]
    tri = np.array([[0, 0], [1, 1], [0, 1]], np.float32)   # y >= x
    square = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    us, polys = np.array([2, 2, 0]), (tri, square, tri)
    eng = QueryEngine(idx, device="cpu", path="two_phase")
    want = np.array([False, True, False])
    assert np.array_equal(eng.polygon_batch(us, polys), want)
    assert np.array_equal(polygon_reach_host(idx, us, polys), want)
    assert np.array_equal(RQ.polygon_reach_host(ref, us, polys), want)
    assert [PP.polygon_query(idx, int(u), p) for u, p in zip(us, polys)] \
        == list(want)
    pg = make_graph(3, edges, coords, spatial)
    assert [PP.polygon_oracle(pg, int(u), p) for u, p in zip(us, polys)] \
        == list(want)


def test_knn_oracle_matches_reference(graph):
    pg = make_graph(graph.n_nodes, graph.edges, graph.coords,
                    graph.spatial_mask)
    us, pts = RD.knn_workload(graph, 6, seed=2)
    for u, p in zip(us, pts):
        ids, d2 = PO.knn_reach_oracle(pg, int(u), p, 5)
        rids, rd2 = RO.knn_reach_oracle(graph, int(u), p, 5)
        assert np.array_equal(ids, rids) and np.array_equal(d2, rd2)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_queries_polygon(graph, pairs, engine):
    ref, idx = pairs["comp"]
    us, polys = RD.polygon_workload(graph, 16, n_edges=5, seed=4)
    kw = {"device": "cpu"} if engine == "device" else {}
    got = run_queries(idx, QueryProgram.polygon(us, polys), engine=engine,
                      **kw)
    want = R.run_queries(ref, RQ.QueryProgram.polygon(us, polys),
                         engine="host")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    built = build_index(make_graph(graph.n_nodes, graph.edges, graph.coords,
                                   graph.spatial_mask), "2dreach-comp")
    assert np.array_equal(run_queries(built, QueryProgram.polygon(
        us, polys), engine=engine, **kw), want)
