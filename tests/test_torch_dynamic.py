"""The port's dynamic index (``repro_torch.dynamic``) against the JAX
package's, on the CPU.

``streaming_workload`` giving the reference's op tuples; the reference's
``tests/test_dynamic.py`` cases on the port (the interleaved
update/query streams against the BFS oracle, the baselines wrapped,
background and racing compactions, the latched failed build, SCC merges,
check-ins, validation, the reach cache, the policy, the union-find,
``nbytes``); the port's ``DynamicIndex`` fed the same op sequence as the
reference's host-engine ``DynamicIndex`` and answering reach, count,
collect, kNN and polygons exactly alike, on all six methods where the
reference serves the class, with base probes on the host, on the device
engine and on the sharded engine (``device="cpu"``); the device engine
adopting every compaction's fresh build with no upload and the
swapped-out engine freed without the cycle collector; the wrapper
branches of ``batch_query`` / ``run_queries``; the tests that waited for
the dynamic index (``test_trace``'s trace ids across a swap, the
wrapper half of ``test_obs``'s host-fallback warning, ``test_chaos``'s
crash-safe compaction); ``perf_dynamic`` at a small cut.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import gc
import threading
import warnings
import weakref

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
from repro.dynamic import NEVER as RNEVER
from repro.dynamic import DynamicIndex as RDynamicIndex
from repro_torch import obs
from repro_torch.benchmarks import perf_dynamic
from repro_torch.core import (
    METHODS,
    batch_query,
    build_dynamic_index,
    index_nbytes,
    make_graph,
    rangereach_oracle_batch,
    run_queries,
)
from repro_torch.core import api as port_api
from repro_torch.core.engine import UPLOAD_COUNTERS, QueryEngine
from repro_torch.data import (
    STREAM_OP_KINDS,
    apply_stream_op,
    get_dataset,
    streaming_workload,
    workload,
)
from repro_torch.dynamic import (
    NEVER,
    CompactionPolicy,
    DynamicIndex,
    UnionFind,
)
from repro_torch.obs import trace_context
from repro_torch.queries import QueryProgram
from repro_torch.resilience import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    inject,
)
from repro_torch.resilience.faults import INJECTOR
from conftest import given, random_geosocial, random_queries, settings, st

VARIANTS = ("2dreach", "2dreach-comp", "2dreach-pointer")
COMPACTION_POINTS = (
    "dynamic.compaction.build",
    "dynamic.compaction.mid_build",
    "dynamic.compaction.pre_swap",
    "dynamic.compaction.mid_swap",
    "dynamic.compaction.replay",
)
CPU = {"device": "cpu"}
# base-probe engines a 2DReach DynamicIndex is held to the reference on
ENGINES = ({"engine": "host"}, {"engine": "device", **CPU},
           {"engine": "cluster", "n_shards": 3, **CPU})


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def port_geosocial(rng, n, m):
    """``conftest.random_geosocial``'s graph, made by the port, and the
    reference's own."""
    rg = random_geosocial(rng, n, m)
    return make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask), rg


class GraphMirror:
    """Independent record of the mutated graph for the oracle."""

    def __init__(self, g):
        self.edges = [tuple(e) for e in g.edges]
        self.coords = [tuple(c) for c in g.coords]
        self.mask = list(g.spatial_mask)

    @property
    def n(self):
        return len(self.mask)

    def apply(self, op):
        if op[0] == "add_edge":
            self.edges.append((op[1], op[2]))
        elif op[0] == "add_vertex":
            self.coords.append(op[1] or (0.0, 0.0))
            self.mask.append(op[1] is not None)
        else:
            self.coords[op[1]] = op[2]
            self.mask[op[1]] = True

    def graph(self):
        return make_graph(
            self.n,
            np.asarray(self.edges, dtype=np.int64).reshape(-1, 2),
            np.asarray(self.coords, dtype=np.float32),
            np.asarray(self.mask, dtype=bool),
        )


def _rects(rng, g, n, half):
    ext = g.spatial_extent()
    cx = rng.random(n) * (ext[2] - ext[0]) + ext[0]
    cy = rng.random(n) * (ext[3] - ext[1]) + ext[1]
    return np.stack([cx - half, cy - half, cx + half, cy + half],
                    1).astype(np.float32)


# ----------------------------------------------------------------- stream

@pytest.mark.parametrize("seed,mix", [
    (0, {}),
    (7, dict(p_query=0.0, p_edge=0.6, p_vertex=0.2, p_spatial=0.2)),
    (11, dict(p_query=0.45, p_edge=0.3, p_vertex=0.13, p_spatial=0.12,
              new_spatial_frac=0.3, extent_ratio=0.02)),
])
def test_streaming_workload_matches_reference(seed, mix):
    """The same graph and seed give the reference's op tuples, in order
    (rects bit for bit), and the ops apply to both packages alike."""
    g, rg = get_dataset("yelp", scale=0.05), RD.get_dataset("yelp",
                                                             scale=0.05)
    got = list(streaming_workload(g, n_steps=400, seed=seed, **mix))
    want = list(RD.streaming_workload(rg, n_steps=400, seed=seed, **mix))
    assert len(got) == len(want) == 400
    for a, b in zip(got, want):
        assert a[0] == b[0] and a[0] in STREAM_OP_KINDS
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert x == y
    # apply_stream_op: a query op returns (u, rect), an update None
    seen = []

    class Sink:
        def add_edge(self, s, t):
            seen.append(("add_edge", s, t))

        def add_vertex(self, c):
            seen.append(("add_vertex", c))

        def add_spatial(self, v, c):
            seen.append(("add_spatial", v, c))

    for op in got:
        r = apply_stream_op(Sink(), op)
        assert (r is None) == (op[0] != "query")
    assert seen == [op for op in got if op[0] != "query"]


# -------------------------------------------- the reference's test_dynamic

def _run_interleaved(variant, n_steps, seed, compact_at=None,
                     policy=NEVER, n=45, m=130, **kw):
    """Drive one DynamicIndex through a randomized stream, checking every
    query against the oracle; returns (steps_executed, dyn)."""
    rng = np.random.default_rng(seed)
    g, _ = port_geosocial(rng, n, m)
    dyn = build_dynamic_index(g, variant, policy=policy, **kw)
    mirror = GraphMirror(g)
    steps = 0
    for step, op in enumerate(streaming_workload(
            g, n_steps=n_steps, seed=seed + 1,
            p_query=0.45, p_edge=0.3, p_vertex=0.13, p_spatial=0.12)):
        if op[0] == "query":
            u, rect = op[1], op[2]
            got = dyn.query(u, rect)
            want = bool(rangereach_oracle_batch(
                mirror.graph(), np.array([u]), np.array([rect]))[0])
            assert got == want, (variant, step, u, rect)
        else:
            apply_stream_op(dyn, op)
            mirror.apply(op)
        if compact_at is not None and step == compact_at:
            assert dyn.compact(background=False)
            assert dyn.overlay_size == 0
        steps += 1
    assert dyn.n_nodes == mirror.n
    return steps, dyn


@pytest.mark.parametrize("engine", ENGINES[:2], ids=["host", "device"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_interleaved_updates_queries_vs_oracle(variant, engine):
    """Interleaved streams with a mid-stream compaction swap: every
    answer equals the oracle before and after it, with base probes on
    the host or on the device engine."""
    for seed in (3, 11):
        steps, dyn = _run_interleaved(
            variant, n_steps=180, seed=seed, compact_at=90, **engine)
        assert steps == 180
        assert dyn.stats["n_compactions"] == 1


@pytest.mark.parametrize("method", ("georeach", "3dreach", "3dreach-rev"))
def test_dynamic_wraps_baseline_methods(method):
    """The dynamic layer is method-agnostic: baselines work unmodified;
    device serving is refused for them at construction."""
    steps, _ = _run_interleaved(method, n_steps=80, seed=5, n=30, m=80)
    assert steps == 80
    g, _ = port_geosocial(np.random.default_rng(5), 30, 80)
    with pytest.raises(ValueError, match=method):
        DynamicIndex(g, method, engine="device", device="cpu")
    with pytest.raises(ValueError, match="host|device|cluster"):
        DynamicIndex(g, method, engine="tpu")


def test_policy_background_compaction_equivalence():
    """Policy-triggered background swaps with racing mutations never lose
    or double-apply an update."""
    rng = np.random.default_rng(23)
    g, _ = port_geosocial(rng, 50, 150)
    policy = CompactionPolicy(max_overlay_edges=40, max_staged=None,
                              max_updates=None, background=True)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=policy)
    mirror = GraphMirror(g)
    for op in streaming_workload(g, n_steps=300, seed=24, p_query=0.0,
                                 p_edge=0.6, p_vertex=0.2, p_spatial=0.2):
        apply_stream_op(dyn, op)
        mirror.apply(op)
    dyn.join_compaction()
    assert dyn.stats["n_compactions"] >= 1
    gm = mirror.graph()
    us = rng.integers(0, mirror.n, size=80)
    rects = _rects(rng, gm, 80, 20)
    assert (dyn.query_batch(us, rects)
            == rangereach_oracle_batch(gm, us, rects)).all()
    snap = dyn.snapshot_graph()
    assert snap.n_nodes == gm.n_nodes
    assert (snap.spatial_mask == gm.spatial_mask).all()
    assert np.allclose(snap.coords, gm.coords)


def test_concurrent_compaction_triggers_are_exclusive():
    """Racing compact() calls must never overlap builds: the loser's swap
    would replay a stale op-log tail and corrupt the index."""
    rng = np.random.default_rng(77)
    g, _ = port_geosocial(rng, 60, 200)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=NEVER)
    mirror = GraphMirror(g)
    stop = threading.Event()

    def force_compactions():
        while not stop.is_set():
            dyn.compact(background=True)

    threads = [threading.Thread(target=force_compactions) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for op in streaming_workload(g, n_steps=250, seed=78, p_query=0.0,
                                     p_edge=0.6, p_vertex=0.2, p_spatial=0.2):
            apply_stream_op(dyn, op)
            mirror.apply(op)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    dyn.join_compaction(timeout=60)
    assert dyn.n_nodes == mirror.n
    snap = dyn.snapshot_graph()
    gm = mirror.graph()
    assert snap.n_nodes == gm.n_nodes
    assert (snap.spatial_mask == gm.spatial_mask).all()
    assert snap.n_edges == gm.n_edges
    us = rng.integers(0, mirror.n, size=60)
    rects = _rects(rng, gm, 60, 15)
    assert (dyn.query_batch(us, rects)
            == rangereach_oracle_batch(gm, us, rects)).all()


def test_failed_background_build_latches_no_retry_storm():
    """A crashing background build must latch the error: no policy-driven
    rebuild storm, join raises, explicit compact() clears and retries."""
    rng = np.random.default_rng(91)
    g, _ = port_geosocial(rng, 40, 120)
    policy = CompactionPolicy(max_overlay_edges=5, max_staged=None,
                              max_updates=None, background=True)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=policy)
    boom = RuntimeError("simulated build OOM")

    def broken_build(snapshot):
        raise boom

    dyn._build_static = broken_build
    for _ in range(20):
        dyn.add_edge(int(rng.integers(0, 40)), int(rng.integers(0, 40)))
    dyn._compactor._thread.join(10)
    assert dyn.compaction_error is boom
    assert dyn.stats.get("n_compaction_failures") == 1  # no storm
    assert dyn.stats["n_compactions"] == 0
    with pytest.raises(RuntimeError, match="background compaction failed"):
        dyn.join_compaction()
    assert dyn.overlay_size == 20
    gm = dyn.snapshot_graph()
    us = rng.integers(0, 40, size=30)
    rects = _rects(rng, gm, 30, 10)
    assert (dyn.query_batch(us, rects)
            == rangereach_oracle_batch(gm, us, rects)).all()
    del dyn._build_static  # restore the class method
    assert dyn.compact(background=False)
    assert dyn.compaction_error is None
    assert dyn.stats["n_compactions"] == 1 and dyn.overlay_size == 0
    assert (dyn.query_batch(us, rects)
            == rangereach_oracle_batch(gm, us, rects)).all()


@pytest.mark.parametrize("engine", ENGINES, ids=["host", "device",
                                                 "cluster"])
def test_scc_merge_via_delta_cycle(engine):
    """A delta edge closing a cycle collapses components (DAGGER-style)
    and queries route through the merged group."""
    coords = np.zeros((4, 2), np.float32)
    coords[3] = (5.0, 5.0)
    sm = np.array([False, False, False, True])
    g = make_graph(4, np.array([[0, 1], [1, 2], [2, 3]]), coords, sm)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=NEVER, **engine)
    rect = np.array([4.5, 4.5, 5.5, 5.5], np.float32)
    assert dyn.query(0, rect)
    dyn.add_edge(2, 0)
    assert dyn.stats["n_scc_merges"] >= 1
    for u in (0, 1, 2):
        assert dyn.query(u, rect)
    w = dyn.add_vertex()
    dyn.add_edge(w, 0)
    dyn.add_edge(2, w)
    assert dyn.stats["n_scc_merges"] >= 2
    assert dyn.query(w, rect)


@pytest.mark.parametrize("engine", ENGINES, ids=["host", "device",
                                                 "cluster"])
def test_new_vertex_and_checkin_paths(engine):
    g = make_graph(3, np.array([[0, 1]]),
                   np.zeros((3, 2), np.float32), np.zeros(3, bool))
    dyn = build_dynamic_index(g, "2dreach", policy=NEVER, **engine)
    rect = np.array([0.5, 0.5, 1.5, 1.5], np.float32)
    assert not dyn.query(0, rect)
    dyn.add_spatial(1, (1.0, 1.0))
    assert dyn.query(0, rect)
    assert dyn.query(1, rect)
    assert not dyn.query(2, rect)
    v = dyn.add_vertex((1.2, 1.2))
    assert dyn.query(v, rect)
    assert not dyn.query(2, rect)
    dyn.add_edge(2, v)
    assert dyn.query(2, rect)
    u = dyn.add_vertex()
    assert not dyn.query(u, rect)
    dyn.add_edge(u, 0)
    assert dyn.query(u, rect)


def test_mutation_validation():
    g = make_graph(3, np.array([[0, 1]]),
                   np.zeros((3, 2), np.float32),
                   np.array([True, False, False]))
    dyn = build_dynamic_index(g, "2dreach-comp", policy=NEVER)
    with pytest.raises(IndexError):
        dyn.add_edge(0, 99)
    with pytest.raises(IndexError):
        dyn.add_spatial(99, (0, 0))
    with pytest.raises(ValueError):
        dyn.add_spatial(0, (1, 1))     # already spatial in the base
    dyn.add_spatial(1, (2.0, 2.0))
    with pytest.raises(ValueError):
        dyn.add_spatial(1, (3.0, 3.0))  # already staged
    with pytest.raises(IndexError):
        dyn.query(99, np.array([0, 0, 1, 1], np.float32))
    with pytest.raises(ValueError, match="k >= 1"):
        dyn.collect_batch(np.array([0]), np.array([[0, 0, 1, 1]]), 0)
    with pytest.raises(ValueError, match="k >= 1"):
        dyn.knn_batch(np.array([0]), np.array([[0, 0]]), 0)


def test_reach_cache_hit_and_invalidation():
    rng = np.random.default_rng(31)
    g, _ = port_geosocial(rng, 40, 120)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=NEVER)
    dyn.add_edge(0, 1)
    rect = np.array([500, 500, 501, 501], np.float32)
    dyn.query(2, rect)
    dyn.query(2, rect)
    assert dyn.stats["cache_hits"] >= 1
    before = dyn.stats["n_cache_invalidations"]
    dyn.add_edge(2, 3)
    assert dyn.stats["n_cache_invalidations"] >= before


def test_compaction_policy_thresholds():
    p = CompactionPolicy(max_overlay_edges=10, max_staged=5, max_updates=100)
    assert not p.should_compact(9, 4, 99)
    assert p.should_compact(10, 0, 0)
    assert p.should_compact(0, 5, 0)
    assert p.should_compact(0, 0, 100)
    assert not NEVER.should_compact(10**9, 10**9, 10**9)


def test_union_find_groups():
    uf = UnionFind(4)
    assert uf.group(2) == [2]
    assert uf.union(0, 1)
    assert not uf.union(1, 0)
    assert sorted(uf.group(0)) == [0, 1]
    e = uf.add()
    assert uf.union(e, 0)
    assert sorted(uf.group(1)) == [0, 1, e]
    assert uf.find(e) == uf.find(0) == uf.find(1)


def test_dynamic_nbytes_reports_overlay():
    """``nbytes`` and ``index_nbytes`` of a wrapper, equal to the
    reference's for the same op sequence."""
    rng = np.random.default_rng(7)
    g, rg = port_geosocial(rng, 40, 120)
    dyn = build_dynamic_index(g, "2dreach-pointer", policy=NEVER)
    ref = RDynamicIndex(rg, "2dreach-pointer", policy=RNEVER)
    nb0 = dyn.nbytes()
    assert nb0["total"] >= nb0["rtree"] + nb0["aux"]
    for d in (dyn, ref):
        d.add_vertex((1.0, 1.0))
        d.add_edge(0, 1)
    nb1 = dyn.nbytes()
    assert nb1["overlay"] > nb0["overlay"]
    assert index_nbytes(dyn) == nb1 == ref.nbytes()


# ------------------------------------------- parity with the reference

def _drive_pair(method, seed, n_ops, kw, n=60, m=170, policy=NEVER,
                compact_after=None):
    """The port's and the reference's host-engine DynamicIndex fed one op
    sequence (``compact_after`` ops in, one sync compaction each)."""
    rng = np.random.default_rng(seed)
    g, rg = port_geosocial(rng, n, m)
    port = DynamicIndex(g, method, policy=policy, **kw)
    ref = RDynamicIndex(rg, method, policy=RNEVER)
    ops = list(streaming_workload(g, n_steps=n_ops, seed=seed + 1,
                                  p_query=0.0, p_edge=0.6, p_vertex=0.2,
                                  p_spatial=0.2))
    for i, op in enumerate(ops):
        apply_stream_op(port, op)
        RD.apply_stream_op(ref, op)
        if compact_after is not None and i == compact_after:
            port.compact(background=False)
            ref.compact(background=False)
    return port, ref, rng


def _same_collect(a, b):
    return (np.array_equal(a.ids, b.ids)
            and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.overflow, b.overflow))


def _same_knn(a, b):
    return (np.array_equal(a.ids, b.ids)
            and np.array_equal(a.dist2, b.dist2))


CASES = [(m, {"engine": "host"}) for m in METHODS] + [
    (v, e) for v in VARIANTS for e in ENGINES[1:]]


@pytest.mark.parametrize("method,kw", CASES,
                         ids=[f"{m}-{e['engine']}" for m, e in CASES])
def test_every_class_matches_reference(method, kw):
    """After one op sequence (and again after a compaction and more
    ops) the port answers reach, count, collect, kNN and polygons
    exactly as the reference's host-engine DynamicIndex; a baseline
    refuses the analytics classes in both packages alike."""
    port, ref, rng = _drive_pair(method, 17, 120, kw)
    for phase in range(2):
        gm = port.snapshot_graph()
        us = rng.integers(0, port.n_nodes, 40)
        rects = _rects(rng, gm, 40, 18)
        pts = rects[:, :2] + 9
        polys = [np.array([[x - 15, y - 12], [x + 14, y - 10], [x + 2, y + 16]],
                          np.float32) for x, y in pts]
        got = port.query_batch(us, rects)
        assert np.array_equal(got, ref.query_batch(us, rects))
        assert np.array_equal(got, rangereach_oracle_batch(gm, us, rects))
        if method.startswith("2dreach"):
            assert np.array_equal(port.count_batch(us, rects),
                                  ref.count_batch(us, rects))
            for k in (1, 4):
                assert _same_collect(port.collect_batch(us, rects, k),
                                     ref.collect_batch(us, rects, k))
                assert _same_knn(port.knn_batch(us, pts, k),
                                 ref.knn_batch(us, pts, k))
            assert np.array_equal(port.polygon_batch(us, polys),
                                  ref.polygon_batch(us, polys))
        else:
            for fn in ("count_batch", "polygon_batch"):
                arg = rects if fn == "count_batch" else polys
                with pytest.raises(ValueError, match="2DReach"):
                    getattr(port, fn)(us, arg)
                with pytest.raises(ValueError, match="2DReach"):
                    getattr(ref, fn)(us, arg)
        assert port.stats == ref.stats | {
            k: port.stats[k] for k in ("t_initial_build",
                                       "t_compaction_total",
                                       "t_last_compaction")}
        if phase == 0:
            port.compact(background=False)
            ref.compact(background=False)
            ops = streaming_workload(gm, n_steps=30, seed=5, p_query=0.0,
                                     p_edge=0.5, p_vertex=0.3, p_spatial=0.2)
            for op in ops:
                apply_stream_op(port, op)
                RD.apply_stream_op(ref, op)


def test_run_queries_and_batch_query_wrapper_branches():
    """``run_queries`` on a wrapper answers every class as the wrapper
    does (and as the reference's ``run_queries`` on its wrapper);
    ``engine="device"`` needs a device-built wrapper for the analytics
    classes and a device or cluster one for reach."""
    import repro.queries as RQ

    port, ref, rng = _drive_pair("2dreach-comp", 3, 60, {"engine": "host"})
    dev, _, _ = _drive_pair("2dreach-comp", 3, 60,
                            {"engine": "device", **CPU})
    clu, _, _ = _drive_pair("2dreach-comp", 3, 60,
                            {"engine": "cluster", "n_shards": 2, **CPU})
    g = port.snapshot_graph()
    us, rects = workload(g, 24, extent_ratio=0.05, seed=2)
    pts = rects[:, :2]
    progs = [(QueryProgram.reach(us, rects), RQ.QueryProgram.reach(us, rects)),
             (QueryProgram.count(us, rects), RQ.QueryProgram.count(us, rects)),
             (QueryProgram.collect(us, rects, 3),
              RQ.QueryProgram.collect(us, rects, 3)),
             (QueryProgram.knn(us, pts, 3), RQ.QueryProgram.knn(us, pts, 3))]
    for p, rp in progs:
        want = R.run_queries(ref, rp)
        for eng, idx in (("host", port), ("device", dev)):
            got = run_queries(idx, p, engine=eng)
            if p.kind in ("reach", "count"):
                assert np.array_equal(got, want)
            elif p.kind == "collect":
                assert _same_collect(got, want)
            else:
                assert _same_knn(got, want)
        with pytest.raises(ValueError, match="engine='host'"):
            run_queries(port, p, engine="device")
        if p.kind == "reach":
            assert np.array_equal(run_queries(clu, p, engine="device"), want)
        else:
            with pytest.raises(ValueError, match="engine='cluster'"):
                run_queries(clu, p, engine="device")
    want = ref.query_batch(us, rects)
    for idx in (dev, clu):
        assert np.array_equal(
            batch_query(idx, us, rects, engine="device", required=True),
            want)
    with pytest.raises(ValueError, match="DynamicIndex"):
        batch_query(port, us, rects, engine="device", required=True)
    with pytest.raises(ValueError, match="DynamicIndex"):
        batch_query(port, us, rects, engine="cluster", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        run_queries(port, progs[0][0], engine="cluster")


def test_host_fallback_warns_once_per_reason_and_counts():
    """The reference's ``test_obs`` case on the port: an unsupported
    index and a host-engine wrapper each get their own single warning,
    and every fallback is counted."""
    rng = np.random.default_rng(11)
    g, _ = port_geosocial(rng, 120, 360)
    us, rects = random_queries(rng, g, 4)
    geo = port_api.build_index(g, "georeach")
    dyn = build_dynamic_index(g, "2dreach-comp")
    assert getattr(dyn, "engine", None) == "host"
    assert port_api.FALLBACK_REASONS == ("unsupported-index",
                                         "wrapper-host-engine")
    port_api._FALLBACK_WARNED.discard(("unsupported-index", "GeoReachIndex"))
    port_api._FALLBACK_WARNED.discard(("wrapper-host-engine",
                                       "DynamicIndex"))
    c_unsup = obs.REGISTRY.counter("api.host_fallback.unsupported-index")
    c_wrap = obs.REGISTRY.counter("api.host_fallback.wrapper-host-engine")
    n_unsup, n_wrap = c_unsup.value, c_wrap.value
    with pytest.warns(RuntimeWarning, match="unsupported-index"):
        batch_query(geo, us, rects, engine="device")
    with pytest.warns(RuntimeWarning, match="wrapper-host-engine"):
        got = batch_query(dyn, us, rects, engine="device")
    assert np.array_equal(got, dyn.query_batch(us, rects))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        batch_query(geo, us, rects, engine="device")
        batch_query(dyn, us, rects, engine="device")
    assert c_unsup.value == n_unsup + 2
    assert c_wrap.value == n_wrap + 2


# --------------------------------------------- the device engine's swaps

def test_device_engine_adopts_every_swap_and_frees_the_old_one():
    """``engine="device"``: the base and every compaction's rebuild are
    built with ``backend="device"`` and adopted (no host upload), the
    swapped-out index and engine are freed by reference counting alone,
    answers stay equal to the host wrapper's, and the engine serves no
    new shape once warm."""
    g = get_dataset("yelp", scale=0.05)
    us, rects = workload(g, 96, extent_ratio=0.05, seed=4)
    up0 = UPLOAD_COUNTERS["host_uploads"]
    dev = build_dynamic_index(g, "2dreach-comp", policy=NEVER,
                              engine="device", device="cpu")
    host = build_dynamic_index(g, "2dreach-comp", policy=NEVER)
    assert dev._build_kw == {"backend": "device", "device": "cpu"}
    assert isinstance(dev.base_engine, QueryEngine)
    assert dev.base_engine.stats["adopted"] == 1
    ops = list(streaming_workload(g, n_steps=240, seed=9, p_query=0.0,
                                  p_edge=0.6, p_vertex=0.2, p_spatial=0.2))
    gc.disable()
    try:
        for rnd in range(3):
            for op in ops[80 * rnd: 80 * rnd + 80]:
                apply_stream_op(dev, op)
                apply_stream_op(host, op)
            assert np.array_equal(dev.query_batch(us, rects),
                                  host.query_batch(us, rects))
            # the first pass may ratchet the capacity for its base and
            # extra-probe batches; the second serves every shape warm
            dev.query_batch(us, rects)
            warm = dev.base_engine.n_compiles
            assert np.array_equal(dev.query_batch(us, rects),
                                  host.query_batch(us, rects))
            assert dev.base_engine.n_compiles == warm
            old_eng = weakref.ref(dev.base_engine)
            old_idx = weakref.ref(dev.base_index)
            assert dev.compact(background=False)
            assert old_eng() is None and old_idx() is None
            assert dev.base_engine.stats["adopted"] == 1
            assert np.array_equal(dev.query_batch(us, rects),
                                  host.query_batch(us, rects))
    finally:
        gc.enable()
    assert UPLOAD_COUNTERS["host_uploads"] == up0
    assert dev.stats["n_compactions"] == 3


@pytest.mark.parametrize("point", ("dynamic.compaction.mid_swap",
                                   "dynamic.compaction.replay"))
@pytest.mark.parametrize("engine", ENGINES[1:], ids=["device", "cluster"])
def test_failed_swap_frees_the_new_engine(point, engine):
    """A swap that crashes after the new engine was made restores the old
    one, still serving, and frees the new one without the cycle
    collector."""
    g = get_dataset("yelp", scale=0.05)
    us, rects = workload(g, 48, extent_ratio=0.05, seed=5)
    dyn = build_dynamic_index(g, "2dreach-comp", policy=NEVER, **engine)
    for op in streaming_workload(g, n_steps=40, seed=2, p_query=0.0):
        apply_stream_op(dyn, op)
    want = dyn.query_batch(us, rects)
    old = dyn.base_engine
    snapshot, cut = dyn._begin_compaction()
    built = dyn._build_static(snapshot)
    new_idx = weakref.ref(built[0])
    gc.disable()
    try:
        with inject(FaultPlan(FaultSpec(point, kind="raise"))):
            with pytest.raises(InjectedFault):
                dyn._finish_compaction(snapshot, built, cut, 0.0)
        new_eng = getattr(built[0], "_device_engine", None) or getattr(
            built[0], "_cluster_engine", None)
        assert new_eng is None
        del built
        assert new_idx() is None
    finally:
        gc.enable()
    assert dyn.base_engine is old
    assert np.array_equal(dyn.query_batch(us, rects), want)


# ---------------------------------------------- tests that waited for it

def test_dynamic_compaction_swap_preserves_trace_ids():
    """DynamicIndex queries inside a scope keep carrying ids across a
    mid-stream compaction swap (base index replaced under the reader)."""
    rng = np.random.default_rng(3)
    g, _ = port_geosocial(rng, 60, 160)
    dyn = build_dynamic_index(g, "2dreach-comp")
    us, rects = random_queries(rng, g, 4)
    obs.enable()
    ctxs = [trace_context.mint(u=int(u)) for u in us]
    want = [c.trace_id for c in ctxs]
    with trace_context.scope(ctxs):
        before = [dyn.query(int(u), r) for u, r in zip(us, rects)]
        dyn.add_edge(0, 1)
        assert dyn.compact(background=False)
        after = [dyn.query(int(u), r) for u, r in zip(us, rects)]
    assert dyn.stats["n_compactions"] == 1
    tagged = [e for e in obs.TRACER.events()
              if e[0].startswith("dynamic.")
              and (e[5] or {}).get("trace_ids") == want]
    assert len(tagged) >= len(before) + len(after)
    names = {e[0] for e in obs.TRACER.events()}
    assert {"dynamic.query_batch", "dynamic.base_probe",
            "dynamic.compaction_build", "dynamic.compaction_swap"} <= names


def _mutated_dynamic(seed, n=50, m=140, n_ops=25, **kw):
    rng = np.random.default_rng(seed)
    g, _ = port_geosocial(rng, n, m)
    dyn = DynamicIndex(g, "2dreach", policy=NEVER, **kw)
    for _ in range(n_ops):
        dyn.add_edge(int(rng.integers(0, n)), int(rng.integers(0, n)))
    us, rects = random_queries(np.random.default_rng(seed + 1),
                               dyn._materialise(), 48)
    want = rangereach_oracle_batch(dyn._materialise(), us, rects)
    return dyn, us, rects, want


def _crash_compaction_at(point, seed, **kw):
    dyn, us, rects, want = _mutated_dynamic(seed, **kw)
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    with inject(FaultPlan(FaultSpec(point, kind="raise"))):
        with pytest.raises(InjectedFault):
            dyn.compact(background=False)
    assert dyn.stats["n_compactions"] == 0
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    assert dyn.compact(background=False)
    assert dyn.stats["n_compactions"] == 1
    assert dyn.overlay_size == 0
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)


@pytest.mark.parametrize("point", COMPACTION_POINTS)
@pytest.mark.parametrize("seed", (3, 17))
def test_compaction_crash_rolls_back(point, seed):
    _crash_compaction_at(point, seed)


@pytest.mark.parametrize("point", COMPACTION_POINTS)
@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**16))
def test_compaction_crash_rolls_back_property(point, seed):
    """Property form: any mutation history, any stage boundary — a
    crashed swap never changes an answer."""
    _crash_compaction_at(point, seed)


@pytest.mark.parametrize("point", COMPACTION_POINTS)
def test_compaction_crash_rolls_back_on_the_device_engine(point):
    _crash_compaction_at(point, 5, engine="device", device="cpu")


def test_background_compaction_crash_latches_and_recovers():
    dyn, us, rects, want = _mutated_dynamic(seed=29)
    plan = FaultPlan(FaultSpec("dynamic.compaction.mid_swap", kind="raise"))
    with inject(plan):
        assert dyn.compact(background=True)
        with pytest.raises(RuntimeError):
            dyn.join_compaction(timeout=60)
    assert isinstance(dyn.compaction_error, InjectedFault)
    assert not dyn.maybe_compact()
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    assert dyn.compact(background=True)
    dyn.join_compaction(timeout=60)
    assert dyn.compaction_error is None
    assert dyn.stats["n_compactions"] == 1
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)


def test_compaction_crash_rollback_with_racing_tail():
    """Crash during the op-log replay of mutations that raced the
    build: rollback restores the old overlay (which still carries the
    raced ops), so nothing is lost or double-applied."""
    dyn, us, rects, _ = _mutated_dynamic(seed=31)
    cut_ops = len(dyn._oplog)
    snapshot, cut = dyn._begin_compaction()
    built = dyn._build_static(snapshot)
    rng = np.random.default_rng(5)
    for _ in range(6):
        dyn.add_edge(int(rng.integers(0, dyn.n_base)),
                     int(rng.integers(0, dyn.n_base)))
    want = rangereach_oracle_batch(dyn._materialise(), us, rects)
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    with inject(FaultPlan(
            FaultSpec("dynamic.compaction.replay", kind="raise"))):
        with pytest.raises(InjectedFault):
            dyn._finish_compaction(snapshot, built, cut, 0.0)
    assert len(dyn._oplog) == cut_ops + 6
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    dyn._finish_compaction(snapshot, built, cut, 0.0)
    np.testing.assert_array_equal(dyn.query_batch(us, rects), want)
    assert INJECTOR.enabled is False


# ------------------------------------------------------------ perf_dynamic

@pytest.mark.parametrize("variant", ("2dreach-comp", "2dreach-pointer"))
def test_perf_dynamic_sweep_on_cpu(variant, monkeypatch):
    """The bench at a small cut, on the device engine with
    ``device="cpu"``: every overlay checkpoint timed, the oracle
    spot-checks pass, the post-swap row."""
    monkeypatch.setattr(perf_dynamic, "OVERLAY_CHECKPOINTS", (0, 16, 48))
    out = perf_dynamic.dynamic_sweep("yelp", 0.05, n_q=64, device="cpu",
                                     variants=(variant,))
    rows = out[variant]
    assert [r["phase"] for r in rows] == ["overlay"] * 3 + [
        "post_compaction"]
    assert [r["overlay_size"] for r in rows[:3]] == [0, 16, 48]
    assert rows[3]["overlay_size"] == 0 and rows[3]["n_updates_absorbed"]
    assert perf_dynamic.VARIANTS == VARIANTS


def test_perf_dynamic_device_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_dynamic.main([])
    g = get_dataset("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicIndex(g, "2dreach-comp", engine="device")
