"""The port's cluster (``repro_torch.cluster``, ``repro_torch.launch.mesh``)
on the CPU.

The partition against the JAX package's (``balanced_assignment``,
``partition_forest`` and ``shard_arenas`` array for array; the device
path of ``shard_arenas`` equal to its host path); the reference's
``tests/test_cluster.py`` and ``tests/test_frontend_load.py`` cases on
the port, with the sharded engine held to ``query_host`` and the
single-device ``QueryEngine`` at S = 1, 2, 4 and 8 on the fused and the
two-phase path (the reference's own ``ShardedEngine`` does not run on
this JAX, ROADMAP R2), its launches per batch counted (one fused serve,
or one prune and one scan, per shard), a two-device mesh of CPUs; the
tests that waited for the cluster (``test_obs``'s frontend half of the
coverage gate and its explicit query log, ``test_trace``'s shard fan-out
spans and futures, ``test_chaos``'s frontend run).  Threads wait with
bounded timeouts or on the reference's fake clock, never on latency.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import threading
import time

import numpy as np
import pytest
import torch

import repro.cluster.partition as RP
import repro.core as R
import repro.data as RD
from repro_torch import obs
from repro_torch.cluster import (
    Frontend,
    ShardedEngine,
    balanced_assignment,
    partition_forest,
    shard_arenas,
    sharded_engine_for,
)
from repro_torch.cluster import sharded_engine as SE
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    batch_query,
    build_2dreach,
    build_dynamic_index,
    build_index,
    make_graph,
    query_host,
    rangereach_oracle_batch,
)
from repro_torch.core.engine import UPLOAD_COUNTERS
from repro_torch.data import apply_stream_op, get_dataset, streaming_workload
from repro_torch.data import workload
from repro_torch.dynamic import CompactionPolicy
from repro_torch.kernels.range_query.layout import TB, TP
from repro_torch.launch import ShardMesh, make_shard_mesh, visible_devices
from repro_torch.launch.mesh import devices_for
from repro_torch.obs.audit import ExactnessAuditor
from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.obs.querylog import (
    I_ATTEMPT,
    I_TRACE_ID,
    I_VERTEX_CLASS,
    QueryLog,
)
from repro_torch.resilience import (
    BreakerPolicy,
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    FrontendClosed,
    InjectedFault,
    Overloaded,
    QueueFull,
    ResilienceError,
    ResilientEngine,
    RetryPolicy,
    fault_point,
    inject,
)
from conftest import random_geosocial, random_queries

SHARD_COUNTS = (1, 2, 4, 8)
VARIANTS = ("base", "comp", "pointer")
CPU = "cpu"
RECT = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def graph():
    return get_dataset("yelp", scale=0.05)


@pytest.fixture(scope="module")
def ref_indexes():
    g = RD.get_dataset("yelp", scale=0.05)
    return {v: R.build_2dreach(g, variant=v) for v in VARIANTS}


@pytest.fixture(scope="module")
def indexes(ref_indexes):
    """The reference's indexes carried into the port: one forest, two
    packages."""
    return {v: index_from_arrays(index_to_arrays(i))
            for v, i in ref_indexes.items()}


def _engine(idx, S, **kw):
    return ShardedEngine(idx, n_shards=S, device=CPU, **kw)


# ---------------------------------------------------------------- partition

def test_balanced_assignment_lpt():
    w = np.array([10, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int64)
    a = balanced_assignment(w, 2)
    loads = np.bincount(a, weights=w, minlength=2)
    assert sorted(loads.tolist()) == [10.0, 10.0]
    assert (a == balanced_assignment(w, 2)).all()
    rng = np.random.default_rng(3)
    for S in (1, 3, 8):
        w = rng.integers(0, 50, 200)
        assert np.array_equal(balanced_assignment(w, S),
                              RP.balanced_assignment(w, S))
    assert balanced_assignment(np.zeros(0, np.int64), 4).shape == (0,)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", SHARD_COUNTS)
def test_partition_matches_reference(indexes, ref_indexes, variant, S):
    """Every routing array and the shard loads equal the reference's."""
    got = partition_forest(indexes[variant].forest, S)
    want = RP.partition_forest(ref_indexes[variant].forest, S)
    assert got.n_shards == want.n_shards and got.n_trees == want.n_trees
    for a, b in zip(got.shard_trees, want.shard_trees):
        assert np.array_equal(a, b)
    for k in ("tree_shard", "tree_qs", "tree_qe", "shard_entries"):
        x, y = getattr(got, k), getattr(want, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert got.balance() == want.balance()


def test_partition_routing_arrays(indexes):
    forest = indexes["comp"].forest
    for S in SHARD_COUNTS:
        part = partition_forest(forest, S)
        counts = np.diff(forest.entry_off)
        assert part.n_trees == forest.n_trees
        seen = np.zeros(forest.n_trees, dtype=bool)
        for s, trees in enumerate(part.shard_trees):
            lo = 0
            for t in trees:
                assert part.tree_shard[t] == s
                assert part.tree_qs[t] == lo
                assert part.tree_qe[t] == lo + counts[t]
                lo += counts[t]
                seen[t] = True
            assert part.shard_entries[s] == lo
        assert seen.all()
        assert part.shard_entries.sum() == counts.sum()
        assert part.width % TP == 0
        assert part.width >= part.shard_entries.max()


def test_partition_balance_and_bad_shards(indexes):
    forest = indexes["comp"].forest
    counts = np.diff(forest.entry_off).astype(np.int64)
    for S in (2, 4):
        part = partition_forest(forest, S)
        assert part.shard_entries.max() <= counts.sum() / S + counts.max()
    with pytest.raises(ValueError):
        partition_forest(forest, 0)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", (1, 3, 8))
def test_shard_arenas_match_reference(indexes, ref_indexes, variant, S):
    """The host path's stacks equal the reference's host path bit for
    bit; the device path (a forest built with ``backend="device"``, here
    on the CPU) gathers equal planes as tensors, with one adoption and
    no upload."""
    got = shard_arenas(indexes[variant].forest,
                       partition_forest(indexes[variant].forest, S))
    want = RP.shard_arenas(ref_indexes[variant].forest,
                           RP.partition_forest(ref_indexes[variant].forest,
                                               S))
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    g = get_dataset("yelp", scale=0.05)
    built = build_2dreach(g, variant=variant, backend="device", device=CPU)
    part = partition_forest(built.forest, S)
    up, ad = (UPLOAD_COUNTERS["host_uploads"],
              UPLOAD_COUNTERS["device_adoptions"])
    dev = shard_arenas(built.forest, part)
    assert UPLOAD_COUNTERS["host_uploads"] == up
    assert UPLOAD_COUNTERS["device_adoptions"] == ad + 1
    assert all(isinstance(t, torch.Tensor) and t.is_contiguous()
               for t in dev[:3])
    for a, b in zip(dev[:3], got[:3]):
        assert torch.equal(a, torch.as_tensor(b))


def test_empty_forest_partition_and_arenas():
    g = make_graph(2, np.array([[0, 1]]), np.zeros((2, 2), np.float32),
                   np.zeros(2, bool))
    idx = build_2dreach(g, variant="comp")
    part = partition_forest(idx.forest, 4)
    assert part.n_trees == 0 and part.width == TP
    assert np.array_equal(part.tree_shard, [-1])
    entries, fine, coarse, nt = shard_arenas(idx.forest, part)
    assert entries.shape == (4, 4, TP) and nt == 1
    assert (entries[:, :2] > entries[:, 2:]).all()     # inert boxes


# ---------------------------------------------------------------- exactness

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_matches_host_oracle(graph, indexes, variant, n_shards):
    """Bit-identical to ``query_host``, the host index and the
    single-device engine on every 2DReach variant, on both paths."""
    idx = indexes[variant]
    eng = _engine(idx, n_shards)
    one = QueryEngine(idx, device=CPU)
    for seed in range(3):
        us, rects = workload(graph, 160, extent_ratio=0.05, seed=seed)
        want = idx.query_batch(us, rects)
        tid = np.where(idx.excluded[us], -1, idx.lookup_tree(us))
        routed = tid >= 0
        assert np.array_equal(want[routed], query_host(
            idx.forest, tid[routed], rects[routed]))
        assert np.array_equal(one.query_batch(us, rects), want)
        for got in (eng.query_batch(us, rects),
                    eng.query_batch_two_phase(us, rects)):
            assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert eng.shard_queries.sum() <= eng.stats["queries"]
    assert eng.shard_hits.sum() <= eng.shard_queries.sum()


class _Count:
    """A kernel wrapper that counts its calls (the plain versions run
    on the CPU and never count)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("S", SHARD_COUNTS)
def test_launches_per_batch(graph, indexes, monkeypatch, S):
    """One fused serve per shard a batch (plus S per ratchet re-run); one
    prune and one scan per shard a two-phase batch; the largest count
    read once a batch."""
    k = {n: _Count(getattr(SE, n)) for n in ("fused_serve", "prune_tiles",
                                             "descent_scan")}
    for n, c in k.items():
        monkeypatch.setattr(SE, n, c)
    eng = _engine(indexes["comp"], S)
    us, rects = workload(graph, 256, extent_ratio=0.05, seed=4)
    for b in range(0, 256, 64):
        eng.query_batch(us[b:b + 64], rects[b:b + 64])
    reruns = eng.stats["fused_reruns"]
    assert k["fused_serve"].calls == S * (4 + reruns)
    assert k["prune_tiles"].calls == 0 and k["descent_scan"].calls == 0
    k["fused_serve"].calls = 0
    eng.query_batch_two_phase(us[:64], rects[:64])
    assert k["prune_tiles"].calls == S and k["descent_scan"].calls == S
    assert k["fused_serve"].calls == 0


def test_two_device_mesh_of_cpus(graph, indexes):
    """The multi-device arm on a mesh of two CPU devices: shard s on
    device s // L, hits gathered on the first; equal answers."""
    idx = indexes["pointer"]
    mesh = ShardMesh((torch.device(CPU), torch.device(CPU)))
    eng = ShardedEngine(idx, n_shards=4, device=CPU, mesh=mesh)
    assert eng.mesh.shape == {"data": 2} and len(eng._groups) == 2
    assert [g.first for g in eng._groups] == [0, 2]
    us, rects = workload(graph, 200, extent_ratio=0.05, seed=8)
    want = idx.query_batch(us, rects)
    assert np.array_equal(eng.query_batch(us, rects), want)
    assert np.array_equal(eng.query_batch_two_phase(us, rects), want)
    with pytest.raises(ValueError, match="multiple"):
        ShardedEngine(idx, n_shards=3, device=CPU, mesh=mesh)


def test_sharded_trees_empty_on_some_shards():
    """More shards than trees: shards with an empty arena stay inert."""
    edges = np.array([[0, 1]], dtype=np.int64)
    coords = np.array([[0, 0], [1, 1], [0, 0], [5, 5]], dtype=np.float32)
    spatial = np.array([False, True, False, True])
    g = make_graph(4, edges, coords, spatial)
    for variant in VARIANTS:
        idx = build_2dreach(g, variant=variant)
        assert idx.forest.n_trees < 8
        eng = _engine(idx, 8)
        us = np.array([0, 2, 3, 1])
        rects = np.array([[0.5, 0.5, 1.5, 1.5]] * 4, dtype=np.float32)
        want = idx.query_batch(us, rects)
        assert np.array_equal(eng.query_batch(us, rects), want), variant
        assert np.array_equal(eng.query_batch_two_phase(us, rects), want)
        assert want[0] and not want[1]


def test_sharded_empty_forest():
    """No reachable venue at all: T = 0, every shard arena empty."""
    edges = np.array([[0, 1]], dtype=np.int64)
    g = make_graph(2, edges, np.zeros((2, 2), np.float32),
                   np.zeros(2, dtype=bool))
    for variant in VARIANTS:
        idx = build_2dreach(g, variant=variant)
        assert idx.forest.n_trees == 0
        eng = _engine(idx, 2)
        us = np.array([0, 1])
        rects = np.array([[-1, -1, 1, 1]] * 2, dtype=np.float32)
        want = idx.query_batch(us, rects)
        assert np.array_equal(eng.query_batch(us, rects), want)
        assert np.array_equal(eng.query_batch_two_phase(us, rects), want)


@pytest.mark.parametrize("variant", ["comp", "pointer"])
def test_sharded_spatial_query_vertices(indexes, variant):
    """Alg. 2: excluded (spatial-sink) query vertices answer by their own
    point, on every shard count."""
    idx = indexes[variant]
    eng = _engine(idx, 2)
    exc = np.nonzero(idx.excluded)[0]
    rng = np.random.default_rng(7)
    us = rng.choice(exc, size=32)
    pts = idx.coords[us]
    rects = np.concatenate([pts - 0.01, pts + 0.01], axis=1).astype(
        np.float32)
    rects[::2] += 1e3
    want = idx.query_batch(us, rects)
    assert np.array_equal(eng.query_batch(us, rects), want)
    assert np.array_equal(eng.query_batch_two_phase(us, rects), want)
    assert want[1::2].all() and not want[::2].any()


@pytest.mark.parametrize("B", [1, TB, TB + 1, 100, 256, 257])
def test_sharded_bucket_boundaries(graph, indexes, B):
    idx = indexes["comp"]
    eng = _engine(idx, 4)
    us, rects = workload(graph, B, extent_ratio=0.05, seed=B)
    want = idx.query_batch(us, rects)
    assert np.array_equal(eng.query_batch(us, rects), want)
    assert np.array_equal(eng.query_batch_two_phase(us, rects), want)


def test_sharded_empty_batch_and_bad_ids(indexes):
    idx = indexes["comp"]
    eng = _engine(idx, 2)
    for fn in (eng.query_batch, eng.query_batch_two_phase):
        out = fn(np.zeros(0, np.int64), np.zeros((0, 4), np.float32))
        assert out.shape == (0,) and out.dtype == np.bool_
    n = len(idx.excluded)
    for bad in (n, -n - 1):
        with pytest.raises(IndexError, match="out of bounds"):
            eng.query_batch(np.array([0, bad]), np.tile(RECT, (2, 1)))
    assert eng.query(0, RECT) == bool(idx.query_batch(np.array([0]),
                                                      RECT[None])[0])


def test_sharded_no_steady_state_recompiles(graph, indexes):
    idx = indexes["pointer"]
    eng = _engine(idx, 8)
    for seed, B in [(0, 1), (1, 8), (2, 100), (3, 128)]:
        us, rects = workload(graph, B, extent_ratio=0.05, seed=seed)
        eng.query_batch(us, rects)
    warm = eng.n_compiles
    for seed, B in [(10, 3), (11, 100), (12, 77), (13, 128), (14, 1)]:
        us, rects = workload(graph, B, extent_ratio=0.05, seed=seed)
        assert np.array_equal(idx.query_batch(us, rects),
                              eng.query_batch(us, rects))
    assert eng.n_compiles == warm
    assert eng.stats["uploads"] == 1


def test_sharded_engine_for_memoised_and_strict(graph, indexes):
    idx = build_index(graph, "2dreach")
    assert sharded_engine_for(idx, device=CPU) is sharded_engine_for(
        idx, device=CPU)
    us, rects = np.array([0]), RECT[None]
    assert np.array_equal(
        batch_query(idx, us, rects, engine="cluster", device=CPU),
        batch_query(idx, us, rects))
    eng2 = sharded_engine_for(idx, n_shards=2, device=CPU)
    assert eng2.n_shards == 2 and idx._cluster_engine is eng2
    assert sharded_engine_for(idx, device=CPU) is eng2
    geo = build_index(graph, "georeach")
    with pytest.raises(ValueError, match="GeoReachIndex"):
        sharded_engine_for(geo, device=CPU)
    with pytest.raises(ValueError, match="cluster"):
        batch_query(geo, us, rects, engine="cluster", device=CPU)


def test_sharded_mesh_divisibility(indexes):
    assert visible_devices(CPU) == [torch.device(CPU)]
    mesh = make_shard_mesh(device=CPU)
    assert mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="n_dev"):
        make_shard_mesh(2, device=CPU)
    assert [devices_for(s, 4) for s in (1, 2, 3, 4, 6, 8)] == \
        [1, 2, 3, 4, 3, 4]
    assert devices_for(7, 4) == 1
    eng = _engine(indexes["comp"], 3)
    assert eng.n_shards == 3
    assert eng.n_shards % eng.mesh.shape["data"] == 0


def test_sharded_engine_adopts_device_build(graph):
    """A device-built index (``backend="device"``, here on the CPU): its
    shard stacks are gathered from the resident planes, adopted, and
    answer as the host build."""
    idx = build_2dreach(graph, variant="comp", backend="device", device=CPU)
    up = UPLOAD_COUNTERS["host_uploads"]
    eng = _engine(idx, 4)
    assert eng.stats["adopted"] == 1
    assert UPLOAD_COUNTERS["host_uploads"] == up
    us, rects = workload(graph, 128, extent_ratio=0.05, seed=2)
    assert np.array_equal(eng.query_batch(us, rects),
                          idx.query_batch(us, rects))
    assert eng.nbytes_planes > 0


def test_no_gpu_raises(indexes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx = indexes["comp"]
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEngine(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_engine_for(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_query(idx, np.array([0]), RECT[None], engine="cluster")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_shard_mesh()


# ---------------------------------------------------------------- frontend

def test_frontend_answers_match_host(graph, indexes):
    idx = indexes["comp"]
    eng = _engine(idx, 2)
    us, rects = workload(graph, 300, extent_ratio=0.05, seed=5)
    want = idx.query_batch(us, rects)
    with Frontend(eng, max_batch=64, max_delay=5e-3) as fe:
        got = fe.submit_many(us, rects, timeout=60)
        assert np.array_equal(got, want)
        assert fe.stats["n_flush_full"] >= 1
        assert fe.stats["batched_queries"] == 300
        assert fe.mean_batch > 1


def test_frontend_deadline_flush(graph, indexes):
    """A lone request (batch never fills) resolves via the deadline
    flush."""
    idx = indexes["comp"]
    eng = _engine(idx, 2)
    us, rects = workload(graph, 1, extent_ratio=0.05, seed=9)
    with Frontend(eng, max_batch=64, max_delay=2e-3) as fe:
        fe.warmup(us, rects)
        got = fe.submit(int(us[0]), rects[0]).result(timeout=30)
        assert got == bool(idx.query_batch(us, rects)[0])
        assert fe.stats["n_flush_deadline"] >= 1


def test_frontend_steady_state_no_recompiles(graph, indexes):
    idx = indexes["comp"]
    eng = _engine(idx, 8)
    us, rects = workload(graph, 400, extent_ratio=0.05, seed=6)
    with Frontend(eng, max_batch=64, max_delay=2e-3) as fe:
        fe.warmup(us[:64], rects[:64])
        fe.submit_many(us, rects, timeout=60)
        fe.warmup(us[:64], rects[:64])
        fe.submit_many(us, rects, timeout=60)
        warm = eng.n_compiles
        got = fe.submit_many(us, rects, timeout=60)
        assert eng.n_compiles == warm, "steady-state recompile"
    assert np.array_equal(got, idx.query_batch(us, rects))


def test_frontend_backpressure_and_close(graph, indexes):
    idx = indexes["comp"]
    eng = _engine(idx, 2)
    us, rects = workload(graph, 64, extent_ratio=0.05, seed=4)
    fe = Frontend(eng, max_batch=8, max_delay=1e-3, max_queue=8)
    errs = []

    def feed():
        try:
            for i in range(64):
                fe.submit(int(us[i]), rects[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=feed)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errs
    assert fe.stats["max_pending_seen"] <= 8
    fe.close(timeout=60)
    with pytest.raises(RuntimeError):
        fe.submit(int(us[0]), rects[0])


def test_frontend_validates_config(indexes):
    eng = _engine(indexes["comp"], 1)
    with pytest.raises(ValueError):
        Frontend(eng, max_batch=0)
    with pytest.raises(ValueError):
        Frontend(eng, max_batch=64, max_queue=8)


def test_frontend_survives_cancelled_future(graph, indexes):
    idx = indexes["comp"]
    us, rects = workload(graph, 16, extent_ratio=0.05, seed=13)
    with Frontend(idx, max_batch=8, max_delay=50e-3) as fe:
        cancelled = fe.submit(int(us[0]), rects[0])
        assert cancelled.cancel()
        got = fe.submit_many(us[1:], rects[1:], timeout=30)
    assert np.array_equal(got, idx.query_batch(us[1:], rects[1:]))


def test_frontend_rejects_ragged_rects_and_survives(graph, indexes):
    idx = indexes["comp"]
    us, rects = workload(graph, 8, extent_ratio=0.05, seed=12)
    with Frontend(idx, max_batch=4, max_delay=1e-3) as fe:
        fe.submit(int(us[0]), rects[0])
        with pytest.raises(ValueError, match="coords"):
            fe.submit(int(us[1]), rects[1][:3])
        got = fe.submit_many(us, rects, timeout=30)
    assert np.array_equal(got, idx.query_batch(us, rects))


@pytest.mark.parametrize("make", [
    lambda idx: idx,
    lambda idx: QueryEngine(idx, device=CPU),
    lambda idx: QueryEngine(idx, device=CPU, path="two_phase"),
], ids=["host_index", "query_engine", "two_phase_engine"])
def test_frontend_works_with_any_engine(graph, indexes, make):
    """Engine-agnostic: the frontend micro-batches any query_batch."""
    idx = indexes["comp"]
    us, rects = workload(graph, 40, extent_ratio=0.05, seed=8)
    with Frontend(make(idx), max_batch=16, max_delay=1e-3) as fe:
        got = fe.submit_many(us, rects, timeout=30)
    assert np.array_equal(got, idx.query_batch(us, rects))


# ------------------------------------- the reference's test_frontend_load

class FakeClock:
    """Injectable monotonic clock; ``advance`` also wakes the scheduler
    so its deadline wait re-evaluates against the new time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, fe: Frontend, dt: float) -> None:
        self.t += dt
        with fe._cond:
            fe._cond.notify_all()


class BlockableEngine:
    """Answers True for everything; optionally blocks inside the first
    ``query_batch`` until released (holds the frontend inflight)."""

    def __init__(self, block_first: bool = False):
        self.calls: list = []
        self.entered = threading.Event()
        self.release = threading.Event()
        self._block_first = block_first

    def query_batch(self, us, rects):
        self.calls.append(np.asarray(us).copy())
        self.entered.set()
        if self._block_first and len(self.calls) == 1:
            assert self.release.wait(timeout=30), "engine never released"
        return np.ones(len(np.asarray(us)), dtype=bool)


def _await(predicate, timeout=10.0, what="condition"):
    """Bounded wait for a cross-thread state transition."""
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out awaiting {what}"
        time.sleep(0.001)


def test_deadline_flush_on_time_is_not_a_miss():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine()
    with Frontend(eng, max_batch=8, max_delay=10.0, metrics=reg,
                  clock=clock) as fe:
        fut = fe.submit(0, RECT)
        assert not fut.done()
        clock.advance(fe, 10.0)
        assert fut.result(timeout=10) is True
        assert fe.stats["n_flush_deadline"] == 1
        assert fe.stats["n_deadline_misses"] == 0
        assert reg.counter("frontend.n_flush_deadline").value == 1
        assert reg.counter("frontend.deadline_misses").value == 0
        h = reg.histogram("frontend.flush_lateness_us")
        assert h.snapshot()["count"] == 1
        assert h.snapshot()["max"] == 0.0


def test_deadline_miss_behind_inflight_batch():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=1, max_queue=8, max_delay=10.0,
                  deadline_grace=5.0, metrics=reg, clock=clock)
    try:
        f1 = fe.submit(0, RECT)
        assert eng.entered.wait(timeout=10)
        f2 = fe.submit(1, RECT)
        clock.advance(fe, 100.0)
        eng.release.set()
        assert f1.result(timeout=10) is True
        assert f2.result(timeout=10) is True
        assert fe.stats["n_deadline_misses"] == 1
        assert reg.counter("frontend.deadline_misses").value == 1
        h = reg.histogram("frontend.flush_lateness_us")
        assert h.snapshot()["max"] == pytest.approx(90e6)
    finally:
        fe.close()


def test_lateness_within_grace_is_not_a_miss():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine()
    with Frontend(eng, max_batch=8, max_delay=10.0, deadline_grace=5.0,
                  metrics=reg, clock=clock) as fe:
        fut = fe.submit(0, RECT)
        clock.advance(fe, 13.0)
        assert fut.result(timeout=10) is True
        assert fe.stats["n_deadline_misses"] == 0
        h = reg.histogram("frontend.flush_lateness_us")
        assert h.snapshot()["max"] == pytest.approx(3e6)


def test_queue_full_backpressure_blocks_and_recovers():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=2, max_queue=2, max_delay=10.0,
                  metrics=reg, clock=clock)
    try:
        fa = fe.submit(0, RECT)
        fb = fe.submit(1, RECT)
        assert eng.entered.wait(timeout=10)
        fc = fe.submit(2, RECT)
        fd = fe.submit(3, RECT)
        extra = {}

        def blocked_submit():
            extra["fut"] = fe.submit(4, RECT)

        th = threading.Thread(target=blocked_submit)
        th.start()
        _await(lambda: fe.stats["n_submit_blocked"] == 1,
               what="submit to block on the full queue")
        assert th.is_alive()
        assert reg.counter("frontend.submit_blocked").value == 1
        eng.release.set()
        th.join(timeout=10)
        assert not th.is_alive()
        clock.advance(fe, 50.0)
        for f in (fa, fb, fc, fd, extra["fut"]):
            assert f.result(timeout=10) is True
        assert fe.stats["n_requests"] == 5
        assert sum(len(c) for c in eng.calls) == 5
    finally:
        fe.close()


def test_gauges_track_depth_occupancy_inflight():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=4, max_queue=16, max_delay=10.0,
                  metrics=reg, clock=clock)
    try:
        for i in range(4):
            fe.submit(i, RECT)
        assert eng.entered.wait(timeout=10)
        assert reg.gauge("frontend.inflight").value == 1
        for i in range(3):
            fe.submit(4 + i, RECT)
        assert reg.gauge("frontend.queue_depth").max >= 3
        eng.release.set()
        clock.advance(fe, 10.0)
        _await(lambda: fe.stats["n_batches"] == 2, what="both flushes")
        assert reg.gauge("frontend.inflight").value == 0
        assert reg.gauge("frontend.batch_occupancy").max == 1.0
        assert reg.gauge("frontend.batch_occupancy").value == \
            pytest.approx(3 / 4)
        h = reg.histogram("frontend.batch_size")
        assert h.snapshot()["count"] == 2
        assert h.snapshot()["max"] == 4.0
        assert reg.counter("frontend.requests").value == 7
        assert reg.histogram(
            "frontend.queue_wait_us").snapshot()["count"] == 7
    finally:
        fe.close()


def test_fake_clock_does_not_leak_into_default_frontend():
    eng = BlockableEngine()
    with Frontend(eng, max_batch=4, max_delay=1e-3) as fe:
        got = fe.submit_many(np.arange(4), np.tile(RECT, (4, 1)),
                             timeout=30)
    assert got.all()
    assert fe.stats["n_batches"] >= 1


def test_submit_timeout_raises_queue_full():
    reg = Registry()
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=2, max_queue=2, max_delay=10.0,
                  metrics=reg)
    try:
        fe.submit(0, RECT)
        fe.submit(1, RECT)
        assert eng.entered.wait(timeout=10)
        fe.submit(2, RECT)
        fe.submit(3, RECT)
        with pytest.raises(QueueFull):
            fe.submit(4, RECT, timeout=0.05)
        assert fe.stats["n_queue_full_timeouts"] == 1
        assert reg.counter("frontend.queue_full_timeouts").value == 1
        eng.release.set()
        assert fe.stats["n_requests"] == 4
    finally:
        fe.close()


def test_overloaded_shed_on_doomed_deadline():
    reg = Registry()
    eng = BlockableEngine()
    fe = Frontend(eng, max_batch=8, max_delay=0.5, max_queue=16,
                  metrics=reg, slo=0.01)
    try:
        with pytest.raises(Overloaded):
            fe.submit(0, RECT)
        fut = fe.submit(1, RECT, deadline=60.0)
        fe.flush(timeout=10)
        assert fut.result(timeout=10) is True
        assert fe.stats["n_shed"] == 1
        assert reg.counter("frontend.shed").value == 1
    finally:
        fe.close()


def test_deadline_expired_in_queue_is_dropped_typed():
    clock = FakeClock()
    reg = Registry()
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=1, max_queue=8, max_delay=0.1,
                  metrics=reg, clock=clock)
    try:
        fa = fe.submit(0, RECT)
        assert eng.entered.wait(timeout=10)
        fb = fe.submit(1, RECT, deadline=0.5)
        fc = fe.submit(2, RECT, deadline=50.0)
        clock.advance(fe, 1.0)
        eng.release.set()
        assert fa.result(timeout=10) is True
        with pytest.raises(DeadlineExceeded):
            fb.result(timeout=10)
        assert fc.result(timeout=10) is True
        assert fe.stats["n_deadline_dropped"] == 1
        assert reg.counter("frontend.deadline_dropped").value == 1
        assert sum(len(c) for c in eng.calls) == 2
    finally:
        fe.close()


def test_engine_exception_latches_and_scheduler_survives():
    class Exploding:
        def __init__(self):
            self.calls = 0

        def query_batch(self, us, rects):
            self.calls += 1
            if self.calls == 1:
                raise ValueError("device on fire")
            return np.ones(len(np.asarray(us)), dtype=bool)

    eng = Exploding()
    with Frontend(eng, max_batch=2, max_delay=10.0) as fe:
        fa = fe.submit(0, RECT)
        fb = fe.submit(1, RECT)
        for f in (fa, fb):
            with pytest.raises(ValueError):
                f.result(timeout=10)
        fc = fe.submit(2, RECT)
        fd = fe.submit(3, RECT)
        assert fc.result(timeout=10) is True
        assert fd.result(timeout=10) is True
    assert eng.calls == 2


def test_close_drain_false_fails_pending_typed():
    eng = BlockableEngine(block_first=True)
    fe = Frontend(eng, max_batch=2, max_queue=8, max_delay=10.0)
    fa = fe.submit(0, RECT)
    fb = fe.submit(1, RECT)
    assert eng.entered.wait(timeout=10)
    fc = fe.submit(2, RECT)
    eng.release.set()
    fe.close(timeout=10, drain=False)
    assert fa.result(timeout=10) is True
    assert fb.result(timeout=10) is True
    with pytest.raises(FrontendClosed):
        fc.result(timeout=10)
    with pytest.raises(FrontendClosed):
        fe.submit(3, RECT)
    with pytest.raises(RuntimeError):
        fe.submit(4, RECT)


def test_close_drain_true_still_serves_everything():
    eng = BlockableEngine()
    fe = Frontend(eng, max_batch=64, max_delay=10.0)
    futs = [fe.submit(i, RECT) for i in range(5)]
    fe.close(timeout=10)
    assert all(f.result(timeout=10) is True for f in futs)


# ---------------------------------------------------------- dynamic base

def test_dynamic_sharded_base_across_compactions():
    """DynamicIndex(engine="cluster"): sharded base probe under the
    overlay, oracle-checked interleaved mutations across >= 2 compaction
    swaps (each swap repartitions the fresh device build)."""
    from repro_torch.core import rangereach_oracle_batch as oracle

    g = get_dataset("yelp", scale=0.05)
    dyn = build_dynamic_index(
        g, "2dreach-comp", engine="cluster", n_shards=4, device=CPU,
        policy=CompactionPolicy(max_overlay_edges=30, background=False),
    )
    engines = [dyn.base_engine]
    assert isinstance(dyn.base_engine, ShardedEngine)
    assert dyn.base_engine.n_shards == 4
    assert dyn.base_engine.stats["adopted"] == 1
    step = 0
    for op in streaming_workload(g, n_steps=400, seed=31, p_query=0.35,
                                 p_edge=0.45, p_vertex=0.1, p_spatial=0.1):
        apply_stream_op(dyn, op)
        if dyn.base_engine is not engines[-1]:
            engines.append(dyn.base_engine)
        step += 1
        if step % 100 == 0:
            gm = dyn.snapshot_graph()
            vu, vr = workload(gm, 24, extent_ratio=0.05, seed=step)
            assert np.array_equal(dyn.query_batch(vu, vr),
                                  oracle(gm, vu, vr)), step
    assert dyn.stats["n_compactions"] >= 2
    assert len(engines) >= 3
    assert all(e.stats["adopted"] == 1 for e in engines)
    gm = dyn.snapshot_graph()
    vu, vr = workload(gm, 64, extent_ratio=0.05, seed=999)
    assert np.array_equal(dyn.query_batch(vu, vr), oracle(gm, vu, vr))


# ----------------------------------------------------- obs, trace, chaos

@pytest.fixture(scope="module")
def served(graph, indexes):
    idx = indexes["comp"]
    us, rects = workload(graph, 128, extent_ratio=0.05, seed=7)
    return idx, QueryEngine(idx, device=CPU), us, rects


def test_mixed_serve_coverage_at_least_95pct(served):
    """The frontend half of the reference's coverage gate: spans across
    the serve, engine and frontend layers cover >= 95% of a mixed
    serve's wall time, and the frontend logs every request."""
    _, eng, us, rects = served
    obs.enable()
    t0 = time.perf_counter()
    with obs.span("serve.mixed_pass", cat="serve"):
        eng.query_batch(us, rects)
        with Frontend(eng, max_batch=32, max_delay=1e-3) as fe:
            fe.submit_many(us[:64], rects[:64], timeout=60)
    t1 = time.perf_counter()
    obs.disable()
    assert obs.coverage(t0, t1) >= 0.95
    layers = {name.split(".")[0] for name in obs.stage_totals()}
    assert {"serve", "engine", "frontend"} <= layers
    snap = obs.snapshot()
    assert snap["schema_version"] == 2
    assert snap["query_log"]["total"] >= 64
    assert "frontend.flush" in snap["spans"]


def test_frontend_explicit_query_log(served):
    """An explicit query_log records even with obs disabled; shard and
    vertex-class fields are populated."""
    idx, _, us, rects = served
    eng = _engine(idx, 4)
    qlog = QueryLog(capacity=256)
    with Frontend(eng, max_batch=16, max_delay=1e-3, query_log=qlog) as fe:
        fe.submit_many(us[:48], rects[:48], timeout=60)
    assert qlog.total == 48
    recs = qlog.records()
    assert {r[I_VERTEX_CLASS] for r in recs} <= {"user", "sink", "unknown"}
    want_sink = int(idx.excluded[us[:48]].sum())
    assert sum(1 for r in recs if r[I_VERTEX_CLASS] == "sink") == want_sink
    assert sum(qlog.by_shard.values()) == 48
    assert set(qlog.by_shard) <= {-1, 0, 1, 2, 3}


def test_shard_fanout_spans_and_futures_carry_ids(served):
    """8-shard ShardedEngine behind the Frontend: futures expose their
    trace id, cluster spans carry the batch's ids, and the querylog v3
    rows join on them; the cluster metrics are recorded."""
    idx, _, us, rects = served
    eng = _engine(idx, 8)
    qlog = QueryLog()
    obs.enable()
    fe = Frontend(eng, max_batch=16, max_delay=1e-3, query_log=qlog)
    try:
        fe.warmup(us[:16], rects[:16])
        futs = [fe.submit(int(u), r) for u, r in zip(us[:16], rects[:16])]
        fe.flush(timeout=60)
        ans = [f.result(timeout=60) for f in futs]
    finally:
        fe.close()
    want = sorted(f.trace_id for f in futs)
    assert len(set(want)) == 16
    assert ans == list(idx.query_batch(us[:16], rects[:16]))
    tagged = [e for e in obs.TRACER.events()
              if e[0].startswith("cluster.")
              and (e[5] or {}).get("trace_ids")]
    assert tagged, "no cluster spans carried trace ids"
    for e in tagged:
        assert set(e[5]["trace_ids"]) <= set(want)
    assert {e[0] for e in tagged} >= {"cluster.query_batch",
                                      "cluster.fused", "cluster.sync"}
    recs = qlog.records()
    assert sorted(r[I_TRACE_ID] for r in recs) == want
    assert all(r[I_ATTEMPT] >= 0 for r in recs)
    assert REGISTRY.histogram("cluster.batch_us").snapshot()["count"] >= 1
    assert REGISTRY.gauge("cluster.n_compiles").value == eng.n_compiles


def test_cluster_fault_point_and_auditor(served):
    """``cluster.query_batch`` is a fault point; the exactness auditor
    behind the frontend finds no divergence."""
    idx, _, us, rects = served
    eng = _engine(idx, 2)
    with inject(FaultPlan(FaultSpec("cluster.query_batch", kind="raise"))):
        with pytest.raises(InjectedFault):
            eng.query_batch(us[:8], rects[:8])
    aud = ExactnessAuditor(idx, sample=1.0, registry=Registry())
    with Frontend(eng, max_batch=32, max_delay=1e-3, auditor=aud) as fe:
        assert np.array_equal(fe.submit_many(us, rects, timeout=60),
                              idx.query_batch(us, rects))
    aud.drain()
    rep = aud.report()
    assert rep["checked"] == len(us) and rep["divergences"] == 0


class SimDevice:
    """Device-path stand-in: the exact host answer behind the engine's
    fault point (the reference's chaos suite's)."""

    def __init__(self, index):
        self.index = index
        self.calls = 0

    def query_batch(self, us, rects):
        fault_point("engine.query_batch", n=len(us))
        self.calls += 1
        return self.index.query_batch(us, rects)


def test_chaos_frontend_end_to_end():
    """Frontend + resilient engine under a mixed fault plan: every future
    resolves (bounded wait) to the exact answer or a typed error; the
    scheduler thread survives everything."""
    rng = np.random.default_rng(42)
    rg = random_geosocial(rng, 200, 560)
    g = make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask)
    idx = build_index(g, "2dreach")
    us, rects = random_queries(rng, g, 400)
    want = idx.query_batch(us, rects)
    np.testing.assert_array_equal(want, rangereach_oracle_batch(g, us, rects))
    res = ResilientEngine(
        SimDevice(idx), idx,
        retry=RetryPolicy(max_attempts=2, base_s=1e-6, cap_s=1e-5),
        breaker=BreakerPolicy(failure_threshold=2, reset_timeout_s=0.0),
        sleep=lambda s: None, registry=Registry())
    plan = FaultPlan(
        FaultSpec("engine.query_batch", kind="raise", p=0.4, max_fires=None),
        FaultSpec("engine.query_batch", kind="delay", p=0.1, delay_s=2e-4,
                  max_fires=None),
        FaultSpec("frontend.flush", kind="raise", p=0.05, max_fires=None),
        FaultSpec("frontend.queue_stall", kind="delay", p=0.05,
                  delay_s=2e-4, max_fires=None),
        seed=77)
    shed = served = typed = wrong = 0
    with Frontend(res, max_batch=16, max_delay=5e-4, max_queue=512,
                  metrics=Registry()) as fe:
        with inject(plan):
            futs = []
            for i in range(len(us)):
                try:
                    dl = 0.0 if i % 37 == 0 else (5.0 if i % 5 == 0 else None)
                    futs.append((i, fe.submit(us[i], rects[i], deadline=dl)))
                except Overloaded:
                    shed += 1
            for i, fut in futs:
                try:
                    got = fut.result(timeout=30)
                    served += 1
                    wrong += int(got != bool(want[i]))
                except (ResilienceError, InjectedFault):
                    typed += 1
        assert fe.submit(us[0], rects[0]).result(timeout=30) == bool(want[0])
    assert wrong == 0
    assert served > 0
    assert shed > 0
    assert plan.total_fires > 0
    assert served + typed == len(futs)
