"""The port's resilience layer (``repro_torch.resilience``) against the
JAX package's, on the CPU.

The reference's ``tests/test_resilience.py`` cases on the port (fault
specs and plans, deadlines, retry, the breaker protocol, every
``ResilientEngine`` case with its flaky and sharded fake devices); the
same plan seed, retry seed and breaker sequence giving the same fires,
schedule and states as the reference; the ``tests/test_chaos.py``
invariants that need neither a frontend nor a dynamic index (bulk
faults, a bounded hang, the degraded path bit-identical on every
variant); and the engine's fault hooks on the port's ``QueryEngine``
(the same hits per call as the reference engine's, an injected raise
retried, two-phase degradation, a corrupt answer).
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import threading

import numpy as np
import pytest

import repro.core as R
import repro.resilience as RR
from repro.resilience import breaker as RB
from repro.resilience import faults as RF
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    build_index,
    make_graph,
    rangereach_oracle_batch,
)
from repro_torch.core.engine import engine_for
from repro_torch.data import (
    get_dataset,
    knn_workload,
    polygon_workload,
    workload,
)
from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.queries import (
    knn_reach_host,
    polygon_reach_host,
    range_collect_host,
    range_count_host,
)
from repro_torch.resilience import (
    BreakerPolicy,
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    FaultPlan,
    FaultSpec,
    INJECTOR,
    InjectedFault,
    ResilientEngine,
    RetryPolicy,
    ShardDropout,
    fault_point,
    inject,
)
from repro_torch.resilience import faults as PF
from repro_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN
from conftest import random_geosocial, random_queries

VARIANTS = ("2dreach", "2dreach-comp", "2dreach-pointer")


class Ticker:
    """Manually advanced monotonic clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def port_geosocial(rng, n, m):
    """``conftest.random_geosocial``'s graph, made by the port."""
    rg = random_geosocial(rng, n, m)
    return make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask)


@pytest.fixture(autouse=True)
def _no_plan_left():
    yield
    assert not INJECTOR.enabled and not RF.INJECTOR.enabled


# ----------------------------------------------------------------------
# fault plans / injection
# ----------------------------------------------------------------------


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("p", kind="explode")
    with pytest.raises(ValueError):
        FaultSpec("p", p=1.5)


def test_fault_point_disabled_is_noop():
    assert not INJECTOR.enabled
    fault_point("engine.query_batch", n=4)   # must not raise


def _fires(pkg_faults, specs, seed, hits=50, point="pt"):
    """Which of ``hits`` crossings of ``point`` fired, under a plan of
    ``specs`` (FaultSpec keyword dicts) at ``seed``, in one package."""
    plan = pkg_faults.FaultPlan(
        *[pkg_faults.FaultSpec(**s) for s in specs], seed=seed)
    fired = []
    with pkg_faults.inject(plan):
        for _ in range(hits):
            try:
                pkg_faults.fault_point(point)
                fired.append(0)
            except Exception:  # noqa: BLE001 — the injected fault
                fired.append(1)
    return fired, plan.total_fires, plan.hits_at(point)


def test_plan_fires_deterministically():
    spec = [dict(point="pt", kind="raise", p=0.5, max_fires=None)]
    a, na, _ = _fires(PF, spec, 7)
    b, nb, _ = _fires(PF, spec, 7)
    c, nc, _ = _fires(PF, spec, 8)
    assert a == b and na == nb
    assert a != c                       # different seed, different draw
    assert 0 < na < 50                  # p=0.5 actually probabilistic


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("specs", [
    [dict(point="pt", kind="raise", p=0.5, max_fires=None)],
    [dict(point="pt", kind="raise", p=0.3, after=4, max_fires=9)],
    [dict(point="pt", kind="raise", p=0.25, max_fires=3),
     dict(point="pt", kind="raise", p=0.6, max_fires=None)],
    [dict(point="other", kind="raise", p=0.5, max_fires=None),
     dict(point="pt", kind="raise", p=0.9, after=10, max_fires=None)],
])
def test_fire_schedule_matches_reference(seed, specs):
    """The same plan at the same seed fires on the same hits as the
    reference's, hit counts and totals included."""
    assert _fires(PF, specs, seed, hits=80) == _fires(RF, specs, seed,
                                                      hits=80)


def test_plan_after_and_max_fires():
    plan = FaultPlan(FaultSpec("pt", after=2, max_fires=3))
    hits, fires = 10, 0
    with inject(plan):
        for i in range(hits):
            try:
                fault_point("pt")
            except InjectedFault as e:
                fires += 1
                assert i >= 2           # first two hits skipped
                assert e.point == "pt"
    assert fires == 3
    assert plan.hits_at("pt") == hits
    assert plan.fires_at("pt") == 3


def test_injected_counters_land_in_registry():
    before = REGISTRY.counter("faults.injected").value
    with inject(FaultPlan(FaultSpec("pt.counted", max_fires=2))):
        for _ in range(4):
            try:
                fault_point("pt.counted")
            except InjectedFault:
                pass
    assert REGISTRY.counter("faults.injected").value == before + 2
    assert REGISTRY.counter("faults.pt.counted").value >= 2


def test_corrupt_value_point_matches_reference():
    """A corrupt spec flips the first answer of a value point, as the
    reference's default mutator does; other kinds leave it alone."""
    ans = np.array([True, False, True])
    for pkg in (PF, RF):
        with pkg.inject(pkg.FaultPlan(pkg.FaultSpec(
                "engine.answer", kind="corrupt", max_fires=1))):
            got = pkg.fault_value("engine.answer", ans)
            again = pkg.fault_value("engine.answer", ans)
        assert got.tolist() == [False, False, True]
        assert again is ans
        with pkg.inject(pkg.FaultPlan(pkg.FaultSpec(
                "engine.answer", kind="corrupt"))):
            pkg.fault_point("engine.answer")     # ignored at plain points
    assert PF.fault_value("engine.answer", ans) is ans   # disabled


def test_uninstall_releases_pending_hang():
    plan = FaultPlan(FaultSpec("pt.hang", kind="hang", hang_s=60.0))
    stalled = threading.Event()
    done = threading.Event()

    def worker():
        stalled.set()
        fault_point("pt.hang")          # blocks until release
        done.set()

    INJECTOR.install(plan)
    try:
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        assert stalled.wait(timeout=10)
        assert not done.wait(timeout=0.05)   # genuinely stalled
    finally:
        INJECTOR.uninstall()            # sets plan.release
    assert done.wait(timeout=10), "uninstall must end the hang"


# ----------------------------------------------------------------------
# deadlines / retry
# ----------------------------------------------------------------------


def test_deadline_budget():
    clk = Ticker()
    dl = Deadline(1.0, clock=clk)
    assert not dl.expired() and dl.remaining() == pytest.approx(1.0)
    clk.t = 0.75
    assert dl.remaining() == pytest.approx(0.25)
    dl.check()                          # still inside budget
    clk.t = 1.0
    assert dl.expired()
    with pytest.raises(DeadlineExceeded):
        dl.check("probe")
    assert Deadline.none().remaining() == np.inf
    assert not Deadline(None).expired()


def test_retry_backoff_bounded_and_deterministic():
    pol = RetryPolicy(max_attempts=6, base_s=1e-3, cap_s=20e-3)
    sched = pol.schedule(np.random.default_rng(3))
    assert sched == pol.schedule(np.random.default_rng(3))
    assert len(sched) == 5
    prev = 0.0
    for s in sched:
        assert pol.base_s <= s <= pol.cap_s
        assert s <= max(pol.base_s, 3.0 * prev) + 1e-12  # decorrelated
        prev = s


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("policy", [(6, 1e-3, 20e-3), (3, 1e-4, 1e-3),
                                    (10, 0.4, 0.4), (1, 1e-3, 1e-3)])
def test_retry_schedule_matches_reference(seed, policy):
    n, base, cap = policy
    got = RetryPolicy(max_attempts=n, base_s=base, cap_s=cap).schedule(
        np.random.default_rng(seed))
    want = RR.RetryPolicy(max_attempts=n, base_s=base, cap_s=cap).schedule(
        np.random.default_rng(seed))
    assert got == want


def test_retry_policy_validation():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(base_s=2.0, cap_s=1.0)


# ----------------------------------------------------------------------
# circuit breaker
# ----------------------------------------------------------------------


def _breaker(clk, **kw):
    return CircuitBreaker("t", BreakerPolicy(**kw), clock=clk,
                          registry=Registry())


def test_breaker_opens_after_threshold():
    clk = Ticker()
    br = _breaker(clk, failure_threshold=3, reset_timeout_s=5.0)
    for _ in range(2):
        assert br.allow()
        br.record_failure()
    assert br.state == CLOSED           # 2 < threshold
    assert br.allow()
    br.record_failure()
    assert br.state == OPEN
    assert not br.allow()               # open refuses outright


def test_breaker_success_resets_failure_streak():
    clk = Ticker()
    br = _breaker(clk, failure_threshold=2)
    br.record_failure()
    br.record_success()                 # streak broken
    br.record_failure()
    assert br.state == CLOSED


def test_breaker_half_open_probe_protocol():
    clk = Ticker()
    br = _breaker(clk, failure_threshold=1, reset_timeout_s=10.0)
    br.record_failure()
    assert br.state == OPEN
    clk.t = 9.9
    assert not br.allow()
    clk.t = 10.0
    assert br.state == HALF_OPEN
    assert br.allow()                   # the single probe slot
    assert not br.allow()               # concurrent caller refused
    br.record_success()
    assert br.state == CLOSED


def test_breaker_probe_failure_reopens():
    clk = Ticker()
    br = _breaker(clk, failure_threshold=1, reset_timeout_s=1.0)
    br.record_failure()
    clk.t = 1.0
    assert br.allow()
    br.record_failure()                 # failed probe
    assert br.state == OPEN
    assert not br.allow()               # timeout restarted
    clk.t = 2.0
    assert br.allow()


def test_breaker_release_frees_probe_slot():
    clk = Ticker()
    br = _breaker(clk, failure_threshold=1, reset_timeout_s=1.0)
    br.record_failure()
    clk.t = 1.0
    assert br.allow()
    br.release()                        # grant unused: no outcome
    assert br.state == HALF_OPEN
    assert br.allow()                   # slot available again


def test_breaker_trip_and_policy_validation():
    clk = Ticker()
    br = _breaker(clk, reset_timeout_s=100.0)
    br.trip()
    assert br.state == OPEN and not br.allow()
    with pytest.raises(ValueError):
        BreakerPolicy(failure_threshold=0)
    with pytest.raises(ValueError):
        BreakerPolicy(reset_timeout_s=-1.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_breaker_states_match_reference(seed):
    """A seeded sequence of allow / success / failure / release / trip and
    clock steps drives both breakers through the same states, grants
    and transition counts."""
    from repro.obs.metrics import Registry as RReg

    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 6, size=200)
    steps = rng.uniform(0.0, 0.6, size=200)
    ck_p, ck_r = Ticker(), Ticker()
    reg_p, reg_r = Registry(), RReg()
    pol = dict(failure_threshold=2, reset_timeout_s=1.0,
               half_open_successes=2)
    p = CircuitBreaker("seq", BreakerPolicy(**pol), clock=ck_p,
                       registry=reg_p)
    r = RB.CircuitBreaker("seq", RB.BreakerPolicy(**pol), clock=ck_r,
                          registry=reg_r)
    trace_p, trace_r = [], []
    for op, dt in zip(ops, steps):
        for br, ck, trace in ((p, ck_p, trace_p), (r, ck_r, trace_r)):
            ck.t += dt
            out = None
            if op == 0:
                out = br.allow()
            elif op == 1:
                br.record_success()
            elif op in (2, 3):
                br.record_failure()
            elif op == 4:
                br.release()
            else:
                br.trip()
            trace.append((out, br.state, br.state_name))
    assert trace_p == trace_r
    for what in ("opened", "closed", "refused"):
        name = f"resilience.breaker.seq.{what}"
        assert reg_p.counter(name).value == reg_r.counter(name).value
    assert {s for _, s, _ in trace_p} >= {CLOSED, OPEN}


# ----------------------------------------------------------------------
# resilient engine (fake devices over the port's host index)
# ----------------------------------------------------------------------


class FlakyDevice:
    """Delegates to the host index; raises on scheduled call numbers."""

    def __init__(self, index, fail_calls=(), exc=None):
        self.index = index
        self.fail_calls = set(fail_calls)
        self.exc = exc or InjectedFault("flaky")
        self.calls = 0

    def query_batch(self, us, rects):
        self.calls += 1
        if self.calls in self.fail_calls:
            raise self.exc
        return self.index.query_batch(us, rects)


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(11)
    g = port_geosocial(rng, 120, 320)
    idx = build_index(g, "2dreach")
    us, rects = random_queries(rng, g, 64)
    want = rangereach_oracle_batch(g, us, rects)
    return idx, us, rects, want


def _resilient(idx, dev, clk=None, **kw):
    clk = clk or Ticker()
    kw.setdefault("retry", RetryPolicy(max_attempts=3, base_s=1e-4,
                                       cap_s=1e-3))
    kw.setdefault("breaker", BreakerPolicy(failure_threshold=2,
                                           reset_timeout_s=1.0))
    return ResilientEngine(dev, idx, clock=clk, sleep=lambda s: None,
                           registry=Registry(), **kw)


def test_resilient_healthy_passthrough(small_index):
    idx, us, rects, want = small_index
    dev = FlakyDevice(idx)
    res = _resilient(idx, dev)
    got = res.query_batch(us, rects)
    np.testing.assert_array_equal(got, want)
    assert res.stats["device_batches"] == 1
    assert res.stats["fallback_batches"] == 0
    assert not res.degraded


def test_resilient_retry_recovers_exactly(small_index):
    idx, us, rects, want = small_index
    dev = FlakyDevice(idx, fail_calls={1})      # first attempt fails
    res = _resilient(idx, dev)
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert res.stats["retries"] == 1
    assert res.stats["device_failures"] == 1
    assert res.stats["fallback_batches"] == 0


def test_resilient_exhaustion_degrades_exactly(small_index):
    idx, us, rects, want = small_index
    dev = FlakyDevice(idx, fail_calls=set(range(1, 100)))
    res = _resilient(idx, dev)
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert res.stats["fallback_batches"] == 1
    assert res.stats["fallback_queries"] == len(us)
    # two consecutive failures opened the breaker
    assert res.breaker.state == OPEN and res.degraded
    # while open, queries go straight to host — no device calls at all
    calls = dev.calls
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert dev.calls == calls


def test_resilient_deadline_exhaustion_falls_back(small_index):
    idx, us, rects, want = small_index
    clk = Ticker()
    dev = FlakyDevice(idx, fail_calls={1, 2, 3})

    def sleep(s):
        clk.t += s

    res = ResilientEngine(
        dev, idx, retry=RetryPolicy(max_attempts=5, base_s=0.4,
                                    cap_s=0.4),
        breaker=BreakerPolicy(failure_threshold=10),
        clock=clk, sleep=sleep, registry=Registry())
    got = res.query_batch(us, rects, deadline=0.5)
    np.testing.assert_array_equal(got, want)
    # one failure + one 0.4s backoff + one more failure exhausts 0.5s
    assert res.stats["fallback_batches"] == 1
    assert clk.t <= 0.5 + 1e-9          # never slept past the budget


def test_resilient_trip_forces_degraded(small_index):
    idx, us, rects, want = small_index
    dev = FlakyDevice(idx)
    res = _resilient(idx, dev)
    res.trip()
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert dev.calls == 0 and res.degraded


class ShardedFlaky:
    """Two-shard device sim: shard = u % 2; shard 1 always drops."""

    def __init__(self, index, dead_shard=1):
        self.index = index
        self.dead = dead_shard
        self.calls = []

    def shard_of(self, us):
        return np.asarray(us) % 2

    def query_batch(self, us, rects):
        us = np.asarray(us)
        self.calls.append(us.copy())
        if (self.shard_of(us) == self.dead).any():
            raise ShardDropout(self.dead, "cluster.query_batch")
        return self.index.query_batch(us, rects)


def test_resilient_shard_dropout_degrades_only_that_shard(small_index):
    idx, us, rects, want = small_index
    dev = ShardedFlaky(idx)
    res = _resilient(idx, dev,
                     breaker=BreakerPolicy(failure_threshold=1,
                                           reset_timeout_s=100.0))
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert res.shard_breaker(1).state == OPEN
    assert res.breaker.state == CLOSED  # engine itself stays healthy
    # second batch: dead shard filtered before the device call, healthy
    # shard served on device, remainder host-filled — still exact
    np.testing.assert_array_equal(res.query_batch(us, rects), want)
    assert (res.shard_breaker(1).state == OPEN)
    last = dev.calls[-1]
    assert (last % 2 == 0).all()        # no dead-shard query on device
    assert res.stats["fallback_queries"] >= int((us % 2 == 1).sum())


def test_resilient_analytics_fallback_exact(small_index):
    idx, us, rects, want = small_index
    dev = FlakyDevice(idx)              # exposes no count_batch at all
    res = _resilient(idx, dev)
    got = res.count_batch(us, rects)
    np.testing.assert_array_equal(got, range_count_host(idx, us, rects))
    assert res.stats["fallback_batches"] == 1
    assert res.stats["fallback_queries"] == len(us)


def test_resilient_report_and_metrics_match_reference(small_index):
    """The same failure schedule through both packages' wrappers, over
    the same index: the same stats, last_report and ``resilience.*``
    counters."""
    from repro.obs.metrics import Registry as RReg

    idx, us, rects, want = small_index
    ref_idx = R.build_2dreach(_ref_graph(idx), variant="base")
    out = []
    for pkg, index, reg in ((RR, ref_idx, RReg()), (None, idx, Registry())):
        Eng = ResilientEngine if pkg is None else pkg.ResilientEngine
        Ret = RetryPolicy if pkg is None else pkg.RetryPolicy
        Brk = BreakerPolicy if pkg is None else pkg.BreakerPolicy
        dev = FlakyDevice(index, fail_calls={1, 2, 4, 5, 6, 9})
        res = Eng(dev, index, retry=Ret(max_attempts=2, base_s=1e-4,
                                        cap_s=1e-3),
                  breaker=Brk(failure_threshold=3, reset_timeout_s=0.0),
                  sleep=lambda s: None, registry=reg, seed=4)
        answers = [res.query_batch(us[s:s + 8], rects[s:s + 8])
                   for s in range(0, len(us), 8)]
        rep = res.last_report
        out.append((np.concatenate(answers).tolist(), dict(res.stats),
                    rep["degraded"].tolist(), rep["retries"],
                    rep["attempts"].tolist(),
                    {n: reg.counter(f"resilience.{n}").value
                     for n in ("retries", "device_failures",
                               "fallback_batches", "fallback_queries")},
                    reg.histogram("resilience.degraded_query_us").count))
    assert out[0] == out[1]
    assert out[1][0] == want.tolist()


def _ref_graph(idx):
    """The reference's graph of ``small_index`` (same generator)."""
    return random_geosocial(np.random.default_rng(11), 120, 320)


# ----------------------------------------------------------------------
# chaos invariants (no frontend, no dynamic index)
# ----------------------------------------------------------------------


class SimDevice:
    """Device-path stand-in: the exact host answer behind the engine's
    fault point."""

    def __init__(self, index):
        self.index = index
        self.calls = 0

    def query_batch(self, us, rects):
        fault_point("engine.query_batch", n=len(us))
        self.calls += 1
        return self.index.query_batch(us, rects)


def _fast_resilient(idx, dev, **kw):
    kw.setdefault("retry",
                  RetryPolicy(max_attempts=2, base_s=1e-6, cap_s=1e-5))
    kw.setdefault("breaker",
                  BreakerPolicy(failure_threshold=2, reset_timeout_s=0.0))
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("registry", Registry())
    return ResilientEngine(dev, idx, **kw)


@pytest.fixture(scope="module")
def chaos_index():
    rng = np.random.default_rng(42)
    g = port_geosocial(rng, 200, 560)
    idx = build_index(g, "2dreach")
    us, rects = random_queries(rng, g, 400)
    want = idx.query_batch(us, rects)
    # the host index is itself oracle-exact (the invariant's anchor)
    np.testing.assert_array_equal(
        want, rangereach_oracle_batch(g, us, rects))
    return idx, us, rects, want


def test_chaos_invariant_bulk_faults(chaos_index):
    """≥ 500 injected device faults; every answer exact, none lost."""
    idx, us, rects, want = chaos_index
    res = _fast_resilient(idx, SimDevice(idx))
    plan = FaultPlan(
        FaultSpec("engine.query_batch", kind="raise", p=0.6,
                  max_fires=None),
        seed=123)
    injected_before = REGISTRY.counter("faults.injected").value
    wrong = 0
    n_batches = 650                     # ~0.93 fires/batch at p=0.6
    with inject(plan):
        for b in range(n_batches):
            sel = np.arange(b * 4, b * 4 + 4) % len(us)
            got = res.query_batch(us[sel], rects[sel])
            wrong += int((got != want[sel]).sum())
    assert wrong == 0
    assert plan.total_fires >= 500, plan.total_fires
    assert (REGISTRY.counter("faults.injected").value
            >= injected_before + 500)
    # both paths genuinely exercised
    assert res.stats["device_batches"] > 0
    assert res.stats["fallback_batches"] > 0
    assert res.stats["retries"] > 0


def test_chaos_hang_is_bounded(chaos_index):
    """A hang-kind fault stalls the device call until the plan's
    release — the caller's thread is stuck *inside* the injected hang,
    not lost; release ends it and the answer is still exact."""
    idx, us, rects, want = chaos_index
    res = _fast_resilient(idx, SimDevice(idx))
    plan = FaultPlan(
        FaultSpec("engine.query_batch", kind="hang", hang_s=30.0))
    out = {}
    with inject(plan):
        def call():
            out["got"] = res.query_batch(us[:8], rects[:8])

        t = threading.Thread(target=call, daemon=True)
        t.start()
        t.join(timeout=0.1)
        assert t.is_alive()             # genuinely stalled
        plan.release.set()
        t.join(timeout=30)
        assert not t.is_alive(), "hang must end on release"
    np.testing.assert_array_equal(out["got"], want[:8])


def test_hang_then_raise_with_deadline_degrades_to_host(chaos_index):
    """A stalled device call that ends in an error past the batch's
    deadline: no retry, the host answers, in bounded time."""
    idx, us, rects, want = chaos_index

    class Device:
        def query_batch(self, us, rects):
            fault_point("engine.query_batch", n=len(us))
            fault_point("engine.route_prune", n=len(us))
            return idx.query_batch(us, rects)

    res = _fast_resilient(idx, Device(), sleep=lambda s: None)
    plan = FaultPlan(FaultSpec("engine.query_batch", kind="hang",
                               hang_s=0.05),
                     FaultSpec("engine.route_prune", kind="raise"))
    with inject(plan):
        got = res.query_batch(us[:16], rects[:16], deadline=0.01)
    np.testing.assert_array_equal(got, want[:16])
    rep = res.last_report
    assert rep["degraded"].all() and rep["retries"] == 0
    assert (rep["attempts"] == 1).all()
    assert res.stats["fallback_queries"] == 16
    assert plan.total_fires == 2


@pytest.mark.parametrize("variant", VARIANTS)
def test_degraded_path_bit_identical_all_variants(variant):
    """The degradation target equals the healthy device path bit for
    bit on every 2DReach variant (the port's engine on the CPU)."""
    rng = np.random.default_rng(9)
    g = port_geosocial(rng, 150, 420)
    idx = build_index(g, variant)
    us, rects = random_queries(rng, g, 96)
    dev = engine_for(idx, device="cpu", required=True)
    healthy = ResilientEngine(dev, idx, registry=Registry())
    got_dev = healthy.query_batch(us, rects)
    assert healthy.stats["fallback_batches"] == 0
    degraded = ResilientEngine(dev, idx, registry=Registry())
    degraded.trip()
    got_host = degraded.query_batch(us, rects)
    np.testing.assert_array_equal(got_dev, got_host)
    np.testing.assert_array_equal(
        got_host, rangereach_oracle_batch(g, us, rects))
    assert degraded.stats["fallback_batches"] == 1
    two = ResilientEngine(dev, idx, registry=Registry(),
                          degraded_path="two_phase")
    two.trip()
    np.testing.assert_array_equal(two.query_batch(us, rects), got_host)


# ----------------------------------------------------------------------
# the port's engine behind the wrapper, with its fault hooks
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """yelp x0.05 2dreach-comp: the port's index and CPU engine, the
    reference's index, and a workload of each class."""
    g = get_dataset("yelp", scale=0.05)
    import repro.data as RD

    ref = R.build_2dreach(RD.get_dataset("yelp", scale=0.05),
                          variant="comp")
    idx = index_from_arrays(index_to_arrays(ref))
    eng = QueryEngine(idx, device="cpu")
    us, rects = workload(g, 64, extent_ratio=0.05, seed=3)
    kus, pts = knn_workload(g, 32, seed=4)
    pus, polys = polygon_workload(g, 32, extent_ratio=0.05, seed=5)
    return ref, idx, eng, (us, rects), (kus, pts), (pus, polys)


def _class_calls(eng, work, knn, poly):
    us, rects = work
    return {
        "reach": lambda: eng.query_batch(us, rects),
        "reach_two_phase": lambda: eng.query_batch_two_phase(us, rects),
        "count": lambda: eng.count_batch(us, rects),
        "count_two_phase": lambda: eng.count_batch_two_phase(us, rects),
        "collect": lambda: eng.collect_batch(us, rects, 5),
        "knn": lambda: eng.knn_batch(*knn, 4),
        "polygon": lambda: eng.polygon_batch(*poly),
    }


def test_engine_fault_hits_match_reference(served):
    """With an empty plan installed, every query class crosses the same
    fault points as often on the port's engine as on the reference's."""
    ref, idx, eng, work, knn, poly = served
    ref_eng = R.QueryEngine(ref, interpret=True, fused_impl="xla")
    got, want = {}, {}
    for calls, pkg, out in ((_class_calls(eng, work, knn, poly), PF, got),
                            (_class_calls(ref_eng, work, knn, poly), RF,
                             want)):
        for kind, call in calls.items():
            plan = pkg.FaultPlan()
            with pkg.inject(plan):
                call()
            out[kind] = {p: plan.hits_at(p) for p in (
                "engine.query_batch", "engine.route_prune",
                "engine.answer")}
    assert got == want
    assert got["reach"] == {"engine.query_batch": 1,
                            "engine.route_prune": 1, "engine.answer": 1}


def test_healthy_wrapper_serves_every_class_on_the_engine(served):
    _, idx, eng, work, knn, poly = served
    us, rects = work
    res = ResilientEngine(eng, idx, registry=Registry())
    assert (res.query_batch(us, rects) == idx.query_batch(us, rects)).all()
    assert (res.count_batch(us, rects)
            == range_count_host(idx, us, rects)).all()
    a, b = res.collect_batch(us, rects, 5), range_collect_host(idx, us,
                                                               rects, 5)
    assert (a.ids == b.ids).all() and (a.counts == b.counts).all()
    a, b = res.knn_batch(*knn, 4), knn_reach_host(idx, *knn, 4)
    assert (a.ids == b.ids).all() and (a.dist2 == b.dist2).all()
    assert (res.polygon_batch(*poly) == polygon_reach_host(idx, *poly)).all()
    assert res.stats["device_batches"] == 5
    assert res.stats["fallback_queries"] == 0
    assert res.n_compiles == eng.n_compiles > 0


def test_injected_raise_on_the_engine_retries_once(served):
    _, idx, eng, work, _, _ = served
    us, rects = work
    res = ResilientEngine(eng, idx, registry=Registry(),
                          sleep=lambda s: None)
    plan = FaultPlan(FaultSpec("engine.query_batch", kind="raise"), seed=1)
    with inject(plan):
        got = res.query_batch(us, rects)
    assert (got == idx.query_batch(us, rects)).all()
    assert res.stats["retries"] == 1 and res.stats["fallback_queries"] == 0
    assert (res.last_report["attempts"] == 2).all()
    # the analytics classes' shared phase 1 carries its own point
    plan = FaultPlan(FaultSpec("engine.route_prune", kind="raise"), seed=1)
    with inject(plan):
        got = res.count_batch(us, rects)
    assert (got == range_count_host(idx, us, rects)).all()
    assert res.stats["retries"] == 2 and plan.fires_at(
        "engine.route_prune") == 1


def test_two_phase_degradation_on_the_engine(served, monkeypatch):
    """Retries exhausted with ``degraded_path="two_phase"``: the engine's
    two-phase path answers (the plan's fires spent, it runs clean), one
    prune and one descent scan for the batch, nothing on the host."""
    from repro_torch.core import engine as E

    _, idx, eng, work, _, _ = served
    us, rects = work
    res = ResilientEngine(eng, idx, degraded_path="two_phase",
                          retry=RetryPolicy(max_attempts=2, base_s=1e-6,
                                            cap_s=1e-5),
                          registry=Registry(), sleep=lambda s: None)
    calls = {"prune": 0, "scan": 0, "host": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(E, "prune_tiles", counted("prune", E.prune_tiles))
    monkeypatch.setattr(E, "descent_scan", counted("scan", E.descent_scan))
    monkeypatch.setattr(idx, "query_batch", counted("host", idx.query_batch))
    plan = FaultPlan(FaultSpec("engine.query_batch", kind="raise",
                               max_fires=2), seed=5)
    with inject(plan):
        got = res.query_batch(us, rects)
    monkeypatch.undo()
    assert (got == idx.query_batch(us, rects)).all()
    assert calls == {"prune": 1, "scan": 1, "host": 0}
    assert res.last_report["degraded"].all()
    assert res.stats["fallback_batches"] == 1 and res.stats["retries"] == 1
    assert plan.fires_at("engine.query_batch") == 2


def test_corrupt_answer_on_the_engine(served):
    _, idx, eng, work, _, _ = served
    us, rects = work
    want = idx.query_batch(us, rects)
    with inject(FaultPlan(FaultSpec("engine.answer", kind="corrupt"))):
        got = eng.query_batch(us, rects)
    assert got[0] != want[0] and (got[1:] == want[1:]).all()
    assert (eng.query_batch(us, rects) == want).all()
