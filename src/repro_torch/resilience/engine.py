"""Resilient engine wrapper: retries, breakers, exact degradation (the
port of ``repro.resilience.engine``).

:class:`ResilientEngine` wraps a device serving engine (the port's
single-device ``QueryEngine``, or any engine with its methods and a
``shard_of``, as the reference's cluster ``ShardedEngine`` has) **plus
the host index it was built from**, and turns untyped infrastructure failures into one of
two outcomes — the exact answer, or a typed error:

* **bounded retry** — a failed device call is retried up to
  ``RetryPolicy.max_attempts`` with exponential backoff + decorrelated
  jitter, never sleeping past the request's :class:`Deadline` budget;
* **circuit breakers** — consecutive failures open the engine's
  breaker (and a :class:`~repro_torch.resilience.errors.ShardDropout` opens
  only the dropped shard's), so a dead device degrades in O(1) instead
  of paying the full retry schedule per batch;
* **exact degradation** — whatever the device path cannot answer
  (breaker open, retries exhausted, deadline spent) is answered by the
  **bit-identical host descent** of the same index.  The engines are
  bit-identical to ``query_host`` by construction (their parity tests
  hold every path to the host index), so degradation changes latency,
  never answers.  Downgrades are
  counted (``resilience.fallback_*``) and their latency lands in the
  ``resilience.degraded_query_us`` histogram, not silently mixed into
  the healthy numbers.  With ``degraded_path="two_phase"`` the
  degradation target is the engine's retained two-phase device path
  (``*_batch_two_phase``) instead of host NumPy — the right lever when
  only the *fused* serving path is suspect (it shares no prune/compact
  trace with two-phase), while ``"host"`` stays the refuge from device
  failures generally; classes without a two-phase variant (kNN,
  polygon) always degrade to host.

Per-shard degradation: when the wrapped engine exposes ``shard_of``
(the cluster engine does), a shard whose breaker is open only reroutes
*its own* queries to the host path — the healthy shards keep serving on
device.  Shard breakers are created lazily on the first dropout, so the
healthy fast path never pays a routing pass.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import span
from ..obs import trace_context
from ..obs.flight import FLIGHT
from ..obs.tracer import TRACER, _now_ns
from .breaker import BreakerPolicy, CircuitBreaker, CLOSED
from .errors import ShardDropout
from .retry import Deadline, RetryPolicy

#: trace ids carried per flight-recorder note (the full lists live in
#: ``last_report``; the black-box ring stays bounded per event)
_NOTE_ID_CAP = 32


def _ids_for(tids, mask) -> Optional[list]:
    """The trace ids the boolean ``mask`` selects, or None without an
    ambient trace context of matching length."""
    if tids is None:
        return None
    return [tids[i] for i in np.flatnonzero(mask)]


class ResilientEngine:
    """Fault-tolerant facade over a device engine + its host index.

    Parameters
    ----------
    engine:   anything with ``query_batch(us, rects)`` — the device
              path (``QueryEngine`` / ``ShardedEngine``); analytics
              classes are wrapped too when the engine exposes them.
    index:    the built index the engine serves — its host path is the
              bit-identical degradation target (``TwoDReachIndex
              .query_batch`` and the ``repro_torch.queries`` host
              descents).
    retry:    transient-failure schedule; default ``RetryPolicy()``.
    breaker:  breaker thresholds (shared by the engine-level breaker
              and every lazily created shard breaker).
    name:     metric prefix (``resilience.breaker.<name>.*``).
    degraded_path: ``"host"`` (default) degrades to the host descent;
              ``"two_phase"`` degrades to the engine's retained
              two-phase device path where it exists (see module
              docstring), host otherwise.
    clock / sleep / seed: injectable time + jitter sources so chaos
              tests replay deterministic schedules without wall sleeps.
    """

    #: the frontend passes per-batch deadline budgets when it sees this
    supports_deadline = True

    def __init__(self, engine, index,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 name: str = "engine",
                 degraded_path: str = "host",
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int = 0,
                 registry: Optional[obs_metrics.Registry] = None):
        if degraded_path not in ("host", "two_phase"):
            raise ValueError(f"unknown degraded_path {degraded_path!r}")
        self.engine = engine
        self.index = index
        self.degraded_path = degraded_path
        self.retry = retry or RetryPolicy()
        self.breaker_policy = breaker or BreakerPolicy()
        self.name = name
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._reg = registry if registry is not None else obs_metrics.REGISTRY
        self._breaker = CircuitBreaker(
            name, self.breaker_policy, clock=clock, registry=self._reg)
        self._shard_breakers: Dict[int, CircuitBreaker] = {}
        self._shard_of = getattr(engine, "shard_of", None)
        self.stats: Dict[str, int] = {
            "device_batches": 0, "retries": 0, "device_failures": 0,
            "fallback_batches": 0, "fallback_queries": 0,
        }
        self._c_retries = self._reg.counter("resilience.retries")
        self._c_failures = self._reg.counter("resilience.device_failures")
        self._c_fb_batches = self._reg.counter("resilience.fallback_batches")
        self._c_fb_queries = self._reg.counter("resilience.fallback_queries")
        self._h_degraded = self._reg.histogram("resilience.degraded_query_us")
        #: per-batch serving report, rewritten by every ``*_batch`` call:
        #: {"degraded": (B,) bool — answered by the host fallback,
        #:  "retries": device attempts burned beyond the first,
        #:  "attempts": (B,) int — device attempts that *included* each
        #:  query (0 = never reached the device),
        #:  "trace_ids": the ambient per-request trace ids when a
        #:  :mod:`~repro_torch.obs.trace_context` scope of matching length is
        #:  active (else None),
        #:  "retried_trace_ids" / "degraded_trace_ids": the specific
        #:  requests retries and degradations are attributed to}.  The
        #: frontend copies it into the structured query log so workload
        #: analytics can split healthy vs degraded traffic and flight
        #: bundles can resolve a trace id to its serving decisions.
        self.last_report: Dict[str, object] = {
            "degraded": np.zeros(0, dtype=bool), "retries": 0,
            "attempts": np.zeros(0, dtype=np.int32), "trace_ids": None,
            "retried_trace_ids": [], "degraded_trace_ids": []}

    # ------------------------------------------------------------------
    # breaker surface
    # ------------------------------------------------------------------

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def shard_breaker(self, shard: int) -> CircuitBreaker:
        """The (lazily created) breaker guarding one shard."""
        br = self._shard_breakers.get(int(shard))
        if br is None:
            br = CircuitBreaker(
                f"{self.name}.shard{int(shard)}", self.breaker_policy,
                clock=self._clock, registry=self._reg)
            self._shard_breakers[int(shard)] = br
        return br

    def trip(self) -> None:
        """Force full degradation: open the engine breaker (ops switch;
        the ``--degraded`` bench arm measures through this)."""
        self._breaker.trip()

    @property
    def degraded(self) -> bool:
        """True when *some* breaker currently refuses device traffic."""
        return self._breaker.state != CLOSED or any(
            b.state != CLOSED for b in self._shard_breakers.values())

    # n_compiles passthrough keeps the frontend's steady-state
    # no-recompile assertions meaningful through the wrapper
    @property
    def n_compiles(self) -> int:
        return getattr(self.engine, "n_compiles", 0)

    # ------------------------------------------------------------------
    # grant / settle around one device attempt
    # ------------------------------------------------------------------

    def _grants(self, us: np.ndarray, pending: np.ndarray):
        """(device-eligible mask, granted breakers) for one attempt.
        A granted breaker must be settled (success / failure /
        release) by the caller."""
        if not self._breaker.allow():
            return np.zeros(len(us), dtype=bool), []
        granted = [self._breaker]
        mask = pending.copy()
        if self._shard_breakers and self._shard_of is not None:
            shards = np.asarray(self._shard_of(us))
            for s, br in list(self._shard_breakers.items()):
                mine = shards == s
                if not (mask & mine).any():
                    continue
                if br.allow():
                    granted.append(br)
                else:
                    mask &= ~mine
        return mask, granted

    def _settle_failure(self, granted, exc: BaseException) -> None:
        """Attribute one failed attempt to the right failure domain."""
        self.stats["device_failures"] += 1
        self._c_failures.inc()
        if isinstance(exc, ShardDropout):
            # the dropped shard is the failing domain; everyone else's
            # grant went unproven — release, don't score
            dropped = self.shard_breaker(exc.shard)
            dropped.record_failure()
            for br in granted:
                if br is not dropped:
                    br.release()
        else:
            self._breaker.record_failure()
            for br in granted:
                if br is not self._breaker:
                    br.release()

    # ------------------------------------------------------------------
    # boolean RangeReach (per-shard splitting)
    # ------------------------------------------------------------------

    def query_batch(self, us: np.ndarray, rects: np.ndarray,
                    deadline: Optional[float] = None) -> np.ndarray:
        """Batched RangeReach: exact on every path.  ``deadline`` is a
        seconds budget for the whole call (retry sleeps never exceed
        it; on exhaustion the remainder degrades to host)."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        rects = np.asarray(rects, dtype=np.float32).reshape(B, -1)
        dl = Deadline(deadline, clock=self._clock)
        out = np.zeros(B, dtype=bool)
        pending = np.ones(B, dtype=bool)
        tids = trace_context.current_ids()
        if tids is not None and len(tids) != B:
            tids = None      # ambient scope is not per-query for this batch
        attempts_arr = np.zeros(B, dtype=np.int32)
        report = {"degraded": np.zeros(B, dtype=bool), "retries": 0,
                  "attempts": attempts_arr, "trace_ids": tids,
                  "retried_trace_ids": [], "degraded_trace_ids": []}
        self.last_report = report
        attempts, prev_sleep = 0, 0.0
        while attempts < self.retry.max_attempts and not dl.expired():
            mask, granted = self._grants(us, pending)
            if not mask.any():
                for br in granted:
                    br.release()
                break
            attempts += 1
            attempts_arr[mask] += 1
            try:
                got = self.engine.query_batch(us[mask], rects[mask])
            except Exception as e:  # noqa: BLE001 — converted to fallback
                self._settle_failure(granted, e)
                if attempts < self.retry.max_attempts and not dl.expired():
                    prev_sleep = self.retry.next_backoff(
                        prev_sleep, self._rng)
                    self.stats["retries"] += 1
                    report["retries"] += 1
                    self._c_retries.inc()
                    self._note_decision("retry", mask, tids, report,
                                        "retried_trace_ids",
                                        attempt=attempts, error=type(e).__name__)
                    s = min(prev_sleep, max(dl.remaining(), 0.0))
                    if s > 0:
                        self._sleep(s)
                continue
            for br in granted:
                br.record_success()
            out[mask] = np.asarray(got, dtype=bool)
            pending &= ~mask
            self.stats["device_batches"] += 1
            if not pending.any():
                return out
            # only shard-excluded queries remain: degrade just those
            break
        if pending.any():
            report["degraded"] = pending.copy()
            self._note_decision("degraded", pending, tids, report,
                                "degraded_trace_ids",
                                path=self.degraded_path)
            target = self._degrade_target(
                "query_batch", self.index.query_batch)
            out[pending] = self._host_fallback(
                lambda sel: target(us[sel], rects[sel]), pending)
        return out

    def _note_decision(self, what: str, mask: np.ndarray, tids, report,
                       report_key: str, **fields) -> None:
        """Attribute one retry/degradation decision to the specific
        trace ids it affects: extend ``last_report[report_key]``, land a
        black-box note, and (tracing enabled) drop an instant event next
        to the stage spans."""
        ids = _ids_for(tids, mask)
        if ids is not None:
            report[report_key].extend(ids)
        note = dict(fields, n=int(mask.sum()))
        if ids is not None:
            note["trace_ids"] = ids[:_NOTE_ID_CAP]
        FLIGHT.note(f"engine.{what}", **note)
        if TRACER.enabled:
            TRACER.record(f"resilience.{what}", "resilience",
                          _now_ns(), 0, note)

    def _degrade_target(self, method: str, host_fn):
        """The degradation callable for one query class: the engine's
        retained two-phase path when selected and present, else host."""
        if self.degraded_path == "two_phase":
            fn = getattr(self.engine, f"{method}_two_phase", None)
            if fn is not None:
                return fn
        return host_fn

    def _host_fallback(self, call, pending: np.ndarray):
        """Serve the degraded remainder on the exact host path, counted
        and latency-attributed separately from healthy traffic."""
        n = int(pending.sum())
        t0 = time.perf_counter()
        # the degraded serve is itself a span: a breaker-open window
        # where no device engine runs must still leave causal evidence
        # of who served each trace (the flight replay requires it)
        with span("resilience.degraded_serve", cat="resilience", n=n):
            got = call(pending)
        self._h_degraded.record(
            (time.perf_counter() - t0) * 1e6 / max(n, 1))
        self.stats["fallback_batches"] += 1
        self.stats["fallback_queries"] += n
        self._c_fb_batches.inc()
        self._c_fb_queries.inc(n)
        return got

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])

    # ------------------------------------------------------------------
    # analytics classes (whole-batch retry + fallback)
    # ------------------------------------------------------------------

    def _whole_batch(self, method: str, n: int, dev_call, host_call,
                     deadline: Optional[float]):
        """Generic wrapper for the structured-result classes: retry the
        device call whole, degrade the whole batch to the host descent
        (structured results do not merge across a per-shard split)."""
        dl = Deadline(deadline, clock=self._clock)
        attempts, prev_sleep = 0, 0.0
        whole = np.ones(max(n, 0), dtype=bool)
        tids = trace_context.current_ids()
        if tids is not None and len(tids) != n:
            tids = None
        attempts_arr = np.zeros(max(n, 0), dtype=np.int32)
        report = {"degraded": np.zeros(max(n, 0), dtype=bool), "retries": 0,
                  "attempts": attempts_arr, "trace_ids": tids,
                  "retried_trace_ids": [], "degraded_trace_ids": []}
        self.last_report = report
        have_dev = hasattr(self.engine, method)
        while have_dev and attempts < self.retry.max_attempts \
                and not dl.expired():
            if not self._breaker.allow():
                break
            attempts += 1
            attempts_arr += 1
            try:
                got = dev_call()
            except Exception as e:  # noqa: BLE001 — converted to fallback
                self._settle_failure([self._breaker], e)
                if attempts < self.retry.max_attempts and not dl.expired():
                    prev_sleep = self.retry.next_backoff(
                        prev_sleep, self._rng)
                    self.stats["retries"] += 1
                    report["retries"] += 1
                    self._c_retries.inc()
                    self._note_decision("retry", whole, tids, report,
                                        "retried_trace_ids",
                                        attempt=attempts, method=method,
                                        error=type(e).__name__)
                    s = min(prev_sleep, max(dl.remaining(), 0.0))
                    if s > 0:
                        self._sleep(s)
                continue
            self._breaker.record_success()
            self.stats["device_batches"] += 1
            return got
        report["degraded"] = np.ones(max(n, 0), dtype=bool)
        self._note_decision("degraded", report["degraded"], tids, report,
                            "degraded_trace_ids", method=method,
                            path=self.degraded_path)
        return self._host_fallback(lambda _sel: host_call(),
                                   np.ones(max(n, 1), dtype=bool))

    def count_batch(self, us, rects, deadline: Optional[float] = None):
        from ..queries.host import range_count_host  # deferred: no cycle

        us = np.asarray(us, dtype=np.int64)
        degrade = self._degrade_target(
            "count_batch",
            lambda u, r: range_count_host(self.index, u, r))
        return self._whole_batch(
            "count_batch", len(us),
            lambda: self.engine.count_batch(us, rects),
            lambda: degrade(us, rects),
            deadline)

    def collect_batch(self, us, rects, k: int,
                      deadline: Optional[float] = None):
        from ..queries.host import range_collect_host  # deferred

        us = np.asarray(us, dtype=np.int64)
        degrade = self._degrade_target(
            "collect_batch",
            lambda u, r, kk: range_collect_host(self.index, u, r, kk))
        return self._whole_batch(
            "collect_batch", len(us),
            lambda: self.engine.collect_batch(us, rects, k),
            lambda: degrade(us, rects, k),
            deadline)

    def knn_batch(self, us, points, k: int,
                  deadline: Optional[float] = None):
        from ..queries.knn import knn_reach_host  # deferred

        us = np.asarray(us, dtype=np.int64)
        return self._whole_batch(
            "knn_batch", len(us),
            lambda: self.engine.knn_batch(us, points, k),
            lambda: knn_reach_host(self.index, us, points, k),
            deadline)

    def polygon_batch(self, us, polygons,
                      deadline: Optional[float] = None):
        from ..queries.host import polygon_reach_host  # deferred

        us = np.asarray(us, dtype=np.int64)
        return self._whole_batch(
            "polygon_batch", len(us),
            lambda: self.engine.polygon_batch(us, polygons),
            lambda: polygon_reach_host(self.index, us, polygons),
            deadline)
