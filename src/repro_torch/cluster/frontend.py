"""Micro-batching frontend: request queue -> engine-sized batches (the
port of ``repro.cluster.frontend``).

A serving node receives single RangeReach requests; the engines want
batches (they pad to power-of-two buckets, and per-query overhead
amortises across a tile).  :class:`Frontend` sits between:

* ``submit(u, rect)`` enqueues a request onto a **bounded** queue
  (backpressure: submit blocks while ``max_queue`` requests are
  pending) and returns a future;
* a scheduler thread flushes the queue into the engine on
  **deadline-or-full**: as soon as ``max_batch`` requests are pending,
  or when the oldest pending request has waited ``max_delay`` seconds —
  whichever comes first.  Flushed batches are at most ``max_batch``
  (keep it a power of two so steady state re-uses the engine's compiled
  buckets), and the engine's own bucket padding absorbs ragged tails.

The frontend is engine-agnostic: anything with a
``query_batch(us, rects) -> bool array`` works — the single-device
``QueryEngine``, the cluster ``ShardedEngine``, or a host index.
``warmup`` serves every batch bucket the flush policy can produce, so a
steady-state stream serves no new shape (asserted in tests via the
engine's ``n_compiles`` introspection).  The scheduler thread launches
the engine's kernels; the engines name the device of every tensor, so
nothing in the thread depends on its current CUDA device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..kernels.range_query.layout import TB
from ..obs import metrics as obs_metrics
from ..obs import querylog as obs_querylog
from ..obs import span
from ..obs import trace_context
from ..obs.flight import FLIGHT
from ..obs.tracer import TRACER as _TRACER
from ..resilience.errors import (
    DeadlineExceeded,
    FrontendClosed,
    Overloaded,
    QueueFull,
)
from ..resilience.faults import fault_point


class Frontend:
    """Deadline-or-full micro-batch scheduler in front of a query engine.

    Parameters
    ----------
    engine:    anything with ``query_batch(us, rects)``.
    max_batch: flush as soon as this many requests are pending (keep it
               a power of two to reuse the engine's compiled buckets).
    max_delay: flush when the oldest pending request is this old (s).
    max_queue: bounded-queue capacity; ``submit`` blocks above it.
    metrics:   a :class:`repro_torch.obs.Registry` for the frontend's gauges
               (queue depth, batch occupancy), counters (flushes by
               reason, deadline misses, backpressure blocks) and wait /
               lateness histograms; defaults to the global registry.
    query_log: a :class:`repro_torch.obs.QueryLog` receiving one
               structured record per served request; ``None`` uses the
               global log when ``repro_torch.obs`` is enabled (and skips logging when it
               is not, keeping the disabled fast path flat).
    clock:     monotonic time source (seconds) — injectable so load
               tests drive deadlines deterministically with a fake
               clock instead of sleeping.
    deadline_grace: lateness tolerance (s) before a flush that starts
               after ``enqueue + max_delay`` counts as a deadline miss;
               defaults to ``max_delay / 4`` (absorbs timer wakeup
               jitter without hiding real scheduler stalls).
    auditor:   optional :class:`repro_torch.obs.ExactnessAuditor`; every
               served batch is offered for sampled shadow-replay
               (``observe`` is near-free when sampling is disabled).
    slo:       default per-request deadline budget (s).  When a request
               carries a budget (this default, or an explicit
               ``deadline=`` on submit), admission control sheds it
               with :class:`Overloaded` whenever the projected queue
               wait (EWMA of recent batch service time × batches ahead,
               plus the flush delay) already exceeds the budget —
               failing fast beats queueing work that is doomed to
               expire.  ``None`` (default) disables shedding.

    Every *accepted* request resolves: with the exact answer, or with a
    typed error (:class:`DeadlineExceeded` if its budget expired in the
    queue, :class:`FrontendClosed` on ``close(drain=False)``, or the
    engine's own exception latched onto the batch).  The scheduler
    thread survives any engine failure.
    """

    def __init__(self, engine, max_batch: int = 256,
                 max_delay: float = 2e-3, max_queue: int = 8192,
                 metrics: Optional["obs_metrics.Registry"] = None,
                 query_log: Optional["obs_querylog.QueryLog"] = None,
                 clock: Optional[Callable[[], float]] = None,
                 deadline_grace: Optional[float] = None,
                 slo: Optional[float] = None,
                 auditor=None):
        if max_batch < 1 or max_queue < max_batch:
            raise ValueError(
                f"need 1 <= max_batch <= max_queue, got "
                f"{max_batch}/{max_queue}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.max_queue = int(max_queue)
        self.metrics = metrics if metrics is not None else obs_metrics.REGISTRY
        self._query_log = query_log
        self._clock = clock if clock is not None else time.monotonic
        self._auditor = auditor
        self.deadline_grace = (float(deadline_grace)
                               if deadline_grace is not None
                               else self.max_delay / 4.0)
        self.slo = None if slo is None else float(slo)
        self._cond = threading.Condition()
        self._rect_len = None                 # fixed by the first submit
        # (u, rect, future, t_enq, t_deadline | None, TraceContext)
        self._pending: List[tuple] = []
        self._inflight = False
        self._closed = False
        self._force = False
        self._ewma_batch_s = 0.0              # recent batch service time
        self.stats: Dict[str, float] = {
            "n_requests": 0, "n_batches": 0, "n_flush_full": 0,
            "n_flush_deadline": 0, "n_flush_forced": 0,
            "batched_queries": 0, "max_pending_seen": 0,
            "n_deadline_misses": 0, "n_submit_blocked": 0,
            "n_shed": 0, "n_queue_full_timeouts": 0,
            "n_deadline_dropped": 0,
        }
        m = self.metrics
        self._g_depth = m.gauge("frontend.queue_depth")
        self._g_occupancy = m.gauge("frontend.batch_occupancy")
        self._g_inflight = m.gauge("frontend.inflight")
        self._c_requests = m.counter("frontend.requests")
        self._c_misses = m.counter("frontend.deadline_misses")
        self._c_blocked = m.counter("frontend.submit_blocked")
        self._c_shed = m.counter("frontend.shed")
        self._c_queue_full = m.counter("frontend.queue_full_timeouts")
        self._c_dl_dropped = m.counter("frontend.deadline_dropped")
        self._h_wait = m.histogram("frontend.queue_wait_us")
        self._h_lateness = m.histogram("frontend.flush_lateness_us")
        self._h_batch = m.histogram("frontend.batch_size")
        self._flush_counters = {
            r: m.counter(f"frontend.{r}")
            for r in ("n_flush_full", "n_flush_deadline", "n_flush_forced")
        }
        self._thread = threading.Thread(
            target=self._run, name="rangereach-torch-frontend", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------

    def submit(self, u: int, rect, timeout: Optional[float] = None,
               deadline: Optional[float] = None) -> "Future[bool]":
        """Enqueue one request; returns a future resolving to the answer.

        Blocks while the queue is at capacity (backpressure); with
        ``timeout=`` the block is bounded and expiry raises
        :class:`QueueFull` instead.  ``deadline=`` is this request's
        budget in seconds from now (default: the frontend ``slo``);
        requests whose budget expires while queued resolve to
        :class:`DeadlineExceeded`, and requests whose budget is already
        doomed by the projected queue wait are shed up front with
        :class:`Overloaded`.  Raises :class:`FrontendClosed` after
        :meth:`close`."""
        fut: Future = Future()
        rect = np.asarray(rect, dtype=np.float32).ravel()
        budget = self.slo if deadline is None else float(deadline)
        with self._cond:
            # reject shape mismatches in the caller's thread — a ragged
            # rect must never reach batch assembly on the scheduler
            if self._rect_len is None:
                self._rect_len = len(rect)
            elif len(rect) != self._rect_len:
                raise ValueError(
                    f"rect has {len(rect)} coords, expected "
                    f"{self._rect_len}")
            if self._closed:
                raise FrontendClosed("Frontend is closed")
            if budget is not None and budget < self._projected_wait():
                self.stats["n_shed"] += 1
                self._c_shed.inc()
                raise Overloaded(
                    f"projected queue wait {self._projected_wait():.4f}s "
                    f"exceeds deadline budget {budget:.4f}s")
            if len(self._pending) >= self.max_queue and not self._closed:
                self.stats["n_submit_blocked"] += 1
                self._c_blocked.inc()
                t_end = (None if timeout is None
                         else self._clock() + float(timeout))
                while (len(self._pending) >= self.max_queue
                       and not self._closed):
                    if t_end is None:
                        self._cond.wait()
                        continue
                    rem = t_end - self._clock()
                    if rem <= 0:
                        self.stats["n_queue_full_timeouts"] += 1
                        self._c_queue_full.inc()
                        raise QueueFull(
                            f"queue still at capacity "
                            f"({self.max_queue}) after {timeout}s")
                    self._cond.wait(timeout=rem)
            if self._closed:
                raise FrontendClosed("Frontend is closed")
            t_enq = self._clock()
            t_dl = None if budget is None else t_enq + budget
            # admission is where the causal trace starts: mint the
            # request's TraceContext here so every downstream span,
            # querylog row and exemplar joins on its id.  Minting sits
            # behind the tracer gate — disabled serving pays one
            # attribute check and shares the null context.
            if _TRACER.enabled:
                ctx = trace_context.mint(u=int(u), query_class="reach",
                                         t_admit=t_enq, deadline=budget)
            else:
                ctx = trace_context.NULL
            fut.trace_id = ctx.trace_id
            self._pending.append((int(u), rect, fut, t_enq, t_dl, ctx))
            self.stats["n_requests"] += 1
            self._c_requests.inc()
            depth = len(self._pending)
            self._g_depth.set(depth)
            self.stats["max_pending_seen"] = max(
                self.stats["max_pending_seen"], depth)
            self._cond.notify_all()
        return fut

    def _projected_wait(self) -> float:
        """Expected queue wait for a request arriving now (held lock):
        the flush delay plus one EWMA batch service time per batch that
        must drain first (inflight + queued-ahead + its own)."""
        batches_ahead = (1 if self._inflight else 0) \
            + len(self._pending) // self.max_batch + 1
        return self.max_delay + batches_ahead * self._ewma_batch_s

    def submit_many(self, us: Sequence[int], rects,
                    timeout: Optional[float] = None) -> np.ndarray:
        """Submit a request stream one by one and gather the answers —
        the convenience used by benchmarks and examples."""
        rects = np.asarray(rects, dtype=np.float32)
        futs = [self.submit(u, r) for u, r in zip(us, rects)]
        return np.array([f.result(timeout=timeout) for f in futs],
                        dtype=bool)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Force-dispatch everything pending and wait until served."""
        with self._cond:
            self._force = True
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: not self._pending and not self._inflight,
                timeout=timeout)
            # don't leak the flag onto requests submitted after the
            # flush completes (they should wait for deadline-or-full)
            self._force = False

    def warmup(self, us: np.ndarray, rects: np.ndarray) -> None:
        """Serve every batch bucket the flush policy can produce once,
        using a representative workload (tiled up to ``max_batch``)."""
        us = np.asarray(us, dtype=np.int64)
        rects = np.asarray(rects, dtype=np.float32).reshape(len(us), -1)
        reps = -(-self.max_batch // max(len(us), 1))
        us = np.tile(us, reps)
        rects = np.tile(rects, (reps, 1))
        b = TB
        while True:
            k = min(b, self.max_batch)
            self.engine.query_batch(us[:k], rects[:k])
            if b >= self.max_batch:
                break
            b <<= 1

    def close(self, timeout: Optional[float] = None,
              drain: bool = True) -> None:
        """Stop accepting requests and stop the scheduler thread.

        ``drain=True`` (default) serves everything pending first;
        ``drain=False`` fails every pending future with
        :class:`FrontendClosed` and stops as soon as any inflight batch
        finishes — either way no accepted future is left unresolved."""
        failed: List[tuple] = []
        with self._cond:
            self._closed = True
            if not drain:
                failed = self._pending[:]
                self._pending.clear()
                self._g_depth.set(0)
            self._cond.notify_all()
        if failed:
            self._fail_batch(
                failed, FrontendClosed("Frontend closed without drain"))
        self._thread.join(timeout=timeout)

    @staticmethod
    def _fail_batch(batch: List[tuple], exc: BaseException) -> None:
        for item in batch:
            try:
                item[2].set_exception(exc)
            except InvalidStateError:       # client cancelled meanwhile
                pass

    def __enter__(self) -> "Frontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def mean_batch(self) -> float:
        b = self.stats["n_batches"]
        return self.stats["batched_queries"] / b if b else 0.0

    # ------------------------------------------------------------------
    # scheduler thread
    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._pending:
                        n = len(self._pending)
                        deadline = self._pending[0][3] + self.max_delay
                        now = self._clock()
                        if n >= self.max_batch:
                            reason = "n_flush_full"
                            break
                        if self._force or self._closed:
                            reason = "n_flush_forced"
                            break
                        if now >= deadline:
                            reason = "n_flush_deadline"
                            break
                        self._cond.wait(timeout=deadline - now)
                    elif self._closed:
                        return
                    else:
                        self._force = False
                        self._cond.wait()
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
                # flush lateness: how far past the oldest request's
                # deadline this batch starts serving; beyond the grace
                # it is a deadline miss (the scheduler could not keep
                # the latency SLO — usually an inflight batch ahead)
                lateness = max(0.0, self._clock() - deadline)
                self._g_depth.set(len(self._pending))
                if not self._pending:
                    self._force = False
                self._inflight = True
                self._g_inflight.set(1)
                self._cond.notify_all()       # queue space freed
            self._h_lateness.record(lateness * 1e6)
            if lateness > self.deadline_grace:
                self.stats["n_deadline_misses"] += 1
                self._c_misses.inc()
            t_serve = self._clock()
            try:
                self._serve(batch, reason)
            except BaseException as e:  # noqa: BLE001 — last-resort latch
                # _serve latches engine errors itself; this guard means
                # even a failure in its own bookkeeping cannot strand
                # futures or kill the scheduler thread
                self._fail_batch(batch, e)
            with self._cond:
                dt = self._clock() - t_serve
                self._ewma_batch_s = (dt if self._ewma_batch_s == 0.0
                                      else 0.2 * dt
                                      + 0.8 * self._ewma_batch_s)
                self._inflight = False
                self._g_inflight.set(0)
                self._cond.notify_all()

    def _serve(self, batch: List[tuple], reason: str) -> None:
        # budget-expired requests are dropped at the flush boundary —
        # serving them would spend engine time on answers nobody can
        # use within their SLO
        now = self._clock()
        expired = [b for b in batch
                   if b[4] is not None and now > b[4]]
        if expired:
            batch = [b for b in batch
                     if b[4] is None or now <= b[4]]
            self.stats["n_deadline_dropped"] += len(expired)
            self._c_dl_dropped.inc(len(expired))
            # attribute the drops: the black box keeps which requests
            # died in the queue (their traces end here, by design)
            FLIGHT.note("frontend.deadline_dropped",
                        trace_ids=[b[5].trace_id for b in expired])
            self._fail_batch(expired, DeadlineExceeded(
                "deadline budget expired while queued"))
            if not batch:
                return
        ctxs = [b[5] for b in batch]
        try:
            # assembly inside the latch too: no input may ever kill the
            # scheduler thread and strand the batch's futures.  The
            # trace scope makes the batch's ids ambient: every span the
            # engine stack opens below (padder, megakernel, shard
            # fan-out, dynamic probes) tags itself with them, and the
            # resilient engine attributes retries/degradations to them.
            # (One gate check per batch: disabled serving skips the
            # scope push — the contexts are all NULL then anyway.)
            sc = (trace_context.scope(ctxs) if _TRACER.enabled
                  else contextlib.nullcontext())
            with sc, \
                    span("frontend.flush", cat="frontend", n=len(batch),
                         reason=reason):
                fault_point("frontend.queue_stall", n=len(batch))
                us = np.array([b[0] for b in batch], dtype=np.int64)
                rects = np.stack([b[1] for b in batch])
                fault_point("frontend.flush", n=len(batch))
                if getattr(self.engine, "supports_deadline", False):
                    dls = [b[4] - now for b in batch if b[4] is not None]
                    ans = self.engine.query_batch(
                        us, rects,
                        deadline=min(dls) if dls else None)
                else:
                    ans = self.engine.query_batch(us, rects)
        except BaseException as e:  # latch the error onto every future
            self._fail_batch(batch, e)
            return
        self.stats["n_batches"] += 1
        self.stats[reason] += 1
        self.stats["batched_queries"] += len(batch)
        self._flush_counters[reason].inc()
        self._h_batch.record(len(batch))
        self._g_occupancy.set(len(batch) / self.max_batch)
        now = self._clock()
        tracing = _TRACER.enabled
        for (_, _, fut, t_enq, _, ctx), a in zip(batch, ans):
            # queue-wait exemplars join the p99 quantile back to real
            # requests; only retained while tracing (reservoir writes
            # stay off the disabled fast path)
            self._h_wait.record(
                (now - t_enq) * 1e6,
                exemplar=ctx.trace_id if tracing else None)
            try:
                fut.set_result(bool(a))
            except InvalidStateError:       # client cancelled meanwhile
                pass
        self._log_batch(us, rects, ans, batch, now)
        if self._auditor is not None:
            self._auditor.observe(us, rects, ans,
                                  trace_ids=[c.trace_id for c in ctxs])

    def _log_batch(self, us, rects, ans, batch, now) -> None:
        """Structured query-log records for a served batch — explicit
        ``query_log`` always logs; otherwise the global log, only while
        ``repro_torch.obs`` is enabled."""
        qlog = self._query_log
        if qlog is None:
            if not _TRACER.enabled:
                return
            qlog = obs_querylog.QUERY_LOG
        shard_of = getattr(self.engine, "shard_of", None)
        shards = (shard_of(us) if shard_of is not None
                  else np.zeros(len(us), dtype=np.int64))
        vclass = obs_querylog.vertex_class_of(self.engine, us)
        lats = [now - b[3] for b in batch]
        # engine-reported serving status (resilient engines rewrite
        # last_report per batch): healthy vs exact-host-degraded split
        statuses, retries, attempts = "ok", 0, None
        rep = getattr(self.engine, "last_report", None)
        if rep is not None:
            mask = np.asarray(rep.get("degraded", ()), dtype=bool)
            if len(mask) == len(us):
                statuses = np.where(mask, "degraded", "ok")
            retries = int(rep.get("retries", 0))
            att = rep.get("attempts")
            if att is not None and len(att) == len(us):
                attempts = att
        qlog.record_batch("reach", vclass, rects, shards, lats,
                          np.asarray(ans).astype(np.int64), us=us,
                          statuses=statuses, retries=retries,
                          trace_ids=[b[5].trace_id for b in batch],
                          attempts=attempts)
