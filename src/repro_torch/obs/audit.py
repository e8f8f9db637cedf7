"""Online exactness auditor: shadow-replay a sample of served answers.

The repo's exactness story is build-time: tier-1 tests prove the device
path bit-identical to the host path on fixed seeds.  That proves the
*code*; it does not watch the *serving process* — a corrupted device
buffer, a bad degradation fallback, or an injected wrong answer (the
``engine.answer`` / ``kind="corrupt"`` fault in the reference's
:mod:`repro.resilience.faults`, not ported yet) would sail through
untested, because a **wrong answer is silent**: latency fine, status
``ok``, SLOs green.

:class:`ExactnessAuditor` closes that gap online.  The frontend hands
it every served batch (``observe`` — a seeded Bernoulli sample into a
bounded queue, near-free when disabled); a background drain (or a
synchronous :meth:`drain` in tests) **replays the sampled queries
through the bit-identical host path** (``TwoDReachIndex.query_batch``)
and diffs the answers.  A (lower-rate) sub-sample goes all the way to
the BFS oracle (:func:`repro_torch.core.oracle.rangereach_oracle_batch`),
guarding against the host index itself being wrong.  Any divergence:

* increments ``audit.divergences`` (and keeps the offending
  ``(u, rect, served, expected, trace_id)`` tuples, bounded);
* lands a note in the flight recorder's black-box ring;
* fires a ``audit-divergence`` flight-bundle trigger, so the spans /
  querylog / events around the wrong answer are frozen for replay.

Everything is seeded and deterministic: a fixed seed samples a fixed
subset of a fixed stream.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from . import metrics as _metrics
from .flight import FLIGHT

#: divergent answers retained for inspection (counters are unbounded)
MAX_KEPT_DIVERGENCES = 64


class ExactnessAuditor:
    """Sampled online diff of served answers vs the exact host path.

    Parameters
    ----------
    index:  host-path authority — anything with a bit-identical
            ``query_batch(us, rects) -> bool[n]`` (a
            ``TwoDReachIndex``, or ``QueryEngine._index``).
    graph:  optional :class:`~repro_torch.core.graph.GeosocialGraph` enabling
            the BFS-oracle sub-sample (``oracle_sample`` is ignored
            without it).
    sample: fraction of served queries shadow-replayed (0 disables:
            ``observe`` returns after one comparison).
    oracle_sample: fraction of *checked* queries also diffed against
            the BFS oracle.
    capacity: bounded pending queue; overflow drops oldest (counted).
    interval: background drain period (s) for :meth:`start`.
    seed:   Bernoulli sampling seed (deterministic audit of a
            deterministic stream).
    """

    def __init__(self, index, graph=None, sample: float = 0.05,
                 oracle_sample: float = 0.0, capacity: int = 4096,
                 interval: float = 0.05, seed: int = 0,
                 registry: Optional[_metrics.Registry] = None,
                 clock: Callable[[], float] = time.time):
        self.index = index
        self.graph = graph
        self.sample = float(sample)
        self.oracle_sample = float(oracle_sample)
        self.interval = float(interval)
        self.seed = int(seed)
        self._clock = clock
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque(
            maxlen=int(capacity))
        self.divergences: List[dict] = []
        reg = registry if registry is not None else _metrics.REGISTRY
        self._c_sampled = reg.counter("audit.sampled")
        self._c_checked = reg.counter("audit.checked")
        self._c_diverged = reg.counter("audit.divergences")
        self._c_oracle = reg.counter("audit.oracle_checked")
        self._c_dropped = reg.counter("audit.dropped")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- ingest (frontend hot path) -------------------------------------

    def observe(self, us, rects, answers, trace_ids=None) -> int:
        """Offer a served batch for auditing; returns how many queries
        were sampled into the pending queue.  ``sample <= 0`` exits
        after one float comparison — the disabled-overhead case."""
        if self.sample <= 0.0:
            return 0
        us = np.asarray(us)
        rects = np.asarray(rects, dtype=np.float64)
        answers = np.asarray(answers, dtype=bool)
        taken = 0
        with self._lock:
            for i in range(len(us)):
                if self._rng.random() >= self.sample:
                    continue
                if len(self._pending) == self._pending.maxlen:
                    self._c_dropped.inc()
                item = (int(us[i]), rects[i].copy(), bool(answers[i]),
                        int(trace_ids[i]) if trace_ids is not None else -1,
                        self._clock())
                self._pending.append(item)
                taken += 1
        if taken:
            self._c_sampled.inc(taken)
        return taken

    # -- replay ---------------------------------------------------------

    def drain(self) -> int:
        """Replay everything pending through the host path (and the
        oracle sub-sample); returns how many queries were checked.
        Thread-safe; the background drain calls this on ``interval``."""
        with self._lock:
            items = list(self._pending)
            self._pending.clear()
        if not items:
            return 0
        us = np.array([it[0] for it in items], dtype=np.int64)
        rects = np.stack([it[1] for it in items])
        served = np.array([it[2] for it in items], dtype=bool)
        expected = np.asarray(self.index.query_batch(us, rects),
                              dtype=bool)
        self._c_checked.inc(len(items))
        bad = served != expected
        if self.graph is not None and self.oracle_sample > 0.0:
            osel = np.array([self._rng.random() < self.oracle_sample
                             for _ in items], dtype=bool)
            if osel.any():
                from ..core.oracle import rangereach_oracle_batch
                oans = rangereach_oracle_batch(
                    self.graph, us[osel], rects[osel])
                self._c_oracle.inc(int(osel.sum()))
                obad = np.zeros(len(items), dtype=bool)
                obad[osel] = served[osel] != np.asarray(oans, dtype=bool)
                bad |= obad
        n_bad = int(bad.sum())
        if n_bad:
            self._record_divergences(items, expected, bad)
        return len(items)

    def _record_divergences(self, items, expected, bad) -> None:
        self._c_diverged.inc(int(bad.sum()))
        first = None
        for i in np.flatnonzero(bad):
            d = {"u": items[i][0], "rect": [float(v) for v in items[i][1]],
                 "served": bool(items[i][2]),
                 "expected": bool(expected[i]),
                 "trace_id": items[i][3], "t": items[i][4]}
            if first is None:
                first = d
            if len(self.divergences) < MAX_KEPT_DIVERGENCES:
                self.divergences.append(d)
            FLIGHT.note("audit.divergence", trace_id=d["trace_id"],
                        u=d["u"], served=d["served"],
                        expected=d["expected"])
        # one bundle per drain, carrying the first offender — the rest
        # are in the events ring the bundle freezes anyway
        FLIGHT.trigger("audit-divergence", detail=first)

    # -- background drain ----------------------------------------------

    def start(self) -> "ExactnessAuditor":
        """Start the background drain thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-audit", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.drain()

    def stop(self, final_drain: bool = True) -> None:
        """Stop the drain thread; by default drains what is pending so
        a short run still gets audited."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_drain:
            self.drain()

    # -- introspection --------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def report(self) -> dict:
        return {
            "sample": self.sample,
            "oracle_sample": self.oracle_sample,
            "sampled": int(self._c_sampled.value),
            "checked": int(self._c_checked.value),
            "oracle_checked": int(self._c_oracle.value),
            "divergences": int(self._c_diverged.value),
            "dropped": int(self._c_dropped.value),
            "pending": self.pending(),
            "kept": list(self.divergences),
        }
