"""Circuit breaker: closed → open → half-open with a single probe (the
port of ``repro.resilience.breaker``).

A breaker guards one failure domain (a whole engine, or one shard of a
sharded engine).  Closed, calls flow; ``failure_threshold`` consecutive
failures open it.  Open, calls are refused outright — the resilient
engine degrades to the exact host path instead of hammering a dead
device — until ``reset_timeout_s`` elapses, when the breaker turns
half-open and admits exactly **one probe** call at a time:
``half_open_successes`` consecutive probe successes close it, any probe
failure re-opens it (restarting the timeout).

State changes are decided against an injectable monotonic clock (chaos
tests step time deterministically) and reported as a registry gauge
(``resilience.breaker.<name>.state``: 0 closed / 1 open / 2 half-open)
plus open/close transition counters.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from ..obs import metrics as obs_metrics

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    failure_threshold: int = 3      # consecutive failures that open
    reset_timeout_s: float = 1.0    # open -> half-open after this
    half_open_successes: int = 1    # probe successes that close

    def __post_init__(self):
        if self.failure_threshold < 1 or self.half_open_successes < 1:
            raise ValueError("thresholds must be >= 1")
        if self.reset_timeout_s < 0:
            raise ValueError("reset_timeout_s must be >= 0")


class CircuitBreaker:
    """One failure domain's breaker; thread-safe.

    Call :meth:`allow` before attempting; when it returns True the
    caller *must* report the outcome via :meth:`record_success` /
    :meth:`record_failure` (a half-open probe slot stays taken until
    its outcome arrives, so concurrent callers during a probe are
    refused rather than stampeding the recovering domain).
    """

    def __init__(self, name: str, policy: Optional[BreakerPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[obs_metrics.Registry] = None):
        self.name = name
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0           # consecutive, while closed
        self._probe_successes = 0    # consecutive, while half-open
        self._probe_inflight = False
        self._opened_at = 0.0
        reg = registry if registry is not None else obs_metrics.REGISTRY
        self._g_state = reg.gauge(f"resilience.breaker.{name}.state")
        self._c_opened = reg.counter(f"resilience.breaker.{name}.opened")
        self._c_closed = reg.counter(f"resilience.breaker.{name}.closed")
        self._c_refused = reg.counter(f"resilience.breaker.{name}.refused")

    # -- state ----------------------------------------------------------

    @property
    def state(self) -> int:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    def _set_state(self, s: int) -> None:
        self._state = s
        self._g_state.set(s)

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and (
                self._clock() - self._opened_at >= self.policy.reset_timeout_s):
            self._set_state(HALF_OPEN)
            self._probe_successes = 0
            self._probe_inflight = False

    def _open(self) -> None:
        self._set_state(OPEN)
        self._opened_at = self._clock()
        self._failures = 0
        self._probe_inflight = False
        self._c_opened.inc()

    # -- protocol -------------------------------------------------------

    def allow(self) -> bool:
        """May the caller attempt the guarded call right now?"""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True   # this caller is the probe
                return True
            self._c_refused.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == CLOSED:
                self._failures = 0
                return
            if self._state == HALF_OPEN:
                self._probe_inflight = False
                self._probe_successes += 1
                if self._probe_successes >= self.policy.half_open_successes:
                    self._set_state(CLOSED)
                    self._failures = 0
                    self._c_closed.inc()

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            if self._state == HALF_OPEN:
                self._open()                  # failed probe: back to open
                opened = True
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.policy.failure_threshold:
                    self._open()
                    opened = True
        if opened:
            self._notify_opened()

    def release(self) -> None:
        """An ``allow()`` grant went unused (no call was made): free the
        half-open probe slot without counting an outcome."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def trip(self) -> None:
        """Force the breaker open (ops switch / degraded-bench arm)."""
        with self._lock:
            self._open()
        self._notify_opened()

    def _notify_opened(self) -> None:
        """Black-box + bundle trigger for an open transition — called
        *after* the state lock is released so bundle writing never
        happens under a lock the serve path contends on."""
        from ..obs.flight import FLIGHT   # deferred: keeps import light
        FLIGHT.note("breaker.opened", name=self.name,
                    opens=int(self._c_opened.value))
        FLIGHT.trigger("breaker-open", detail={"breaker": self.name})
