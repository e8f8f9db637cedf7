"""Deadline budgets and bounded retry with decorrelated-jitter backoff
(the port of ``repro.resilience.retry``: the same rng gives the same
schedule).

Two small, deterministic pieces the resilient engine composes:

* :class:`Deadline` — a per-request time budget on an injectable
  monotonic clock.  Everything downstream (retry sleeps, fallback
  decisions, queue-wait projections) asks the same object "how much
  budget is left", so a request can never sleep past its own deadline.
* :class:`RetryPolicy` — attempt count plus exponential backoff with
  **decorrelated jitter** (`sleep = min(cap, uniform(base, 3·prev))`,
  the AWS-architecture variant): retries from many callers de-correlate
  instead of thundering back in lockstep, while the cap bounds the
  worst case.  The rng is injectable, so tests replay exact schedules.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from .errors import DeadlineExceeded


class Deadline:
    """Absolute time budget on a monotonic clock.

    ``Deadline(None)`` is the unlimited budget (``remaining() == inf``,
    never expires) so call sites need no None-handling.
    """

    __slots__ = ("_t_end", "_clock")

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._t_end = (math.inf if budget_s is None
                       else clock() + float(budget_s))

    @classmethod
    def none(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> float:
        return self._t_end - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self._t_end

    def check(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} deadline budget exhausted")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry schedule for transient serving failures.

    ``max_attempts`` counts the first try too (1 = no retry).  Backoff
    is decorrelated jitter: the next sleep is drawn uniformly from
    ``[base_s, 3 * previous_sleep]`` and clipped to ``cap_s``.
    """

    max_attempts: int = 3
    base_s: float = 1e-3
    cap_s: float = 50e-3

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"need max_attempts >= 1, got {self.max_attempts}")
        if not (0 < self.base_s <= self.cap_s):
            raise ValueError(
                f"need 0 < base_s <= cap_s, got {self.base_s}/{self.cap_s}")

    def next_backoff(self, prev_s: float,
                     rng: np.random.Generator) -> float:
        """Sleep before the next attempt, given the previous sleep
        (pass 0.0 before the first retry)."""
        hi = max(self.base_s, 3.0 * prev_s)
        return float(min(self.cap_s, rng.uniform(self.base_s, hi)))

    def schedule(self, rng: np.random.Generator) -> list:
        """The full (deterministic, given ``rng``) backoff schedule —
        ``max_attempts - 1`` sleeps; used by tests and docs."""
        out, prev = [], 0.0
        for _ in range(self.max_attempts - 1):
            prev = self.next_backoff(prev, rng)
            out.append(prev)
        return out
