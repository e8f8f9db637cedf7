"""repro_torch.resilience — fault-tolerant serving for the RangeReach
stack (the port of ``repro.resilience``: the same public names, metric
names, fault schedules and retry schedules for the same seeds).

Four pieces, wired through the engine today (the cluster, frontend and
dynamic index that the reference also wires wait for their ports):

* :mod:`~repro_torch.resilience.faults` — deterministic, seedable fault
  injection at named failure points (raise / bounded hang / latency
  spike / silent corruption), a single attribute check when disabled;
* :mod:`~repro_torch.resilience.retry` — :class:`Deadline` budgets and
  :class:`RetryPolicy` (exponential backoff, decorrelated jitter);
* :mod:`~repro_torch.resilience.breaker` — :class:`CircuitBreaker`
  (closed → open → half-open with a single probe) per engine and per
  shard;
* :mod:`~repro_torch.resilience.engine` — :class:`ResilientEngine`:
  retries transient device failures, breaks on persistent ones, and
  degrades **exactly** to the bit-identical host descent (or the
  engine's two-phase device path) instead of failing.

The global invariant (asserted by ``tests/test_torch_resilience.py``):
every request resolves to the exact answer or one of the typed errors
in :mod:`~repro_torch.resilience.errors` — no hangs, no wrong answers.
"""

from .breaker import BreakerPolicy, CircuitBreaker
from .engine import ResilientEngine
from .errors import (
    CircuitOpen,
    DeadlineExceeded,
    FrontendClosed,
    InjectedFault,
    Overloaded,
    QueueFull,
    ResilienceError,
    ShardDropout,
)
from .faults import INJECTOR, FaultPlan, FaultSpec, fault_point, inject
from .retry import Deadline, RetryPolicy

__all__ = [
    "BreakerPolicy", "CircuitBreaker", "CircuitOpen", "Deadline",
    "DeadlineExceeded", "FaultPlan", "FaultSpec", "FrontendClosed",
    "INJECTOR", "InjectedFault", "Overloaded", "QueueFull",
    "ResilienceError", "ResilientEngine", "RetryPolicy", "ShardDropout",
    "fault_point", "inject",
]
