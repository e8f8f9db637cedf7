"""Typed serving errors — the only failures a client is allowed to see
(the port of ``repro.resilience.errors``).

The fault-tolerance invariant (asserted by the chaos suite) is that
every request submitted to the serving stack resolves to either the
exact answer or one of these typed errors — never a hang, never a wrong
answer, never a naked internal exception escaping the frontend.

All of them subclass :class:`ResilienceError` (itself a
``RuntimeError``, so pre-existing callers that caught the frontend's
old ``RuntimeError("Frontend is closed")`` keep working).
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every typed serving failure."""


class Overloaded(ResilienceError):
    """Admission control shed the request: the projected queue wait
    already exceeds the request's deadline budget, so accepting it
    would only burn capacity on an answer nobody can use."""


class QueueFull(ResilienceError):
    """The bounded submit queue stayed at capacity past the caller's
    backpressure timeout."""


class DeadlineExceeded(ResilienceError):
    """The request's deadline budget expired before it could be
    served (it waited in the queue past its budget, or every serving
    attempt within the budget failed)."""


class FrontendClosed(ResilienceError):
    """The frontend was closed: either this submit arrived after
    ``close()``, or ``close(drain=False)`` failed the still-pending
    future instead of serving it."""


class CircuitOpen(ResilienceError):
    """Internal: a circuit breaker refused the call.  Never escapes the
    resilient engine — it triggers the exact host fallback instead."""


class InjectedFault(RuntimeError):
    """Default exception raised by a ``raise``-kind fault spec.  A
    plain ``RuntimeError`` (not a :class:`ResilienceError`): injected
    faults model *untyped* infrastructure failures, which the stack
    must absorb or convert — an ``InjectedFault`` reaching a client
    future is a chaos-suite failure unless the client submitted
    directly to a faulted layer with no resilience wrapper."""

    def __init__(self, point: str = "", fire: int = 0):
        super().__init__(f"injected fault at {point!r} (fire #{fire})")
        self.point = point
        self.fire = fire


class ShardDropout(InjectedFault):
    """Injected loss of one shard of a sharded engine.  Carries the
    shard id so the resilient wrapper can open that shard's breaker
    (degrading only the queries routed to it) instead of the whole
    engine's."""

    def __init__(self, shard: int, point: str = "", fire: int = 0):
        super().__init__(point=point, fire=fire)
        self.shard = int(shard)
