"""Per-request trace context: the causal key of stage-3 observability.

A :class:`TraceContext` is minted once per request at ``Frontend.submit``
(trace id, admission timestamp, deadline budget, query class, vertex /
rect class) and travels with the request through the whole serving
stack.  Layers do not pass it explicitly — the frontend scheduler
**activates** the batch's contexts for the dynamic extent of the engine
call (:func:`scope`), and every instrumented site reads the ambient
batch through :func:`current` / :func:`current_ids`:

* the span tracer attaches ``trace_ids`` to every span recorded while a
  scope is active, so the padder, the fused megakernel batch, the
  ``ShardedEngine`` fan-out and the ``DynamicIndex`` base/overlay probes
  all carry the ids of the requests they served;
* ``ResilientEngine`` attributes every retry / breaker refusal /
  degradation decision to the specific trace ids it affected
  (``last_report``);
* the structured query log writes one ``trace_id`` + ``attempt`` per
  record (schema v3), and the latency histograms keep (trace id, value)
  exemplars per bucket.

The scope is **thread-local** (the frontend serves a batch on one
scheduler thread; background threads — compaction builders, the
exactness auditor's shadow replays — deliberately run scope-free so
their spans never masquerade as request work).  Minting and scope
activation are a few hundred nanoseconds per *request* / per *batch*
and are always-on; everything per-span stays behind the tracer's
enabled gate, so the disabled hot path is unchanged (timed by
``chip_smoke.py --ab``).
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence, Tuple

# process-global monotonically increasing ids; itertools.count.__next__
# is atomic under CPython, so minting takes no lock
_NEXT_ID = itertools.count(1)


class TraceContext:
    """One request's identity and admission-time facts.

    ``attempt`` is mutable: the resilient engine bumps it once per
    device attempt that included this request, so by completion it
    reads "how many device calls this answer cost".
    """

    __slots__ = ("trace_id", "t_admit", "deadline", "query_class", "u",
                 "vertex_class", "rect_bucket", "attempt")

    def __init__(self, trace_id: int, t_admit: float = 0.0,
                 deadline: Optional[float] = None,
                 query_class: str = "reach", u: int = -1,
                 vertex_class: str = "unknown", rect_bucket: int = -64,
                 attempt: int = 0):
        self.trace_id = int(trace_id)
        self.t_admit = float(t_admit)
        self.deadline = None if deadline is None else float(deadline)
        self.query_class = query_class
        self.u = int(u)
        self.vertex_class = vertex_class
        self.rect_bucket = int(rect_bucket)
        self.attempt = int(attempt)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "t_admit": self.t_admit,
            "deadline": self.deadline, "query_class": self.query_class,
            "u": self.u, "vertex_class": self.vertex_class,
            "rect_bucket": self.rect_bucket, "attempt": self.attempt,
        }

    def __repr__(self) -> str:
        return (f"TraceContext(id={self.trace_id}, u={self.u}, "
                f"class={self.query_class!r}, attempt={self.attempt})")


def mint(u: int = -1, query_class: str = "reach",
         t_admit: float = 0.0, deadline: Optional[float] = None,
         **kw) -> TraceContext:
    """A fresh context with the next process-global trace id."""
    return TraceContext(next(_NEXT_ID), t_admit=t_admit,
                        deadline=deadline, query_class=query_class,
                        u=u, **kw)


#: the shared no-identity context (trace id -1).  The frontend hands it
#: to requests admitted while tracing is disabled, so the disabled hot
#: path pays one enabled-check per submit instead of a mint — the same
#: gate discipline every per-span cost follows.  Never mutate it.
NULL = TraceContext(-1)


_TLS = threading.local()


class scope:
    """Activate a batch of contexts for the dynamic extent of a with
    block (re-entrant: scopes nest as a stack per thread)::

        with trace_context.scope(ctxs):
            engine.query_batch(us, rects)   # spans carry the ids

    The ids tuple is precomputed once on entry so per-span attachment
    is a thread-local read plus one reference, not a list build.
    """

    __slots__ = ("_ctxs", "_ids")

    def __init__(self, ctxs: Sequence[TraceContext]):
        self._ctxs = tuple(ctxs)
        self._ids = [c.trace_id for c in self._ctxs]

    def __enter__(self) -> "scope":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.stack.pop()
        return False


def current() -> Optional[Tuple[TraceContext, ...]]:
    """The innermost active batch of contexts on this thread, or None."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return None
    return stack[-1]._ctxs


def current_ids() -> Optional[List[int]]:
    """The innermost active batch's trace ids (shared list — treat as
    read-only), or None when no scope is active on this thread."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return None
    return stack[-1]._ids
