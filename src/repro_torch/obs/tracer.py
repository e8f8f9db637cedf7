"""Span tracer: Chrome-trace-format timing for every serving layer.

The serving stack (engine -> cluster -> frontend, plus the offline build
stages) is instrumented with :func:`span` context managers.  Disabled —
the default — a span is one module-attribute check, one read of
``torch.profiler``'s capture flag and the return of a shared no-op
context manager, so the hot path pays ~100ns per span
(``benchmarks/obs_overhead.py`` measures it).
Enabled, each span records a Chrome trace "complete" event (``ph: "X"``)
into a bounded in-memory buffer: name, category, thread id, start/dur in
microseconds, and any keyword args, also those a span is given at its
end (:meth:`_Span.set`).  The buffer is thread-safe (the
frontend scheduler thread and compaction builders trace concurrently
with the caller) and drops-with-a-counter rather than growing without
bound.

While a ``torch.profiler`` capture runs in the process (the harness's
traced window, :func:`~repro_torch.obs.profiler.device_trace`), every
span also opens a profiler range of its name on its thread and records
into the buffer, enabled or not: the stages then sit in the profiler's
own timeline, on its clock, beside the card's kernels.  When the capture
stops, both stop.

Open the dump in ``chrome://tracing`` / https://ui.perfetto.dev:

    from repro_torch import obs
    obs.enable()
    ... serve ...
    obs.dump("results/obs")          # writes trace.json
"""

from __future__ import annotations

import functools
import json
import math
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace_context

# Timestamps are perf_counter_ns throughout, so spans recorded on any
# thread share one monotonic clock and line up in the trace viewer.
_now_ns = time.perf_counter_ns


class _ProfilerUnbound:
    """Stands for ``torch.autograd.profiler`` until torch is loaded: no
    capture can run before, and the first read after it binds the module
    itself, whose ``_is_profiler_enabled`` is the flag ``torch.profiler``
    sets while a capture runs.  The package imports no torch."""

    def __getattr__(self, name):
        global _PROFILER
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _PROFILER = mod
        return getattr(mod, name)


_PROFILER = _ProfilerUnbound()


class Tracer:
    """Bounded, thread-safe buffer of completed spans."""

    def __init__(self, max_events: int = 1_000_000):
        self.enabled = False
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._events: List[tuple] = []   # (name, cat, tid, t0_ns, dur_ns, args)
        self.dropped = 0

    # -- recording ------------------------------------------------------

    def record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
               args: Optional[dict]) -> None:
        tid = threading.get_ident()
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append((name, cat, tid, t0_ns, dur_ns, args))

    # -- control --------------------------------------------------------

    def start(self) -> None:
        self.enabled = True

    def stop(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0

    # -- introspection --------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[tuple]:
        """Snapshot of the raw event tuples (name, cat, tid, t0_ns,
        dur_ns, args)."""
        with self._lock:
            return list(self._events)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name totals: {name: {count, total_us, mean_us}}."""
        out: Dict[str, Dict[str, float]] = {}
        for name, _cat, _tid, _t0, dur, _args in self.events():
            s = out.setdefault(name, {"count": 0, "total_us": 0.0})
            s["count"] += 1
            s["total_us"] += dur / 1e3
        for s in out.values():
            s["mean_us"] = s["total_us"] / s["count"]
        return out

    @staticmethod
    def _union_len(iv: List[Tuple[float, float]]) -> float:
        """Total length of the union of (start, end) intervals."""
        iv.sort()
        covered, end = 0.0, -math.inf
        for a, b in iv:
            if a > end:
                covered += b - a
                end = b
            elif b > end:
                covered += b - end
                end = b
        return covered

    @staticmethod
    def _merge_per_thread(per_thread: Dict[int, List[Tuple[float, float]]]
                          ) -> List[Tuple[float, float]]:
        """Union each thread's intervals first, then pool the per-thread
        unions — the two-level shape both :meth:`stage_totals` and
        :meth:`coverage` attribute through, so spans that overlap
        (nested same-name spans on one thread, or concurrent frontend
        flush threads) can never count the same wall time twice."""
        pooled: List[Tuple[float, float]] = []
        for iv in per_thread.values():
            iv.sort()
            start = end = None
            for a, b in iv:
                if start is None:
                    start, end = a, b
                elif a > end:
                    pooled.append((start, end))
                    start, end = a, b
                elif b > end:
                    end = b
            if start is not None:
                pooled.append((start, end))
        return pooled

    def stage_totals(self, prefix: str = "") -> Dict[str, float]:
        """{name: total_us} over spans whose name starts with ``prefix``
        — the per-stage attribution the benchmarks record.

        Totals are interval *unions* computed per thread before merging
        across threads: wall time during which at least one thread was
        inside the stage.  Sequential spans sum as before; overlapping
        same-name spans (recursion on one thread, concurrent frontend
        flush threads) no longer double-count, so a stage total can
        never exceed the wall interval it ran in.
        """
        per: Dict[str, Dict[int, List[Tuple[float, float]]]] = {}
        for name, _cat, tid, t0, dur, _args in self.events():
            if name.startswith(prefix):
                per.setdefault(name, {}).setdefault(tid, []).append(
                    (t0, t0 + dur))
        return {name: self._union_len(self._merge_per_thread(by_tid)) / 1e3
                for name, by_tid in per.items()}

    def coverage(self, t0_s: float, t1_s: float,
                 prefixes: Sequence[str] = ()) -> float:
        """Fraction of the wall interval ``[t0_s, t1_s]`` (perf_counter
        seconds) covered by the union of matching spans.

        Intervals are clipped to the window, unioned **per thread
        first**, then unioned across threads — concurrent spans
        (frontend scheduler thread vs caller, or several flush threads)
        merge rather than add, so coverage is capped at 1.0 by
        construction.  The result answers "how much of the end-to-end
        wall time is attributed to *some* instrumented stage".
        """
        lo, hi = t0_s * 1e9, t1_s * 1e9
        if hi <= lo:
            return 0.0
        per_thread: Dict[int, List[Tuple[float, float]]] = {}
        for name, _cat, tid, t0, dur, _args in self.events():
            if prefixes and not any(name.startswith(p) for p in prefixes):
                continue
            a, b = max(t0, lo), min(t0 + dur, hi)
            if b > a:
                per_thread.setdefault(tid, []).append((a, b))
        covered = self._union_len(self._merge_per_thread(per_thread))
        return covered / (hi - lo)

    def chrome_trace(self) -> dict:
        """The buffer as a Chrome trace (``chrome://tracing`` /
        Perfetto): one ``ph:"X"`` complete event per span, microsecond
        timestamps on the shared monotonic clock."""
        ev = []
        for name, cat, tid, t0, dur, args in self.events():
            e = {
                "name": name, "cat": cat or "repro", "ph": "X",
                "ts": t0 / 1e3, "dur": dur / 1e3, "pid": 0, "tid": tid,
            }
            if args:
                e["args"] = args
            ev.append(e)
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


TRACER = Tracer()


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """Nothing to record."""


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_name", "_cat", "_args", "_t0", "_range")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self._name = name
        self._cat = cat
        self._args = args
        self._range = None
        if _PROFILER._is_profiler_enabled:
            # an operator-like range (~1 µs), not a user annotation: the
            # profiler puts no copy of it among the card's activity
            from torch._C._profiler import _RecordFunctionFast

            self._range = _RecordFunctionFast(name)

    def set(self, **args) -> None:
        """Add keyword args known only inside the span (a wait timed
        within it); they land beside those given at its start."""
        self._args = {**self._args, **args} if self._args else args

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t1 = _now_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        args = self._args
        # an active per-request scope stamps its trace ids onto every
        # span recorded within it — the causal key the flight-recorder
        # replay resolves.  Enabled-only cost: one thread-local read.
        ids = trace_context.current_ids()
        if ids is not None:
            args = dict(args) if args else {}
            args["trace_ids"] = ids
        TRACER.record(self._name, self._cat, self._t0, t1 - self._t0,
                      args)
        return False


def span(name: str, cat: str = "", **args):
    """Context manager timing one stage.  ``with span("engine.scan"): ...``

    Disabled (the default) and with no ``torch.profiler`` capture
    running, this returns a shared no-op — the checks are two attribute
    loads, so instrumented hot paths stay hot.  Under a capture the span
    is also a profiler range of the same name.  Keyword args, and those
    given to ``.set`` inside the block, land in the Chrome trace event's
    ``args`` field.
    """
    if not TRACER.enabled and not _PROFILER._is_profiler_enabled:
        return _NULL
    return _Span(name, cat, args or None)


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form of :func:`span`; defaults to the function's
    qualified name.  ``@traced()`` or ``@traced("engine.scan")``."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled and not _PROFILER._is_profiler_enabled:
                return fn(*a, **kw)
            with _Span(label, cat, None):
                return fn(*a, **kw)

        return wrapper

    return deco
