"""SLO burn-rate monitoring over the serving metrics.

Classic multi-window burn-rate alerting (the SRE-workbook shape) on top
of the registry's cumulative counters, the latency histograms and the
resilience layer's typed-error counters:

* an :class:`SLO` names a **bad-event** and a **total-event** source
  (cumulative, monotone — a counter value, a histogram ``count``, or a
  ``count_above`` latency threshold) and an **error budget** (the
  allowed bad fraction, e.g. 0.01 for 99% availability);
* the monitor keeps a bounded ring of timestamped (bad, total)
  snapshots per SLO and, on every :meth:`tick`, computes the burn rate
  — (bad fraction over the window) / budget — over each configured
  window (default 5s and 60s);
* the alert **fires** only when *every* window burns above the
  threshold (the short window makes detection fast, the long window
  stops a single blip from flapping) and **clears** as soon as the
  short window recovers.

Alert transitions are emitted three ways so nothing has to poll:
appended to :attr:`SLOMonitor.events` (bounded), counted/gauged in the
registry (``slo.<name>.fired`` / ``.cleared`` / ``.active`` /
``.burn``), and recorded as instantaneous events into the span tracer
so they land in the Chrome trace timeline next to the stage spans.

The monitor has no thread of its own: hook :meth:`tick` onto the
time-series collector's sampling cadence (``serve.py --obs`` does), or
drive it with a fake clock in tests.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from . import metrics as _metrics
from .tracer import TRACER, _now_ns

Source = Union[str, Callable[[_metrics.Registry], float]]


def _resolve(src: Source, reg: _metrics.Registry) -> float:
    if callable(src):
        return float(src(reg))
    return float(reg.counter(src).value)


def latency_above(hist_name: str, threshold: float) -> Callable:
    """Bad-event source: recordings of ``hist_name`` at or above
    ``threshold`` (same unit the histogram records, typically µs)."""
    return lambda reg: reg.histogram(hist_name).count_above(threshold)


def hist_count(hist_name: str) -> Callable:
    """Total-event source: everything ``hist_name`` recorded."""
    return lambda reg: reg.histogram(hist_name).count


class SLO:
    """One objective: bad/total sources, budget, windows, threshold."""

    __slots__ = ("name", "bad", "total", "budget", "windows",
                 "threshold", "min_events", "ring", "active")

    def __init__(self, name: str, bad: Source, total: Source,
                 budget: float = 0.01,
                 windows: Sequence[float] = (5.0, 60.0),
                 threshold: float = 1.0, min_events: int = 1,
                 capacity: int = 4096):
        if budget <= 0:
            raise ValueError(f"budget must be > 0, got {budget}")
        self.name = name
        self.bad = bad
        self.total = total
        self.budget = float(budget)
        self.windows = tuple(float(w) for w in windows)
        self.threshold = float(threshold)
        self.min_events = int(min_events)
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.active = False


class SLOMonitor:
    """Evaluates a set of :class:`SLO`\\ s against the registry."""

    def __init__(self, registry: Optional[_metrics.Registry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_events: int = 1024):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self._clock = clock
        self.max_events = int(max_events)
        self.slos: List[SLO] = []
        self.events: List[dict] = []

    def add(self, name: str, bad: Source, total: Source,
            budget: float = 0.01, windows: Sequence[float] = (5.0, 60.0),
            threshold: float = 1.0, min_events: int = 1) -> SLO:
        slo = SLO(name, bad, total, budget=budget, windows=windows,
                  threshold=threshold, min_events=min_events)
        self.slos.append(slo)
        return slo

    # -- evaluation -----------------------------------------------------

    def _burns(self, slo: SLO, t: float) -> Optional[Dict[float, float]]:
        """Burn rate per window, or ``None`` while no window is
        covered by history yet."""
        burns: Dict[float, float] = {}
        for w in slo.windows:
            base = None
            for s in reversed(slo.ring):
                if s[0] <= t - w:
                    base = s
                    break
            if base is None:
                # window not covered yet: fall back to the oldest
                # sample once history spans at least the window
                oldest = slo.ring[0]
                if t - oldest[0] < w:
                    return None
                base = oldest
            now = slo.ring[-1]
            dbad = now[1] - base[1]
            dtot = now[2] - base[2]
            frac = (dbad / dtot) if dtot >= max(slo.min_events, 1) else 0.0
            burns[w] = frac / slo.budget
        return burns

    def _emit(self, slo: SLO, kind: str, t: float,
              burns: Dict[float, float]) -> dict:
        event = {
            "slo": slo.name, "kind": kind, "t": t,
            "burns": {f"{w:g}s": b for w, b in burns.items()},
            "budget": slo.budget, "threshold": slo.threshold,
        }
        if len(self.events) < self.max_events:
            self.events.append(event)
        reg = self.registry
        reg.counter(f"slo.{slo.name}.{kind}").inc()
        reg.gauge(f"slo.{slo.name}.active").set(1 if kind == "fired" else 0)
        # instantaneous tracer event: alerts line up with stage spans
        TRACER.record(f"slo.{slo.name}.{kind}", "slo", _now_ns(), 0,
                      {k: round(v, 3) for k, v in event["burns"].items()})
        # flight recorder: every transition lands in the black box; a
        # burn *firing* freezes a debug bundle (rate-limited, no-op
        # unless the recorder is armed)
        from .flight import FLIGHT   # deferred: avoids an import cycle
        FLIGHT.note(f"slo.{kind}", slo=slo.name, t=t,
                    burns=event["burns"])
        if kind == "fired":
            FLIGHT.trigger(f"slo-{slo.name}", detail=event)
        return event

    def tick(self, t: Optional[float] = None) -> List[dict]:
        """Snapshot every SLO's sources and evaluate; returns the alert
        transitions (fired/cleared) this tick produced."""
        t = self._clock() if t is None else float(t)
        reg = self.registry
        out: List[dict] = []
        for slo in self.slos:
            slo.ring.append((t, _resolve(slo.bad, reg),
                             _resolve(slo.total, reg)))
            burns = self._burns(slo, t)
            if burns is None:
                continue
            reg.gauge(f"slo.{slo.name}.burn").set(max(burns.values()))
            firing = all(b > slo.threshold for b in burns.values())
            if firing and not slo.active:
                slo.active = True
                out.append(self._emit(slo, "fired", t, burns))
            elif not firing and slo.active:
                slo.active = False
                out.append(self._emit(slo, "cleared", t, burns))
        return out

    def active(self) -> Dict[str, dict]:
        """Currently-firing SLOs -> their latest fired event."""
        fired = {}
        for e in self.events:
            if e["kind"] == "fired":
                fired[e["slo"]] = e
        return {s.name: fired.get(s.name, {"slo": s.name, "kind": "fired"})
                for s in self.slos if s.active}

    def snapshot(self) -> dict:
        return {
            "slos": [{"name": s.name, "budget": s.budget,
                      "windows": list(s.windows),
                      "threshold": s.threshold, "active": s.active}
                     for s in self.slos],
            "active": sorted(self.active()),
            "events": list(self.events),
        }


def default_slos(monitor: SLOMonitor,
                 latency_slo_us: float = 50_000.0,
                 windows: Sequence[float] = (5.0, 60.0)) -> SLOMonitor:
    """The serving stack's standard objectives, wired to the counters
    the frontend and resilience layers already maintain:

    * ``availability`` — typed-error rejections (Overloaded sheds,
      DeadlineExceeded drops, QueueFull timeouts) vs accepted requests;
    * ``degraded``     — queries answered by the exact host fallback
      (breaker open / retries exhausted) vs requests;
    * ``breaker``      — circuit-breaker open transitions vs requests;
    * ``latency``      — frontend queue waits at or above
      ``latency_slo_us`` vs everything the wait histogram recorded.
    """

    def _bad_availability(reg: _metrics.Registry) -> float:
        return (reg.counter("frontend.shed").value
                + reg.counter("frontend.deadline_dropped").value
                + reg.counter("frontend.queue_full_timeouts").value)

    def _breaker_opens(reg: _metrics.Registry) -> float:
        return sum(reg.counter(n).value for n in reg.names()
                   if n.startswith("resilience.breaker.")
                   and n.endswith(".opened"))

    monitor.add("availability", _bad_availability, "frontend.requests",
                budget=0.01, windows=windows)
    monitor.add("degraded", "resilience.fallback_queries",
                "frontend.requests", budget=0.05, windows=windows)
    monitor.add("breaker", _breaker_opens, "frontend.requests",
                budget=0.001, windows=windows)
    monitor.add("latency", latency_above("frontend.queue_wait_us",
                                         latency_slo_us),
                hist_count("frontend.queue_wait_us"),
                budget=0.05, windows=windows)
    return monitor
