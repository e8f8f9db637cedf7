"""Time-series collector: the metrics registry sampled over a run.

One final snapshot hides everything interesting about a serve — warmup
vs steady state, a breaker opening halfway through, queue depth ramping
under load.  :class:`TimeSeriesCollector` turns the registry into
rate/percentile curves: a background sampler (or an explicit
:meth:`sample` call under a fake clock in tests) snapshots every
registered metric into a **bounded ring of timestamped deltas**:

* counters — cumulative value, per-interval delta and rate/s;
* gauges — instantaneous value and high-water mark;
* histograms — cumulative count plus a *windowed* view of the interval
  via :meth:`Histogram.since` (snapshot-delta subtraction), so the
  exported p50/p95/p99 describe the queries served in that interval,
  not the whole run smeared together.

``to_jsonl`` dumps the ring (first line: schema header) — the
``timeseries.jsonl`` artifact ``serve.py --obs`` writes; per-sample
hooks let the SLO monitor evaluate its burn-rate windows on the same
cadence without a second thread.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics

SCHEMA_VERSION = 1


class TimeSeriesCollector:
    """Bounded ring of timestamped registry deltas.

    Parameters
    ----------
    registry: source of truth; defaults to the global registry.
    interval: background sampling period (s) for :meth:`start`.
    capacity: ring size; the oldest samples drop (counted) beyond it.
    clock:    wall-time source (injectable for deterministic tests).
    percentiles: exported windowed histogram percentiles.
    """

    def __init__(self, registry: Optional[_metrics.Registry] = None,
                 interval: float = 0.25, capacity: int = 4096,
                 clock: Callable[[], float] = time.time,
                 percentiles: Tuple[float, ...] = (50.0, 95.0, 99.0)):
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.interval = float(interval)
        self.capacity = int(capacity)
        self.percentiles = tuple(percentiles)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.dropped = 0
        self._prev_t: Optional[float] = None
        self._prev_counters: Dict[str, float] = {}
        self._prev_hist: Dict[str, _metrics.HistogramState] = {}
        self._hooks: List[Callable[[float, dict], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add_hook(self, hook: Callable[[float, dict], None]) -> None:
        """Call ``hook(t, sample)`` after every sample (the SLO monitor
        ticks through this)."""
        self._hooks.append(hook)

    # -- sampling -------------------------------------------------------

    def sample(self, t: Optional[float] = None) -> dict:
        """Take one snapshot-delta sample and append it to the ring."""
        t = self._clock() if t is None else float(t)
        with self._lock:
            dt = None if self._prev_t is None else t - self._prev_t
            sample: dict = {"t": t, "dt": dt, "counters": {},
                            "gauges": {}, "histograms": {}}
            for name, m in self.registry.items():
                if isinstance(m, _metrics.Counter):
                    v = float(m.value)
                    delta = v - self._prev_counters.get(name, 0.0)
                    self._prev_counters[name] = v
                    entry = {"value": v, "delta": delta}
                    if dt and dt > 0:
                        entry["rate"] = delta / dt
                    sample["counters"][name] = entry
                elif isinstance(m, _metrics.Gauge):
                    sample["gauges"][name] = {"value": float(m.value),
                                              "max": float(m.max)}
                elif isinstance(m, _metrics.Histogram):
                    win = m.since(self._prev_hist.get(name))
                    self._prev_hist[name] = m.state()
                    entry = {"count": int(m.count),
                             "delta": int(win.count),
                             "sum_delta": float(win.sum)}
                    if win.count > 0:
                        for p in self.percentiles:
                            key = f"p{p:g}".replace(".", "_")
                            entry[key] = win.percentile(p)
                    sample["histograms"][name] = entry
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(sample)
            self._prev_t = t
            hooks = list(self._hooks)
        for hook in hooks:
            hook(t, sample)
        return sample

    # -- background sampler ---------------------------------------------

    def start(self) -> "TimeSeriesCollector":
        """Start the background sampler thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-timeseries", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample()

    def stop(self, final_sample: bool = True) -> None:
        """Stop the sampler; by default takes one last sample so the
        tail of the run is captured."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_sample:
            self.sample()

    # -- introspection / export -----------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def samples(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def series(self, kind: str, name: str,
               field: str = "value") -> Tuple[List[float], List[float]]:
        """(timestamps, values) for one metric curve, skipping samples
        where the metric or field is absent."""
        ts: List[float] = []
        vs: List[float] = []
        for s in self.samples():
            entry = s.get(kind, {}).get(name)
            if entry is None:
                continue
            v = entry.get(field) if isinstance(entry, dict) else entry
            if v is None:
                continue
            ts.append(s["t"])
            vs.append(float(v))
        return ts, vs

    def dirty(self) -> bool:
        """True when the registry holds activity the ring has not
        sampled yet — counter movement or histogram recordings since
        the last :meth:`sample` (or any at all when none was taken)."""
        with self._lock:
            no_samples = self._prev_t is None
            prev_counters = dict(self._prev_counters)
            prev_hist = dict(self._prev_hist)
        for name, m in self.registry.items():
            if isinstance(m, _metrics.Counter):
                if float(m.value) != prev_counters.get(name, 0.0):
                    return True
            elif isinstance(m, _metrics.Histogram):
                prev = prev_hist.get(name)
                if m.count != (prev.count if prev is not None else 0):
                    return True
        return no_samples and bool(self.registry.names())

    def to_jsonl(self, path: str, final_sample: bool = True) -> str:
        """Dump the ring, one sample per line after a schema header.

        ``final_sample`` (default) first flushes the partial in-flight
        window — anything recorded since the last background sample —
        into one last sample, so a short serve that never spanned a
        full ``interval`` still exports its data instead of silently
        dropping the tail (or, with no elapsed interval at all, the
        whole run)."""
        if final_sample and self.dirty():
            self.sample()
        samples = self.samples()
        with open(path, "w") as f:
            f.write(json.dumps({
                "schema_version": SCHEMA_VERSION,
                "interval_s": self.interval,
                "capacity": self.capacity,
                "dropped": self.dropped,
                "samples": len(samples),
            }) + "\n")
            for s in samples:
                f.write(json.dumps(s) + "\n")
        return path
