"""Metrics registry: counters, gauges and bounded latency histograms.

One process-wide :data:`REGISTRY` absorbs the ad-hoc timing globals that
used to live scattered across the stack (``engine.UPLOAD_COUNTERS``,
``range_query.ops.SOA_BUILDS``, the one-time host-fallback warning, the
frontend's stats dict) plus the new per-shard and frontend gauges.
Everything is thread-safe and cheap enough to stay always-on at the
granularity it is recorded at (per batch / per flush / per build — never
per query in a kernel loop).

:class:`Histogram` is the one percentile implementation in the repo (the
hand-rolled ``np.percentile`` calls in the reference's
``launch/serve.py`` and ``benchmarks/perf_rangereach.py`` route through
it): a bounded HDR-style
log-linear bucket array for streaming aggregation, plus an exact sample
window.  While the window is unsaturated — every latency distribution
the benches replay fits — percentiles are **bit-for-bit**
``np.percentile`` (linear interpolation, float64); past ``max_samples``
they degrade gracefully to bucket-interpolated values with bounded
relative error (2^(1/sub) per bucket) instead of unbounded memory.
"""

from __future__ import annotations

import json
import math
import random
import threading
from typing import Dict, Iterable, List, MutableMapping, Optional, \
    Sequence, Tuple, Union

import numpy as np

Number = Union[int, float]


class Counter:
    """Monotonic (but resettable) named counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: Number) -> None:
        """Legacy dict-style assignment support (see CounterDict)."""
        with self._lock:
            self._value = v

    @property
    def value(self) -> Number:
        return self._value

    def reset(self) -> None:
        self.set(0)

    def snapshot(self) -> Number:
        return self._value


class Gauge:
    """Last-value-wins instantaneous measurement (queue depth, batch
    occupancy, compile count) with a high-water mark."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> Number:
        return self._value

    @property
    def max(self) -> Number:
        return self._max

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._max = 0.0

    def snapshot(self) -> Dict[str, Number]:
        return {"value": self._value, "max": self._max}


class HistogramState:
    """Opaque snapshot of a histogram's cumulative state, taken with
    :meth:`Histogram.state` and subtracted with :meth:`Histogram.since`
    — the windowed-view primitive the time-series collector and the SLO
    burn-rate windows are built on."""

    __slots__ = ("count", "sum", "buckets", "n_samples", "min", "max")

    def __init__(self, count: int, sum_: float, buckets: np.ndarray,
                 n_samples: int, min_: float, max_: float):
        self.count = count
        self.sum = sum_
        self.buckets = buckets
        self.n_samples = n_samples
        self.min = min_
        self.max = max_


class Histogram:
    """Bounded log-linear histogram with an exact sample window.

    Parameters
    ----------
    lo, hi:      resolvable value range; values clamp into
                 ``[lo, hi)`` (underflow/overflow buckets count them).
    sub:         linear sub-buckets per octave (HDR-style); relative
                 bucket width is ``2^(1/sub) - 1`` (~4.4% at sub=16).
    max_samples: exact window size.  Below it, ``percentile`` is
                 bit-for-bit ``np.percentile``; above, bucket-
                 interpolated (``saturated`` flips to True).
    exemplar_cap: bounded (trace id, value) exemplar reservoir size per
                 bucket; recordings that pass ``exemplar=`` feed it.
    seed:        exemplar reservoir rng seed — a fixed seed over a
                 fixed stream keeps the retained exemplars
                 deterministic (golden-tested).
    """

    __slots__ = ("name", "lo", "hi", "sub", "max_samples", "_buckets",
                 "_samples", "_count", "_sum", "_min", "_max", "_lock",
                 "exemplar_cap", "seed", "_exemplars", "_ex_seen",
                 "_ex_rng")

    def __init__(self, name: str = "", lo: float = 1e-3, hi: float = 1e9,
                 sub: int = 16, max_samples: int = 65536,
                 exemplar_cap: int = 4, seed: int = 0):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}/{hi}")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.sub = int(sub)
        self.max_samples = int(max_samples)
        self.exemplar_cap = int(exemplar_cap)
        self.seed = int(seed)
        n_octaves = int(math.ceil(math.log2(hi / lo)))
        # bucket 0: underflow; buckets 1..n: log-linear; last: overflow
        self._buckets = np.zeros(n_octaves * self.sub + 2, dtype=np.int64)
        self._samples: list = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # bucket -> bounded reservoir of (trace_id, value) exemplars
        self._exemplars: Dict[int, List[Tuple[int, float]]] = {}
        self._ex_seen: Dict[int, int] = {}   # stream length per bucket
        self._ex_rng = random.Random(self.seed)
        self._lock = threading.Lock()

    @classmethod
    def from_samples(cls, values, name: str = "", **kw) -> "Histogram":
        """Histogram over a replayed sample, window sized to keep it
        exact — the unified percentile path for the benches."""
        values = np.asarray(values, dtype=np.float64).ravel()
        kw.setdefault("max_samples", max(len(values), 1))
        h = cls(name=name, **kw)
        h.record_many(values)
        return h

    # -- recording ------------------------------------------------------

    def _idx(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return len(self._buckets) - 1
        return 1 + int(math.log2(v / self.lo) * self.sub)

    def record(self, v: Number, exemplar: Optional[int] = None) -> None:
        """Record one value; ``exemplar=`` attaches a trace id to the
        value's bucket reservoir (Algorithm-R reservoir sampling with
        the histogram's seeded rng, so a fixed stream retains a fixed
        exemplar set — "show me an actual p99 request" is then a bucket
        lookup)."""
        v = float(v)
        with self._lock:
            i = self._idx(v)
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            if exemplar is not None:
                seen = self._ex_seen.get(i, 0)
                self._ex_seen[i] = seen + 1
                res = self._exemplars.setdefault(i, [])
                if len(res) < self.exemplar_cap:
                    res.append((int(exemplar), v))
                else:
                    j = self._ex_rng.randrange(seen + 1)
                    if j < self.exemplar_cap:
                        res[j] = (int(exemplar), v)

    def record_many(self, values) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.record(v)

    # -- merge / windowed views -----------------------------------------

    def _compatible(self, other: "Histogram") -> None:
        if (self.lo, self.hi, self.sub) != (other.lo, other.hi, other.sub):
            raise ValueError(
                f"cannot combine histograms with different bucket "
                f"layouts: lo/hi/sub {self.lo}/{self.hi}/{self.sub} vs "
                f"{other.lo}/{other.hi}/{other.sub}")

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram (bucket layouts must
        match).  While the combined count fits this histogram's exact
        window, merged percentiles are bit-for-bit ``np.percentile`` on
        the concatenated samples; past saturation they degrade to the
        usual bucket interpolation.  Returns ``self``."""
        self._compatible(other)
        with other._lock:
            buckets = other._buckets.copy()
            count, sum_ = other._count, other._sum
            mn, mx = other._min, other._max
            samples = list(other._samples)
        with self._lock:
            self._buckets += buckets
            self._count += count
            self._sum += sum_
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx
            room = self.max_samples - len(self._samples)
            if room > 0:
                self._samples.extend(samples[:room])
        return self

    def state(self) -> HistogramState:
        """Cumulative snapshot for later :meth:`since` subtraction."""
        with self._lock:
            return HistogramState(self._count, self._sum,
                                  self._buckets.copy(),
                                  len(self._samples), self._min, self._max)

    def since(self, prev: Optional[HistogramState]) -> "Histogram":
        """A new histogram holding only what was recorded after
        ``prev`` (``None``: everything) — snapshot-delta subtraction.

        While both snapshots were unsaturated the window's samples are
        exact (the sample list is append-only below ``max_samples``),
        so the windowed percentiles are bit-for-bit ``np.percentile``
        of the values recorded in between; otherwise they fall back to
        the bucket-diff interpolation."""
        out = Histogram(name=self.name, lo=self.lo, hi=self.hi,
                        sub=self.sub, max_samples=self.max_samples)
        with self._lock:
            buckets = self._buckets.copy()
            count, sum_ = self._count, self._sum
            mn, mx = self._min, self._max
            tail = list(self._samples[prev.n_samples:]) if prev else \
                list(self._samples)
        if prev is None:
            out._buckets[:] = buckets
            out._count, out._sum = count, sum_
        else:
            out._buckets[:] = buckets - prev.buckets
            out._count = count - prev.count
            out._sum = sum_ - prev.sum
        out._samples = tail
        if out._count == len(tail) and tail:
            out._min = min(tail)
            out._max = max(tail)
        elif out._count:
            # saturated window: exact extrema unknown — inherit the
            # cumulative bounds (they still bracket every windowed value)
            out._min, out._max = mn, mx
        return out

    def count_above(self, threshold: float) -> int:
        """Recordings ``>= threshold`` — the bad-event count for a
        latency SLO.  Exact while unsaturated; afterwards counted at
        bucket granularity (the threshold's whole bucket is included,
        so the answer errs toward alerting)."""
        v = float(threshold)
        with self._lock:
            if self._count <= len(self._samples):
                if not self._samples:
                    return 0
                return int(np.sum(
                    np.asarray(self._samples, dtype=np.float64) >= v))
            return int(self._buckets[self._idx(v):].sum())

    # -- percentiles ----------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    @property
    def saturated(self) -> bool:
        """True once the exact window overflowed: percentiles are now
        bucket-interpolated (bounded relative error), not exact."""
        return self._count > len(self._samples)

    def _edge(self, i: int) -> float:
        """Lower value edge of log-linear bucket ``i`` (1-based)."""
        return self.lo * 2.0 ** ((i - 1) / self.sub)

    def percentile(self, p: float) -> float:
        """The ``p``-th percentile.  Unsaturated: exactly
        ``float(np.percentile(samples, p))``."""
        with self._lock:
            if self._count == 0:
                return float("nan")
            if self._count <= len(self._samples):
                return float(np.percentile(
                    np.asarray(self._samples, dtype=np.float64), p))
            buckets = self._buckets.copy()
            mn, mx = self._min, self._max
        # saturated: rank interpolation over the bucket cumulative
        cum = np.cumsum(buckets)
        rank = (cum[-1] - 1) * (p / 100.0)
        i = int(np.searchsorted(cum, rank, side="right"))
        i = min(i, len(buckets) - 1)
        if i == 0:
            return mn
        if i == len(buckets) - 1:
            return mx
        lo_e, hi_e = self._edge(i), self._edge(i + 1)
        prev = cum[i - 1]
        frac = (rank - prev + 1) / max(buckets[i], 1)
        return float(min(max(lo_e + (hi_e - lo_e) * min(frac, 1.0), mn), mx))

    def percentiles(self, ps: Sequence[float] = (50, 95, 99, 99.9)
                    ) -> Dict[str, float]:
        def key(p: float) -> str:
            return f"p{p}".replace("99.9", "999").replace(".", "_")

        return {key(p): self.percentile(p) for p in ps}

    def percentile_dict(self, ps: Sequence[float] = (50, 95, 99),
                        prefix: str = "p", suffix: str = "") -> Dict[str, float]:
        """{f"{prefix}{p}{suffix}": value} — the benches' legacy key
        shapes (``p50`` / ``lat_p50_us``) from one implementation."""
        return {f"{prefix}{int(p) if float(p).is_integer() else p}{suffix}":
                self.percentile(p) for p in ps}

    # -- exemplars ------------------------------------------------------

    def exemplars(self) -> Dict[int, List[Tuple[int, float]]]:
        """{bucket index: [(trace_id, value), ...]} — every retained
        exemplar reservoir (buckets that never saw an ``exemplar=``
        recording are absent)."""
        with self._lock:
            return {i: list(res) for i, res in self._exemplars.items()
                    if res}

    def exemplars_near(self, v: float) -> List[Tuple[int, float]]:
        """The exemplar reservoir of the bucket ``v`` falls in — e.g.
        ``h.exemplars_near(h.percentile(99))`` answers "show me actual
        p99 requests" as a lookup."""
        with self._lock:
            return list(self._exemplars.get(self._idx(float(v)), ()))

    def reset(self) -> None:
        with self._lock:
            self._buckets[:] = 0
            self._samples = []
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._exemplars = {}
            self._ex_seen = {}
            self._ex_rng = random.Random(self.seed)

    def snapshot(self) -> Dict[str, Number]:
        out: Dict[str, Number] = {
            "count": self._count,
            "sum": self._sum,
            "min": self._min if self._count else None,
            "max": self._max if self._count else None,
            "saturated": self.saturated,
        }
        if self._count:
            out.update(self.percentiles())
        if self._exemplars:
            out["exemplars"] = {
                str(i): [[tid, val] for tid, val in res]
                for i, res in sorted(self._exemplars.items()) if res}
        return out


class Registry:
    """Name -> metric, get-or-create; one global instance plus private
    ones for deterministic tests (``Frontend(metrics=Registry())``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, not a "
                    f"{cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def items(self) -> list:
        """Sorted ``[(name, metric), ...]`` over the live metric
        objects — the iteration surface for the time-series collector
        and the OpenMetrics exporter."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> Dict[str, dict]:
        """{counters: {...}, gauges: {...}, histograms: {...}} — the
        metrics half of ``repro_torch.obs.snapshot()``."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def reset(self) -> None:
        """Zero every registered metric (registrations stay)."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


REGISTRY = Registry()


class CounterDict(MutableMapping):
    """Dict-shaped live view over registry counters.

    The legacy module globals (``engine.UPLOAD_COUNTERS``) were plain
    dicts that benchmarks read with ``dict(...)`` and code bumped with
    ``d[k] += 1``; this view keeps that surface while the values live in
    the registry, so ``repro_torch.obs.snapshot()`` sees them too.
    """

    def __init__(self, prefix: str, keys: Iterable[str],
                 registry: Optional[Registry] = None):
        self._registry = registry or REGISTRY
        self._prefix = prefix
        self._keys = list(keys)
        for k in self._keys:
            self._registry.counter(prefix + k)

    def __getitem__(self, k: str) -> Number:
        if k not in self._keys:
            raise KeyError(k)
        return self._registry.counter(self._prefix + k).value

    def __setitem__(self, k: str, v: Number) -> None:
        if k not in self._keys:
            self._keys.append(k)
        self._registry.counter(self._prefix + k).set(v)

    def __delitem__(self, k: str) -> None:
        raise TypeError("CounterDict keys are fixed at registration")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def latency_percentiles(lat_us, ps: Sequence[float] = (50, 95, 99),
                        prefix: str = "p", suffix: str = "") -> Dict[str, float]:
    """Percentiles of a replayed latency sample (µs) through the one
    Histogram implementation — shared by the reference's
    ``launch/serve.py`` and ``benchmarks/perf_rangereach.py``
    (golden-tested bit-for-bit against the ``np.percentile`` math it
    replaced)."""
    return Histogram.from_samples(lat_us).percentile_dict(
        ps, prefix=prefix, suffix=suffix)
