"""repro_torch.obs — zero-dependency observability for the serving stack
(the port of ``repro.obs``: the same public names, span and metric names
and snapshot schema, so a trace or a metrics dump of the port reads like
the reference's).

* :mod:`~repro_torch.obs.tracer` — span tracer (context manager + decorator,
  thread-safe, ~100ns when disabled) emitting Chrome-trace JSON; wraps
  the hot paths of the engine, cluster, frontend, dynamic overlay and
  the offline build stages.  Under a ``torch.profiler`` capture every
  span is also a profiler range, on the capture's clock, and records.
* :mod:`~repro_torch.obs.metrics` — counters / gauges / bounded log-linear
  histograms with exact (``np.percentile``-identical) p50/p95/p99/p999
  while unsaturated; the one percentile implementation in the repo.
* :mod:`~repro_torch.obs.profiler` — opt-in ``torch.profiler`` capture
  + per-kernel cost model (bytes touched, candidate tiles after prune).
* :mod:`~repro_torch.obs.querylog` — bounded structured query log (vertex
  class, query class, rect bucket, shard, latency, cardinality) with
  JSONL export — the input for the future result cache/repartitioner.

Usage::

    from repro_torch import obs
    obs.enable()                       # spans + hot-path metrics on
    ... build / serve ...
    snap = obs.snapshot()              # metrics + span summary + log
    obs.dump("results/obs")            # trace.json / metrics.json /
    obs.disable()                      # querylog.jsonl

Everything cheap stays always-on (build counters, frontend flush stats);
only per-batch span/histogram recording is gated by :func:`enable`;
``chip_smoke.py --ab`` times the engines with it off against a checkout
without the hooks.  No module here imports ``torch`` at import time.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

from . import audit, export, flight, metrics, profiler, querylog, slo, \
    timeseries, trace_context, tracer, workload
from .audit import ExactnessAuditor
from .export import to_openmetrics, write_prom
from .flight import FLIGHT, FlightRecorder
from .metrics import (
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    HistogramState,
    REGISTRY,
    Registry,
    latency_percentiles,
)
from .profiler import annotate, device_trace, engine_cost_model
from .querylog import QUERY_LOG, QueryLog, rect_bucket, vertex_class_of
from .slo import SLOMonitor, default_slos
from .timeseries import TimeSeriesCollector
from .trace_context import TraceContext
from .tracer import TRACER, span, traced
from .workload import SpaceSaving, WorkloadAnalytics, gini

__all__ = [
    "Counter", "CounterDict", "ExactnessAuditor", "FLIGHT",
    "FlightRecorder", "Gauge", "Histogram", "HistogramState",
    "QueryLog", "Registry", "REGISTRY", "SLOMonitor", "SpaceSaving",
    "TRACER", "TimeSeriesCollector", "TraceContext", "QUERY_LOG",
    "WorkloadAnalytics",
    "annotate", "coverage", "default_slos", "device_trace", "disable",
    "dump", "dump_flight", "enable", "enabled", "engine_cost_model",
    "gini", "latency_percentiles", "rect_bucket", "reset", "snapshot",
    "span", "stage_totals", "start_timeseries", "stop_timeseries",
    "to_openmetrics", "traced", "vertex_class_of", "write_prom",
]

# the default layer prefixes coverage() attributes wall time to
LAYER_PREFIXES = ("engine.", "cluster.", "frontend.", "dynamic.",
                  "build.", "serve.")


def enable() -> None:
    """Turn on span recording and gated hot-path metric recording."""
    tracer.TRACER.start()


def disable() -> None:
    tracer.TRACER.stop()


def enabled() -> bool:
    """Fast gate for optional hot-path recording — a single attribute
    check, safe to call per batch."""
    return tracer.TRACER.enabled


def reset() -> None:
    """Clear spans, zero metrics, empty the query log, forget the
    time-series sampler and the flight recorder's black box
    (registrations and enablement state stay)."""
    global _TIMESERIES
    tracer.TRACER.clear()
    metrics.REGISTRY.reset()
    querylog.QUERY_LOG.clear()
    flight.FLIGHT.reset()
    if _TIMESERIES is not None:
        _TIMESERIES.stop(final_sample=False)
        _TIMESERIES = None


# -- stage-2 singletons: the time-series sampler --------------------------

_TIMESERIES: Optional[timeseries.TimeSeriesCollector] = None


def start_timeseries(interval: float = 0.25,
                     **kw) -> timeseries.TimeSeriesCollector:
    """Start (or return) the process-wide background sampler over the
    global registry; its ring is what :func:`dump` writes to
    ``timeseries.jsonl``."""
    global _TIMESERIES
    if _TIMESERIES is None:
        _TIMESERIES = timeseries.TimeSeriesCollector(
            interval=interval, **kw)
    return _TIMESERIES.start()


def stop_timeseries() -> Optional[timeseries.TimeSeriesCollector]:
    """Stop the process-wide sampler (taking one final sample).  The
    collector and its ring stay registered so :func:`dump` still writes
    ``timeseries.jsonl``; :func:`reset` forgets it."""
    if _TIMESERIES is not None:
        _TIMESERIES.stop()
    return _TIMESERIES


def stage_totals(prefix: str = "") -> dict:
    """{span name: total µs} — per-stage attribution for the benches."""
    return tracer.TRACER.stage_totals(prefix)


def coverage(t0_s: float, t1_s: float,
             prefixes: Sequence[str] = LAYER_PREFIXES) -> float:
    """Fraction of the perf_counter interval covered by instrumented
    spans across the serving layers (the >=95% acceptance check)."""
    return tracer.TRACER.coverage(t0_s, t1_s, prefixes=prefixes)


def snapshot() -> dict:
    """One structured view of everything observed so far: metric values
    and histogram percentiles, per-span totals, query-log aggregates,
    tracer + flight-recorder state.  Schema is additive-versioned for
    the BENCH files."""
    return {
        "schema_version": 2,
        "wall_time": time.time(),
        "metrics": metrics.REGISTRY.snapshot(),
        "spans": tracer.TRACER.summary(),
        "query_log": querylog.QUERY_LOG.snapshot(),
        "tracer": {
            "enabled": tracer.TRACER.enabled,
            "events": len(tracer.TRACER),
            "dropped": tracer.TRACER.dropped,
        },
        "flight": flight.FLIGHT.snapshot(),
    }


def dump_flight(reason: str = "manual",
                dirpath: Optional[str] = None) -> Optional[str]:
    """Freeze a flight bundle right now (the ops/debugger entry point).
    Arms the recorder at ``dirpath`` first when given; bypasses the
    rate limit but not arming — returns the bundle directory, or
    ``None`` when the recorder is unarmed / over its dump budget."""
    if dirpath is not None and not flight.FLIGHT.armed:
        flight.FLIGHT.arm(dirpath)
    return flight.FLIGHT.trigger(reason, force=True)


def dump(dirpath: str, prefix: str = "") -> dict:
    """Write the trace (Chrome format), metrics snapshot (JSON and
    OpenMetrics text) and query log under ``dirpath`` — plus the
    time-series ring when the background sampler ran; returns
    {kind: path}."""
    import json

    os.makedirs(dirpath, exist_ok=True)
    paths = {
        "trace": tracer.TRACER.dump(
            os.path.join(dirpath, prefix + "trace.json")),
        "metrics": os.path.join(dirpath, prefix + "metrics.json"),
        "prom": export.write_prom(
            os.path.join(dirpath, prefix + "metrics.prom")),
        "querylog": querylog.QUERY_LOG.to_jsonl(
            os.path.join(dirpath, prefix + "querylog.jsonl")),
    }
    with open(paths["metrics"], "w") as f:
        json.dump(snapshot(), f, indent=1)
    # to_jsonl flushes the partial in-flight window itself, so even a
    # sampler that never completed an interval exports its data
    if _TIMESERIES is not None:
        paths["timeseries"] = _TIMESERIES.to_jsonl(
            os.path.join(dirpath, prefix + "timeseries.jsonl"))
    return paths
