"""Structured query log: the durable record of what was actually served.

Every served query can append one bounded-memory record — query vertex,
vertex class, query class, log2 rect-area bucket, owning shard, latency,
result cardinality, and the engine-reported serving status (healthy vs
degraded, retry count) — the direct input for the workload analytics
(:mod:`repro_torch.obs.workload`), the planned result cache (cache key =
``(vertex_class, rect_bucket)``) and query-log-driven hot-shard
repartitioning (shard load = records per shard).  The log is a
ring buffer (oldest records drop once ``capacity`` is reached, with a
drop counter, never unbounded growth) plus always-cheap aggregate
counters that survive ring eviction; ``to_jsonl`` exports the retained
window for offline analysis (first line: a schema header).

Streaming consumers (the Space-Saving sketches in
:mod:`~repro_torch.obs.workload`) attach with :meth:`QueryLog.add_sink` and
see every record *before* ring eviction, so their aggregates cover the
whole stream even when the ring only retains a window of it.

Schema v2 grew ``u`` (the query vertex id — heavy-hitter detection
needs the key, not just its class), ``status`` (``ok`` / ``degraded``:
whether the engine answered on the device path or the exact host
fallback) and ``retries`` (device attempts the batch burned beyond the
first); v1 consumers keyed on field names keep working, the JSONL dump
carries ``schema_version`` in its header line.

Schema v3 grew the causal columns: ``trace_id`` (the per-request
:class:`~repro_torch.obs.trace_context.TraceContext` id minted at
``Frontend.submit`` — the join key against span ``trace_ids`` and
histogram exemplars in a flight bundle) and ``attempt`` (device
attempts that included *this* query, attributed per trace id by
``ResilientEngine.last_report`` instead of the batch-level ``retries``
count, which stays for v2 consumers).  Both default to their "unknown"
values (-1 / 0) for producers without a trace context; the aggregate
surfaces (``by_status`` et al.) are unchanged.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

SCHEMA_VERSION = 3

FIELDS = ("t", "query_class", "u", "vertex_class", "rect_bucket", "shard",
          "latency_us", "cardinality", "status", "retries",
          "trace_id", "attempt")

# tuple indices for consumers iterating raw records (v3 appends fields,
# so v2 consumers indexing by these constants keep working)
I_T, I_QUERY_CLASS, I_U, I_VERTEX_CLASS, I_RECT_BUCKET, I_SHARD, \
    I_LATENCY_US, I_CARDINALITY, I_STATUS, I_RETRIES, \
    I_TRACE_ID, I_ATTEMPT = range(len(FIELDS))


def rect_bucket(rect) -> int:
    """log2 bucket of the rect's area — the workload-skew key.

    Degenerate (zero-area) rects bucket to -64; buckets clamp to
    [-63, 63] so the key space stays enumerable for cache sizing.
    """
    r = np.asarray(rect, dtype=np.float64).ravel()
    dim = len(r) // 2
    area = 1.0
    for a in range(dim):
        area *= max(float(r[dim + a] - r[a]), 0.0)
    if area <= 0.0:
        return -64
    return int(np.clip(math.floor(math.log2(area)), -63, 63))


def vertex_class_of(index_like, us) -> np.ndarray:
    """Coarse per-vertex classes from whatever the serving object
    exposes: ``sink`` (excluded spatial sink — Alg. 2's special case),
    ``user`` (routed through a tree probe), ``unknown`` otherwise."""
    us = np.asarray(us, dtype=np.int64)
    exc = getattr(index_like, "_excluded_host", None)
    if exc is None:
        exc = getattr(index_like, "excluded", None)
    if exc is None:
        return np.full(len(us), "unknown", dtype=object)
    out = np.full(len(us), "user", dtype=object)
    out[np.asarray(exc)[us]] = "sink"
    return out


class QueryLog:
    """Bounded ring of per-query records + eviction-proof aggregates."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self.total = 0
        self.by_class: Dict[str, int] = {}
        self.by_shard: Dict[int, int] = {}
        self.by_status: Dict[str, int] = {}
        self._sinks: List[Callable[[tuple], None]] = []

    def add_sink(self, sink: Callable[[tuple], None]) -> None:
        """Register a streaming consumer called with every record
        appended from now on (before any ring eviction drops it)."""
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[tuple], None]) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def record(self, query_class: str, vertex_class: str, rect_b: int,
               shard: int, latency_s: float, cardinality: int,
               t: Optional[float] = None, u: int = -1,
               status: str = "ok", retries: int = 0,
               trace_id: int = -1, attempt: int = 0) -> None:
        rec = (t if t is not None else time.time(), query_class, int(u),
               vertex_class, int(rect_b), int(shard),
               float(latency_s) * 1e6, int(cardinality), status,
               int(retries), int(trace_id), int(attempt))
        with self._lock:
            self._ring.append(rec)
            self.total += 1
            self.by_class[query_class] = self.by_class.get(query_class, 0) + 1
            self.by_shard[rec[I_SHARD]] = \
                self.by_shard.get(rec[I_SHARD], 0) + 1
            self.by_status[status] = self.by_status.get(status, 0) + 1
            sinks = list(self._sinks)
        for sink in sinks:
            sink(rec)

    def record_batch(self, query_class: str, vertex_classes, rects,
                     shards, latencies_s, cardinalities,
                     us=None, statuses=None, retries: int = 0,
                     trace_ids=None, attempts=None) -> None:
        """Vectorised append for a served batch (one lock per record,
        shared wall timestamp).  ``statuses`` is a per-query string
        sequence (or one string for the whole batch); ``retries`` is
        the batch-level device retry count the engine reported;
        ``trace_ids`` / ``attempts`` are the per-query causal columns
        (schema v3) the frontend reads off the batch's trace contexts
        and the resilient engine's per-trace attribution."""
        now = time.time()
        shards = np.asarray(shards)
        lats = np.asarray(latencies_s, dtype=np.float64)
        cards = np.asarray(cardinalities)
        for i in range(len(lats)):
            if statuses is None:
                st = "ok"
            elif isinstance(statuses, str):
                st = statuses
            else:
                st = str(statuses[i])
            self.record(query_class, str(vertex_classes[i]),
                        rect_bucket(rects[i]), int(shards[i]),
                        float(lats[i]), int(cards[i]), t=now,
                        u=int(us[i]) if us is not None else -1,
                        status=st, retries=retries,
                        trace_id=(int(trace_ids[i])
                                  if trace_ids is not None else -1),
                        attempt=(int(attempts[i])
                                 if attempts is not None else 0))

    # -- introspection --------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Records evicted from the ring (aggregates still count them)."""
        with self._lock:
            return self.total - len(self._ring)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._ring)
            lat = np.fromiter((r[I_LATENCY_US] for r in self._ring),
                              dtype=np.float64, count=n)
            out = {
                "schema_version": SCHEMA_VERSION,
                "retained": n,
                "total": self.total,
                "dropped": self.total - n,
                "capacity": self.capacity,
                "by_class": dict(self.by_class),
                "by_shard": {str(k): v
                             for k, v in sorted(self.by_shard.items())},
                "by_status": dict(self.by_status),
            }
        if n:
            out["latency_us"] = {
                f"p{p}": float(np.percentile(lat, p)) for p in (50, 95, 99)}
        return out

    def to_jsonl(self, path: str) -> str:
        """Export the retained window, one JSON object per line; the
        first line is a schema header (``schema_version`` + field
        list), the rest are records."""
        with open(path, "w") as f:
            f.write(json.dumps({"schema_version": SCHEMA_VERSION,
                                "fields": list(FIELDS)}) + "\n")
            for rec in self.records():
                f.write(json.dumps(dict(zip(FIELDS, rec))) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total = 0
            self.by_class = {}
            self.by_shard = {}
            self.by_status = {}


QUERY_LOG = QueryLog()
