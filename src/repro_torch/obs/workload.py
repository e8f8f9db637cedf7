"""Workload analytics: streaming heavy hitters + shard-load skew.

The query log records per-query facts; this module aggregates them into
the signals the hot-shard economics work (ROADMAP: replication +
query-log-driven repartitioning, DAGGER-style) actually needs:

* **heavy hitters** — which vertices, rect buckets and shards dominate
  the stream.  Detection is streaming via the Space-Saving sketch
  (Metwally et al.): bounded memory (``capacity`` monitored keys),
  with the classic guarantees — every key whose true frequency exceeds
  ``n / capacity`` is monitored, estimates overcount by at most the
  tracked per-key error, and ``true <= estimate <= true + n/capacity``.
  Because the sketch consumes records as a :class:`QueryLog` sink it
  sees the *whole* stream, not just the log's retained ring window;
  :meth:`WorkloadAnalytics.verify` recounts the retained window exactly
  and cross-checks the sketch against it.
* **shard-load skew** — per-shard query share and latency share, their
  Gini coefficients, and max/mean balance: the placement report a
  repartitioner consumes (move load off shards whose share drives the
  Gini up; replicate the heavy-hitter vertices' trees).
* **healthy vs degraded split** — the schema-v2 ``status`` field lets
  the report separate device-served traffic from exact-host-degraded
  traffic, so a hot shard that is hot *because* it is degraded is
  visible as such.

Nothing here touches the serving hot path: records arrive only when the
query log records (obs enabled, or an explicit log), so the disabled
overhead stays at the existing <2% gate.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from . import querylog as _ql


def gini(values) -> float:
    """Gini coefficient of a non-negative load vector in ``[0, 1)``:
    0 = perfectly balanced, ``(n-1)/n`` = one shard carries everything.
    Computed with the sorted-rank formula (O(n log n)), identical to
    the pairwise mean-absolute-difference definition."""
    x = np.sort(np.asarray(values, dtype=np.float64).ravel())
    n = len(x)
    s = x.sum()
    if n == 0 or s <= 0.0:
        return 0.0
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * np.sum(ranks * x) / (n * s)) - (n + 1.0) / n)


class SpaceSaving:
    """Space-Saving heavy-hitter sketch over a key stream.

    Maintains at most ``capacity`` monitored keys.  ``offer(key)``
    either bumps a monitored key, fills a free slot, or evicts the
    current minimum-count key and inherits its count as the newcomer's
    error bound.  Guarantees (n = total offered weight):

    * any key with true count > n / capacity is monitored;
    * for a monitored key: ``estimate - error <= true <= estimate``;
    * ``error <= n / capacity``.

    The min is tracked with a lazily-invalidated heap (stale entries
    are skipped on pop and the heap is rebuilt when it outgrows the
    monitored set), so offers stay O(log capacity) amortised.
    """

    __slots__ = ("capacity", "n", "_counts", "_errs", "_heap")

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.n = 0
        self._counts: Dict[Hashable, int] = {}
        self._errs: Dict[Hashable, int] = {}
        self._heap: List[tuple] = []    # (count, seq, key) lazy entries

    def offer(self, key: Hashable, inc: int = 1) -> None:
        self.n += inc
        c = self._counts.get(key)
        if c is not None:
            self._counts[key] = c + inc
        elif len(self._counts) < self.capacity:
            self._counts[key] = inc
            self._errs[key] = 0
        else:
            # evict the current minimum; the newcomer inherits its
            # count as the overcount bound
            while True:
                mc, _seq, mk = self._heap[0]
                if self._counts.get(mk) == mc:
                    break
                heapq.heappop(self._heap)           # stale
            heapq.heappop(self._heap)
            del self._counts[mk]
            del self._errs[mk]
            self._counts[key] = mc + inc
            self._errs[key] = mc
        heapq.heappush(self._heap, (self._counts[key], self.n, key))
        if len(self._heap) > 8 * self.capacity:     # compact lazy dups
            self._heap = [(c, 0, k) for k, c in self._counts.items()]
            heapq.heapify(self._heap)

    def count(self, key: Hashable) -> Optional[Tuple[int, int]]:
        """(estimate, error bound) for a monitored key, else None."""
        c = self._counts.get(key)
        return None if c is None else (c, self._errs[key])

    def items(self) -> List[Tuple[Hashable, int, int]]:
        """[(key, estimate, error)] sorted by estimate, descending."""
        return sorted(((k, c, self._errs[k])
                       for k, c in self._counts.items()),
                      key=lambda t: (-t[1], str(t[0])))

    def heavy_hitters(self, phi: float) -> List[Tuple[Hashable, int, int]]:
        """Keys whose estimate reaches ``phi * n``.  Complete (no false
        negatives) whenever ``phi > 1 / capacity``; reported counts obey
        the sketch error bound."""
        thr = phi * self.n
        return [t for t in self.items() if t[1] >= thr]

    def top(self, k: int) -> List[Tuple[Hashable, int, int]]:
        return self.items()[: int(k)]

    def __len__(self) -> int:
        return len(self._counts)


class WorkloadAnalytics:
    """Streaming aggregation of query-log records into a placement
    report.  Attach with ``query_log.add_sink(wa.observe)`` (or replay
    a retained window through :meth:`observe`); thread-safe — the
    frontend scheduler thread is the usual producer."""

    def __init__(self, k_vertices: int = 256, k_rects: int = 64,
                 k_shards: int = 64):
        self._lock = threading.Lock()
        self.vertices = SpaceSaving(k_vertices)
        self.rect_buckets = SpaceSaving(k_rects)
        self.shards = SpaceSaving(k_shards)
        self.total = 0
        self.latency_us_sum = 0.0
        self.by_status: Dict[str, int] = {}
        self.retries = 0
        self._shard_q: Dict[int, int] = {}
        self._shard_lat: Dict[int, float] = {}
        self._shard_degraded: Dict[int, int] = {}

    # -- ingestion ------------------------------------------------------

    def observe(self, rec: tuple) -> None:
        """Consume one query-log record (schema v2 tuple)."""
        u = rec[_ql.I_U]
        shard = rec[_ql.I_SHARD]
        lat = rec[_ql.I_LATENCY_US]
        status = rec[_ql.I_STATUS]
        with self._lock:
            self.total += 1
            self.latency_us_sum += lat
            self.by_status[status] = self.by_status.get(status, 0) + 1
            self.retries += rec[_ql.I_RETRIES]
            if u >= 0:
                self.vertices.offer(u)
            self.rect_buckets.offer(rec[_ql.I_RECT_BUCKET])
            self.shards.offer(shard)
            self._shard_q[shard] = self._shard_q.get(shard, 0) + 1
            self._shard_lat[shard] = self._shard_lat.get(shard, 0.0) + lat
            if status != "ok":
                self._shard_degraded[shard] = \
                    self._shard_degraded.get(shard, 0) + 1

    def observe_all(self, records) -> None:
        for rec in records:
            self.observe(rec)

    # -- skew -----------------------------------------------------------

    def skew(self) -> dict:
        """Per-shard load shares and their inequality metrics."""
        with self._lock:
            shard_q = dict(self._shard_q)
            shard_lat = dict(self._shard_lat)
            shard_deg = dict(self._shard_degraded)
            total = self.total
            lat_sum = self.latency_us_sum
        shards = sorted(shard_q)
        q = np.array([shard_q[s] for s in shards], dtype=np.float64)
        lat = np.array([shard_lat[s] for s in shards], dtype=np.float64)
        q_share = q / total if total else q
        lat_share = lat / lat_sum if lat_sum else lat
        per_shard = {
            str(s): {
                "queries": int(q[i]),
                "query_share": float(q_share[i]),
                "latency_us": float(lat[i]),
                "latency_share": float(lat_share[i]),
                "degraded": int(shard_deg.get(s, 0)),
            }
            for i, s in enumerate(shards)
        }
        return {
            "n_shards": len(shards),
            "per_shard": per_shard,
            "gini_queries": gini(q),
            "gini_latency": gini(lat),
            "max_query_share": float(q_share.max()) if len(q) else 0.0,
            "balance": float(q.max() / q.mean()) if len(q) else 0.0,
        }

    # -- verification ---------------------------------------------------

    def verify(self, query_log: "_ql.QueryLog",
               phi: float = 0.01) -> dict:
        """Exact recount of the log's retained window vs the sketch.

        When the window is the whole stream (nothing evicted since the
        sketch attached), the Space-Saving guarantee is checkable
        directly: every exact heavy hitter (frequency >= phi * n) must
        appear in ``heavy_hitters(phi)`` and every estimate must sit in
        ``[true, true + n/capacity]``.
        """
        records = query_log.records()
        exact: Dict[int, int] = {}
        for rec in records:
            u = rec[_ql.I_U]
            if u >= 0:
                exact[u] = exact.get(u, 0) + 1
        n = sum(exact.values())
        window_is_stream = query_log.dropped == 0 and n == self.vertices.n
        thr = phi * max(n, 1)
        exact_hh = {u for u, c in exact.items() if c >= thr}
        sketch_hh = {k for k, _c, _e in self.vertices.heavy_hitters(phi)}
        bound = self.vertices.n / self.vertices.capacity
        max_overcount = 0
        within_bound = True
        for k, c, _e in self.vertices.items():
            t = exact.get(k, 0)
            if window_is_stream:
                if not (t <= c <= t + bound):
                    within_bound = False
                max_overcount = max(max_overcount, c - t)
        return {
            "window": len(records),
            "window_is_stream": window_is_stream,
            "exact_heavy_hitters": sorted(exact_hh),
            "sketch_heavy_hitters": sorted(sketch_hh),
            "all_exact_reported": exact_hh <= sketch_hh,
            "exact_match": window_is_stream and exact_hh <= sketch_hh
            and within_bound,
            "max_overcount": int(max_overcount),
            "error_bound": float(bound),
        }

    # -- report ---------------------------------------------------------

    def placement_report(self, top_k: int = 10,
                         query_log: Optional["_ql.QueryLog"] = None,
                         phi: float = 0.01) -> dict:
        """The structured input for a repartitioner: skew + heavy
        hitters (+ an exact-recount verification block when the source
        log is supplied)."""

        def hh(sketch: SpaceSaving) -> list:
            n = max(sketch.n, 1)
            return [{"key": k if isinstance(k, str) else int(k),
                     "count": int(c), "err": int(e),
                     "share": float(c / n)}
                    for k, c, e in sketch.top(top_k)]

        with self._lock:
            total = self.total
            by_status = dict(self.by_status)
            retries = self.retries
            lat_sum = self.latency_us_sum
        report = {
            "schema_version": 1,
            "total_queries": total,
            "latency_us_sum": lat_sum,
            "by_status": by_status,
            "degraded_fraction": (
                sum(v for k, v in by_status.items() if k != "ok")
                / total if total else 0.0),
            "device_retries": retries,
            "skew": self.skew(),
            "heavy_hitters": {
                "vertices": hh(self.vertices),
                "rect_buckets": hh(self.rect_buckets),
                "shards": hh(self.shards),
            },
            "sketch": {
                "capacity": self.vertices.capacity,
                "monitored": len(self.vertices),
                "error_bound": self.vertices.n / self.vertices.capacity,
            },
        }
        if query_log is not None:
            report["verified"] = self.verify(query_log, phi=phi)
        return report

    def top_table(self, top_k: int = 10) -> str:
        """Human-readable top-k heavy-hitter table (the ``--obs`` serve
        epilogue prints this)."""
        lines = []
        n = max(self.total, 1)
        for title, sketch in (("vertex", self.vertices),
                              ("rect_bucket", self.rect_buckets),
                              ("shard", self.shards)):
            lines.append(f"  {title:>12}  {'count':>8}  {'±err':>6}  share")
            for k, c, e in sketch.top(top_k):
                lines.append(
                    f"  {str(k):>12}  {c:>8d}  {e:>6d}  {c / n:6.1%}")
        return "\n".join(lines)
