"""Flight recorder: an always-on black box + SLO-triggered debug bundles.

A tail-latency incident in a serving run is unreproducible by
definition — by the time a human looks, the queue has drained, the
breaker has closed and the interesting spans have been evicted.  The
flight recorder keeps the recent past in bounded rings (the span
tracer's buffer, the structured query log's window, its own event ring
of fault / breaker / SLO / audit transitions) and **freezes** them into
a self-contained ``flightdump/`` bundle the moment something goes
wrong:

* a PR-8 SLO burn-rate monitor fires (``slo.py`` notifies on every
  ``fired`` transition);
* a circuit breaker opens (``resilience.breaker`` notifies on every
  closed/half-open → open transition);
* the online exactness auditor observes a divergence
  (:mod:`repro_torch.obs.audit`);
* someone calls :func:`repro_torch.obs.dump_flight` (manual, e.g. from a
  debugger or an ops shell).

Triggers are **rate-limited** (default: one bundle per 30s, bounded
total per run) so a burning SLO cannot fill a disk, and the recorder
only writes when **armed** (``serve.py --obs`` arms it; unit tests stay
silent).  ``note()`` — the always-on black-box append — is one bounded
deque append and is safe from any thread.

Bundle layout (all paths relative to the bundle directory)::

    manifest.json     schema, trigger, counts, exemplars, worst traces
    trace.json        Chrome-trace of the span ring (chrome://tracing)
    spans.jsonl       the same spans as JSONL (header line first)
    querylog.jsonl    the query-log window (schema v3: trace_id/attempt)
    events.jsonl      fault / breaker / SLO / audit event ring
    metrics.json      registry snapshot at freeze time

Replay CLI — prints the causal story (admission → kernel/shards →
retries/degradation → completion) of the worst traces in the bundle::

    python -m repro_torch.obs.flight results/flightdump/000-slo-latency
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import querylog as _querylog
from .tracer import TRACER

SCHEMA_VERSION = 1

#: spans written per bundle (newest retained; the tracer ring itself
#: may hold up to a million)
MAX_BUNDLE_SPANS = 50_000


class FlightRecorder:
    """Bounded black-box ring + rate-limited bundle freezing."""

    def __init__(self, capacity_events: int = 4096):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity_events))
        self.events_total = 0
        self.armed = False
        self._dir: Optional[str] = None
        self.min_interval_s = 30.0
        self.max_dumps = 16
        self._last_dump_t = -math.inf
        self._seq = 0

    # -- black box ------------------------------------------------------

    def note(self, kind: str, **fields) -> None:
        """Append one event to the always-on bounded ring (breaker
        transitions, SLO fired/cleared, injected faults, audit
        divergences).  Cheap and thread-safe; never triggers a dump by
        itself."""
        evt = {"t": time.time(), "kind": kind}
        evt.update(fields)
        with self._lock:
            self._events.append(evt)
            self.events_total += 1

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # -- arming ---------------------------------------------------------

    def arm(self, dirpath: str, min_interval_s: float = 30.0,
            max_dumps: int = 16) -> "FlightRecorder":
        """Arm the recorder: triggers now freeze bundles under
        ``dirpath`` (rate-limited).  Unarmed (the default), triggers
        are counted but write nothing — unit tests and library users
        who never opted in stay file-free."""
        with self._lock:
            self._dir = str(dirpath)
            self.min_interval_s = float(min_interval_s)
            self.max_dumps = int(max_dumps)
            self.armed = True
        return self

    def disarm(self) -> None:
        with self._lock:
            self.armed = False

    def reset(self) -> None:
        """Forget events and disarm (test isolation; the rate-limit
        clock and dump sequence restart too)."""
        with self._lock:
            self._events.clear()
            self.events_total = 0
            self.armed = False
            self._dir = None
            self._last_dump_t = -math.inf
            self._seq = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": self.armed, "dir": self._dir,
                    "events": len(self._events),
                    "events_total": self.events_total,
                    "dumps": self._seq}

    # -- triggering -----------------------------------------------------

    def trigger(self, reason: str, detail: Optional[dict] = None,
                force: bool = False) -> Optional[str]:
        """Freeze a bundle for ``reason``; returns its directory, or
        ``None`` when unarmed / rate-limited / over the dump budget.
        ``force`` (the manual ``obs.dump_flight`` path) skips the rate
        limit but still respects arming and ``max_dumps``."""
        reg = _metrics.REGISTRY
        reg.counter(f"flight.trigger.{reason}").inc()
        with self._lock:
            if not self.armed or self._dir is None:
                reg.counter("flight.unarmed").inc()
                return None
            now = time.monotonic()
            if not force and now - self._last_dump_t < self.min_interval_s:
                reg.counter("flight.suppressed").inc()
                return None
            if self._seq >= self.max_dumps:
                reg.counter("flight.suppressed").inc()
                return None
            self._last_dump_t = now
            seq = self._seq
            self._seq += 1
            root = self._dir
        path = self._write_bundle(root, seq, reason, detail)
        reg.counter("flight.dumps").inc()
        return path

    # -- bundle writing -------------------------------------------------

    def _write_bundle(self, root: str, seq: int, reason: str,
                      detail: Optional[dict]) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)
        bundle = os.path.join(root, f"{seq:03d}-{safe}")
        os.makedirs(bundle, exist_ok=True)

        spans = TRACER.events()[-MAX_BUNDLE_SPANS:]
        with open(os.path.join(bundle, "spans.jsonl"), "w") as f:
            f.write(json.dumps({"schema_version": SCHEMA_VERSION,
                                "fields": ["name", "cat", "tid", "t0_us",
                                           "dur_us", "args"]}) + "\n")
            for name, cat, tid, t0, dur, args in spans:
                f.write(json.dumps({
                    "name": name, "cat": cat, "tid": tid,
                    "t0_us": t0 / 1e3, "dur_us": dur / 1e3,
                    "args": args or {}}) + "\n")
        TRACER.dump(os.path.join(bundle, "trace.json"))
        _querylog.QUERY_LOG.to_jsonl(os.path.join(bundle, "querylog.jsonl"))
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            for evt in self.events():
                f.write(json.dumps(evt) + "\n")
        _metrics.REGISTRY.dump(os.path.join(bundle, "metrics.json"))

        qrecs = _querylog.QUERY_LOG.records()
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "detail": detail,
            "t_wall": time.time(),
            "files": ["manifest.json", "trace.json", "spans.jsonl",
                      "querylog.jsonl", "events.jsonl", "metrics.json"],
            "counts": {
                "spans": len(spans),
                "spans_dropped": TRACER.dropped,
                "querylog": len(qrecs),
                "events": len(self.events()),
            },
            "exemplars": self._exemplar_index(),
            "worst_traces": _worst_trace_ids(
                [dict(zip(_querylog.FIELDS, r)) for r in qrecs]),
        }
        with open(os.path.join(bundle, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return bundle

    @staticmethod
    def _exemplar_index() -> Dict[str, dict]:
        """{histogram name: {bucket: [[trace_id, value], ...]}} over
        every registry histogram that retained exemplars — the lookup
        the replay CLI resolves p99 requests through."""
        out: Dict[str, dict] = {}
        for name, m in _metrics.REGISTRY.items():
            if isinstance(m, _metrics.Histogram):
                ex = m.exemplars()
                if ex:
                    out[name] = {
                        str(i): [[tid, val] for tid, val in res]
                        for i, res in sorted(ex.items())}
        return out


FLIGHT = FlightRecorder()


def _worst_trace_ids(records: List[dict], p: float = 99.0,
                     cap: int = 32) -> List[dict]:
    """Trace summaries for the records in the window's p99 latency
    bucket (ties included), worst first."""
    lats = [r["latency_us"] for r in records if r.get("trace_id", -1) >= 0]
    if not lats:
        return []
    lats_sorted = sorted(lats)
    k = max(0, min(len(lats_sorted) - 1,
                   int(math.ceil(p / 100.0 * len(lats_sorted))) - 1))
    thresh = lats_sorted[k]
    worst = [r for r in records
             if r.get("trace_id", -1) >= 0 and r["latency_us"] >= thresh]
    worst.sort(key=lambda r: -r["latency_us"])
    return [{"trace_id": r["trace_id"], "latency_us": r["latency_us"],
             "status": r["status"], "attempt": r.get("attempt", 0),
             "u": r["u"], "query_class": r["query_class"],
             "shard": r["shard"]} for r in worst[:cap]]


# ---------------------------------------------------------------------------
# replay: load a bundle and reconstruct causal stories
# ---------------------------------------------------------------------------

def _load_jsonl(path: str, skip_header: bool = True) -> List[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if i == 0 and skip_header and "schema_version" in obj \
                    and "fields" in obj:
                continue
            out.append(obj)
    return out


def load_bundle(bundle: str) -> dict:
    """Parse a flight bundle directory into plain dicts/lists."""
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    return {
        "manifest": manifest,
        "spans": _load_jsonl(os.path.join(bundle, "spans.jsonl")),
        "querylog": _load_jsonl(os.path.join(bundle, "querylog.jsonl")),
        "events": _load_jsonl(os.path.join(bundle, "events.jsonl"),
                              skip_header=False),
    }


def resolve_trace(data: dict, trace_id: int) -> dict:
    """One trace id's causal story out of a loaded bundle: the
    admission record, every span that served it, every black-box event
    that names it, and a completeness verdict (admission → engine work
    → completion all present)."""
    tid = int(trace_id)
    record = next((r for r in data["querylog"]
                   if r.get("trace_id") == tid), None)
    spans = [s for s in data["spans"]
             if tid in (s.get("args") or {}).get("trace_ids", ())]
    spans.sort(key=lambda s: s["t0_us"])
    events = [e for e in data["events"]
              if tid in e.get("trace_ids", ())
              or e.get("trace_id") == tid]
    worked = any(s["name"].split(".")[0] in
                 ("engine", "cluster", "dynamic", "resilience")
                 for s in spans)
    return {
        "trace_id": tid,
        "record": record,
        "spans": spans,
        "events": events,
        "complete": record is not None and worked,
    }


def replay(bundle: str, top: int = 5) -> dict:
    """The replay the CLI prints: resolve the worst traces (manifest
    ``worst_traces`` ∪ the p99-bucket exemplars of every latency
    histogram) against the bundle's spans / querylog / events."""
    data = load_bundle(bundle)
    manifest = data["manifest"]
    targets: List[int] = []
    for w in manifest.get("worst_traces", []):
        if w["trace_id"] not in targets:
            targets.append(w["trace_id"])
    # every exemplar in the top occupied bucket of each histogram —
    # "the p99 latency bucket of the dump window" resolved by lookup
    exemplar_ids: List[int] = []
    for _name, buckets in manifest.get("exemplars", {}).items():
        if not buckets:
            continue
        top_bucket = max(buckets, key=lambda b: int(b))
        for tid, _v in buckets[top_bucket]:
            if tid not in exemplar_ids:
                exemplar_ids.append(tid)
    for tid in exemplar_ids:
        if tid not in targets:
            targets.append(tid)
    stories = [resolve_trace(data, t) for t in targets[:max(top, 1)]]
    return {
        "bundle": bundle,
        "reason": manifest.get("reason"),
        "counts": manifest.get("counts", {}),
        "targets": targets,
        "exemplar_ids": exemplar_ids,
        "stories": stories,
        "resolved": sum(1 for s in stories if s["complete"]),
    }


def _print_story(story: dict) -> None:
    tid = story["trace_id"]
    rec = story["record"]
    print(f"trace {tid}" + ("" if story["complete"]
                            else "  [INCOMPLETE]"))
    if rec is not None:
        dl = rec.get("attempt", 0)
        print(f"  admitted  u={rec['u']} class={rec['query_class']} "
              f"rect_bucket={rec['rect_bucket']} shard={rec['shard']}")
        print(f"  completed status={rec['status']} attempt={dl} "
              f"retries={rec.get('retries', 0)} "
              f"latency={rec['latency_us']:.0f}us "
              f"cardinality={rec['cardinality']}")
    else:
        print("  (no querylog record retained in the window)")
    for s in story["spans"]:
        n_ids = len((s.get("args") or {}).get("trace_ids", ()))
        print(f"    span {s['name']:<28} {s['dur_us']:>10.1f}us "
              f"(batch of {n_ids})")
    for e in story["events"]:
        kind = e.get("kind", "?")
        extra = {k: v for k, v in e.items()
                 if k not in ("t", "kind", "trace_ids")}
        print(f"    event {kind} {extra}")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.flight",
        description="Replay a flight-recorder bundle: print the causal "
                    "story of the worst traces.")
    ap.add_argument("bundle", help="bundle directory (contains "
                                   "manifest.json)")
    ap.add_argument("--top", type=int, default=5,
                    help="how many worst traces to print")
    args = ap.parse_args(argv)

    rep = replay(args.bundle, top=args.top)
    print(f"[flight] bundle {rep['bundle']}  trigger={rep['reason']}  "
          f"spans={rep['counts'].get('spans')}  "
          f"querylog={rep['counts'].get('querylog')}  "
          f"events={rep['counts'].get('events')}")
    if not rep["stories"]:
        print("[flight] no traced requests in the window")
        return 0
    print(f"[flight] {rep['resolved']}/{len(rep['stories'])} worst "
          f"traces resolve to a full causal chain "
          f"(admission -> kernel/shards -> completion)")
    for story in rep["stories"]:
        _print_story(story)
    return 0 if rep["resolved"] == len(rep["stories"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
