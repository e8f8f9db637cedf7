"""Bench-regression sentinel: the port's ``BENCH_*.json`` runs against a
history of its own (the port of the reference's
``benchmarks/regress.py``).

The three perf benches (``perf_rangereach``, ``perf_build``,
``perf_queries``) each write a structured ``results/torch/BENCH_*.json``;
this tool reads the trajectory:

1. **extract** a flat ``{metric path: value}`` view of each BENCH file
   (latency-like metrics only: lower is better for everything tracked);
2. **compare** the current run against a noise-aware baseline: the
   median of the last ``--baseline-n`` history entries for that metric
   (median, not mean, so one noisy run cannot poison the baseline), with
   a relative tolerance: global ``--tol`` plus per-metric
   ``--metric-tol name=frac`` overrides;
3. **gate** the history-free structural ratios (:data:`RATIO_GATES`):
   per query class the fused device engine must not be slower than the
   host descent, and the cluster must stay within 2x the single device;
   same-run ratios, so they hold on any machine speed;
4. **append** the run to ``results/torch/bench_history.jsonl`` (one JSON
   object per line: timestamp, bench, label, metrics and the device
   named by ``--device``, the GPU by default) so the next run sees it;
5. print a per-metric verdict table and **exit nonzero** when any metric
   regressed past tolerance or any ratio gate broke.

It reads ``results/torch/`` only: never the reference's root
``BENCH_*.json`` or its ``results/bench_history.jsonl`` (``--bench`` and
``--history`` name other files explicitly).

    python -m repro_torch.benchmarks.perf_rangereach --smoke
    python -m repro_torch.benchmarks.regress          # check + append all
    python -m repro_torch.benchmarks.regress --tol 1.0 --label ci
    python -m repro_torch.benchmarks.regress --no-append \\
        --bench results/torch/BENCH_build.json

Tolerance: a same-machine history supports a tight ``--tol 0.25``;
across machines ``--tol 1.0`` catches algorithmic regressions (2x and
more), not scheduler noise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from .. import benchmarks as _bench
from ..device import resolve_device

BENCHES = ("BENCH_rangereach.json", "BENCH_build.json",
           "BENCH_queries.json")
HISTORY_FILE = "bench_history.jsonl"

SCHEMA_VERSION = 1

#: verdicts, in severity order
OK, IMPROVED, NEW, REGRESSED = "ok", "improved", "new", "REGRESSED"


def results_dir() -> str:
    """The port's ``results/torch/`` (``benchmarks.RESULTS``)."""
    return _bench.RESULTS


def default_history() -> str:
    return os.path.join(results_dir(), HISTORY_FILE)


# ---------------------------------------------------------------- extract

def _extract_rangereach(doc: dict) -> Dict[str, float]:
    out = {f"engines.{k}": float(v)
           for k, v in doc.get("engines", {}).items()}
    for eng, pct in doc.get("latency_percentiles_us", {}).items():
        if "p99" in pct:
            out[f"latency.{eng}.p99"] = float(pct["p99"])
    deg = doc.get("degraded", {})
    if "degraded_us_per_q" in deg:
        out["degraded.us_per_q"] = float(deg["degraded_us_per_q"])
    return out


def _extract_build(doc: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for variant, row in (doc.get("largest_config", {})
                         .get("per_variant", {})).items():
        for key in ("host_total_s", "device_warm_total_s"):
            if key in row:
                out[f"build.{variant}.{key}"] = float(row[key])
    return out


def _extract_queries(doc: dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for cls, row in doc.get("classes", {}).items():
        for key in ("host_us_per_q", "device_us_per_q"):
            if key in row:
                out[f"queries.{cls}.{key}"] = float(row[key])
    return out


EXTRACTORS = {
    "BENCH_rangereach.json": _extract_rangereach,
    "BENCH_build.json": _extract_build,
    "BENCH_queries.json": _extract_queries,
}


def extract(bench: str, doc: dict) -> Dict[str, float]:
    """Flat latency metrics (lower is better) for one BENCH document."""
    fn = EXTRACTORS.get(os.path.basename(bench))
    if fn is None:
        raise ValueError(
            f"no extractor for {bench!r} (known: {sorted(EXTRACTORS)})")
    return fn(doc)


# ---------------------------------------------------------------- history

def load_history(path: Optional[str] = None) -> List[dict]:
    path = path or default_history()
    if not os.path.exists(path):
        return []
    runs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                runs.append(json.loads(line))
    return runs


def append_history(path: str, bench: str, metrics: Dict[str, float],
                   label: str = "", t: Optional[float] = None,
                   device: Optional[str] = None) -> dict:
    run = {
        "schema_version": SCHEMA_VERSION,
        "t": time.time() if t is None else t,
        "bench": os.path.basename(bench),
        "label": label,
        "metrics": metrics,
    }
    if device is not None:
        run["device"] = device
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(run) + "\n")
    return run


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def baseline_for(history: List[dict], bench: str, metric: str,
                 n: int) -> Optional[float]:
    """Median of the metric over the last ``n`` history runs of this
    bench that recorded it (None: no baseline yet)."""
    bench = os.path.basename(bench)
    vals = [run["metrics"][metric] for run in history
            if run.get("bench") == bench and metric in run.get(
                "metrics", {})]
    if not vals:
        return None
    return _median([float(v) for v in vals[-n:]])


# -------------------------------------------------------------- invariants

#: History-free ratio ceilings: the structural claims the fused serving
#: path must hold on every run, whatever the machine's speed: per query
#: class the device engine may not be slower than the host descent (both
#: numbers come from the same process, so machine noise cancels), and
#: the single-host cluster may not cost more than 2x the single-device
#: engine.  (bench, gate name, numerator metric, denominator metric, max
#: ratio).
RATIO_GATES = (
    ("BENCH_queries.json", "reach.device_vs_host",
     "queries.reach.device_us_per_q", "queries.reach.host_us_per_q", 1.0),
    ("BENCH_queries.json", "count.device_vs_host",
     "queries.count.device_us_per_q", "queries.count.host_us_per_q", 1.0),
    ("BENCH_queries.json", "collect.device_vs_host",
     "queries.collect.device_us_per_q",
     "queries.collect.host_us_per_q", 1.0),
    ("BENCH_queries.json", "knn.device_vs_host",
     "queries.knn.device_us_per_q", "queries.knn.host_us_per_q", 1.0),
    # polygon serves through the two-phase scan (host point-in-polygon
    # epilogue): a narrower margin, so a little noise headroom
    ("BENCH_queries.json", "polygon.device_vs_host",
     "queries.polygon.device_us_per_q",
     "queries.polygon.host_us_per_q", 1.25),
    ("BENCH_rangereach.json", "device_vs_host",
     "engines.device", "engines.host", 1.0),
    ("BENCH_rangereach.json", "cluster_vs_device",
     "engines.cluster", "engines.device", 2.0),
)


def gate_rows(bench: str, metrics: Dict[str, float],
              slack: float = 0.0) -> List[dict]:
    """Evaluate the :data:`RATIO_GATES` for one bench over its extracted
    metrics; ``slack`` relaxes every ceiling by a relative fraction."""
    bench = os.path.basename(bench)
    rows = []
    for b, name, num, den, ceil in RATIO_GATES:
        if b != bench or num not in metrics or den not in metrics:
            continue
        d = metrics[den]
        ratio = metrics[num] / d if d > 0 else float("inf")
        limit = ceil * (1.0 + slack)
        rows.append({"gate": name, "numerator": metrics[num],
                     "denominator": d, "ratio": ratio, "limit": limit,
                     "verdict": OK if ratio <= limit else REGRESSED})
    return rows


def print_gates(bench: str, rows: List[dict]) -> None:
    if not rows:
        return
    name_w = max([len(r["gate"]) for r in rows] + [12])
    print(f"[regress] {os.path.basename(bench)} ratio gates")
    print(f"  {'gate':<{name_w}}  {'num':>12}  {'den':>12}  "
          f"{'ratio':>7}  {'limit':>6}  verdict")
    for r in rows:
        print(f"  {r['gate']:<{name_w}}  {r['numerator']:12.3f}  "
              f"{r['denominator']:12.3f}  {r['ratio']:7.2f}  "
              f"{r['limit']:6.2f}  {r['verdict']}")


# ---------------------------------------------------------------- compare

def compare(bench: str, metrics: Dict[str, float], history: List[dict],
            baseline_n: int = 5, tol: float = 0.25,
            metric_tol: Optional[Dict[str, float]] = None) -> List[dict]:
    """Per-metric verdict rows: current against the noise-aware baseline.

    A metric REGRESSES when ``current > baseline * (1 + tolerance)``; it
    is IMPROVED below ``baseline * (1 - tolerance)`` (informational),
    NEW without a baseline, and ok otherwise.
    """
    metric_tol = metric_tol or {}
    rows = []
    for name in sorted(metrics):
        cur = float(metrics[name])
        base = baseline_for(history, bench, name, baseline_n)
        t = float(metric_tol.get(name, tol))
        if base is None:
            verdict, ratio = NEW, None
        else:
            ratio = cur / base if base > 0 else float("inf")
            if cur > base * (1.0 + t):
                verdict = REGRESSED
            elif cur < base * (1.0 - t):
                verdict = IMPROVED
            else:
                verdict = OK
        rows.append({"metric": name, "current": cur, "baseline": base,
                     "ratio": ratio, "tolerance": t, "verdict": verdict})
    return rows


def print_table(bench: str, rows: List[dict]) -> None:
    name_w = max([len(r["metric"]) for r in rows] + [12])
    print(f"[regress] {os.path.basename(bench)}")
    print(f"  {'metric':<{name_w}}  {'current':>12}  {'baseline':>12}  "
          f"{'ratio':>7}  {'tol':>5}  verdict")
    for r in rows:
        base = "-" if r["baseline"] is None else f"{r['baseline']:12.3f}"
        ratio = "-" if r["ratio"] is None else f"{r['ratio']:7.2f}"
        print(f"  {r['metric']:<{name_w}}  {r['current']:12.3f}  "
              f"{base:>12}  {ratio:>7}  {r['tolerance']:5.2f}  "
              f"{r['verdict']}")


# ---------------------------------------------------------------- driver

def run_sentinel(bench_paths: List[str], history_path: Optional[str] = None,
                 baseline_n: int = 5, tol: float = 0.25,
                 metric_tol: Optional[Dict[str, float]] = None,
                 append: bool = True, label: str = "",
                 gates: bool = True, gate_slack: float = 0.0,
                 device: Optional[str] = None) -> int:
    """Check every bench file against the history plus the history-free
    :data:`RATIO_GATES`, optionally append the runs, print verdict
    tables; returns the process exit code (1 when anything REGRESSED)."""
    history_path = history_path or default_history()
    history = load_history(history_path)
    regressed = []
    gated = []
    for path in bench_paths:
        with open(path) as f:
            doc = json.load(f)
        metrics = extract(path, doc)
        if not metrics:
            print(f"[regress] {os.path.basename(path)}: no tracked "
                  f"metrics; skipped")
            continue
        rows = compare(path, metrics, history, baseline_n=baseline_n,
                       tol=tol, metric_tol=metric_tol)
        print_table(path, rows)
        regressed += [r for r in rows if r["verdict"] == REGRESSED]
        if gates:
            grows = gate_rows(path, metrics, slack=gate_slack)
            print_gates(path, grows)
            gated += [r for r in grows if r["verdict"] == REGRESSED]
        if append:
            append_history(history_path, path, metrics, label=label,
                           device=device)
    if regressed:
        print(f"[regress] FAIL: {len(regressed)} metric(s) regressed "
              f"past tolerance:")
        for r in regressed:
            print(f"  {r['metric']}: {r['current']:.3f} vs baseline "
                  f"{r['baseline']:.3f} (x{r['ratio']:.2f} > "
                  f"1+{r['tolerance']:.2f})")
    if gated:
        print(f"[regress] FAIL: {len(gated)} ratio gate(s) broken:")
        for r in gated:
            print(f"  {r['gate']}: {r['numerator']:.3f} / "
                  f"{r['denominator']:.3f} = x{r['ratio']:.2f} > "
                  f"{r['limit']:.2f}")
    if regressed or gated:
        return 1
    print(f"[regress] ok: no regressions past tolerance "
          f"({len(history)} historical runs consulted)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="append", default=None,
                    help="BENCH_*.json to check (repeatable; default: "
                         "every known BENCH file present in "
                         "results/torch/)")
    ap.add_argument("--history", default=None,
                    help="history JSONL, append-only (default: "
                         "results/torch/bench_history.jsonl)")
    ap.add_argument("--baseline-n", type=int, default=5,
                    help="baseline = median of the last N runs")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="global relative tolerance (0.25 = fail past "
                         "+25%%)")
    ap.add_argument("--metric-tol", action="append", default=[],
                    metavar="NAME=FRAC",
                    help="per-metric tolerance override (repeatable)")
    ap.add_argument("--no-gates", action="store_true",
                    help="skip the history-free device-vs-host ratio "
                         "ceilings")
    ap.add_argument("--gate-slack", type=float, default=0.0,
                    help="relative slack on every ratio-gate ceiling "
                         "(0.1 = allow 10%% over)")
    ap.add_argument("--no-append", action="store_true",
                    help="check only; do not record this run")
    ap.add_argument("--no-check", action="store_true",
                    help="append only: seed or extend the history "
                         "without gating")
    ap.add_argument("--label", default="",
                    help="free-form run label recorded in the history "
                         "(e.g. ci / local / a git sha)")
    ap.add_argument("--device", default=None,
                    help="the device whose runs are judged, recorded "
                         "with each history entry (default: the GPU; "
                         "'cpu' for runs made with --device cpu)")
    args = ap.parse_args(argv)
    device = _bench.device_name(resolve_device(args.device))

    root = results_dir()
    history = args.history or default_history()
    benches = args.bench or [
        os.path.join(root, b) for b in BENCHES
        if os.path.exists(os.path.join(root, b))]
    if not benches:
        print("[regress] no BENCH_*.json found in results/torch/; run the "
              "perf benches first")
        return 2
    mtol = {}
    for spec in args.metric_tol:
        name, _, frac = spec.partition("=")
        if not frac:
            ap.error(f"--metric-tol wants NAME=FRAC, got {spec!r}")
        mtol[name] = float(frac)
    if args.no_check:
        for path in benches:
            with open(path) as f:
                metrics = extract(path, json.load(f))
            append_history(history, path, metrics, label=args.label,
                           device=device)
            print(f"[regress] appended {os.path.basename(path)} "
                  f"({len(metrics)} metrics) to {history}")
        return 0
    return run_sentinel(benches, history_path=history,
                        baseline_n=args.baseline_n, tol=args.tol,
                        metric_tol=mtol, append=not args.no_append,
                        label=args.label, gates=not args.no_gates,
                        gate_slack=args.gate_slack, device=device)


if __name__ == "__main__":
    sys.exit(main())
