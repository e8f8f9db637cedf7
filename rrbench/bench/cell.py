"""One run of one cell: set-up, the measured window, the per-layer
metrics, the check against the plain reference, and the result.

Set-up (``setup_s``, from the process's start to the first timed batch):
the graph from ``--seed`` (the harness's own generator), the program's
graph and index build on the card (``build_s``), the engine, the query
stream from the seed, and ``warm_batches`` batches of it, which build the
kernels on a checkout's first run and ratchet the engine's candidate
capacity.

The window: one client in a closed loop sends the stream's batches in
turn, the next once the previous batch's answers are on the host, for
``--seconds``.  Every batch of the window is new (``Stream``).
``queries_per_s`` is every query answered over the window's length;
``p95_ms`` the 95th percentile of the batches' times from the call into
the engine to the answers on the host.  With ``--trace 1`` the same
window runs under ``torch.profiler`` and the per-layer metrics are read
instead.

The check, once the window has closed and the program's state is freed:
the reference's answers to a sample, drawn from the seed, of the answers
the window gave (each batch keeps the answers at ``kept_per_batch``
positions drawn from the seed), all of which have to agree.

``control=True`` puts the reference, its region test in bfloat16, in the
program's place (answering the kept positions, the only ones the check
reads); the check has to find it wrong.  The benchmark's runs never do.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import lbsn, queries, spec, trace
from ..reference.rangereach import Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from ``/proc`` (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Stream:
    """The queries a run sends, drawn from the seed in set-up.

    Batch ``b`` pairs block ``b mod V`` of a pool of query vertices with
    block ``b mod R`` of a pool of regions (``vertex_blocks`` and
    ``region_blocks``, coprime), so the first ``V * R`` batches are all
    different and no query repeats among them.  Batches ``0 ..
    warm_batches - 1`` warm the program up; the window sends the next."""

    def __init__(self, graph: lbsn.Graph, traffic: Dict, seed: int):
        self.batch = B = int(traffic["batch"])
        self.v_blocks = int(traffic["vertex_blocks"])
        self.r_blocks = int(traffic["region_blocks"])
        if math.gcd(self.v_blocks, self.r_blocks) != 1:
            raise ValueError("vertex_blocks and region_blocks must be "
                             "coprime")
        self.warm = int(traffic["warm_batches"])
        self.check_sample = int(traffic["check_sample"])
        rng = np.random.default_rng([1, seed])
        self.us = queries.sample_vertices_by_degree(
            lbsn.out_degree(graph), traffic["degree_bucket"],
            self.v_blocks * B, rng).astype(np.int64)
        self.rects = queries.region_for_extent(
            lbsn.spatial_extent(graph), float(traffic["extent"]),
            self.r_blocks * B, rng)
        self.kept = np.sort(np.random.default_rng([2, seed]).choice(
            B, size=min(int(traffic["kept_per_batch"]), B), replace=False))
        self.seed = seed

    def queries(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        v, r = b % self.v_blocks, b % self.r_blocks
        return (self.us[v * self.batch:(v + 1) * self.batch],
                self.rects[r * self.batch:(r + 1) * self.batch])

    def check_picks(self, n_batches: int) -> np.ndarray:
        """Which of ``n_batches`` batches' kept answers the check compares
        (flat indices, ``check_sample`` of them or all), from the seed."""
        n = n_batches * len(self.kept)
        k = min(self.check_sample, n)
        return np.sort(np.random.default_rng([3, self.seed]).choice(
            n, size=k, replace=False))

    def kept_queries(self, seq: List[int], picks: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The queries at flat kept indices ``picks`` of the batches
        ``seq``."""
        k = len(self.kept)
        us = np.empty(len(picks), np.int64)
        rects = np.empty((len(picks), 4), np.float32)
        for j, f in enumerate(picks):
            bu, br = self.queries(seq[f // k])
            us[j], rects[j] = bu[self.kept[f % k]], br[self.kept[f % k]]
        return us, rects


class _Control:
    """The reference in the program's place, its region test in
    bfloat16: answers a batch's kept positions, the only ones the check
    reads, and 0 elsewhere."""

    def __init__(self, ref: Reference, stream: Stream, mode: str):
        self.ref, self.stream, self.mode = ref, stream, mode

    def __call__(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        k = self.stream.kept
        out = np.zeros(len(us), np.int64)
        out[k] = self.ref.counts(us[k], rects[k], dtype=torch.bfloat16)
        return out > 0 if self.mode == "reach" else out


def _engine_call(engine, mode: str) -> Callable:
    if mode == "count":
        return engine.count_batch
    if mode == "reach":
        return engine.query_batch
    raise ValueError(f"unknown traffic mode {mode!r}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(call, stream: Stream, seconds: float, traced: bool):
    """The measured window.  Returns (latencies s, batches sent in order,
    kept answers per batch, length s, the profiler or None)."""
    lat, seq, kept = [], [], []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        span = lambda: record_function(trace.WINDOW_SPAN)  # noqa: E731
    else:
        span = contextlib.nullcontext
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        b = stream.warm
        while True:
            us, rects = stream.queries(b)
            ts = time.perf_counter()
            with span():
                ans = call(us, rects)
            te = time.perf_counter()
            lat.append(te - ts)
            seq.append(b)
            kept.append(ans[stream.kept])
            b += 1
            if te >= deadline:
                break
    return lat, seq, kept, te - t0, prof


def run(cell: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", cell_spec: Optional[Dict] = None,
        control: bool = False) -> Dict:
    """One run.  Returns the result line, its compared numbers under
    ``limits``, last.  ``control`` runs the check's control instead of
    the program (see the module's note)."""
    sp = cell_spec or spec.cell_spec(cell)
    config, traffic = sp["config"], sp["traffic"]
    dev = torch.device(device)

    def say(msg):
        print(f"[rrbench {cell} seed={seed}] {msg}", file=sys.stderr,
              flush=True)

    stages = [("start", process_age_s())]

    def stage(name):
        stages.append((name, process_age_s()))

    graph = lbsn.generate(config["graph"], seed)
    stage("generate")
    stream = Stream(graph, traffic, seed)
    stage("stream")
    index = engine = ref = None
    build_s = 0.0
    if control:
        ref = Reference(graph.n_nodes, graph.edges, graph.coords,
                        graph.spatial_mask, device=dev)
        call = _Control(ref, stream, traffic["mode"])
        stage("reference")
    else:
        from repro_torch.core import QueryEngine, build_index, make_graph

        g = make_graph(graph.n_nodes, graph.edges, graph.coords,
                       graph.spatial_mask)
        stage("make_graph")
        build = config["build"]
        t0 = time.perf_counter()
        index = build_index(g, build["method"], backend=build["backend"],
                            fanout=int(build["fanout"]), device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0
        stage("build_index")
        n_edges = g.n_edges
        del g
        engine = QueryEngine(index, device=dev, path=traffic["path"])
        stage("engine")
        call = _engine_call(engine, traffic["mode"])
        say(f"graph {graph.n_nodes} vertices {n_edges} edges; "
            f"index {len(index.forest.entries)} entries in "
            f"{index.forest.n_trees} trees; build {build_s:.3f} s")
    for b in range(stream.warm):
        call(*stream.queries(b))
    _sync(dev)
    stage("warm-up")
    say("set-up stages ending at (s): "
        + ", ".join(f"{n} {t:.2f}" for n, t in stages if t is not None))
    stats0 = dict(engine.stats) if engine is not None else {}
    setup_s = process_age_s()
    lat, seq, kept, window_s, prof = _window(call, stream, seconds, traced)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    n_q = len(seq) * stream.batch
    e2e = {"queries_per_s": n_q / window_s,
           "p95_ms": float(np.percentile(np.asarray(lat), 95)) * 1e3,
           "setup_s": setup_s}
    ends = np.cumsum(lat)      # batch ends, less the harness's own time
    tenths = np.bincount(np.minimum((ends / ends[-1] * 10).astype(int), 9),
                         minlength=10) * stream.batch / (window_s / 10)
    say(f"window {window_s:.3f} s, {len(seq)} batches, {n_q} queries; "
        f"M queries/s by tenth of the window: "
        + " ".join(f"{v / 1e6:.3f}" for v in tenths))

    summary = trace.from_profiler(prof) if prof is not None else None
    stats = ({k: engine.stats[k] - stats0[k] for k in stats0}
             if engine is not None else {})
    ctx = {"trace": summary, "stats": stats, "build_s": build_s,
           "index": index, "stream": stream, "sequence": seq,
           "mode": traffic["mode"], "device": dev, "seed": seed}
    units = {m["name"]: m["unit"] for m in sp["end_to_end"] + sp["per_layer"]}
    metrics: Dict[str, Dict] = {}
    if traced and not control:
        for m in sp["per_layer"]:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in sp["end_to_end"]:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}

    # the check: free the program's state, then the reference
    del ctx, engine, index, call, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if ref is None:
        ref = Reference(graph.n_nodes, graph.edges, graph.coords,
                        graph.spatial_mask, device=dev)
    picks = stream.check_picks(len(seq))
    us, rects = stream.kept_queries(seq, picks)
    want = ref.counts(us, rects)
    if traffic["mode"] == "reach":
        want = want > 0
    got = np.concatenate(kept)[picks]
    wrong, checked = int((got != want).sum()), len(picks)
    say(f"reference {time.perf_counter() - t0:.3f} s over {checked} "
        f"answers of {len(seq)} batches")
    limits = {"mismatched_answers": {"value": wrong, "limit": 0},
              "answers_checked": {"value": checked, "limit": "more than 0"}}
    correct = checked > 0 and wrong == 0

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": n_q, "failed": wrong,
              "metrics": metrics, "device": device_info}
    if traced and summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": trace.top(summary["device_s"]),
                               "idle_gaps": trace.top(summary["idle_s"])}
    result["limits"] = limits
    return result


def report(result: Dict, out=None, err=None) -> int:
    """Print a run's compared numbers (last on standard error) and its
    result line (last on standard output); returns the exit code.  A run
    that loaded JAX or the JAX package prints no result."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = forbidden_modules()
    if bad:
        print(f"rrbench: the run loaded {bad}", file=err, flush=True)
        return 4
    for name, c in result["limits"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
