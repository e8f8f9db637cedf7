"""RangeReach serving launcher, the paper's production workload (the port
of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset yelp \\
        --scale 0.1 --method 2dreach-comp --queries 2000 --engine cluster

Builds the chosen index offline, then serves batched RANGEREACH queries
through one of five engines on ``--device`` (the GPU by default; without
CUDA it raises unless ``--device cpu`` is given):

    host      — vectorised NumPy ragged descent (paper-equivalent)
    wavefront — the fixed-capacity R-tree wavefront in torch
                (``core.query_wavefront``, capacity 128); queries that
                overflow it are answered again by the host descent
    kernel    — the leaf-scan probe ``range_query_forest`` (K9)
    device    — the ``QueryEngine`` (K1; 2DReach variants only)
    cluster   — the ``ShardedEngine`` behind the micro-batching
                ``Frontend``: the forest partitioned over the shard
                mesh, requests flushed deadline-or-full into the
                power-of-two buckets the engine serves

Every engine's answers are checked against the host engine before they
are reported.  Reported per engine: throughput and per-query latency
percentiles (p50/p95/p99), batch-amortised for the batched engines and
submit-to-resolve for the cluster frontend, whose arm also asserts that
no new shape is served (``n_compiles`` flat) after a warm pass.

An index without a per-vertex tree lookup (3DReach, 3DReach-Rev,
GeoReach) has no forest probe for ``--engine wavefront|kernel`` to
serve: it is served from the host arm, and one line says so.  (The
reference tests ``hasattr(index, "forest")`` and so raises an
``AttributeError`` on a 3DReach index; ROADMAP R6.)

``--query-class count|collect|knn|polygon`` serves one of the analytics
classes (:mod:`repro_torch.queries`) instead of boolean RangeReach, on
the host or device engine, oracle-checked and (device) equal to host:

    python -m repro_torch.launch.serve --query-class knn --engine device

``--obs`` writes its artifacts under ``--obs-dir`` (default
``results/torch/obs``); ``--obs-profile`` writes a ``torch.profiler``
trace (``device_trace.json``) of the timed pass under its directory.
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np

from .. import obs
from ..core import batch_query, build_index, index_nbytes
from ..data import get_dataset, workload, zipf_workload
from ..device import resolve_device

WAVEFRONT_CAPACITY = 128


def _percentiles(lat_s: np.ndarray) -> dict:
    """{p50, p95, p99} per-query latency in microseconds, through the one
    Histogram implementation (``repro_torch.obs``)."""
    lat_us = np.asarray(lat_s, dtype=np.float64) * 1e6
    return obs.latency_percentiles(lat_us)


def _fmt_pct(pct: dict) -> str:
    return " ".join(f"{k} {v:8.2f}us" for k, v in pct.items())


def serve_chunked(call, n: int, batch: int):
    """Serve queries [0, n) in chunks of ``batch`` via
    ``call(lo, hi) -> answers`` and measure amortised per-query latency.

    Warms the full chunk's shape and the ragged tail's shape first (an
    engine serves each batch bucket once before it is warm; an unwarmed
    tail would report its first-call cost as tail latency), then times
    each chunk, giving every query in it the chunk's wall time / chunk
    size.  Returns ``(answers (n,) bool, per-query latencies (n,)
    seconds, total s)``.  Shared by this launcher and
    ``benchmarks.perf_rangereach``.
    """
    ans = np.zeros(n, dtype=bool)
    lats = np.zeros(n, dtype=np.float64)
    call(0, min(batch, n))                   # warm-up
    if n % batch:
        call(n - n % batch, n)               # ... and the ragged tail
    total = 0.0
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        t0 = time.perf_counter()
        out = call(lo, hi)
        dt = time.perf_counter() - t0
        ans[lo:hi] = np.asarray(out)[: hi - lo].astype(bool)
        lats[lo:hi] = dt / (hi - lo)
        total += dt
    return ans, lats, total


def _serve_batched(fn, us, rects, batch: int):
    """``serve_chunked`` over a ``fn(us_chunk, rects_chunk)`` engine."""
    return serve_chunked(
        lambda lo, hi: fn(us[lo:hi], rects[lo:hi]), len(us), batch)


def _serve_cluster(index, us, rects, args, auditor=None, device=None):
    """ShardedEngine behind the micro-batching Frontend: per-request
    latencies (submit to resolve), no new shape in the steady state.
    Returns ``(answers, latencies, seconds, stats)``, ``stats`` the
    shards, shapes served, flushes and mean batch."""
    from ..cluster import Frontend, ShardedEngine

    eng = ShardedEngine(index, n_shards=args.shards or None, device=device)
    part = eng.partition
    print(f"[serve] cluster: {eng.n_shards} shards on "
          f"{eng.mesh.shape['data']} device(s), "
          f"{part.n_trees} trees, per-shard entries "
          f"{part.shard_entries.tolist()} (balance {part.balance():.2f})")
    fe = Frontend(eng, max_batch=args.batch,
                  max_delay=args.flush_ms * 1e-3, auditor=auditor)
    try:
        fe.warmup(us[:args.batch], rects[:args.batch])
        fe.submit_many(us, rects)           # warm the K high-water mark
        for i in range(len(us)):            # structure-matched shake-out:
            fe.submit(int(us[i]), rects[i])
        fe.flush(timeout=120)               # the same submission pattern
        # as the timed pass below, so a regrouping's K ratchet lands
        # here; then every batch bucket again at the final mark, so any
        # flush grouping serves a shape already served
        fe.warmup(us[:args.batch], rects[:args.batch])
        warm = eng.n_compiles
        n = len(us)
        lats = np.zeros(n, dtype=np.float64)
        done = np.zeros(n, dtype=bool)
        t0s = np.zeros(n, dtype=np.float64)
        n_done = [0]
        done_lock = threading.Lock()
        all_done = threading.Event()
        errs = []

        def _cb(i):
            # completion callbacks are the sync point: Future.result()
            # can return before callbacks run, so the gather below waits
            # on the callback count, not on the futures
            def cb(fut):
                try:
                    lats[i] = time.monotonic() - t0s[i]
                    done[i] = fut.result()
                except BaseException as e:   # raised after the wait
                    errs.append(e)
                finally:
                    with done_lock:
                        n_done[0] += 1
                        if n_done[0] == n:
                            all_done.set()
            return cb

        t_all = time.perf_counter()
        for i in range(n):
            t0s[i] = time.monotonic()
            fe.submit(int(us[i]), rects[i]).add_done_callback(_cb(i))
        assert all_done.wait(timeout=120), "request stream timed out"
        if errs:
            raise errs[0]
        total = time.perf_counter() - t_all
        assert eng.n_compiles == warm, (
            f"steady-state recompile under the frontend: "
            f"{eng.n_compiles} != {warm}")
        print(f"[serve] cluster: {eng.n_compiles} compiled shapes "
              f"(flat through the steady-state pass), "
              f"frontend {int(fe.stats['n_batches'])} flushes "
              f"(full {int(fe.stats['n_flush_full'])} / deadline "
              f"{int(fe.stats['n_flush_deadline'])}), "
              f"mean batch {fe.mean_batch:.1f}")
        print(f"[serve] cluster: shard query routing "
              f"{eng.shard_queries.tolist()}, "
              f"{eng.stats['tiles_scanned']}/"
              f"{eng.stats['tiles_full_scan']} leaf tiles scanned")
        return done, lats, total, {
            "n_shards": eng.n_shards, "n_compiles": eng.n_compiles,
            "n_compiles_warm": warm, "flushes": int(fe.stats["n_batches"]),
            "mean_batch": fe.mean_batch}
    finally:
        fe.close()


def _log_served(index, us, rects, lats_s, cards,
                query_class: str = "reach", shards=None) -> None:
    """Feed a served pass into the structured query log (and through it
    the workload-analytics sinks): only while obs is enabled, and only
    for the engines that do not log per batch themselves (the cluster
    frontend records its own batches)."""
    if not obs.enabled():
        return
    us = np.asarray(us)
    if shards is None:
        shards = np.zeros(len(us), dtype=np.int64)
    if rects is None:
        rects = np.zeros((len(us), 4), dtype=np.float32)
    obs.QUERY_LOG.record_batch(
        query_class, obs.vertex_class_of(index, us), rects, shards,
        lats_s, np.asarray(cards).astype(np.int64), us=us)


def _serve_query_class(index, g, args, device=None):
    """Analytics query-class serving (count / collect / knn / polygon)
    through ``core.api.run_queries``, host or device engine, answers
    checked against the BFS oracle and (device) against the host path.
    Returns ``{"host": ..., "device": ... or None}``, the answers."""
    from ..core import run_queries
    from ..core.oracle import (
        knn_reach_oracle,
        polygon_reach_oracle,
        range_collect_oracle,
        range_count_oracle,
    )
    from ..data import knn_workload, polygon_workload
    from ..queries import QueryProgram

    if args.engine not in ("host", "device"):
        raise SystemExit(
            f"--query-class {args.query_class} serves on --engine "
            f"host|device (cluster serving is boolean RangeReach only)")
    n = args.queries
    kind = args.query_class
    points = polys = rects = None
    if kind == "knn":
        us, points = knn_workload(g, n, seed=1)
    elif kind == "polygon":
        us, polys = polygon_workload(g, n, extent_ratio=args.extent, seed=1)
    else:
        us, rects = workload(g, n_queries=n, extent_ratio=args.extent,
                             seed=1)

    def prog(lo, hi):
        if kind == "knn":
            return QueryProgram.knn(us[lo:hi], points[lo:hi], args.k)
        if kind == "polygon":
            return QueryProgram.polygon(us[lo:hi], polys[lo:hi])
        if kind == "count":
            return QueryProgram.count(us[lo:hi], rects[lo:hi])
        return QueryProgram.collect(us[lo:hi], rects[lo:hi], args.k)

    host = run_queries(index, prog(0, n), engine="host")
    if args.verify:
        kv = min(args.verify, n)
        for b in range(kv):
            u = int(us[b])
            if kind == "count":
                assert host[b] == range_count_oracle(g, u, rects[b])
            elif kind == "collect":
                want = range_collect_oracle(g, u, rects[b])
                assert host.counts[b] == len(want)
                assert (host.row(b) == want[: args.k]).all()
            elif kind == "knn":
                oi, _ = knn_reach_oracle(g, u, points[b], args.k)
                assert (host.row(b) == oi).all()
            else:
                assert host[b] == polygon_reach_oracle(g, u, polys[b])
        print(f"[serve] verified {kv} {kind} queries vs BFS oracle")
    dev = None
    if args.engine == "device":
        dev = run_queries(index, prog(0, n), engine="device", device=device)
        if kind in ("count", "polygon"):
            ok = (dev == host).all()
        elif kind == "collect":
            ok = ((dev.ids == host.ids).all()
                  and (dev.counts == host.counts).all()
                  and (dev.overflow == host.overflow).all())
        else:
            ok = ((dev.ids == host.ids).all()
                  and (dev.dist2 == host.dist2).all())
        assert ok, f"device {kind} answers diverge from host"
        print(f"[serve] device {kind} answers bit-identical to host")

    def run(lo, hi):
        return run_queries(index, prog(lo, hi), engine=args.engine,
                           device=device)

    run(0, min(args.batch, n))                 # warm-up
    if n % args.batch:
        run(n - n % args.batch, n)             # ... and the ragged tail
    lats = np.zeros(n, dtype=np.float64)
    total = 0.0
    for lo in range(0, n, args.batch):
        hi = min(lo + args.batch, n)
        t0 = time.perf_counter()
        run(lo, hi)
        dt = time.perf_counter() - t0
        lats[lo:hi] = dt / (hi - lo)
        total += dt
    _log_served(index, us, rects, lats, np.zeros(n, dtype=np.int64),
                query_class=kind)
    pct = _percentiles(lats)
    print(f"[serve] {args.engine} {kind}: {n} queries in "
          f"{total * 1e3:.1f} ms ({total / n * 1e6:.2f} us/query mean), "
          f"{_fmt_pct(pct)}")
    return {"host": host, "device": dev}


def _forest_probe(index, engine: str, device):
    """``fn(us, rects) -> (B,) bool`` probing the index's forest through
    the wavefront (overflowed queries answered again on the host) or the
    leaf-scan kernel; the arms' second result counts the overflows."""
    from ..core import query_host, query_wavefront
    from ..kernels.range_query.leafscan import range_query_forest

    overflowed = [0]
    if engine == "wavefront":
        def fn(ub, rb):
            tid = index.lookup_tree(ub)
            hit, ovf = query_wavefront(index.forest, tid, rb,
                                       capacity=WAVEFRONT_CAPACITY,
                                       device=device)
            if ovf.any():
                overflowed[0] += int(ovf.sum())
                hit[ovf] = query_host(index.forest, tid[ovf], rb[ovf])
            return hit
    else:
        def fn(ub, rb):
            return range_query_forest(index.forest, index.lookup_tree(ub),
                                      rb, device=device)
    return fn, overflowed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="yelp")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--method", default="2dreach-comp")
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--extent", type=float, default=0.05)
    ap.add_argument("--engine", default="host",
                    choices=("host", "wavefront", "kernel", "device",
                             "cluster"))
    ap.add_argument("--query-class", default="reach", dest="query_class",
                    choices=("reach", "count", "collect", "knn", "polygon"),
                    help="query class to serve (see repro_torch.queries); "
                         "non-reach classes run on host|device engines")
    ap.add_argument("--k", type=int, default=10,
                    help="collect cap / knn neighbour count")
    ap.add_argument("--batch", type=int, default=256,
                    help="serving batch size (keep it a power of two to "
                         "reuse the engines' batch buckets)")
    ap.add_argument("--shards", type=int, default=0,
                    help="cluster forest partitions; 0 (default) resolves "
                         "to the visible device count; on a single device "
                         "extra shards only add per-shard kernel launches")
    ap.add_argument("--flush-ms", type=float, default=2.0,
                    help="cluster frontend deadline flush (ms)")
    ap.add_argument("--verify", type=int, default=64,
                    help="queries to verify against the BFS oracle")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="draw query vertices from a Zipf(s) rank "
                         "distribution over degree-ranked vertices "
                         "instead of the paper's degree-bucket sweep "
                         "(0 = off); the skewed stream is what the --obs "
                         "heavy-hitter analytics are for")
    ap.add_argument("--obs", action="store_true",
                    help="enable repro_torch.obs span/metric recording "
                         "plus the workload intelligence (heavy hitters, "
                         "placement report, time-series sampler, SLO "
                         "monitor) and dump trace.json / metrics.json / "
                         "metrics.prom / querylog.jsonl / "
                         "timeseries.jsonl / placement_report.json after "
                         "serving")
    ap.add_argument("--obs-dir", default="results/torch/obs",
                    help="directory for the --obs artifacts")
    ap.add_argument("--obs-profile", default="",
                    help="directory for an opt-in torch.profiler trace "
                         "of the timed pass (Chrome trace format)")
    ap.add_argument("--audit-sample", type=float, default=0.0,
                    dest="audit_sample",
                    help="fraction of served cluster queries the online "
                         "exactness auditor shadow-replays through the "
                         "host path (0 = off)")
    ap.add_argument("--audit-oracle-sample", type=float, default=0.0,
                    dest="audit_oracle_sample",
                    help="fraction of audited queries also checked "
                         "against the BFS oracle")
    ap.add_argument("--device", default="cuda",
                    help="where the engines serve (default: the GPU; "
                         "'cpu' runs the plain PyTorch versions)")
    return ap


def main(argv=None) -> dict:
    """Run the launcher; returns what it served, for a caller that drives
    it in-process: ``engine``, ``answers`` (the served answers; the host
    pipeline's for a forest probe, whose own answers are ``probed`` on
    the queries ``probe_mask`` selects), ``host``, ``lats``,
    ``seconds``, ``percentiles``, the auditor's ``audit`` report
    (``None`` without ``--audit-sample``) and the cluster arm's
    ``cluster`` stats; for a query class its ``host`` and ``device``
    answers.  With ``--obs`` it turns obs off again when it returns or
    raises: the time-series sampler stopped, its query-log sink removed,
    the flight recorder disarmed (what was recorded stays until
    ``obs.reset``)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    wa = mon = None
    try:
        if args.obs:
            wa, mon = _obs_start(args)
        return _run(args, dev, wa, mon)
    finally:
        if args.obs:
            obs.stop_timeseries()
            if wa is not None:
                obs.QUERY_LOG.remove_sink(wa.observe)
            obs.FLIGHT.disarm()
            obs.disable()


def _obs_start(args):
    """--obs prologue: spans on, the flight recorder armed, the workload
    analytics and the SLO monitor on the time-series sampler."""
    import os

    obs.enable()
    # flight recorder: SLO burns / breaker opens / audit divergences
    # freeze self-contained debug bundles here
    obs.FLIGHT.arm(os.path.join(args.obs_dir, "flightdump"))
    # workload intelligence: sketches see every query-log record as a
    # streaming sink; the background sampler snapshots the registry and
    # ticks the SLO burn-rate monitor on its cadence
    wa = obs.WorkloadAnalytics()
    obs.QUERY_LOG.add_sink(wa.observe)
    mon = obs.default_slos(obs.SLOMonitor(clock=time.time))
    obs.start_timeseries().add_hook(lambda t, _s: mon.tick(t))
    return wa, mon


def _run(args, dev, wa, mon) -> dict:
    g = get_dataset(args.dataset, scale=args.scale)
    print(f"[serve] dataset {args.dataset} x{args.scale}: "
          f"{g.n_nodes} nodes, {g.n_edges} edges, {g.n_spatial} venues")
    t0 = time.perf_counter()
    index = build_index(g, args.method)
    print(f"[serve] built {args.method} in {time.perf_counter() - t0:.2f}s; "
          f"size {index_nbytes(index)['total'] / 1e6:.1f} MB")

    if args.query_class != "reach":
        with obs.device_trace(args.obs_profile,
                              enabled=bool(args.obs_profile), device=dev):
            t_q0 = time.perf_counter()
            out = _serve_query_class(index, g, args, device=dev)
            t_q1 = time.perf_counter()
        _obs_report(args, t_q0, t_q1, wa=wa, mon=mon)
        return dict(out, query_class=args.query_class)

    if args.zipf > 0:
        us, rects = zipf_workload(g, n_queries=args.queries, s=args.zipf,
                                  extent_ratio=args.extent, seed=1)
        uniq = len(np.unique(us))
        print(f"[serve] zipf(s={args.zipf:g}) workload: {len(us)} "
              f"queries over {uniq} distinct vertices")
    else:
        us, rects = workload(g, n_queries=args.queries,
                             extent_ratio=args.extent, seed=1)

    # correctness gate before timing
    if args.verify:
        from ..core import rangereach_oracle_batch

        k = min(args.verify, len(us))
        want = rangereach_oracle_batch(g, us[:k], rects[:k])
        got = batch_query(index, us[:k], rects[:k])
        assert (want == got).all(), "index disagrees with oracle"
        print(f"[serve] verified {k} queries vs BFS oracle")

    # R6: the forest probes need a per-vertex tree lookup
    no_probe = (args.engine in ("wavefront", "kernel")
                and not hasattr(index, "lookup_tree"))
    if no_probe:
        print(f"[serve] {args.method} has no per-vertex tree lookup: "
              f"--engine {args.engine} serves from the host arm")
    host_arm = args.engine == "host" or no_probe
    # host reference answers, for the arms that check against them
    host = None if host_arm else batch_query(index, us, rects)
    auditor = probed = m = cluster = None
    if args.audit_sample > 0 and args.engine == "cluster":
        auditor = obs.ExactnessAuditor(
            index, graph=g, sample=args.audit_sample,
            oracle_sample=args.audit_oracle_sample).start()
    with obs.device_trace(args.obs_profile, enabled=bool(args.obs_profile),
                          device=dev):
        t_q0 = time.perf_counter()
        with obs.span(f"serve.{args.engine}_pass", cat="serve", n=len(us)):
            if args.engine == "cluster":
                ans, lats, dt, cluster = _serve_cluster(
                    index, us, rects, args, auditor=auditor, device=dev)
            elif host_arm:
                ans, lats, dt = _serve_batched(
                    lambda ub, rb: batch_query(index, ub, rb), us, rects,
                    args.batch)
            elif args.engine == "device":
                from ..core import engine_for

                eng = engine_for(index, device=dev, required=True)
                ans, lats, dt = _serve_batched(eng.query_batch, us, rects,
                                               args.batch)
                print(f"[serve] device engine: {eng.n_compiles} compiled "
                      f"shapes, {eng.stats['tiles_scanned']}/"
                      f"{eng.stats['tiles_full_scan']} leaf tiles scanned "
                      f"(vs full leaf scan)")
            else:
                fn, overflowed = _forest_probe(index, args.engine, dev)
                ans, lats, dt = _serve_batched(fn, us, rects, args.batch)
                if args.engine == "wavefront":
                    print(f"[serve] wavefront: {overflowed[0]} queries "
                          f"overflowed capacity {WAVEFRONT_CAPACITY}, "
                          f"answered again on the host")
                # wavefront/kernel probe trees only: mask the Alg. 2
                # spatial-sink special case the full pipeline handles
                exc = getattr(index, "excluded", None)
                m = ~exc[us] if exc is not None else np.ones(len(us), bool)
                assert (ans[m] == host[m]).all(), "engine mismatch"
                probed, ans = ans, host
        t_q1 = time.perf_counter()
    if args.engine in ("device", "cluster"):
        assert (ans == host).all(), f"{args.engine} engine mismatch"
    if args.engine != "cluster":        # the frontend logs its batches
        _log_served(index, us, rects, lats, ans.astype(np.int64))
    pct = _percentiles(lats)
    print(f"[serve] {args.engine}: {len(us)} queries in {dt * 1e3:.1f} ms "
          f"({dt / len(us) * 1e6:.2f} us/query mean), "
          f"{_fmt_pct(pct)}, {int(np.sum(ans))} positive")
    audit = _obs_report(args, t_q0, t_q1, wa=wa, mon=mon, auditor=auditor)
    return {"engine": args.engine, "answers": ans, "host": host,
            "probed": probed, "probe_mask": m, "lats": lats, "seconds": dt,
            "percentiles": pct, "audit": audit, "cluster": cluster}


def _obs_report(args, t_q0: float, t_q1: float,
                wa=None, mon=None, auditor=None) -> Optional[dict]:
    """--obs epilogue: span coverage of the timed pass, the top stage
    totals, the workload-intelligence report (heavy-hitter table,
    placement report, SLO state) and the artifact dump.  Returns the
    auditor's report (``None`` without an auditor)."""
    import json
    import os

    rep = None
    if auditor is not None:
        auditor.stop()                   # final drain covers the tail
        rep = auditor.report()
    if not args.obs:
        return rep
    obs.stop_timeseries()               # final sample covers the tail
    cov = obs.coverage(t_q0, t_q1)
    totals = sorted(obs.stage_totals().items(),
                    key=lambda kv: kv[1], reverse=True)
    top = ", ".join(f"{k} {v / 1e3:.1f}ms" for k, v in totals[:6])
    print(f"[serve] obs: span coverage {cov * 100:.1f}% of the timed "
          f"pass; top stages: {top}")
    paths = obs.dump(args.obs_dir)
    if wa is not None and wa.total:
        mon.tick()                       # one last burn-rate evaluation
        report = wa.placement_report(query_log=obs.QUERY_LOG)
        report["slo"] = mon.snapshot()
        path = os.path.join(args.obs_dir, "placement_report.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        paths["placement_report"] = path
        skew = report["skew"]
        ver = report["verified"]
        print(f"[serve] obs: workload heavy hitters "
              f"({wa.total} queries observed):")
        print(wa.top_table(top_k=5))
        print(f"[serve] obs: shard skew gini_q {skew['gini_queries']:.3f} "
              f"gini_lat {skew['gini_latency']:.3f} max_share "
              f"{skew['max_query_share']:.2f} over {skew['n_shards']} "
              f"shard(s); degraded {report['degraded_fraction']:.1%}; "
              f"sketch vs exact recount: "
              f"{'MATCH' if ver['exact_match'] else ver}")
        fired = sum(1 for e in mon.events if e["kind"] == "fired")
        print(f"[serve] obs: SLOs {len(mon.slos)} tracked, {fired} "
              f"fired, active now: {sorted(mon.active()) or 'none'}")
    if rep is not None:
        print(f"[serve] obs: exactness audit checked {rep['checked']} "
              f"of {rep['sampled']} sampled queries "
              f"({rep['oracle_checked']} vs BFS oracle): "
              f"{rep['divergences']} divergence(s)")
    fl = obs.FLIGHT.snapshot()
    if fl["dumps"]:
        print(f"[serve] obs: flight recorder froze {fl['dumps']} debug "
              f"bundle(s) under {fl['dir']}; replay with "
              f"python -m repro_torch.obs.flight <bundle>")
    print("[serve] obs: wrote " + ", ".join(sorted(paths.values())))
    return rep


if __name__ == "__main__":
    main()
