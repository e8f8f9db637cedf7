"""The RangeReach query engines and the build-side closure, per query
(the port of the reference's ``benchmarks/perf_rangereach.py``).

Wall-clock per query across engine variants and structural parameters:

    engine    host descent | torch wavefront (capacity c) | the K9 leaf
              scan | device (``QueryEngine``: K1 fused, K2 + K3
              two-phase) | cluster (``ShardedEngine``)
    fanout    R-tree node width
    capacity  the wavefront's frontier budget

plus the build-side closure: the per-level scatter-OR (``closure_np``)
against the unscheduled ``closure_fixpoint`` by the dense bf16 product
(``use_mxu=True``) and by K7, at growing component counts.  Each
configuration is checked against the host engine before it is timed.
The engines run on ``--device`` (the GPU by default; ``--device cpu``
runs the plain PyTorch versions), where the reference's wavefront and
Pallas arms ran on the CPU in interpret mode.

Outputs: ``results/torch/perf_rangereach.json`` (the full sweep) and
``results/torch/BENCH_rangereach.json``, the summary that
``benchmarks.regress`` reads: the best µs/query per engine, the leaf
tiles the device engine scans against the full leaf scan, and the
steady-state new-shape and re-transposition counts (``n_compiles`` and
``layout.SOA_BUILDS``), both gated to zero.  ``--smoke`` runs a
seconds-scale subset; ``--degraded`` adds the host-fallback arm of the
``ResilientEngine``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np

from .. import obs
from ..cluster import ShardedEngine
from ..core import QueryEngine, build_2dreach, query_host, query_wavefront
from ..data import get_dataset, workload
from ..device import DeviceLike, resolve_device
from ..kernels.range_query import layout
from ..kernels.range_query.leafscan import range_query_forest
from ..launch.serve import serve_chunked
from . import build_kernels, device_name, result_path

LAT_BATCH = 256   # chunk size for the per-query latency distribution
# the --smoke subset: one fanout and capacity, yelp x0.1
SMOKE = dict(dataset="yelp", scale=0.1, n_q=256, fanouts=(16,),
             capacities=(64,), repeats=2)
SMOKE_CLOSURE = (0.1,)
# the dense closure arms only at up to this many components
DENSE_MAX_COMPS = 12000


def _t(fn, repeats=5):
    fn()  # warmup
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _lat_pct(call, n, batch=LAT_BATCH) -> Dict[str, float]:
    """p50/p95/p99 per-query latency (µs) serving [0, n) in chunks.

    ``call(lo, hi)`` serves that query slice and returns its answers;
    the chunked warm-and-measure mechanics live in
    ``repro_torch.launch.serve.serve_chunked``.  The chunk size is
    capped so the pass always yields several batches (one amortised
    sample per batch goes into the obs ``Histogram``), and small runs
    take extra passes until the distribution holds enough batch samples
    for a stable p99.
    """
    batch = max(1, min(batch, n // 8 or n))
    n_chunks = -(-n // batch)
    passes = max(1, -(-32 // n_chunks))
    hist = obs.Histogram("bench.lat_us", lo=1e-2, hi=1e9)
    for _ in range(passes):
        _, lats, _ = serve_chunked(call, n, batch)
        # one sample per chunk: lats repeats the chunk's amortised
        # per-query latency across its queries; take the chunk heads
        hist.record_many(np.asarray(lats[::batch]) * 1e6)
    return hist.percentile_dict(prefix="lat_p", suffix="_us")


def _stage_profile(run, prefix, cost_fn=None):
    """One instrumented pass after the timed one: per-stage span totals
    (µs) plus the kernel cost model, recorded outside the timed loop so
    span overhead never skews ``us_per_q``."""
    was = obs.enabled()
    obs.enable()
    before = obs.stage_totals(prefix)
    run()
    after = obs.stage_totals(prefix)
    if not was:
        obs.disable()
    stage = {k: round(after.get(k, 0.0) - before.get(k, 0.0), 3)
             for k in after
             if after.get(k, 0.0) > before.get(k, 0.0)}
    return stage, (cost_fn() if cost_fn is not None else None)


def engine_sweep(dataset="gowalla", scale=0.5, n_q=2000,
                 fanouts=(8, 16, 32, 64), capacities=(32, 64, 128, 256),
                 repeats=5, n_shards=None,
                 device: DeviceLike = None) -> List[Dict]:
    dev = resolve_device(device)
    g = get_dataset(dataset, scale=scale)
    us, rects = workload(g, n_q, extent_ratio=0.05, seed=5)
    rows = []
    for fanout in fanouts:
        idx = build_2dreach(g, variant="comp", fanout=fanout)
        tid = idx.lookup_tree(us)
        ref = query_host(idx.forest, tid, rects)
        full = idx.query_batch(us, rects)
        # host engine
        dt = _t(lambda: query_host(idx.forest, tid, rects), repeats=repeats)
        rows.append(dict(engine="host", fanout=fanout, capacity=None,
                         us_per_q=dt / n_q * 1e6,
                         depth=idx.forest.depth,
                         **_lat_pct(lambda lo, hi: query_host(
                             idx.forest, tid[lo:hi], rects[lo:hi]), n_q)))
        # torch wavefront at several capacities
        for cap in capacities:
            got, ovf = query_wavefront(idx.forest, tid, rects,
                                       capacity=cap, device=dev)
            valid = ~ovf
            assert (got[valid] == ref[valid]).all()
            ovf_frac = float(ovf.mean())
            dt = _t(lambda: query_wavefront(
                idx.forest, tid, rects, capacity=cap, device=dev),
                repeats=repeats)
            rows.append(dict(engine="wavefront", fanout=fanout,
                             capacity=cap, us_per_q=dt / n_q * 1e6,
                             overflow_frac=ovf_frac,
                             depth=idx.forest.depth,
                             **_lat_pct(lambda lo, hi: query_wavefront(
                                 idx.forest, tid[lo:hi], rects[lo:hi],
                                 capacity=cap, device=dev)[0], n_q)))
        # the K9 leaf scan (the reference's Pallas arm)
        got = range_query_forest(idx.forest, tid, rects, device=dev)
        assert (got == ref).all()
        dt = _t(lambda: range_query_forest(idx.forest, tid, rects,
                                           device=dev), repeats=3)
        rows.append(dict(engine="pallas_leafscan", fanout=fanout,
                         capacity=None, us_per_q=dt / n_q * 1e6,
                         depth=idx.forest.depth,
                         **_lat_pct(lambda lo, hi: range_query_forest(
                             idx.forest, tid[lo:hi], rects[lo:hi],
                             device=dev), n_q)))
        # device engine: hierarchical descent, shapes served once
        eng = QueryEngine(idx, device=dev)
        got = eng.query_batch(us, rects)
        assert (got == full).all(), "device engine disagrees with host"
        # steady-state gates: repeat queries, then assert no new shape
        # and no new host-side forest transposition
        compiles0 = eng.n_compiles
        soa0 = layout.SOA_BUILDS
        tiles0 = eng.stats["tiles_scanned"]
        grid0 = eng.stats["tiles_grid"]
        full0 = eng.stats["tiles_full_scan"]
        dt = _t(lambda: eng.query_batch(us, rects), repeats=repeats)
        recompiles = eng.n_compiles - compiles0
        retranspositions = layout.SOA_BUILDS - soa0
        batches = eng.stats["batches"] - 1  # minus the pre-gate batch
        tiles_pb = (eng.stats["tiles_scanned"] - tiles0) / max(batches, 1)
        grid_pb = (eng.stats["tiles_grid"] - grid0) / max(batches, 1)
        full_pb = (eng.stats["tiles_full_scan"] - full0) / max(batches, 1)
        stage_us, cost = _stage_profile(
            lambda: eng.query_batch(us, rects), "engine.",
            lambda: obs.engine_cost_model(eng))
        # the two-phase path: same answers, separate launches, timed and
        # span-attributed beside the fused one
        got2 = eng.query_batch_two_phase(us, rects)
        assert (got2 == full).all(), "two-phase disagrees with host"
        dt2 = _t(lambda: eng.query_batch_two_phase(us, rects),
                 repeats=repeats)
        stage2_us, _ = _stage_profile(
            lambda: eng.query_batch_two_phase(us, rects), "engine.")
        rows.append(dict(
            engine="device", fanout=fanout, capacity=None,
            us_per_q=dt / n_q * 1e6, depth=idx.forest.depth,
            n_leaf_tiles=eng.n_tiles,
            stage_us=stage_us, cost_model=cost,
            two_phase_us_per_q=dt2 / n_q * 1e6,
            two_phase_stage_us=stage2_us,
            tiles_scanned_per_batch=tiles_pb,
            tiles_grid_per_batch=grid_pb,
            tiles_full_scan_per_batch=full_pb,
            steady_state_recompiles=recompiles,
            steady_state_retranspositions=retranspositions,
            **_lat_pct(lambda lo, hi: eng.query_batch(
                us[lo:hi], rects[lo:hi]), n_q),
        ))
        # cluster engine.  The default (n_shards=None) runs shards ==
        # devices, the configuration the cluster <= 2x device ratio gate
        # speaks about; more shards than devices stay with the tests
        ceng = ShardedEngine(idx, n_shards=n_shards, device=dev)
        got = ceng.query_batch(us, rects)
        assert (got == full).all(), "cluster engine disagrees with host"
        pct = _lat_pct(lambda lo, hi: ceng.query_batch(
            us[lo:hi], rects[lo:hi]), n_q)
        got2 = ceng.query_batch_two_phase(us, rects)   # warm both paths
        assert (got2 == full).all(), "cluster two-phase disagrees"
        compiles0 = ceng.n_compiles
        soa0 = layout.SOA_BUILDS
        dt = _t(lambda: ceng.query_batch(us, rects), repeats=repeats)
        cstage_us, ccost = _stage_profile(
            lambda: ceng.query_batch(us, rects), "cluster.",
            lambda: obs.engine_cost_model(ceng))
        cdt2 = _t(lambda: ceng.query_batch_two_phase(us, rects),
                  repeats=repeats)
        cstage2_us, _ = _stage_profile(
            lambda: ceng.query_batch_two_phase(us, rects), "cluster.")
        rows.append(dict(
            engine="cluster", fanout=fanout, capacity=None,
            us_per_q=dt / n_q * 1e6, depth=idx.forest.depth,
            n_shards=ceng.n_shards,
            stage_us=cstage_us, cost_model=ccost,
            two_phase_us_per_q=cdt2 / n_q * 1e6,
            two_phase_stage_us=cstage2_us,
            n_devices=int(ceng.mesh.shape["data"]),
            shard_balance=ceng.partition.balance(),
            shard_queries=ceng.shard_queries.tolist(),
            steady_state_recompiles=ceng.n_compiles - compiles0,
            steady_state_retranspositions=layout.SOA_BUILDS - soa0,
            **pct,
        ))
    return rows


def degraded_arm(dataset="gowalla", scale=0.5, n_q=2000, fanout=16,
                 repeats=5, device: DeviceLike = None) -> Dict:
    """Host-fallback latency under forced degradation (``--degraded``).

    Trips the resilient wrapper's breaker so every query takes the
    exact host descent, the path a dead device degrades to, recording
    what the SLO costs when the device is gone.  Answers are asserted
    equal to the healthy device path first."""
    from ..resilience import BreakerPolicy, ResilientEngine

    dev = resolve_device(device)
    g = get_dataset(dataset, scale=scale)
    us, rects = workload(g, n_q, extent_ratio=0.05, seed=5)
    idx = build_2dreach(g, variant="comp", fanout=fanout)
    res = ResilientEngine(
        QueryEngine(idx, device=dev), idx,
        breaker=BreakerPolicy(reset_timeout_s=float("inf")))
    healthy = res.query_batch(us, rects)
    dt_dev = _t(lambda: res.query_batch(us, rects), repeats=repeats)
    res.trip()                        # the breaker never half-opens again
    got = res.query_batch(us, rects)
    exact = bool((got == healthy).all())
    assert exact, "degraded answers drifted from the device path"
    dt_host = _t(lambda: res.query_batch(us, rects), repeats=repeats)
    pct = _lat_pct(lambda lo, hi: res.query_batch(us[lo:hi],
                                                  rects[lo:hi]), n_q)
    deg_hist = res._h_degraded.snapshot()
    return dict(
        fanout=fanout, n_q=n_q, exact=exact,
        healthy_us_per_q=dt_dev / n_q * 1e6,
        degraded_us_per_q=dt_host / n_q * 1e6,
        degradation_x=dt_host / dt_dev if dt_dev else None,
        fallback_batches=int(res.stats["fallback_batches"]),
        fallback_queries=int(res.stats["fallback_queries"]),
        degraded_hist_count=int(deg_hist["count"]),
        **pct)


def closure_sweep(scales=(0.1, 0.25, 0.5),
                  device: DeviceLike = None) -> List[Dict]:
    """Build side: the per-level scatter-OR against the unscheduled
    fixpoint, by the dense bf16 product and by K7 (equal bit sets)."""
    from ..core import condense, scc_np
    from ..core.reachability import closure_np, pack_rows
    from ..kernels.bitset_mm import bitset_mm
    from ..kernels.bitset_mm.ops import closure_fixpoint

    dev = resolve_device(device)
    rows = []
    for scale in scales:
        g = get_dataset("yelp", scale=scale)
        labels = scc_np(g.n_nodes, g.edges)
        cond = condense(g.n_nodes, g.edges, labels)
        t0 = time.perf_counter()
        clo = closure_np(cond, g.n_nodes, g.spatial_ids)
        t_np = time.perf_counter() - t0
        d, p = cond.n_comps, clo.p
        rows.append(dict(method="scatter_or_levels", scale=scale,
                         n_comps=d, n_spatial=p, seconds=t_np))
        if d > DENSE_MAX_COMPS:
            continue                  # the dense arms only at small d
        own = np.zeros((d, p), dtype=bool)
        own[np.repeat(np.arange(d), np.diff(clo.own_indptr)),
            clo.own_cols] = True
        A = np.zeros((d, d), dtype=bool)
        if cond.dag_edges.size:
            A[cond.dag_edges[:, 0], cond.dag_edges[:, 1]] = True
        ob, ab = pack_rows(own), pack_rows(A)
        got = {}
        for method, mxu in (("bitset_mm_mxu", True), ("bitset_mm_k7", False)):
            closure_fixpoint(ob, ab, n_iters=1, use_mxu=mxu, device=dev)
            k7 = bitset_mm.launches
            t0 = time.perf_counter()
            got[method] = closure_fixpoint(ob, ab, n_iters=cond.n_levels + 1,
                                           use_mxu=mxu, device=dev)
            rows.append(dict(method=method, scale=scale, n_comps=d,
                             n_spatial=p,
                             seconds=time.perf_counter() - t0,
                             k7_launches=bitset_mm.launches - k7))
        assert np.array_equal(got["bitset_mm_mxu"], got["bitset_mm_k7"]), \
            "the two closure products disagree"
    return rows


def bench_summary(engine_rows: List[Dict]) -> Dict:
    """The perf-trajectory datapoint (``BENCH_rangereach.json``)."""
    device = [r for r in engine_rows if r["engine"] == "device"]
    cluster = [r for r in engine_rows if r["engine"] == "cluster"]
    best = {}
    pct = {}
    for name in ("host", "wavefront", "pallas_leafscan", "device",
                 "cluster"):
        cands = [r for r in engine_rows if r["engine"] == name]
        if cands:
            best[name] = min(r["us_per_q"] for r in cands)
            winner = min(cands, key=lambda r: r["us_per_q"])
            if "lat_p50_us" in winner:
                pct[name] = {p: winner[f"lat_{p}_us"]
                             for p in ("p50", "p95", "p99")}
    scanned = sum(r["tiles_scanned_per_batch"] for r in device)
    grid = sum(r["tiles_grid_per_batch"] for r in device)
    full = sum(r["tiles_full_scan_per_batch"] for r in device)

    def _winner_stages(rows):
        if not rows:
            return None
        w = min(rows, key=lambda r: r["us_per_q"])
        out = {"stage_us": w.get("stage_us"),
               "cost_model": w.get("cost_model")}
        if w.get("two_phase_us_per_q") is not None:
            # fused against two-phase: the same engine serving the same
            # workload through the two-launch path
            out["fused_us_per_q"] = w["us_per_q"]
            out["two_phase_us_per_q"] = w["two_phase_us_per_q"]
            out["two_phase_stage_us"] = w.get("two_phase_stage_us")
            out["fusion_speedup_x"] = (
                w["two_phase_us_per_q"] / w["us_per_q"]
                if w["us_per_q"] else None)
        return out

    return {
        "schema_version": 2,
        "unit": "us_per_query (best over structural params)",
        "engines": best,
        # per-stage host-span attribution + kernel cost model of the
        # best device / cluster configurations
        "per_stage": {
            "device": _winner_stages(device),
            "cluster": _winner_stages(cluster),
        },
        "latency_percentiles_us": pct,
        "cluster_engine": {
            "n_shards": cluster[0]["n_shards"] if cluster else None,
            "n_devices": cluster[0]["n_devices"] if cluster else None,
            "shard_balance": max(
                (r["shard_balance"] for r in cluster), default=None),
            "steady_state_recompiles": int(sum(
                r["steady_state_recompiles"] for r in cluster)),
            "steady_state_retranspositions": int(sum(
                r["steady_state_retranspositions"] for r in cluster)),
        },
        "hierarchical_device_engine": {
            "leaf_tiles_scanned_per_batch": scanned,
            "grid_steps_per_batch_incl_bucket_padding": grid,
            "leaf_tiles_full_scan_per_batch": full,
            "scan_fraction": scanned / full if full else None,
            "strictly_fewer_than_full_scan": bool(scanned < full),
            "steady_state_recompiles": int(sum(
                r["steady_state_recompiles"] for r in device)),
            "steady_state_retranspositions": int(sum(
                r["steady_state_retranspositions"] for r in device)),
        },
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale subset: one fanout/capacity, "
                         "yelp x0.1, one closure scale")
    ap.add_argument("--degraded", action="store_true",
                    help="also time the exact host-fallback path with "
                         "the breaker tripped (a 'degraded' field in "
                         "BENCH_rangereach.json)")
    ap.add_argument("--device", default=None,
                    help="where the engines serve (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    build_kernels(dev)

    if args.smoke:
        engines = engine_sweep(**SMOKE, device=dev)
        closure = closure_sweep(scales=SMOKE_CLOSURE, device=dev)
    else:
        engines = engine_sweep(device=dev)
        closure = closure_sweep(device=dev)
    degraded = None
    if args.degraded:
        degraded = (degraded_arm(dataset=SMOKE["dataset"],
                                 scale=SMOKE["scale"], n_q=SMOKE["n_q"],
                                 repeats=SMOKE["repeats"], device=dev)
                    if args.smoke else degraded_arm(device=dev))
    out = {"device": device_name(dev), "engine_sweep": engines,
           "closure": closure}
    if degraded is not None:
        out["degraded"] = degraded
    with open(result_path("perf_rangereach.json"), "w") as f:
        json.dump(out, f, indent=1)
    summary = bench_summary(engines)
    summary["device"] = device_name(dev)
    if degraded is not None:
        # additive field: schema_version stays 2
        summary["degraded"] = degraded
    with open(result_path("BENCH_rangereach.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for r in engines:
        print(r)
    for r in closure:
        print(r)
    print(json.dumps(summary, indent=1))
    dev_s = summary["hierarchical_device_engine"]
    assert dev_s["strictly_fewer_than_full_scan"], \
        "hierarchical engine failed to prune any leaf tiles"
    assert dev_s["steady_state_recompiles"] == 0, "steady-state recompile"
    assert dev_s["steady_state_retranspositions"] == 0, \
        "steady-state host-side forest re-transposition"
    clu = summary["cluster_engine"]
    assert clu["steady_state_recompiles"] == 0, \
        "cluster steady-state recompile"
    assert clu["steady_state_retranspositions"] == 0, \
        "cluster steady-state host-side forest re-transposition"
    assert all("p99" in v for v in
               summary["latency_percentiles_us"].values()), \
        "latency percentiles missing from the bench summary"
    if degraded is not None:
        assert degraded["exact"], "degraded arm must stay exact"
        assert degraded["fallback_queries"] > 0, \
            "degraded arm never reached the host fallback"
    return {"rows": out, "summary": summary}


if __name__ == "__main__":
    main()
