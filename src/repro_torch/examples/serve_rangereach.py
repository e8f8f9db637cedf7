"""End-to-end driver: a RangeReach serving node, the paper's workload
(the port of the reference's ``examples/serve_rangereach.py``).

Phase 1 (static): builds the 2DReach-Comp index over a Yelp-shaped
graph, checks the four query engines against each other and the
oracle, then serves batched request streams and reports latency per
engine: the host descent, the torch wavefront, the leaf-scan kernel
(K9) and the device ``QueryEngine`` (the fused kernel K1), the last
three on ``--device`` (the GPU by default).

Phase 1b (analytics): the same engine answers the richer geosocial
query classes of ``repro_torch.queries``: RangeCount, RangeCollect,
KNNReach and convex-polygon regions, exact, device equal to host,
spot-checked against the BFS oracles.

Phase 2 (cluster): partitions the same forest into 8 shards
(``repro_torch.cluster.ShardedEngine``) and serves it
request-at-a-time through the deadline-or-full micro-batching
``Frontend``, asserting that the answers stay equal to the host's and
that the steady state serves no new shape.

Phase 3 (dynamic): wraps the same graph in a ``DynamicIndex`` on the
device engine and serves a mutating stream (new users, follows and
check-ins among the queries), answering every query on the mutated
graph without a rebuild, spot-checked against the BFS oracle, then
compacts in a background thread and checks the new base again.

    PYTHONPATH=src python -m repro_torch.examples.serve_rangereach
"""

import argparse
import time

import numpy as np

from ..core import (
    batch_query,
    build_dynamic_index,
    build_index,
    engine_for,
    query_host,
    query_wavefront,
    rangereach_oracle_batch,
    run_queries,
)
from ..core.oracle import (
    knn_reach_oracle,
    polygon_reach_oracle,
    range_collect_oracle,
    range_count_oracle,
)
from ..data import (
    apply_stream_op,
    get_dataset,
    knn_workload,
    polygon_workload,
    streaming_workload,
    workload,
)
from ..device import resolve_device
from ..dynamic import CompactionPolicy
from ..kernels.range_query.leafscan import range_query_forest
from ..queries import QueryProgram

BATCHES = 10
BATCH = 256
K = 8
VERIFY_EVERY = 500   # oracle spot-check cadence (BFS on the mutated graph)


def static_phase(g, index, dev):
    engine = engine_for(index, device=dev)   # one upload
    lat = {"host": [], "wavefront": [], "kernel": [], "device": []}
    for b in range(BATCHES):
        us, rects = workload(g, BATCH, extent_ratio=0.05, seed=100 + b)
        tid = index.lookup_tree(us)

        t0 = time.perf_counter()
        host = query_host(index.forest, tid, rects)
        lat["host"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        wf, ovf = query_wavefront(index.forest, tid, rects, device=dev)
        lat["wavefront"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        kr = range_query_forest(index.forest, tid, rects, device=dev)
        lat["kernel"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        dv = engine.query_batch(us, rects)
        lat["device"].append(time.perf_counter() - t0)

        assert not ovf.any()
        assert (host == wf).all() and (host == kr).all(), "engine mismatch"
        full = batch_query(index, us, rects)
        assert (dv == full).all(), "device engine mismatch"  # Alg. 2 too
        if b == 0:  # full-pipeline (Alg. 2) answers vs oracle
            want = rangereach_oracle_batch(g, us[:64], rects[:64])
            assert (full[:64] == want).all()
            print("[verify] engines agree; oracle check OK")
    print(f"[serve] device engine: {engine.n_compiles} compiled shapes "
          f"(steady state), {engine.stats['tiles_scanned']}"
          f"/{engine.stats['tiles_full_scan']} leaf tiles scanned")
    for name, ts in lat.items():
        ts = np.array(ts[1:])  # drop the warm-up batch
        print(f"[serve] {name:<10} p50 {np.median(ts) / BATCH * 1e6:7.2f} "
              f"us/query   p max {ts.max() / BATCH * 1e6:7.2f} us/query "
              f"({BATCHES - 1} batches x {BATCH})")


def analytics_phase(g, index, dev):
    # the same engine answers the richer classes of repro_torch.queries;
    # the CLI: python -m repro_torch.launch.serve --query-class knn \
    #     --engine device
    print("\n[analytics] count / collect / kNN / polygon on the device "
          "engine")
    aus, arects = workload(g, 256, extent_ratio=0.05, seed=300)
    kus, kpts = knn_workload(g, 256, seed=301)
    pus, ppolys = polygon_workload(g, 256, extent_ratio=0.05, seed=302)
    programs = {
        "count": QueryProgram.count(aus, arects),
        "collect": QueryProgram.collect(aus, arects, K),
        "knn": QueryProgram.knn(kus, kpts, K),
        "polygon": QueryProgram.polygon(pus, ppolys),
    }
    host_answers = {}
    for kind, prog in programs.items():
        host_ans = host_answers[kind] = run_queries(index, prog,
                                                    engine="host")
        dev_ans = run_queries(index, prog, engine="device", device=dev)
        t0 = time.perf_counter()
        run_queries(index, prog, engine="device", device=dev)
        dt = time.perf_counter() - t0
        if kind in ("count", "polygon"):
            assert (dev_ans == host_ans).all(), f"{kind}: device != host"
            tail = f"{int(np.sum(host_ans))} " + (
                "total hits" if kind == "count" else "positive")
        elif kind == "collect":
            assert (dev_ans.ids == host_ans.ids).all()
            assert (dev_ans.counts == host_ans.counts).all()
            tail = (f"{int(host_ans.counts.sum())} venues materialised, "
                    f"{int(host_ans.overflow.sum())} overflowed K={K}")
        else:
            assert (dev_ans.ids == host_ans.ids).all()
            assert (dev_ans.dist2 == host_ans.dist2).all()
            tail = f"{int((host_ans.ids >= 0).sum())} neighbours returned"
        print(f"[analytics] {kind:<8} device == host "
              f"({dt / prog.n_queries * 1e6:7.2f} us/query warm)  {tail}")
    # oracle spot-check across all four classes
    cnt_h, col_h = host_answers["count"], host_answers["collect"]
    knn_h, pol_h = host_answers["knn"], host_answers["polygon"]
    for b in range(16):
        assert cnt_h[b] == range_count_oracle(g, int(aus[b]), arects[b])
        want = range_collect_oracle(g, int(aus[b]), arects[b])
        assert (col_h.counts[b] == len(want)
                and (col_h.row(b) == want[:K]).all())
        oi, _ = knn_reach_oracle(g, int(kus[b]), kpts[b], K)
        assert (knn_h.row(b) == oi).all()
        assert pol_h[b] == polygon_reach_oracle(g, int(pus[b]), ppolys[b])
    print("[analytics] oracle spot-check OK on all four classes")


def cluster_phase(g, index, dev):
    # the same forest in 8 shards (stacked per device when fewer are
    # visible), served request-at-a-time through the frontend; the CLI:
    # python -m repro_torch.launch.serve --engine cluster --shards 8
    from ..cluster import Frontend, ShardedEngine

    ceng = ShardedEngine(index, n_shards=8, device=dev)
    print(f"\n[cluster] {ceng.n_shards} shards on "
          f"{ceng.mesh.shape['data']} device(s), per-shard entries "
          f"{ceng.partition.shard_entries.tolist()}")
    us, rects = workload(g, 512, extent_ratio=0.05, seed=200)
    want = batch_query(index, us, rects)
    with Frontend(ceng, max_batch=128, max_delay=2e-3) as fe:
        fe.warmup(us[:128], rects[:128])
        fe.submit_many(us, rects)          # warm pass fixes the K mark
        fe.warmup(us[:128], rects[:128])   # every bucket at that mark
        warm = ceng.n_compiles
        t0 = time.perf_counter()
        got = fe.submit_many(us, rects)
        dt = time.perf_counter() - t0
        assert (got == want).all(), "cluster engine mismatch"
        assert ceng.n_compiles == warm, "steady-state new shape"
        print(f"[cluster] {len(us)} queries in {dt * 1e3:.1f} ms "
              f"({dt / len(us) * 1e6:.2f} us/query), "
              f"{int(fe.stats['n_batches'])} flushes "
              f"(full {int(fe.stats['n_flush_full'])} / deadline "
              f"{int(fe.stats['n_flush_deadline'])}), "
              f"routing {ceng.shard_queries.tolist()}")
        print(f"[cluster] answers match host; {ceng.n_compiles} shapes "
              f"served stayed flat through the steady-state pass")


def dynamic_phase(g, dev, steps: int):
    print("\n[dynamic] serving a mutating stream (updates + queries "
          "interleaved)")
    dyn = build_dynamic_index(
        g, "2dreach-comp", engine="device", device=dev,  # device base probe
        policy=CompactionPolicy(max_overlay_edges=4096, background=True),
    )
    pending_us, pending_rects, q_lat = [], [], []
    n_updates = n_queries = 0
    for step, op in enumerate(streaming_workload(
            g, n_steps=steps, seed=17,
            p_query=0.5, p_edge=0.3, p_vertex=0.1, p_spatial=0.1)):
        pending = apply_stream_op(dyn, op)
        if pending is None:
            n_updates += 1
        else:
            pending_us.append(pending[0])
            pending_rects.append(pending[1])
            if len(pending_us) == 64:  # serve in small batches
                us_b = np.asarray(pending_us)
                rects_b = np.asarray(pending_rects, np.float32)
                t0 = time.perf_counter()
                dyn.query_batch(us_b, rects_b)
                q_lat.append((time.perf_counter() - t0) / len(us_b))
                n_queries += len(us_b)
                pending_us, pending_rects = [], []
        if step and step % VERIFY_EVERY == 0:
            gm = dyn.snapshot_graph()
            vu, vr = workload(gm, 32, extent_ratio=0.05, seed=step)
            assert (dyn.query_batch(vu, vr)
                    == rangereach_oracle_batch(gm, vu, vr)).all(), \
                f"dynamic answers diverged from oracle at step {step}"
            print(f"[dynamic] step {step:5d}: overlay={dyn.overlay_size:5d} "
                  f"p50 {np.median(q_lat) * 1e6:7.2f} us/query  oracle OK")

    if pending_us:  # the trailing partial batch
        dyn.query_batch(np.asarray(pending_us),
                        np.asarray(pending_rects, np.float32))
        n_queries += len(pending_us)

    # a final compaction swap, and the new base checked
    dyn.compact(background=True)
    dyn.join_compaction()
    gm = dyn.snapshot_graph()
    vu, vr = workload(gm, 64, extent_ratio=0.05, seed=999)
    assert (dyn.query_batch(vu, vr)
            == rangereach_oracle_batch(gm, vu, vr)).all()
    rep = dyn.report()
    print(f"[dynamic] {n_updates} updates, {n_queries} queries, "
          f"{int(rep['n_compactions'])} compactions "
          f"({rep['t_compaction_total']:.2f}s total, "
          f"{rep.get('amortized_compaction_us_per_update', 0.0):.1f} "
          f"us/update amortized), {int(rep['n_scc_merges'])} SCC merges")
    print(f"[dynamic] post-swap verify OK on {gm.n_nodes} nodes "
          f"({gm.n_nodes - g.n_nodes} added), {gm.n_edges} edges")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the engines serve (default: the GPU)")
    ap.add_argument("--scale", type=float, default=0.2,
                    help="yelp scale (the reference's: 0.2)")
    ap.add_argument("--steps", type=int, default=4000,
                    help="steps of the mutating stream")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = get_dataset("yelp", scale=args.scale)
    print(f"[build] yelp x{args.scale}: {g.n_nodes} nodes, {g.n_edges} "
          f"edges")
    t0 = time.perf_counter()
    index = build_index(g, "2dreach-comp")
    print(f"[build] 2dreach-comp in {time.perf_counter() - t0:.2f}s, "
          f"{int(index.stats['distinct_rtrees'])} distinct R-trees")
    static_phase(g, index, dev)
    analytics_phase(g, index, dev)
    cluster_phase(g, index, dev)
    dynamic_phase(g, dev, args.steps)


if __name__ == "__main__":
    main()
