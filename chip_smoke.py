#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of 2DReach serving on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises, so the exit code is
not 0.  Where ``torch.cuda.is_available()`` is false, or the package is
not beside this script, it exits with code 2 and prints no result.

  device   the card's name and power limit (as ``nvidia-smi`` gives them)
  build    ``nvcc`` of every kernel source in the checkout, in parallel
  kernels  each kernel against its plain PyTorch version on the card:
           random arenas at the yelp x1.0 2dreach-comp shape and at edge
           shapes (B = 8 and 24; kcap below, at and above the true
           candidate count and the tile count; empty slices), all modes,
           exact equality
  main     the main path: host build of yelp x1.0 2dreach-comp and
           2dreach-pointer and of yelp x0.5 2dreach (base, whose pyramid
           exceeds shared memory); for each, ``QueryEngine`` on the card
           answering 2048 queries (extent 5%) in batches of 256 with
           query_batch, count_batch and collect_batch(k=10), twice; equal
           to the host index and, on a 256-query sample, to the BFS
           oracle; the ratchet flat in the second pass.  Each index's
           launch count is reset just before its serving and read just
           after, and must equal its batches plus ratchet re-runs
  main_batches  the kernel against its plain version on each index's
           first main-path batch (after the count is read)
  timing   device time per launch of the kernel and of the plain
           version at B=256 (torch.profiler; CUDA-event times beside them
           as ``event_ms``), end-to-end microseconds per query, launches
           per batch and the bound, per mode
  profile  torch.profiler over one reach pass: device operations and
           busy time per batch, and the busy share of the end-to-end time

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks at 700 W.  The float32 rate outside the tensor cores,
# 67 TFLOP/s, counts an FMA as two operations on 128 FP32 lanes per SM; a
# compare is one instruction, so float32 compares run at half that rate,
# and integer compares, on the SM's 64 INT32 lanes, at a quarter.
HBM_BYTES_PER_S = 3.35e12
F32_CMP_PER_S = 67e12 / 2
I32_CMP_PER_S = 67e12 / 4
DEVICE = "cuda"
BATCH = 256
N_QUERIES = 2048
# main path: (dataset, scale, method)
CONFIGS = (("yelp", 1.0, "2dreach-comp"), ("yelp", 1.0, "2dreach-pointer"),
           ("yelp", 0.5, "2dreach"))
# random arenas: (leaf tiles, trees, batch sizes); 12,204 leaf tiles is
# the yelp x1.0 2dreach-comp arena
ARENAS = ((12204, 3000, (8, 24)), (3, 2, (8,)))
MODES = ("reach", "count", "collect")
COLLECT_K = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Host references for count / collect (brute force over each tree slice)
# --------------------------------------------------------------------------

def host_count_collect(idx, us, rects, k):
    """Exact counts and the k smallest reachable venue ids per query,
    routed like the host index (Alg. 2 for spatial-sink vertices)."""
    us = np.asarray(us, np.int64)
    rects = np.asarray(rects, np.float32).reshape(len(us), 4)
    f = idx.forest
    exc = idx.excluded[us]
    tid = np.full(len(us), -1, np.int64)
    if (~exc).any():
        tid[~exc] = idx.lookup_tree(us[~exc])
    counts = np.zeros(len(us), np.int64)
    ids = np.full((len(us), k), -1, np.int32)
    for i, r in enumerate(rects):
        if exc[i]:
            p = idx.coords[us[i]]
            if p[0] >= r[0] and p[0] <= r[2] and p[1] >= r[1] and p[1] <= r[3]:
                counts[i], ids[i, 0] = 1, us[i]
        elif tid[i] >= 0:
            s, e = f.entry_off[tid[i]], f.entry_off[tid[i] + 1]
            b = f.entries[s:e]
            ok = ((b[:, 0] <= r[2]) & (b[:, 1] <= r[3])
                  & (b[:, 2] >= r[0]) & (b[:, 3] >= r[1]))
            hit = np.sort(f.entry_ids[s:e][ok])
            counts[i] = len(hit)
            ids[i, :min(k, len(hit))] = hit[:k]
    return counts, ids


# --------------------------------------------------------------------------
# Kernel against its plain version
# --------------------------------------------------------------------------

def compare(fs, args, nt, kcaps, where):
    """Exact equality of the kernel and the plain version, every mode and
    capacity; returns the largest absolute difference (0)."""
    import torch

    err = 0
    for mode in MODES:
        for kcap in kcaps:
            ko, kc = fs.fused_serve(*args, mode=mode, kcap=kcap, nt=nt,
                                    device=DEVICE)
            po, pc = fs.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            torch.cuda.synchronize()
            err = max(err, int((ko.long() - po.long()).abs().max()),
                      int((kc.long() - pc.long()).abs().max()))
            if not (torch.equal(ko, po) and torch.equal(kc, pc)):
                raise AssertionError(
                    f"fused_serve kernel != plain version ({where}, "
                    f"mode={mode}, kcap={kcap})")
    return err


def random_arena(rng, n_tiles, n_trees, device):
    """Random serving inputs at a given arena size: clustered points cut
    into tree slices, each slice sorted along x for tile locality."""
    import torch
    from repro_torch.kernels.range_query import fused as fs
    from repro_torch.kernels.range_query.layout import TP, build_tile_pyramid

    P = n_tiles * TP - int(rng.integers(1, TP))
    cuts = np.sort(rng.choice(np.arange(1, P), n_trees - 1, replace=False))
    off = np.concatenate([[0], cuts, [P]]).astype(np.int64)
    pts = np.empty((P, 2), np.float32)
    for t in range(n_trees):
        s, e = off[t], off[t + 1]
        c = rng.random(2) * 100
        p = (c + rng.standard_normal((e - s, 2)) * rng.uniform(1, 20))
        pts[s:e] = np.clip(p[np.argsort(p[:, 0])], 0, 100)
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    ext = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64)
    grid = fs.make_quant_grid(ext, 2, device)
    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return dict(grid=grid, off=off, nt=nt, esoa=T(esoa), ids=T(ids),
                qfine=fs.quantize_fine(grid, T(fine), 2),
                qcoarse=fs.quantize_coarse(grid, T(coarse), 2))


def random_batch(rng, arena, B, device):
    import torch
    from repro_torch.kernels.range_query import fused as fs

    t = rng.integers(0, len(arena["off"]) - 1, B)
    qs, qe = arena["off"][t], arena["off"][t + 1]
    empty = rng.random(B) < 0.2                    # empty arena slices
    qs[empty] = qe[empty] = 0
    side = rng.uniform(5, 30, (B, 1))
    lo = rng.uniform(-5, 100, (B, 2))
    rsoa = np.concatenate([lo, lo + side], 1).T.astype(np.float32)
    rsoa = torch.as_tensor(np.ascontiguousarray(rsoa), device=device)
    r16, r32 = fs.quantize_rects(arena["grid"], rsoa, 2)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa
    return (arena["qfine"], arena["qcoarse"], arena["esoa"], arena["ids"],
            r16, r32, rsoa, i32(qs), i32(qe))


def phase_kernels(fs):
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    err, cases = 0, []
    for n_tiles, n_trees, Bs in ARENAS:
        arena = random_arena(rng, n_tiles, n_trees, dev)
        nt = arena["nt"]
        for B in Bs:
            args = random_batch(rng, arena, B, dev)
            _, cnt = fs.fused_serve_torch(*args, mode="reach", kcap=1, nt=nt)
            mx = int(cnt.max())
            kcaps = sorted({max(1, mx // 2), max(mx, 1), nt, nt + 3})
            err = max(err, compare(fs, args, nt, kcaps, f"random nt={nt} B={B}"))
            cases.append({"nt": nt, "B": B, "max_cnt": mx, "kcaps": kcaps})
    emit("kernels", ok=True, max_abs_err=err, cases=cases,
         seconds=round(time.perf_counter() - t0, 3))
    return err


# --------------------------------------------------------------------------
# Main path
# --------------------------------------------------------------------------

def serve_all(eng, us, rects):
    """query/count/collect over the workload in batches of BATCH."""
    reach, count, ids, tot = [], [], [], []
    for s in range(0, len(us), BATCH):
        u, r = us[s:s + BATCH], rects[s:s + BATCH]
        reach.append(eng.query_batch(u, r))
        count.append(eng.count_batch(u, r))
        col = eng.collect_batch(u, r, COLLECT_K)
        ids.append(col.ids)
        tot.append(col.counts)
    return (np.concatenate(reach), np.concatenate(count),
            np.concatenate(ids), np.concatenate(tot))


def check_index(fs, name, g, idx, us, rects):
    from repro_torch.core import QueryEngine, rangereach_oracle_batch

    host_reach = idx.query_batch(us, rects)
    host_cnt, host_ids = host_count_collect(idx, us, rects, COLLECT_K)
    eng = QueryEngine(idx)                 # device=None: the GPU
    fs.fused_serve.launches = 0            # this path's count only
    passes = []
    for p in range(2):                     # warm-up pass, then steady
        reruns = eng.stats["fused_reruns"]
        t0 = time.perf_counter()
        reach, count, ids, tot = serve_all(eng, us, rects)
        dt = time.perf_counter() - t0
        if not ((reach == host_reach).all() and (count == host_cnt).all()
                and (tot == host_cnt).all() and (ids == host_ids).all()):
            raise AssertionError(f"{name}: device answers != host index")
        passes.append({"seconds": round(dt, 3),
                       "fused_reruns": eng.stats["fused_reruns"] - reruns})
    launches = fs.fused_serve.launches     # read just after the serving
    want = eng.stats["batches"] + eng.stats["fused_reruns"]
    if launches <= 0 or launches != want:
        raise AssertionError(
            f"{name}: {launches} fused_serve launches, expected {want} "
            f"(one per batch plus ratchet re-runs)")
    if passes[1]["fused_reruns"]:
        raise AssertionError(f"{name}: capacity ratchet re-ran in steady state")
    sample = slice(0, BATCH)
    oracle = rangereach_oracle_batch(g, us[sample], rects[sample])
    if not (oracle == reach[sample]).all():
        raise AssertionError(f"{name}: device answers != BFS oracle")
    return eng, {"index": name, "entries": int(len(idx.forest.entries)),
                 "n_tiles": eng.n_tiles, "launches": launches,
                 "qfine_bytes": int(eng._qfine.numel() * 2),
                 "kcap": min(eng._kb_hwm, eng.n_tiles), "passes": passes,
                 "hit_rate": float(reach.mean()),
                 "stats": {k: int(v) for k, v in eng.stats.items()}}


def phase_main(fs):
    from repro_torch.core import build_index
    from repro_torch.data import get_dataset, workload

    built = []
    for ds, scale, method in CONFIGS:
        g = get_dataset(ds, scale=scale)
        t0 = time.perf_counter()
        idx = build_index(g, method)
        built.append((f"{ds}x{scale} {method}", g, idx,
                      time.perf_counter() - t0))
    results, engines = [], {}
    for name, g, idx, build_s in built:
        us, rects = workload(g, N_QUERIES, extent_ratio=0.05)
        eng, rec = check_index(fs, name, g, idx, us, rects)
        rec["build_seconds"] = round(build_s, 3)
        results.append(rec)
        engines[name] = (eng, us, rects)
    return results, engines


def phase_main_batches(fs, engines):
    """The kernel against its plain version on each index's first
    main-path batch, at the steady capacity and a truncating one."""
    err = 0
    for name, (eng, us, rects) in engines.items():
        _, _, args = eng._prepare(us[:BATCH], rects[:BATCH])
        kcap = min(eng._kb_hwm, eng.n_tiles)
        kcaps = sorted({max(1, kcap // 2), kcap})
        err = max(err, compare(fs, args, eng.n_tiles, kcaps,
                               f"{name} main-path batch"))
    emit("main_batches", ok=True, max_abs_err=err)
    return err


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def event_ms(fn, iters):
    """Milliseconds per call between CUDA events around back-to-back
    calls: the device's time when the host keeps ahead of it, the host's
    launch rate when it does not."""
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_rows(fn, iters):
    """torch.profiler over ``iters`` calls: (name, count, device µs) of
    every kernel and copy the device ran (device rows only, so an
    operator and the kernel it launched are not both counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


def device_ms(fn, iters, what):
    """Device milliseconds per call from the profiler; raises where it
    saw no device activity, so no host time is reported as device time."""
    rows = device_rows(fn, iters)
    if not rows:
        raise RuntimeError(f"torch.profiler saw no device time for {what}")
    return sum(t for _, _, t in rows) / iters / 1e3


def kernel_bound(fs, args, nt, kcap, mode):
    """Least time for the launch's work on these inputs, the larger of two
    times.  Bytes: the pyramid planes, the distinct leaf tiles its
    worklists scan (2 KB each, +512 B of ids in collect) and the query
    inputs read once, the outputs written once, over the memory rate.
    Operations: per query, 4 integer compares for each fine tile and for
    each coarse group that its arena slice [qs, qe) overlaps (the slice
    range itself costs O(1)), and 4 float32 compares for each entry of its
    slice in the tiles its query tile scans, over the compare rates."""
    import torch
    from repro_torch.kernels.range_query.layout import COARSE_GROUP, TB, TP

    qf, qc, ent, ids, r16, r32, rsoa, qs, qe = args
    B = rsoa.shape[1]
    mask = fs.quantized_prune_mask(qf, qc, r16, r32, qs, qe)
    cand, cnt = fs.compact_ascending(mask, nt)
    k = min(kcap, nt)
    ck = cand[:, :k].long()                                    # (nb, k)
    live = (torch.arange(k, device=ck.device)[None, :]
            < cnt.clamp(max=kcap)[:, None])
    tiles = int(torch.unique(ck[live]).numel())
    scanned = int(live.sum())
    tile_b = 4 * TP * 4 + (TP * 4 if mode == "collect" else 0)
    out_b = B * kcap * TP * 4 if mode == "collect" else B * 4
    nbytes = (qf.numel() * 2 + qc.numel() * 4 + tiles * tile_b
              + B * (4 * 2 + 4 * 4 + 4 * 4 + 4 + 4) + out_b + cnt.numel() * 4)
    s, e = qs.long(), qe.long()
    some = e > s
    last = (e - 1).clamp(min=0)
    span = lambda w: torch.where(some, last // w - s // w + 1, 0)  # noqa
    int_cmp = 4 * int((span(TP) + span(TP * COARSE_GROUP)).sum())
    t0 = ck[:, None, :] * TP                                   # (nb, 1, k)
    lo = torch.maximum(t0, s.reshape(-1, TB)[:, :, None])
    hi = torch.minimum(t0 + TP, e.reshape(-1, TB)[:, :, None])
    in_slice = int(((hi - lo).clamp(min=0) * live[:, None, :]).sum())
    f32_cmp = 4 * in_slice
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = (int_cmp / I32_CMP_PER_S + f32_cmp / F32_CMP_PER_S) * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations",
            {"bytes": int(nbytes), "int_compares": int_cmp,
             "f32_compares": f32_cmp, "byte_ms": byte_ms, "op_ms": op_ms,
             "distinct_tiles": tiles, "scanned_tiles": scanned})


def phase_timing(fs, engines, card):
    name = next(iter(engines))           # the first main-path index
    eng, us, rects = engines[name]
    _, _, args = eng._prepare(us[:BATCH], rects[:BATCH])
    args = tuple(a.clone() for a in args)
    kcap = min(eng._kb_hwm, eng.n_tiles)
    nt = eng.n_tiles
    per_mode = {}
    for mode in MODES:
        kern = lambda: fs.fused_serve(                      # noqa: E731
            *args, mode=mode, kcap=kcap, nt=nt, device=DEVICE)
        plain = lambda: fs.fused_serve_torch(               # noqa: E731
            *args, mode=mode, kcap=kcap, nt=nt)
        k_dev = device_ms(kern, 50, f"fused_serve ({mode})")
        p_dev = device_ms(plain, 10, f"fused_serve_torch ({mode})")
        k_ev, p_ev = event_ms(kern, 50), event_ms(plain, 10)
        bound, by, work = kernel_bound(fs, args, nt, kcap, mode)
        call = {"reach": lambda u, r: eng.query_batch(u, r),
                "count": lambda u, r: eng.count_batch(u, r),
                "collect": lambda u, r: eng.collect_batch(u, r, COLLECT_K)}[mode]
        batches0, launches0 = eng.stats["batches"], fs.fused_serve.launches
        t0 = time.perf_counter()
        for rep in range(3):
            for s in range(0, len(us), BATCH):
                call(us[s:s + BATCH], rects[s:s + BATCH])
        e2e_us = (time.perf_counter() - t0) / (3 * len(us)) * 1e6
        per_batch = ((fs.fused_serve.launches - launches0)
                     / (eng.stats["batches"] - batches0))
        per_mode[mode] = {
            "ms": k_dev, "plain_ms": p_dev,
            "event_ms": k_ev, "plain_event_ms": p_ev,
            "bound_ms": bound, "bound_by": by, "e2e_us_per_query": e2e_us,
            "launches_per_batch": per_batch, **work}
    emit("timing", index=name, B=BATCH, kcap=kcap, n_tiles=nt,
         blocks=BATCH // 8, card=card, per_mode=per_mode)
    phase_profile(eng, us, rects, per_mode["reach"]["e2e_us_per_query"])
    return per_mode


def phase_profile(eng, us, rects, e2e_us_per_query):
    """Where a query_batch's time goes: device time by operation over one
    reach pass of the workload, and the device's busy share of the
    unprofiled end-to-end time."""
    n_batches = len(range(0, len(us), BATCH))

    def one_pass():
        for s in range(0, len(us), BATCH):
            eng.query_batch(us[s:s + BATCH], rects[s:s + BATCH])

    rows = device_rows(one_pass, 1)
    if not rows:
        emit("profile", device_time="not measured: the profiler saw no "
             "device activity")
        return
    busy_us = sum(t for _, _, t in rows) / n_batches
    e2e_batch_us = e2e_us_per_query * BATCH
    emit("profile", mode="reach", B=BATCH,
         device_ops_per_batch=sum(c for _, c, _ in rows) / n_batches,
         device_busy_us_per_batch=busy_us,
         e2e_us_per_batch=e2e_batch_us,
         device_busy_share=busy_us / e2e_batch_us,
         top=[{"op": k[:60], "calls_per_batch": c / n_batches,
               "us_per_batch": t / n_batches} for k, c, t in rows[:8]])


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels.range_query import fused as fs
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2

    card = card_line()
    print(card, flush=True)
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib, log = _build.build("fused_serve")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=lib.name,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    kernel_err = phase_kernels(fs)
    results, engines = phase_main(fs)
    launches = {r["index"]: r["launches"] for r in results}
    emit("main", launches=launches, indexes=results)
    kernel_err = max(kernel_err, phase_main_batches(fs, engines))

    per_mode = phase_timing(fs, engines, card)
    reach = per_mode["reach"]
    print(json.dumps({"kernels": [{
        "name": "fused_serve", "route": "cuda",
        "source": "src/repro_torch/kernels/range_query/csrc/fused_serve.cu",
        "replaces": "src/repro/kernels/range_query/fused.py:341",
        "launches": sum(launches.values()), "launches_per_path": launches,
        "max_abs_err": kernel_err,
        "ms": reach["ms"], "plain_ms": reach["plain_ms"],
        "bound_ms": reach["bound_ms"], "bound_by": reach["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
