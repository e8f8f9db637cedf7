#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of 2DReach serving on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises, so the exit code is
not 0.  Where ``torch.cuda.is_available()`` is false, or the package is
not beside this script, it exits with code 2 and prints no result.

  device   the card's name and power limit (as ``nvidia-smi`` gives them)
  build    ``nvcc`` of every kernel source in the checkout
           (``_build.SOURCES``), one compiler per source, all started
           together; the ``ptxas`` register and spill lines per kernel
  kernels  each kernel against its plain PyTorch version on the card,
           exact equality.  Random arenas at the yelp x1.0 2dreach-comp
           shape and at an edge shape, B = 8 and 24 (at B = 24 the last
           query tile has only empty slices: a row of no candidate).
           Fused serve: every mode, kcap below, at and above the true
           candidate count and the tile count.  Tile prune, and the
           descent / count / collect scans with K below, at and above
           the true count and K = NTp
  main     the main paths: host build of yelp x1.0 2dreach-comp and
           2dreach-pointer and of yelp x0.5 2dreach (base, whose pyramid
           exceeds shared memory); for each, ``QueryEngine`` on the card
           answering 2048 queries (extent 5%) in batches of 256 with
           query_batch, count_batch and collect_batch(k=10), twice;
           equal to the host index and, on a 256-query sample, to the
           BFS oracle; the ratchet flat in the second pass.  Then the
           same 2048 queries, twice, through query/count/collect
           _batch_two_phase, equal to the host index and the fused
           answers.  Then kNN (k=8) for 256 queries at the workload's
           rect centres on yelp x1.0 comp, on the fused and the
           two-phase path, equal to the host best-first descent.  Every
           kernel's launch count is reset just before each path and read
           just after: fused serve once per batch plus ratchet re-runs;
           the prune once per two-phase batch, each scan once per batch
           of its mode; kNN launches the fused serve on the fused path,
           and the count and collect scans but no fused serve on the
           two-phase path
  main_batches  every kernel against its plain version on each index's
           first main-path batch (after the counts are read)
  timing   at B=256 on yelp x1.0 comp: device time per launch of each
           kernel and of its plain version (torch.profiler; CUDA-event
           times of the fused serve beside them as ``event_ms``), the
           bound counted from these inputs, end-to-end microseconds per
           query per mode on both paths; the prune also on the yelp x0.5
           base batch, whose mask is 6x larger
  profile  torch.profiler over one reach pass on each path: device
           operations and busy time per batch, and the busy share of the
           end-to-end time

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
KNN_K = 8
KNN_QUERIES = 256
SCANS = {"reach": "descent_scan", "count": "count_scan",
         "collect": "collect_scan"}
KERNELS = ("fused_serve", "prune_tiles", "descent_scan", "count_scan",
           "collect_scan")
CSRC = "src/repro_torch/kernels/range_query/csrc/"
RECORD = {   # name -> (source, the TPU kernel it replaces)
    "fused_serve": ("fused_serve.cu",
                    "src/repro/kernels/range_query/fused.py:341"),
    "prune_tiles": ("prune_tiles.cu",
                    "src/repro/kernels/range_query/descent.py:149"),
    "descent_scan": ("leaf_scan.cu",
                     "src/repro/kernels/range_query/descent.py:236"),
    "count_scan": ("leaf_scan.cu",
                   "src/repro/kernels/range_query/analytics.py:92"),
    "collect_scan": ("leaf_scan.cu",
                     "src/repro/kernels/range_query/analytics.py:164"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Kernels:
    """The port's kernel wrappers by name, with their plain versions and
    launch counters."""

    def __init__(self):
        from repro_torch.kernels.range_query import analytics, descent, fused

        self.fs, self.ds, self.an = fused, descent, analytics
        self.wrap = {"fused_serve": fused.fused_serve,
                     "prune_tiles": descent.prune_tiles,
                     "descent_scan": descent.descent_scan,
                     "count_scan": analytics.count_scan,
                     "collect_scan": analytics.collect_scan}
        self.plain = {"prune_tiles": descent.prune_tiles_torch,
                      "descent_scan": descent.descent_scan_torch,
                      "count_scan": analytics.count_scan_torch,
                      "collect_scan": analytics.collect_scan_torch}

    def reset(self) -> None:
        for fn in self.wrap.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {k: fn.launches for k, fn in self.wrap.items()}


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
# Kernels against their plain versions
# --------------------------------------------------------------------------

def _diff(a, b) -> int:
    import torch

    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if a.shape != b.shape or not torch.equal(a, b):
        return max(err, 1)
    return err


def compare_fused(ks, args, nt, kcaps, where):
    """Exact equality of the fused kernel and its plain version, every
    mode and capacity; returns the largest absolute difference (0)."""
    fs = ks.fs
    err = 0
    for mode in MODES:
        for kcap in kcaps:
            ko, kc = fs.fused_serve(*args, mode=mode, kcap=kcap, nt=nt,
                                    device=DEVICE)
            po, pc = fs.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            e = max(_diff(ko, po), _diff(kc, pc))
            if e:
                raise AssertionError(
                    f"fused_serve kernel != plain version ({where}, "
                    f"mode={mode}, kcap={kcap})")
            err = max(err, e)
    return err


def compare_two_phase(ks, arena, rsoa, qs, qe, nt, Ks, where):
    """Exact equality of the prune kernel and of each scan kernel with
    their plain versions: the prune on this batch, the scans on its
    compacted candidates cut at each K.  Returns ``({kernel: largest
    absolute difference}, true candidate counts)``."""
    ds, an = ks.ds, ks.an
    fine, coarse, ent, ids = (arena["fine"], arena["coarse"], arena["esoa"],
                              arena["ids"])
    mask = ds.prune_tiles(fine, coarse, rsoa, qs, qe, device=DEVICE)
    pmask = ds.prune_tiles_torch(fine, coarse, rsoa, qs, qe)
    errs = {"prune_tiles": _diff(mask, pmask)}
    cand, cnt = ks.fs.compact_ascending(pmask, nt)
    for K in Ks:
        ck = ds.take_candidates(cand, K)
        args = {"descent_scan": (ck, ent, rsoa, qs, qe),
                "count_scan": (ck, ent, rsoa, qs, qe),
                "collect_scan": (ck, ent, ids, rsoa, qs, qe)}
        for name, a in args.items():
            got = ks.wrap[name](*a, device=DEVICE)
            e = _diff(got, ks.plain[name](*a))
            errs[name] = max(errs.get(name, 0), e)
    for name, e in errs.items():
        if e:
            raise AssertionError(f"{name} kernel != plain version ({where}, "
                                 f"K in {list(Ks)})")
    return errs, cnt


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
                fine=T(fine), coarse=T(coarse),
                qfine=fs.quantize_fine(grid, T(fine), 2),
                qcoarse=fs.quantize_coarse(grid, T(coarse), 2))


def random_batch(rng, arena, B, device):
    """The fused serve's inputs for one random batch; where B > 8 the
    last query tile has only empty slices."""
    import torch
    from repro_torch.kernels.range_query import fused as fs
    from repro_torch.kernels.range_query.layout import TB

    t = rng.integers(0, len(arena["off"]) - 1, B)
    qs, qe = arena["off"][t], arena["off"][t + 1]
    empty = rng.random(B) < 0.2                    # empty arena slices
    if B > TB:
        empty[-TB:] = True                         # a row of no candidate
    qs[empty] = qe[empty] = 0
    side = rng.uniform(5, 30, (B, 1))
    lo = rng.uniform(-5, 100, (B, 2))
    rsoa = np.concatenate([lo, lo + side], 1).T.astype(np.float32)
    rsoa = torch.as_tensor(np.ascontiguousarray(rsoa), device=device)
    r16, r32 = fs.quantize_rects(arena["grid"], rsoa, 2)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa
    return (arena["qfine"], arena["qcoarse"], arena["esoa"], arena["ids"],
            r16, r32, rsoa, i32(qs), i32(qe))


def phase_kernels(ks):
    import torch

    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    errs = dict.fromkeys(KERNELS, 0)
    cases = []
    for n_tiles, n_trees, Bs in ARENAS:
        arena = random_arena(rng, n_tiles, n_trees, dev)
        nt = arena["nt"]
        ntp = int(arena["fine"].shape[1])
        for B in Bs:
            args = random_batch(rng, arena, B, dev)
            _, cnt = ks.fs.fused_serve_torch(*args, mode="reach", kcap=1,
                                             nt=nt)
            mx = int(cnt.max())
            kcaps = sorted({max(1, mx // 2), max(mx, 1), nt, nt + 3})
            where = f"random nt={nt} B={B}"
            errs["fused_serve"] = max(errs["fused_serve"], compare_fused(
                ks, args, nt, kcaps, where))
            rsoa, qs, qe = args[6:]
            pmask = ks.ds.prune_tiles_torch(arena["fine"], arena["coarse"],
                                            rsoa, qs, qe)
            _, pcnt = ks.fs.compact_ascending(pmask, nt)
            pmx = int(pcnt.max())
            Ks = sorted({max(1, pmx // 2), max(pmx, 1), pmx + 3, ntp})
            e2, _ = compare_two_phase(ks, arena, rsoa, qs, qe, nt, Ks, where)
            for k, v in e2.items():
                errs[k] = max(errs[k], v)
            cases.append({"nt": nt, "B": B, "max_cnt": mx, "kcaps": kcaps,
                          "two_phase_max_cnt": pmx, "Ks": Ks,
                          "rows_without_candidates": int((pcnt == 0).sum())})
    emit("kernels", ok=True, max_abs_err=errs, cases=cases,
         seconds=round(time.perf_counter() - t0, 3))
    return errs


# --------------------------------------------------------------------------
# Main path
# --------------------------------------------------------------------------

def serve_all(eng, us, rects, two_phase=False):
    """query/count/collect over the workload in batches of BATCH, on the
    fused path or through the ``*_two_phase`` methods."""
    sfx = "_two_phase" if two_phase else ""
    query, count, collect = (getattr(eng, f"{m}_batch{sfx}")
                             for m in ("query", "count", "collect"))
    reach, cnt, ids, tot = [], [], [], []
    for s in range(0, len(us), BATCH):
        u, r = us[s:s + BATCH], rects[s:s + BATCH]
        reach.append(query(u, r))
        cnt.append(count(u, r))
        col = collect(u, r, COLLECT_K)
        ids.append(col.ids)
        tot.append(col.counts)
    return (np.concatenate(reach), np.concatenate(cnt),
            np.concatenate(ids), np.concatenate(tot))


def same_answers(got, reach, cnt, ids):
    g_reach, g_cnt, g_ids, g_tot = got
    return bool((g_reach == reach).all() and (g_cnt == cnt).all()
                and (g_tot == cnt).all() and (g_ids == ids).all())


def check_index(ks, name, g, idx, us, rects):
    from repro_torch.core import QueryEngine, rangereach_oracle_batch

    host_reach = idx.query_batch(us, rects)
    host_cnt, host_ids = host_count_collect(idx, us, rects, COLLECT_K)
    eng = QueryEngine(idx)                 # device=None: the GPU
    ks.reset()                             # this path's counts only
    passes = []
    for p in range(2):                     # warm-up pass, then steady
        reruns = eng.stats["fused_reruns"]
        t0 = time.perf_counter()
        ans = serve_all(eng, us, rects)
        dt = time.perf_counter() - t0
        if not same_answers(ans, host_reach, host_cnt, host_ids):
            raise AssertionError(f"{name}: device answers != host index")
        passes.append({"seconds": round(dt, 3),
                       "fused_reruns": eng.stats["fused_reruns"] - reruns})
    launches = ks.counts()                 # read just after the serving
    want = eng.stats["batches"] + eng.stats["fused_reruns"]
    if launches["fused_serve"] <= 0 or launches["fused_serve"] != want:
        raise AssertionError(
            f"{name}: {launches['fused_serve']} fused_serve launches, "
            f"expected {want} (one per batch plus ratchet re-runs)")
    if passes[1]["fused_reruns"]:
        raise AssertionError(f"{name}: capacity ratchet re-ran in steady state")
    sample = slice(0, BATCH)
    oracle = rangereach_oracle_batch(g, us[sample], rects[sample])
    if not (oracle == ans[0][sample]).all():
        raise AssertionError(f"{name}: device answers != BFS oracle")
    rec = {"index": name, "entries": int(len(idx.forest.entries)),
           "n_tiles": eng.n_tiles, "launches": launches["fused_serve"],
           "qfine_bytes": int(eng._qfine.numel() * 2),
           "kcap": min(eng._kb_hwm, eng.n_tiles), "passes": passes,
           "hit_rate": float(ans[0].mean()),
           "stats": {k: int(v) for k, v in eng.stats.items()}}
    return eng, (host_reach, host_cnt, host_ids), ans, rec


def check_two_phase(ks, name, eng, us, rects, host, fused):
    """The same workload through the ``*_two_phase`` methods, twice:
    equal to the host index and the fused answers; every kernel's count
    reset just before and read just after."""
    batches0 = eng.stats["batches"]
    ks.reset()
    passes = []
    for p in range(2):
        t0 = time.perf_counter()
        ans = serve_all(eng, us, rects, two_phase=True)
        dt = time.perf_counter() - t0
        if not same_answers(ans, *host):
            raise AssertionError(f"{name}: two-phase answers != host index")
        if not same_answers(ans, fused[0], fused[1], fused[2]):
            raise AssertionError(f"{name}: two-phase answers != fused path")
        passes.append({"seconds": round(dt, 3)})
    launches = ks.counts()
    batches = eng.stats["batches"] - batches0
    per_mode = batches // len(MODES)
    want = {"fused_serve": 0, "prune_tiles": batches,
            **{SCANS[m]: per_mode for m in MODES}}
    if launches != want or batches <= 0:
        raise AssertionError(f"{name}: two-phase launches {launches}, "
                             f"expected {want}")
    return {"index": name, "batches": batches, "launches": launches,
            "kb": eng._kb_hwm, "passes": passes}


def check_knn(ks, name, idx, eng, us, rects):
    """kNN at the workload's rect centres on both paths, equal to the
    host best-first descent; the launches of each path."""
    from repro_torch.core import QueryEngine
    from repro_torch.queries import knn_reach_host

    u = us[:KNN_QUERIES]
    pts = ((rects[:KNN_QUERIES, :2] + rects[:KNN_QUERIES, 2:]) / 2).astype(
        np.float32)
    t0 = time.perf_counter()
    want = knn_reach_host(idx, u, pts, KNN_K)
    host_s = time.perf_counter() - t0
    out = {"index": name, "queries": len(u), "k": KNN_K,
           "host_seconds": round(host_s, 3),
           "found": int((want.ids >= 0).sum())}
    for path, e in (("fused", eng),
                    ("two_phase", QueryEngine(idx, path="two_phase"))):
        ks.reset()
        batches0 = e.stats["batches"]
        t0 = time.perf_counter()
        got = e.knn_batch(u, pts, KNN_K)
        dt = time.perf_counter() - t0
        launches = ks.counts()
        if not (np.array_equal(got.ids, want.ids)
                and np.array_equal(got.dist2, want.dist2)):
            raise AssertionError(f"{name}: kNN on the {path} path != host")
        if path == "fused":
            ok = launches["fused_serve"] >= 1
        else:
            ok = (launches["fused_serve"] == 0
                  and launches["count_scan"] >= 1
                  and launches["collect_scan"] >= 1)
        if not ok:
            raise AssertionError(f"{name}: kNN {path} launches {launches}")
        out[path] = {"seconds": round(dt, 3), "launches": launches,
                     "batches": e.stats["batches"] - batches0}
    return out


def phase_main(ks):
    from repro_torch.core import build_index
    from repro_torch.data import get_dataset, workload

    built = []
    for ds, scale, method in CONFIGS:
        g = get_dataset(ds, scale=scale)
        t0 = time.perf_counter()
        idx = build_index(g, method)
        built.append((f"{ds}x{scale} {method}", g, idx,
                      time.perf_counter() - t0))
    results, two_phase, engines = [], [], {}
    knn = None
    for name, g, idx, build_s in built:
        us, rects = workload(g, N_QUERIES, extent_ratio=0.05)
        eng, host, fused, rec = check_index(ks, name, g, idx, us, rects)
        rec["build_seconds"] = round(build_s, 3)
        results.append(rec)
        two_phase.append(check_two_phase(ks, name, eng, us, rects, host,
                                         fused))
        if knn is None:                   # yelp x1.0 2dreach-comp
            knn = check_knn(ks, name, idx, eng, us, rects)
        engines[name] = (eng, us, rects)
    return results, two_phase, knn, engines


def phase_main_batches(ks, engines):
    """Every kernel against its plain version on each index's first
    main-path batch: the fused serve at the steady capacity and a
    truncating one, the prune and the scans at the steady K."""
    errs = dict.fromkeys(KERNELS, 0)
    for name, (eng, us, rects) in engines.items():
        _, _, args = eng._prepare(us[:BATCH], rects[:BATCH])
        kcap = min(eng._kb_hwm, eng.n_tiles)
        kcaps = sorted({max(1, kcap // 2), kcap})
        errs["fused_serve"] = max(errs["fused_serve"], compare_fused(
            ks, args, eng.n_tiles, kcaps, f"{name} main-path batch"))
        rsoa, qs, qe = args[6:]
        e2, _ = compare_two_phase(ks, arena_of(eng), rsoa, qs, qe,
                                  eng.n_tiles, [eng._kb_hwm],
                                  f"{name} main-path batch")
        for k, v in e2.items():
            errs[k] = max(errs[k], v)
    emit("main_batches", ok=True, max_abs_err=errs)
    return errs


def arena_of(eng):
    return {"fine": eng._arena.fine, "coarse": eng._arena.coarse,
            "esoa": eng._arena.entries, "ids": eng._ids_row}


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


def slice_spans(qs, qe, width):
    """Per query, the blocks of ``width`` entries its arena slice
    [qs, qe) overlaps (0 for an empty slice)."""
    import torch

    s, e = qs.long(), qe.long()
    last = (e - 1).clamp(min=0)
    return torch.where(e > s, last // width - s // width + 1, 0)


def scan_work(ck, cnt, qs, qe, K):
    """What scanning the live slots of these candidate lists needs: the
    distinct leaf tiles, the live slots, and per query the entries of
    its slice in the tiles its query tile scans."""
    import torch
    from repro_torch.kernels.range_query.layout import TB, TP

    ck = ck.long()
    live = (torch.arange(ck.shape[1], device=ck.device)[None, :]
            < cnt.clamp(max=K)[:, None])
    tiles = int(torch.unique(ck[live]).numel())
    t0 = ck[:, None, :] * TP                                   # (nb, 1, k)
    lo = torch.maximum(t0, qs.long().reshape(-1, TB)[:, :, None])
    hi = torch.minimum(t0 + TP, qe.long().reshape(-1, TB)[:, :, None])
    in_slice = int(((hi - lo).clamp(min=0) * live[:, None, :]).sum())
    return tiles, int(live.sum()), in_slice


def bound(nbytes, int_cmp, f32_cmp, **terms):
    """The larger of the byte time and the compare time, and which."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = (int_cmp / I32_CMP_PER_S + f32_cmp / F32_CMP_PER_S) * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations",
            {"bytes": int(nbytes), "int_compares": int(int_cmp),
             "f32_compares": int(f32_cmp), "byte_ms": byte_ms,
             "op_ms": op_ms, **terms})


def kernel_bound(fs, args, nt, kcap, mode):
    """K1's least time on these inputs.  Bytes: the pyramid planes, the
    distinct leaf tiles its worklists scan (2 KB each, +512 B of ids in
    collect) and the query inputs read once, the outputs written once.
    Operations: per query, 4 integer compares for each fine tile and for
    each coarse group that its arena slice [qs, qe) overlaps (the slice
    range itself costs O(1)), and 4 float32 compares for each entry of
    its slice in the tiles its query tile scans."""
    from repro_torch.kernels.range_query.layout import COARSE_GROUP, TP

    qf, qc, ent, ids, r16, r32, rsoa, qs, qe = args
    B = rsoa.shape[1]
    mask = fs.quantized_prune_mask(qf, qc, r16, r32, qs, qe)
    cand, cnt = fs.compact_ascending(mask, nt)
    k = min(kcap, nt)
    tiles, scanned, in_slice = scan_work(cand[:, :k], cnt, qs, qe, kcap)
    tile_b = 4 * TP * 4 + (TP * 4 if mode == "collect" else 0)
    out_b = B * kcap * TP * 4 if mode == "collect" else B * 4
    nbytes = (qf.numel() * 2 + qc.numel() * 4 + tiles * tile_b
              + B * (4 * 2 + 4 * 4 + 4 * 4 + 4 + 4) + out_b + cnt.numel() * 4)
    int_cmp = 4 * int((slice_spans(qs, qe, TP)
                       + slice_spans(qs, qe, TP * COARSE_GROUP)).sum())
    return bound(nbytes, int_cmp, 4 * in_slice, distinct_tiles=tiles,
                 scanned_tiles=scanned)


def prune_bound(fine, coarse, rsoa, qs, qe):
    """K2's least time on these inputs.  Bytes: the float32 fine and
    coarse planes and the query inputs read once, the int32 mask
    written once.  Operations: per query, 4 float32 compares for each
    fine tile and each coarse group its slice overlaps (no other tile
    can pass the slice test)."""
    from repro_torch.kernels.range_query.layout import COARSE_GROUP, TB, TP

    B = rsoa.shape[1]
    ntp = fine.shape[1]
    mask_b = (B // TB) * ntp * 4
    nbytes = fine.numel() * 4 + coarse.numel() * 4 + B * (16 + 8) + mask_b
    f32_cmp = 4 * int((slice_spans(qs, qe, TP)
                       + slice_spans(qs, qe, TP * COARSE_GROUP)).sum())
    return bound(nbytes, 0, f32_cmp, mask_bytes=mask_b)


def scan_bound(ck, cnt, qs, qe, mode):
    """K3/K4/K5's least time on these inputs.  Bytes: the distinct leaf
    tiles of the live slots (2 KB each, +512 B of ids for collect), the
    candidate lists and query inputs read once, the output written once
    ((B,) int32, or (B, K*128) int32 for collect).  Operations: 4
    float32 compares per entry of each query's slice in the live tiles
    its query tile scans."""
    from repro_torch.kernels.range_query.layout import TP

    B = qs.shape[0]
    K = ck.shape[1]
    tiles, scanned, in_slice = scan_work(ck, cnt, qs, qe, K)
    tile_b = 4 * TP * 4 + (TP * 4 if mode == "collect" else 0)
    out_b = B * K * TP * 4 if mode == "collect" else B * 4
    nbytes = tiles * tile_b + ck.numel() * 4 + B * (16 + 8) + out_b
    return bound(nbytes, 0, 4 * in_slice, distinct_tiles=tiles,
                 scanned_tiles=scanned, out_bytes=out_b)


def e2e_us(eng, us, rects, mode, two_phase=False):
    """End-to-end µs per query over 3 passes of the workload."""
    sfx = "_two_phase" if two_phase else ""
    call = {"reach": getattr(eng, f"query_batch{sfx}"),
            "count": getattr(eng, f"count_batch{sfx}"),
            "collect": lambda u, r: getattr(eng, f"collect_batch{sfx}")(
                u, r, COLLECT_K)}[mode]
    t0 = time.perf_counter()
    for rep in range(3):
        for s in range(0, len(us), BATCH):
            call(us[s:s + BATCH], rects[s:s + BATCH])
    return (time.perf_counter() - t0) / (3 * len(us)) * 1e6


def phase_timing(ks, engines, card):
    fs, ds = ks.fs, ks.ds
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
        bms, by, work = kernel_bound(fs, args, nt, kcap, mode)
        batches0, launches0 = eng.stats["batches"], fs.fused_serve.launches
        e2e = e2e_us(eng, us, rects, mode)
        per_batch = ((fs.fused_serve.launches - launches0)
                     / (eng.stats["batches"] - batches0))
        per_mode[mode] = {
            "ms": k_dev, "plain_ms": p_dev,
            "event_ms": k_ev, "plain_event_ms": p_ev,
            "bound_ms": bms, "bound_by": by, "e2e_us_per_query": e2e,
            "launches_per_batch": per_batch, **work}

    # the two-phase kernels on the same batch, at the steady K
    arena = arena_of(eng)
    rsoa, qs, qe = (a.clone() for a in args[6:])
    K = eng._kb_hwm
    mask = ds.prune_tiles_torch(arena["fine"], arena["coarse"], rsoa, qs, qe)
    cand, cnt = fs.compact_ascending(mask, nt)
    ck = ds.take_candidates(cand, K)
    two = {}
    prune_args = (arena["fine"], arena["coarse"], rsoa, qs, qe)
    bms, by, work = prune_bound(*prune_args)
    two["prune_tiles"] = {
        "ms": device_ms(lambda: ds.prune_tiles(*prune_args, device=DEVICE),
                        50, "prune_tiles"),
        "plain_ms": device_ms(lambda: ds.prune_tiles_torch(*prune_args), 10,
                              "prune_tiles_torch"),
        "bound_ms": bms, "bound_by": by, **work}
    for mode in MODES:
        kname = SCANS[mode]
        a = ((ck, arena["esoa"], arena["ids"], rsoa, qs, qe)
             if mode == "collect" else (ck, arena["esoa"], rsoa, qs, qe))
        bms, by, work = scan_bound(ck, cnt, qs, qe, mode)
        two[kname] = {
            "ms": device_ms(lambda: ks.wrap[kname](*a, device=DEVICE), 50,
                            kname),
            "plain_ms": device_ms(lambda: ks.plain[kname](*a), 10,
                                  f"{kname} plain"),
            "bound_ms": bms, "bound_by": by, "K": K, **work}
        two[kname]["e2e_us_per_query"] = e2e_us(eng, us, rects, mode,
                                                two_phase=True)
    # the prune's mask write grows with the arena: the same on the
    # largest index's first batch
    big, (beng, bus, brects) = list(engines.items())[-1]
    _, _, bargs = beng._prepare(bus[:BATCH], brects[:BATCH])
    bprune = (beng._arena.fine, beng._arena.coarse,
              *(a.clone() for a in bargs[6:]))
    bms, by, work = prune_bound(*bprune)
    two["prune_tiles"]["largest_index"] = {
        "index": big, "n_tiles": beng.n_tiles,
        "ms": device_ms(lambda: ds.prune_tiles(*bprune, device=DEVICE), 50,
                        f"prune_tiles ({big})"),
        "bound_ms": bms, "bound_by": by, **work}
    emit("timing", index=name, B=BATCH, kcap=kcap, K=K, n_tiles=nt,
         blocks=BATCH // 8, card=card, per_mode=per_mode, two_phase=two,
         e2e_us_per_query={m: {"fused": per_mode[m]["e2e_us_per_query"],
                               "two_phase": two[SCANS[m]]["e2e_us_per_query"]}
                           for m in MODES})
    for two_phase, mode_rec in ((False, per_mode["reach"]),
                                (True, two["descent_scan"])):
        phase_profile(eng, us, rects, mode_rec["e2e_us_per_query"],
                      two_phase)
    return per_mode, two


def phase_profile(eng, us, rects, e2e_us_per_query, two_phase):
    """Where a reach batch's time goes: device time by operation over one
    reach pass of the workload, and the device's busy share of the
    unprofiled end-to-end time."""
    n_batches = len(range(0, len(us), BATCH))
    query = eng.query_batch_two_phase if two_phase else eng.query_batch

    def one_pass():
        for s in range(0, len(us), BATCH):
            query(us[s:s + BATCH], rects[s:s + BATCH])

    path = "two_phase" if two_phase else "fused"
    rows = device_rows(one_pass, 1)
    if not rows:
        emit("profile", path=path, device_time="not measured: the profiler "
             "saw no device activity")
        return
    busy_us = sum(t for _, _, t in rows) / n_batches
    e2e_batch_us = e2e_us_per_query * BATCH
    emit("profile", path=path, mode="reach", B=BATCH,
         device_ops_per_batch=sum(c for _, c, _ in rows) / n_batches,
         device_busy_us_per_batch=busy_us,
         e2e_us_per_batch=e2e_batch_us,
         device_busy_share=busy_us / e2e_batch_us,
         top=[{"op": k[:60], "calls_per_batch": c / n_batches,
               "us_per_batch": t / n_batches} for k, c, t in rows[:8]])


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def phase_build(_build):
    """Every kernel source of the checkout, one ``nvcc`` each, all
    started together."""
    def one(name):
        t0 = time.perf_counter()
        lib, log = _build.build(name)
        return {"library": lib.name, "seconds": round(time.perf_counter()
                                                      - t0, 3),
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Compiling entry" in ln]}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        futs = {name: ex.submit(one, name) for name in _build.SOURCES}
        built = {name: f.result() for name, f in futs.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3), sources=built)


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
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    ks = Kernels()

    card = card_line()
    print(card, flush=True)
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    phase_build(_build)

    errs = phase_kernels(ks)
    results, two_phase, knn, engines = phase_main(ks)
    emit("main", launches={r["index"]: r["launches"] for r in results},
         indexes=results, two_phase=two_phase, knn=knn)
    for k, v in phase_main_batches(ks, engines).items():
        errs[k] = max(errs[k], v)

    per_mode, two = phase_timing(ks, engines, card)
    # launches on the main path, per path: each index's fused serving,
    # its two-phase serving, and the two kNN runs
    per_path = {k: {} for k in KERNELS}
    for r in results:
        per_path["fused_serve"][f"{r['index']} fused"] = r["launches"]
    for r in two_phase:
        for k in KERNELS[1:]:
            per_path[k][f"{r['index']} two_phase"] = r["launches"][k]
    for path in ("fused", "two_phase"):
        for k, n in knn[path]["launches"].items():
            if n:
                per_path[k][f"{knn['index']} knn {path}"] = n
    timed = {"fused_serve": per_mode["reach"], **two}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": CSRC + RECORD[k][0],
        "replaces": RECORD[k][1],
        "launches": sum(per_path[k].values()),
        "launches_per_path": per_path[k],
        "max_abs_err": errs[k],
        "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
        "bound_ms": timed[k]["bound_ms"], "bound_by": timed[k]["bound_by"],
        "library_ms": None} for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
