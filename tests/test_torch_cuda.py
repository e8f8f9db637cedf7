"""GPU tests of the port: each CUDA kernel (fused serve, tile prune,
descent / count / collect / polygon scans (K3-K6 also at K = 1 to 64,
B = 8 to 2048, rows of padding only, tiles outside the arena; K6 at 4,
8 and 16 half-planes; K5 refusing planes at a misaligned base), the
packed closure product (also at f = 1 to 4,099, Wm = 1 to 200, W = 1
to 300, with dense rows, rows without a bit and bits at columns >= m),
the segmented-MBR reduction, the full-arena leaf scan (also on P = 0,
1,001 and 40,000 at B = 1 to 2048, slices of every start residue mod 4
and length 0 to 5,000, clipped, empty and reversed, hits at a slice's
first or last entry, planes at a misaligned base), the fused
EmbeddingBag) against its plain PyTorch version, the wrappers' input
checks, the engine on the card (both paths, polygons) against the
engine on the CPU, the device build on the card against the host build,
the leaf-scan and wavefront engines on the card against the host
descent, the two pyramid prunes (K1, K2) on slices of every kind
(disjoint, nested, degenerate, one over the whole arena) at B = 8 to
2048 and on the yelp x0.5 base arena's 77,440 tiles, K1's reach early
exit (queries that hit in their first candidate, never, or only in
sparse tiles beyond a truncating capacity, empty slices) at cluster
sizes 1 to 8 with its count of scanned tiles, an out-of-range
vertex id that must leave the card usable, the cluster's sharded engine
on the card at 1, 4 and 8 shards (one K1, or one K2 and one K3, per
shard a batch) and its shard stacks gathered from a device build, the
dynamic index's device engine on the card, the resilient engine on the
card (healthy: every class on the kernels with no fallback; retries
spent with ``degraded_path="two_phase"``: one K2 and one K3 launch for
the batch), the boolean sweep closure on the card against its CPU run,
DIN (apply, score_candidates) on the card against its CPU run, the five
reduced LM configs (prefill, decode, loss, one AdamW step) on the card
against the CPU, an LM checkpoint of card tensors restored bit for bit,
and the training launcher's crash and resume on the card.  Every
test needs a CUDA device and skips where there is none.
This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    QueryEngine,
    build_index,
    closure_torch,
    query_host,
    query_wavefront,
)
from repro_torch.core.engine import UPLOAD_COUNTERS
from repro_torch.configs.din import make_config
from repro_torch.core.polygon import convex_halfplanes, polygon_bbox
from repro_torch.data import (
    din_batches,
    get_dataset,
    polygon_workload,
    workload,
)
from repro_torch.kernels import bitset_mm as BM
from repro_torch.kernels.bitset_mm import ops as BMO
from repro_torch.kernels import forest_build as FB
from repro_torch.kernels import segment_bag as SB
from repro_torch.kernels.range_query import analytics as A
from repro_torch.kernels.range_query import descent as D
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query import leafscan as L
from repro_torch.kernels.range_query.layout import (
    TB,
    TP,
    build_tile_pyramid,
    forest_planes,
)
from repro_torch.models.nn import tree_to
from repro_torch.models.recsys import din
from repro_torch.queries import range_count_host
from repro_torch.resilience import (
    FaultPlan,
    FaultSpec,
    ResilientEngine,
    RetryPolicy,
    inject,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _arena(seed, B, n_tiles):
    """Random serving inputs: lattice points sorted along x in three
    tree slices, rects with edges on venue coordinates, empty slices;
    where B > TB the last query tile has only empty slices."""
    rng = np.random.default_rng(seed)
    P = n_tiles * TP - 5
    pts = (np.round(rng.uniform(0, 100, (P, 2)) * 4) / 4).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0])]
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    off = np.array([0, P // 3, P // 2, P], np.int32)
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    qs[: B // 4] = 0
    qe[B // 4: B // 3] = qs[B // 4: B // 3]
    lo = pts[rng.integers(0, P, B)]
    hi = np.maximum(lo, pts[rng.integers(0, P, B)])
    rsoa = np.ascontiguousarray(np.concatenate([lo, hi], 1).T)
    extent = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64)
    return dict(nt=nt, esoa=esoa, ids=ids, fine=fine, coarse=coarse,
                off=off, qs=qs, qe=qe, rsoa=rsoa, extent=extent)


def _args(seed, B, n_tiles, device):
    """The fused serve's inputs on ``device`` (see ``_arena``)."""
    d = _arena(seed, B, n_tiles)
    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    grid = F.make_quant_grid(d["extent"], 2, device)
    r16, r32 = F.quantize_rects(grid, T(d["rsoa"]), 2)
    return d["nt"], (F.quantize_fine(grid, T(d["fine"]), 2),
                     F.quantize_coarse(grid, T(d["coarse"]), 2),
                     T(d["esoa"]), T(d["ids"]), r16, r32, T(d["rsoa"]),
                     T(d["qs"]), T(d["qe"]))


def _two_phase(seed, B, n_tiles, device):
    """The two-phase kernels' inputs on ``device``: the float32 pyramid,
    the arena, ids, rects and slices, and the plain prune's compacted
    candidates."""
    d = _arena(seed, B, n_tiles)
    if B > TB:
        d["qs"][-TB:] = d["qe"][-TB:] = 0
    T = {k: torch.as_tensor(v, device=device) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    mask = D.prune_tiles_torch(T["fine"], T["coarse"], T["rsoa"], T["qs"],
                               T["qe"])
    cand, cnt = F.compact_ascending(mask, d["nt"])
    return d["nt"], T, cand, cnt


@pytest.mark.parametrize("B", [TB, 3 * TB, 32 * TB])
def test_kernel_matches_plain(cuda, B):
    nt, args = _args(B, B, 300, cuda)
    _, cnt = F.fused_serve_torch(*args, mode="reach", kcap=1, nt=nt)
    mx = int(cnt.max())
    assert mx >= 2
    for mode in F.MODES:
        for kcap in (max(1, mx // 2), mx, nt, nt + 3):
            launches = F.fused_serve.launches
            got = F.fused_serve(*args, mode=mode, kcap=kcap, nt=nt)
            want = F.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            assert F.fused_serve.launches == launches + 1
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_rejects_what_it_does_not_take(cuda):
    nt, args = _args(0, TB, 4, cuda)
    bad = list(args)
    bad[6] = args[6].t().contiguous().t()          # non-contiguous rects
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_serve(*bad, mode="reach", kcap=2, nt=nt)
    bad = list(args)
    bad[0] = args[0].to(torch.int32)               # fine plane not int16
    with pytest.raises(ValueError, match="dtype"):
        F.fused_serve(*bad, mode="reach", kcap=2, nt=nt)
    with pytest.raises(ValueError, match="lies on"):
        F.fused_serve(*[a.cpu() for a in args], mode="reach", kcap=2, nt=nt)


@pytest.mark.parametrize("method", ["2dreach", "2dreach-comp",
                                    "2dreach-pointer"])
def test_engine_on_card_matches_cpu(cuda, method):
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, method)
    gpu, cpu = QueryEngine(idx), QueryEngine(idx, device="cpu")
    assert gpu.device.type == "cuda"
    for seed in range(2):
        us, rects = workload(g, 300, extent_ratio=0.05, seed=seed)
        assert (gpu.query_batch(us, rects) == cpu.query_batch(us, rects)).all()
        assert (gpu.count_batch(us, rects) == cpu.count_batch(us, rects)).all()
        a, b = gpu.collect_batch(us, rects, 7), cpu.collect_batch(us, rects, 7)
        assert (a.ids == b.ids).all() and (a.counts == b.counts).all()
    # the kernel's reach stops at first hits; the plain version scans all
    moved = ("k1_scan_tests", "k1_tiles_skipped")
    assert ({k: v for k, v in gpu.stats.items() if k not in moved}
            == {k: v for k, v in cpu.stats.items() if k not in moved})
    assert cpu.stats["k1_tiles_skipped"] == 0
    assert (gpu.stats["k1_scan_tests"] + gpu.stats["k1_tiles_skipped"] * TP * TB
            == cpu.stats["k1_scan_tests"])


# K1's reach early exit: query tiles whose queries all hit in their first
# candidate tile, none of whose queries hits, whose queries hit only in
# sparse tiles (beyond the capacity where it truncates), and of mixed
# queries with empty slices
EARLY_KINDS = ("first", "none", "late", "mixed")


def early_exit_case(seed, n_tiles, B, kind, device):
    """K1's inputs for the reach early exit: leaf tile g holds the x-band
    [g, g + 0.5] (gaps between tiles, so the prune is exact at tile
    level), 128 points on a rising diagonal at rows y = 100 i / 127, a
    half row higher in every 37th tile; three trees cut mid-tile.  Each
    query rect spans 1-300 tiles of its tree from the first on: all
    rows ("first": a hit in its first candidate tile), a band between
    rows ("none": candidates, no hit) or around the shifted rows of a
    few tiles ("late").  "mixed" draws each query's kind, with empty
    slices among them; where B > TB the last query tile is padding."""
    rng = np.random.default_rng(seed)
    P = n_tiles * TP - 37
    g, i = np.arange(P) // TP, np.arange(P) % TP
    late = g % 37 == 5
    x = (g + 0.5 * i / (TP - 1)).astype(np.float32)
    y = (100 * (i + 0.5 * late) / (TP - 1)).astype(np.float32)
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[0, :P] = esoa[2, :P] = x
    esoa[1, :P] = esoa[3, :P] = y
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    off = np.array([0, P // 3, P // 2, P])
    kinds = (rng.choice(["first", "none", "late", "empty"], B)
             if kind == "mixed" else np.full(B, kind))
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    g0 = (qs + TP - 1) // TP                  # the tree's first whole tile
    span = np.maximum(qe // TP - g0, 1)
    first = g0 + rng.integers(0, span)
    last = np.minimum(first + rng.integers(0, 300, B), g0 + span - 1)
    r = rng.integers(60, 77, B)               # x in [g + 0.2, g + 0.3]
    lo_y = np.where(kinds == "first", -1.0,
                    np.where(kinds == "none", r + 0.1, r + 0.4))
    hi_y = np.where(kinds == "first", 101.0,
                    np.where(kinds == "none", r + 0.4, r + 0.6))
    lo_y = np.where(kinds == "first", lo_y, 100 * lo_y / (TP - 1))
    hi_y = np.where(kinds == "first", hi_y, 100 * hi_y / (TP - 1))
    rsoa = np.stack([first + 0.2, lo_y, last + 0.3, hi_y]).astype(np.float32)
    empty = kinds == "empty"
    qs[empty] = qe[empty] = rng.integers(0, P, int(empty.sum()))
    if B > TB:
        qs[-TB:] = qe[-TB:] = 0
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa
    extent = np.array([x.min(), y.min(), x.max(), y.max()], np.float64)
    grid = F.make_quant_grid(extent, 2, device)
    r16, r32 = F.quantize_rects(grid, T(rsoa), 2)
    return nt, (F.quantize_fine(grid, T(fine), 2),
                F.quantize_coarse(grid, T(coarse), 2), T(esoa), T(ids), r16,
                r32, T(rsoa), T(qs.astype(np.int32)), T(qe.astype(np.int32)))


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", EARLY_KINDS)
def test_reach_early_exit_matches_plain(cuda, monkeypatch, kind, C):
    """The reach kernel, at cluster size C, bit for bit its plain version
    in ``out`` and ``cnt`` at capacities below, at and above the true
    counts; its scanned tiles at most ``min(cnt, kcap)``, equal to it
    where no query of the tile hits, and at most 2 a query and CTA where
    every query hits in its first candidate.  Count and collect on the
    same inputs write ``min(cnt, kcap)``."""
    monkeypatch.setattr(F, "cluster_size", lambda nb, sms: C)
    B = 32 * TB
    nt, args = early_exit_case(7 * C + len(kind), 640, B, kind, cuda)
    _, cnt = F.fused_serve_torch(*args, mode="reach", kcap=nt, nt=nt)
    mx = int(cnt.max())
    assert mx >= 100 and int(cnt[-1]) == 0
    truncated = 0
    for kcap in sorted({1, mx // 3, mx, nt}):
        for mode in F.MODES:
            scanned = torch.full((B // TB,), -1, dtype=torch.int32,
                                 device=cuda)
            got = F.fused_serve(*args, mode=mode, kcap=kcap, nt=nt,
                                scanned=scanned)
            want = F.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            assert torch.equal(got[1], want[1]), (mode, kcap)
            assert torch.equal(got[0], want[0]), (mode, kcap)
            full = want[1].clamp(max=kcap)
            if mode != "reach":
                assert torch.equal(scanned, full), (mode, kcap)
                continue
            assert (scanned >= 0).all() and (scanned <= full).all(), kcap
            dry = ~want[0].reshape(-1, TB).bool().any(dim=1)
            assert torch.equal(scanned[dry], full[dry]), kcap
            if kind == "first":
                assert (scanned <= 2 * C * TB).all(), kcap
                if kcap >= mx and C == 1:
                    assert int(full.sum()) > 10 * int(scanned.sum())
            if kcap < mx:
                whole = F.fused_serve_torch(*args, mode="reach", kcap=nt,
                                            nt=nt)[0]
                truncated += int((whole > want[0]).sum())
    # a query whose only hits lie beyond the capacity answers 0 on both
    assert kind not in ("late", "mixed") or truncated > 0


@pytest.mark.parametrize("B", [TB, 3 * TB, 32 * TB])
def test_prune_kernel_matches_plain(cuda, B):
    _, T, _, _ = _two_phase(B, B, 300, cuda)
    args = (T["fine"], T["coarse"], T["rsoa"], T["qs"], T["qe"])
    launches = D.prune_tiles.launches
    got = D.prune_tiles(*args)
    assert D.prune_tiles.launches == launches + 1
    assert torch.equal(got, D.prune_tiles_torch(*args))
    assert got.any()


# slice kinds of the pyramid-prune cases (K1, K2): per query tile, 8
# disjoint slices; nested and overlapping ones; degenerate ones (qs == qe
# inside a tile and on a tile edge, [0, 0)) beside one short slice; one
# slice over the whole arena beside random ones
SLICE_KINDS = ("disjoint", "nested", "degenerate", "whole")


def _slices(rng, P, B, kind):
    qs, qe = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for q0 in range(0, B, TB):
        s = slice(q0, q0 + TB)
        if kind == "disjoint":
            cuts = np.sort(rng.choice(P + 1, 2 * TB, replace=False))
            qs[s], qe[s] = cuts[0::2], cuts[1::2]
        elif kind == "nested":
            c = int(rng.integers(0, P))
            w = np.sort(rng.integers(1, max(2, P // 8), TB))[::-1]
            qs[s], qe[s] = np.clip(c - w, 0, P), np.clip(c + w, 0, P)
            qs[q0 + 6] = min(c + w[2] // 2, P)    # overlapping, not nested
            qe[q0 + 6] = min(c + 2 * w[0], P)
        elif kind == "degenerate":
            a = rng.integers(0, P, TB)
            a[:2] = a[:2] // TP * TP              # on a tile edge
            a[2] = 0
            qs[s], qe[s] = a, a
            qe[q0 + 3] = min(a[3] + 50, P)        # one short real slice
        else:
            a = np.sort(rng.integers(0, P + 1, (TB, 2)), axis=1)
            qs[s], qe[s] = a[:, 0], a[:, 1]
            qs[q0], qe[q0] = 0, P
    return qs, qe


def slice_case(seed, n_tiles, B, kind, device):
    """K1's and K2's inputs on ``device`` for slices of one kind: points
    sorted along x (leaf tiles are x-bands), rects about 0.5-40 tiles
    wide around an entry of the query's slice (anywhere for an empty
    one) and tall, so the candidate counts stay moderate.  Returns ``(nt,
    fused serve args, float32 fine plane, float32 coarse plane)``."""
    rng = np.random.default_rng(seed)
    P = n_tiles * TP - 37
    pts = rng.uniform(0, 100, (P, 2)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, n_tiles * TP), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    qs, qe = _slices(rng, P, B, kind)
    live = qe > qs
    pick = rng.integers(0, P, B)
    pick[live] = rng.integers(qs[live], qe[live])
    c = pts[pick].astype(np.float64)
    half = np.stack([rng.uniform(0.25, 20, B) * 100 / n_tiles,
                     rng.uniform(2, 25, B)], 1)
    rsoa = np.ascontiguousarray(
        np.concatenate([c - half, c + half], 1).T.astype(np.float32))
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa
    grid = F.make_quant_grid(np.concatenate([pts.min(0), pts.max(0)]
                                            ).astype(np.float64), 2, device)
    r16, r32 = F.quantize_rects(grid, T(rsoa), 2)
    args = (F.quantize_fine(grid, T(fine), 2),
            F.quantize_coarse(grid, T(coarse), 2), T(esoa), T(ids), r16, r32,
            T(rsoa), T(qs.astype(np.int32)), T(qe.astype(np.int32)))
    return nt, args, T(fine), T(coarse)


def _check_prunes(nt, args, fine, coarse, full_kcap):
    """K1 in every mode at kcap below, at and above the true count (and
    at nt where ``full_kcap``) and K2, each bit for bit its plain
    version; returns the largest true count."""
    _, cnt = F.fused_serve_torch(*args, mode="reach", kcap=1, nt=nt)
    mx = int(cnt.max())
    kcaps = {max(1, mx // 2), max(mx, 1), mx + 3} | ({nt} if full_kcap
                                                     else set())
    for mode in F.MODES:
        for kcap in sorted(kcaps):
            launches = F.fused_serve.launches
            got = F.fused_serve(*args, mode=mode, kcap=kcap, nt=nt)
            want = F.fused_serve_torch(*args, mode=mode, kcap=kcap, nt=nt)
            assert F.fused_serve.launches == launches + 1
            assert torch.equal(got[1], want[1]), (mode, kcap)
            assert torch.equal(got[0], want[0]), (mode, kcap)
    rsoa, qs, qe = args[6:]
    launches = D.prune_tiles.launches
    got = D.prune_tiles(fine, coarse, rsoa, qs, qe)
    assert D.prune_tiles.launches == launches + 1
    assert torch.equal(got, D.prune_tiles_torch(fine, coarse, rsoa, qs, qe))
    return mx


@pytest.mark.parametrize("B", [TB, 3 * TB, 32 * TB, 256 * TB])
@pytest.mark.parametrize("kind", SLICE_KINDS)
def test_prune_kernels_on_slice_kinds(cuda, kind, B):
    nt, args, fine, coarse = slice_case(B, 3000, B, kind, cuda)
    mx = _check_prunes(nt, args, fine, coarse, full_kcap=B <= 3 * TB)
    assert kind == "degenerate" or mx >= 2


@pytest.mark.parametrize("B", [TB, 32 * TB])
@pytest.mark.parametrize("kind", ["disjoint", "whole"])
def test_prune_kernels_on_the_half_base_arena(cuda, kind, B):
    """NTp = 77,440, the yelp x0.5 2dreach arena's padded tile count."""
    nt, args, fine, coarse = slice_case(B + 1, 77390, B, kind, cuda)
    assert fine.shape[1] == 77440
    assert _check_prunes(nt, args, fine, coarse, full_kcap=B == TB) >= 2


def test_prune_wrappers_reject_misaligned_planes(cuda):
    """K1 copies the arena with 16-byte cp.async and K2 loads the fine
    plane as float4: a tensor whose data starts off a 16-byte boundary
    raises before any launch."""
    nt, args, fine, coarse = slice_case(0, 4, TB, "disjoint", cuda)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    bad = list(args)
    bad[2] = shifted(args[2])
    launches = F.fused_serve.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        F.fused_serve(*bad, mode="reach", kcap=2, nt=nt)
    with pytest.raises(ValueError, match="16-byte boundary"):
        D.prune_tiles(shifted(fine), coarse, *args[6:])
    assert F.fused_serve.launches == launches


def test_collect_scan_rejects_misaligned_planes(cuda):
    """K5 loads the planes as float4 and the ids as int4: a plane or id
    tensor whose data starts off a 16-byte boundary raises before any
    launch."""
    d, T, ck = _cluster_scan_case(5, TB, 4, 8, cuda)
    P = T["esoa"].shape[1]
    ids = torch.arange(P, dtype=torch.int32, device=cuda)[None]

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    rest = (T["rsoa"], T["qs"], T["qe"])
    launches = A.collect_scan.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        A.collect_scan(ck, shifted(T["esoa"]), ids, *rest)
    with pytest.raises(ValueError, match="16-byte boundary"):
        A.collect_scan(ck, T["esoa"], shifted(ids), *rest)
    assert A.collect_scan.launches == launches
    assert torch.equal(A.collect_scan(ck, T["esoa"], ids, *rest),
                       A.collect_scan_torch(ck, T["esoa"], ids, *rest))


@pytest.mark.parametrize("path", ["fused", "two_phase"])
def test_bad_vertex_ids_leave_the_card_usable(cuda, path):
    """An out-of-range vertex id raises IndexError on the host, before a
    gather on the card could fire a device-side assert; the same engine
    then serves a good batch equal to the host's."""
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    eng = QueryEngine(idx, path=path)
    us, rects = workload(g, 64, extent_ratio=0.05, seed=3)
    for bad in (np.full(3, g.n_nodes), np.array([0, -g.n_nodes - 1, 1])):
        with pytest.raises(IndexError, match="out of bounds"):
            eng.query_batch(bad, rects[:3])
    torch.cuda.synchronize()
    assert np.array_equal(eng.query_batch(us, rects), idx.query_batch(us, rects))
    cpu = QueryEngine(idx, device="cpu", path=path)
    assert np.array_equal(eng.count_batch(us, rects),
                          cpu.count_batch(us, rects))


@pytest.mark.parametrize("B", [TB, 3 * TB, 32 * TB])
def test_scan_kernels_match_plain(cuda, B):
    nt, T, cand, cnt = _two_phase(B + 1, B, 300, cuda)
    mx = int(cnt.max())
    assert mx >= 2 and (B == TB or int(cnt[-1]) == 0)
    e, r, qs, qe, ids = T["esoa"], T["rsoa"], T["qs"], T["qe"], T["ids"]
    pairs = (
        (D.descent_scan, D.descent_scan_torch, lambda c: (c, e, r, qs, qe)),
        (A.count_scan, A.count_scan_torch, lambda c: (c, e, r, qs, qe)),
        (A.collect_scan, A.collect_scan_torch,
         lambda c: (c, e, ids, r, qs, qe)),
    )
    for K in (max(1, mx // 2), mx, mx + 3, T["fine"].shape[1]):
        ck = D.take_candidates(cand, K)
        for kernel, plain, args in pairs:
            launches = kernel.launches
            got = kernel(*args(ck))
            assert kernel.launches == launches + 1
            assert torch.equal(got, plain(*args(ck))), (kernel.__name__, K)
    full = D.take_candidates(cand, nt)
    assert torch.equal(A.count_scan(full, e, r, qs, qe),
                       A.count_scan_ref(e, r, qs, qe))


def test_new_wrappers_reject_what_they_do_not_take(cuda):
    _, T, cand, _ = _two_phase(0, 2 * TB, 4, cuda)
    ck = D.take_candidates(cand, 3)
    e, r, qs, qe, ids = T["esoa"], T["rsoa"], T["qs"], T["qe"], T["ids"]
    scans = ((D.descent_scan, lambda c, e_, r_: (c, e_, r_, qs, qe)),
             (A.count_scan, lambda c, e_, r_: (c, e_, r_, qs, qe)),
             (A.collect_scan, lambda c, e_, r_: (c, e_, ids, r_, qs, qe)))
    for fn, args in scans:
        with pytest.raises(ValueError, match="dtype"):
            fn(*args(ck.long(), e, r))
        with pytest.raises(ValueError, match="shape"):
            fn(*args(ck[:1].contiguous(), e, r))
        with pytest.raises(ValueError, match="contiguous"):
            fn(*args(ck.t().contiguous().t(), e, r))
        with pytest.raises(ValueError, match="lies on"):
            fn(*args(ck.cpu(), e, r))
        with pytest.raises(ValueError, match="lies on"):
            fn(*args(ck.cpu(), e.cpu(), r.cpu()))
    with pytest.raises(ValueError, match="dtype"):
        A.collect_scan(ck, e, ids.long(), r, qs, qe)
    pargs = [T["fine"], T["coarse"], r, qs, qe]
    for i, bad in ((0, T["fine"].double()), (1, T["coarse"][:, :-1]),
                   (2, r.t().contiguous().t()), (3, qs.cpu())):
        with pytest.raises(ValueError):
            D.prune_tiles(*pargs[:i], bad, *pargs[i + 1:])


@pytest.mark.parametrize("method", ["2dreach", "2dreach-comp",
                                    "2dreach-pointer"])
def test_two_phase_engine_on_card_matches_cpu(cuda, method):
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, method)
    gpu = QueryEngine(idx, path="two_phase")
    cpu = QueryEngine(idx, device="cpu", path="two_phase")
    launches = (D.prune_tiles.launches, D.descent_scan.launches,
                A.count_scan.launches, A.collect_scan.launches)
    for seed in range(2):
        us, rects = workload(g, 300, extent_ratio=0.05, seed=seed)
        assert (gpu.query_batch(us, rects) == cpu.query_batch(us, rects)).all()
        assert (gpu.count_batch(us, rects) == cpu.count_batch(us, rects)).all()
        a, b = gpu.collect_batch(us, rects, 7), cpu.collect_batch(us, rects, 7)
        assert (a.ids == b.ids).all() and (a.counts == b.counts).all()
    assert gpu.stats == cpu.stats and gpu._kb_hwm == cpu._kb_hwm
    assert (D.prune_tiles.launches - launches[0] == 6
            and D.descent_scan.launches - launches[1] == 2
            and A.count_scan.launches - launches[2] == 2
            and A.collect_scan.launches - launches[3] == 2)
    pts = rects[:64, :2].copy()
    assert (gpu.knn_batch(us[:64], pts, 5).ids
            == cpu.knn_batch(us[:64], pts, 5).ids).all()


def _launches():
    return (F.fused_serve.launches, D.prune_tiles.launches,
            D.descent_scan.launches, A.count_scan.launches,
            A.collect_scan.launches, A.polygon_scan.launches)


def test_resilient_engine_on_card_healthy(cuda):
    """A healthy wrapper over the card's engine: every class answers as
    the host does, on the kernels, with no retry and no fallback."""
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    eng = QueryEngine(idx)
    res = ResilientEngine(eng, idx)
    us, rects = workload(g, 256, extent_ratio=0.05, seed=3)
    pus, polys = polygon_workload(g, 64, extent_ratio=0.05, seed=4)
    before = _launches()
    assert (res.query_batch(us, rects) == idx.query_batch(us, rects)).all()
    assert (res.count_batch(us, rects)
            == range_count_host(idx, us, rects)).all()
    res.collect_batch(us, rects, 5)
    res.knn_batch(us[:64], rects[:64, :2].copy(), 4)
    cpu = QueryEngine(idx, device="cpu")
    assert (res.polygon_batch(pus, polys)
            == cpu.polygon_batch(pus, polys)).all()
    moved = [b - a for a, b in zip(before, _launches())]
    assert moved[0] >= 4 and moved[1] == 1 and moved[5] == 1
    assert res.stats["fallback_queries"] == 0 and res.stats["retries"] == 0
    assert res.stats["device_batches"] == 5


def test_resilient_two_phase_degradation_on_card(cuda):
    """Retries spent on an injected raise at the engine's entry, with
    ``degraded_path="two_phase"``: the card's two-phase path answers
    the batch exactly, one prune (K2) and one descent scan (K3)."""
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    res = ResilientEngine(QueryEngine(idx), idx, degraded_path="two_phase",
                          retry=RetryPolicy(max_attempts=3, base_s=1e-6,
                                            cap_s=1e-5))
    us, rects = workload(g, 256, extent_ratio=0.05, seed=5)
    before = _launches()
    with inject(FaultPlan(FaultSpec("engine.query_batch", kind="raise",
                                    max_fires=3))):
        got = res.query_batch(us, rects)
    moved = [b - a for a, b in zip(before, _launches())]
    assert (got == idx.query_batch(us, rects)).all()
    assert moved == [0, 1, 1, 0, 0, 0]
    assert res.last_report["degraded"].all() and res.stats["retries"] == 2


# --------------------------------------------------------------------------
# Polygon scan, closure product, segmented MBR, device build
# --------------------------------------------------------------------------

def polygon_case(seed, B, n_tiles, ne, plant=True):
    """Polygon-scan inputs: lattice venues sorted along x in three tree
    slices, one small convex polygon of 3..ne vertices per query and
    (``plant``), for about half of the queries, the polygon's vertices
    and points on its edges planted into the query's slice — the inputs
    where a fused multiply-add would flip an answer.  Returns numpy
    arrays; ``lines`` is padded to a power-of-two edge count with inert
    half-planes."""
    rng = np.random.default_rng(seed)
    P = n_tiles * TP - 5
    pts = (np.round(rng.uniform(0, 100, (P, 2)) * 4) / 4).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0])]
    off = np.array([0, P // 3, P // 2, P], np.int64)
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    qe[B // 4: B // 3] = qs[B // 4: B // 3]           # empty slices
    polys = []
    for b in range(B):
        k = int(rng.integers(3, ne + 1))
        ang = np.sort(rng.random(k) * 2 * np.pi) + np.arange(k) * 1e-6
        c, r = rng.uniform(5, 95, 2), rng.uniform(0.3, 3, 2)
        v = np.stack([c[0] + r[0] * np.cos(ang), c[1] + r[1] * np.sin(ang)],
                     1).astype(np.float32)
        polys.append(v)
        if plant and qe[b] > qs[b] and rng.random() < 0.5:
            nxt = np.roll(v, -1, 0).astype(np.float64)
            w = rng.random((k, 1))
            edge = (v * (1 - w) + nxt * w).astype(np.float32)
            on = np.concatenate([v, edge])
            pts[rng.integers(qs[b], qe[b], len(on))] = on
    esoa = np.empty((4, n_tiles * TP), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    neb = 4
    while neb < max(len(p) for p in polys):
        neb *= 2
    rsoa = np.ascontiguousarray(np.stack([polygon_bbox(p) for p in polys]).T)
    hps = np.stack([convex_halfplanes(p, pad_to=neb) for p in polys])
    lines = np.ascontiguousarray(hps.transpose(1, 2, 0).reshape(3 * neb, B))
    return dict(esoa=esoa, fine=fine, coarse=coarse, nt=nt, rsoa=rsoa,
                lines=lines, ne=neb, qs=qs.astype(np.int32),
                qe=qe.astype(np.int32), polys=polys)


@pytest.mark.parametrize("ne", [4, 8])
@pytest.mark.parametrize("B", [TB, 4 * TB])
def test_polygon_kernel_matches_plain(cuda, B, ne):
    d = polygon_case(B + ne, B, 300, ne)
    T = {k: torch.as_tensor(v, device=cuda) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    mask = D.prune_tiles_torch(T["fine"], T["coarse"], T["rsoa"], T["qs"],
                               T["qe"])
    cand, cnt = F.compact_ascending(mask, d["nt"])
    mx = int(cnt.max())
    args = (T["esoa"], T["rsoa"], T["lines"], T["qs"], T["qe"])
    for K in (max(1, mx // 2), mx, mx + 3):
        ck = D.take_candidates(cand, K)
        launches = A.polygon_scan.launches
        got = A.polygon_scan(ck, *args, ne=d["ne"])
        assert A.polygon_scan.launches == launches + 1
        assert torch.equal(got, A.polygon_scan_torch(ck, *args, ne=d["ne"]))
    assert torch.equal(got, A.polygon_scan_ref(*args, ne=d["ne"]))
    assert 0 < int(got.sum()) < B


def _cluster_scan_case(seed, B, K, ne, device):
    """K4's and K6's inputs: ``polygon_case`` (venues on polygon edges
    and vertices, 300 tiles) on ``device``, its plain prune's compacted
    candidates cut at K and, where B > 8, the last row all padding (its
    first tile in every slot) and a tile past the arena and a negative
    one in row 1 (misses that the kernels never read)."""
    d = polygon_case(seed, B, 300, ne)
    T = {k: torch.as_tensor(v, device=device) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    mask = D.prune_tiles_torch(T["fine"], T["coarse"], T["rsoa"], T["qs"],
                               T["qe"])
    cand, _ = F.compact_ascending(mask, d["nt"])
    ck = D.take_candidates(cand, K).clone()
    if B > TB:
        ck[-1] = int(ck[-1, 0])
        ck[1, K // 2] = T["esoa"].shape[1] // TP + 7
        ck[1, 0] = -1
    return d, T, ck


@pytest.mark.parametrize("K", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("B", [TB, 32 * TB, 256 * TB])
def test_cluster_scans_match_plain(cuda, B, K):
    """K3, K4 and K6 bit for bit against their plain versions: one
    query tile (a cluster of min(8, K) CTAs, most with one slot), 32 (the
    serving batch: 8 CTAs a cluster) and 256 (one CTA a query tile, K
    slots through its cp.async ring); K not a multiple of the cluster,
    and 64 (several ring turns).  K5 on the same inputs, at the warps
    per CTA ``collect_warps`` picks (1, 1 to 8, 1 to 8): every (query,
    slot) row written, padding and out-of-arena slots as sentinels."""
    d, T, ck = _cluster_scan_case(B + K, B, K, 8, cuda)
    P = T["esoa"].shape[1]
    ids = torch.as_tensor(np.random.default_rng(B + K).permutation(P)
                          .astype(np.int32)[None], device=cuda)
    box = (T["esoa"], T["rsoa"], T["qs"], T["qe"])
    poly = (T["esoa"], T["rsoa"], T["lines"], T["qs"], T["qe"])
    col = (T["esoa"], ids, T["rsoa"], T["qs"], T["qe"])
    for kernel, plain, args, kw in (
            (D.descent_scan, D.descent_scan_torch, box, {}),
            (A.count_scan, A.count_scan_torch, box, {}),
            (A.collect_scan, A.collect_scan_torch, col, {}),
            (A.polygon_scan, A.polygon_scan_torch, poly, {"ne": d["ne"]})):
        launches = kernel.launches
        got = kernel(ck, *args, **kw)
        assert kernel.launches == launches + 1
        assert torch.equal(got, plain(ck, *args, **kw)), kernel.__name__
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert D.scan_cluster_size(B // TB, K, n_sms) == (
        min(8, K) if B < 256 * TB else 1)
    assert 1 <= A.collect_warps(B // TB, K, n_sms) <= min(8, K)


@pytest.mark.parametrize("B,ne", [(TB, 4), (TB, 8), (TB, 16), (32 * TB, 4),
                                  (32 * TB, 8), (32 * TB, 16), (TB, 512),
                                  (TB, 1024), (TB, 4096)])
def test_polygon_kernel_on_edges_at_each_edge_bucket(cuda, B, ne):
    """K6 with 4, 8 and 16 half-planes a query (the engine's edge
    buckets) and 512, 1024 and 4096 (past the 128 the kernel keeps in
    shared memory: the rest come from global memory), venues exactly on
    the polygons' edges and vertices: equal to its plain version with K
    below and at the true count, and to the dense reference where K
    covers every candidate."""
    d = polygon_case(3 * B + ne, B, 300, ne)
    assert d["ne"] == ne
    T = {k: torch.as_tensor(v, device=cuda) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    mask = D.prune_tiles_torch(T["fine"], T["coarse"], T["rsoa"], T["qs"],
                               T["qe"])
    cand, cnt = F.compact_ascending(mask, d["nt"])
    mx = int(cnt.max())
    args = (T["esoa"], T["rsoa"], T["lines"], T["qs"], T["qe"])
    for K in (max(1, mx // 2), mx):
        ck = D.take_candidates(cand, K)
        got = A.polygon_scan(ck, *args, ne=ne)
        assert torch.equal(got, A.polygon_scan_torch(ck, *args, ne=ne)), K
    assert torch.equal(got, A.polygon_scan_ref(*args, ne=ne))
    assert int(got.sum()) > 0


# K7's cases: f rows; Wm words of A (m = 32*Wm - 3 columns, so the last
# word holds bits at columns >= m); W words of out (one to three warps'
# spans of 128 words)
BITSET_CASES = [(1, 1, 1), (37, 64, 3), (300, 33, 70), (1000, 900, 40)] + [
    (f, 32 * wm - 3, W) for f in (1, 7, 9, 4099) for wm in (1, 3, 90, 200)
    for W in (1, 31, 32, 33, 95, 128, 129, 300)]


def bitset_case(seed, f, m, W):
    """K7's operands as uint32 words: random sparse rows, every fourth
    row from row 1 fully dense and every fourth from row 2 without a bit
    below column m; the last column set in row 0; every row's bits at
    columns >= m set (the kernel must mask them); bit 31 in R's first
    and last column."""
    rng = np.random.default_rng(seed)
    Wm = (m + 31) // 32
    a = rng.integers(0, 2 ** 32, (f, Wm), dtype=np.uint64).astype(np.uint32)
    a[rng.random((f, Wm)) < 0.7] = 0             # many zero words
    a[1::4] = 0xFFFFFFFF                         # dense rows
    a[2::4] = 0                                  # rows with no bit below m
    a[0, -1] |= np.uint32(1 << ((m - 1) % 32))   # the last column
    if m % 32:
        a[:, -1] |= np.uint32(0xFFFFFFFF << (m % 32) & 0xFFFFFFFF)
    r = rng.integers(0, 2 ** 32, (m, W), dtype=np.uint64).astype(np.uint32)
    r[:, 0] |= np.uint32(1 << 31)
    r[:, -1] |= np.uint32(1 << 31)
    return a, r


@pytest.mark.parametrize("f,m,W", BITSET_CASES + [(1056, 67584, 1)])
def test_bitset_mm_kernel_matches_plain(cuda, monkeypatch, f, m, W):
    a, r = bitset_case(f + m + W, f, m, W)
    A_, R_ = BM.uint32_bits(a, cuda), BM.uint32_bits(r, cuda)
    launches = BM.bitset_mm.launches
    got = BM.bitset_mm(A_, R_)
    assert BM.bitset_mm.launches == launches + 1
    want = BM.bitset_mm_torch(A_, R_)
    assert torch.equal(got, want)
    assert (got < 0).any()                        # bit 31 came through
    assert not got[2::4].any()                    # bits past m add nothing
    if f > 1:                                     # a dense row ORs all of R
        dense = np.bitwise_or.reduce(r, axis=0).view(np.int32)
        assert np.array_equal(got[1].cpu().numpy(), dense)
    # ROWWISE (0) and SPREAD at clusters of 1, 2 and 8 CTAs, whichever
    # the launcher would pick
    for C in (0, 1, 2, 8):
        monkeypatch.setattr(BMO, "cluster_size", lambda *_, C=C: C)
        assert torch.equal(BM.bitset_mm(A_, R_), want), C


@pytest.mark.parametrize("fan,n", [(16, 1), (16, 1000), (128, 301),
                                   (8, 77)])
def test_seg_mbr_kernel_matches_plain(cuda, fan, n):
    rng = np.random.default_rng(fan + n)
    c = rng.uniform(-50, 50, (fan, 4, n)).astype(np.float32)
    inert = rng.random((fan, n)) < 0.3
    c[:, :2][np.broadcast_to(inert[:, None], (fan, 2, n))] = np.inf
    c[:, 2:][np.broadcast_to(inert[:, None], (fan, 2, n))] = -np.inf
    x = torch.as_tensor(c.reshape(fan * 4, n), device=cuda)
    launches = FB.seg_mbr.launches
    got = FB.seg_mbr(x, dim=2, fan=fan)
    assert FB.seg_mbr.launches == launches + 1
    assert torch.equal(got, FB.seg_mbr_torch(x, dim=2, fan=fan))


def test_build_wrappers_reject_what_they_do_not_take(cuda):
    a = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    r = torch.zeros((64, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        BM.bitset_mm(a.long(), r)
    with pytest.raises(ValueError, match="rows"):
        BM.bitset_mm(a, torch.zeros((65, 3), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="lies on"):
        BM.bitset_mm(a.cpu(), r)
    x = torch.zeros((16 * 4, 10), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        FB.seg_mbr(x, dim=2, fan=8)
    with pytest.raises(ValueError, match="contiguous"):
        FB.seg_mbr(x.t().contiguous().t(), dim=2, fan=16)
    d = polygon_case(0, TB, 4, 4)
    T = {k: torch.as_tensor(v, device=cuda) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    ck = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        A.polygon_scan(ck, T["esoa"], T["rsoa"], T["lines"], T["qs"],
                       T["qe"], ne=8)
    with pytest.raises(ValueError, match="ne"):
        A.polygon_scan(ck[:, :1].contiguous(), T["esoa"], T["rsoa"],
                       T["lines"], T["qs"], T["qe"], ne=0)


@pytest.mark.parametrize("method", ["2dreach", "2dreach-comp",
                                    "2dreach-pointer"])
def test_device_build_on_card_matches_host(cuda, method):
    g = get_dataset("yelp", scale=0.05)
    host = build_index(g, method)
    launches = (BM.bitset_mm.launches, FB.seg_mbr.launches)
    dev = build_index(g, method, backend="device")
    assert BM.bitset_mm.launches > launches[0]
    assert FB.seg_mbr.launches > launches[1]
    f, fd = host.forest, dev.forest
    for a, b in ((f.entries, fd.entries), (f.entry_ids, fd.entry_ids),
                 (f.entry_off, fd.entry_off), (host.comp_tree, dev.comp_tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(f.level_mbr) == len(fd.level_mbr)
    for a, b in zip(f.level_mbr + f.tree_off, fd.level_mbr + fd.tree_off):
        assert np.array_equal(a, b)
    before = dict(UPLOAD_COUNTERS)
    gpu = QueryEngine(dev)
    assert (UPLOAD_COUNTERS["device_adoptions"]
            == before["device_adoptions"] + 1)
    assert UPLOAD_COUNTERS["host_uploads"] == before["host_uploads"]
    assert gpu.stats["adopted"] == 1
    # served on another device than it was built on, the forest uploads
    cross = QueryEngine(dev, device="cpu")
    assert UPLOAD_COUNTERS == {
        "host_uploads": before["host_uploads"] + 1,
        "device_adoptions": before["device_adoptions"] + 1}
    assert cross.stats["adopted"] == 0
    cpu = QueryEngine(host, device="cpu", path="two_phase")
    for name in ("entries", "fine", "coarse", "entry_off"):
        assert torch.equal(getattr(gpu._arena, name).cpu(),
                           getattr(cpu._arena, name))
    us, rects = workload(g, 300, extent_ratio=0.05, seed=1)
    assert (gpu.query_batch(us, rects) == host.query_batch(us, rects)).all()
    assert (cross.query_batch(us, rects) == host.query_batch(us, rects)).all()
    us, polys = polygon_workload(g, 100, seed=2)
    launches = A.polygon_scan.launches
    assert (gpu.polygon_batch(us, polys)
            == cpu.polygon_batch(us, polys)).all()
    assert A.polygon_scan.launches == launches + 1


def _leafscan_case(seed, dim, B, P):
    """Random K9 inputs: P entries (3-D boxes for dim 3) in tree slices
    that start and end inside 128-entry tiles, P = 0 allowed; slices of
    tree id -1 (empty, query 0 among them), random rects, and query 1's
    rect around an entry of the largest slice."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 100, (P, dim)).astype(np.float32)
    hi = lo + (0 if dim == 2 else rng.uniform(0, 3, (P, dim)).astype(
        np.float32))
    Pp = max(TP, -(-P // TP) * TP)
    esoa = np.empty((2 * dim, Pp), np.float32)
    esoa[:dim], esoa[dim:] = 1.0, 0.0
    esoa[:dim, :P], esoa[dim:, :P] = lo.T, hi.T
    cuts = np.sort(rng.integers(0, P + 1, 6))
    off = np.concatenate([[0], cuts, [P]]).astype(np.int32)
    t = rng.integers(-1, len(off) - 1, B)
    t[0], t[1] = -1, np.argmax(np.diff(off))     # a miss, a hit below
    qs = np.where(t >= 0, off[np.maximum(t, 0)], 0).astype(np.int32)
    qe = np.where(t >= 0, off[np.maximum(t, 0) + 1], 0).astype(np.int32)
    c = rng.uniform(0, 100, (B, dim))
    if P:
        c[1] = lo[(qs[1] + qe[1]) // 2]          # an entry of its slice
    r = rng.uniform(0.5, 15, (B, dim))
    rsoa = np.concatenate([c - r, c + r], 1).T.astype(np.float32)
    return [np.ascontiguousarray(a) for a in (esoa, rsoa, qs, qe)]


# K9's slice lengths; query b's slice starts at residue b % 4
SLICE_LENGTHS = (0, 1, 3, 4, 5, 127, 128, 129, 1800, 5000)


def slice_edge_case(seed, dim, B, P):
    """K9 inputs on planes exactly P entries wide (P % 4 != 0 leaves them
    unaligned): query b's slice has length SLICE_LENGTHS[(b + 8) % 10] and
    starts at b % 4 mod 4; every seventh query's slice starts below 0,
    ends past P, or is empty or reversed, in turn.  Entry p sits alone at
    (1000 + p, ...), so query b's rect hits exactly the first entry of
    its clipped slice, exactly the last, or nothing, as b % 3 is 0, 1,
    2; the other entries lie in [0, 103]."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 100, (P, dim)).astype(np.float32)
    hi = lo + (0 if dim == 2 else rng.uniform(0, 3, (P, dim)).astype(
        np.float32))
    qs = np.zeros(B, np.int64)
    qe = np.zeros(B, np.int64)
    target = np.full(B, -1)
    for b in range(B):
        n = SLICE_LENGTHS[(b + 8) % 10]
        s = b % 4 + 4 * int(rng.integers(0, max(1, (P - n) // 4)))
        s, e = [(s, s + n), (-3, n - 3), (P - 2, P + 50), (s, s),
                (s + 5, s)][1 + (b // 7) % 4 if b % 7 == 6 else 0]
        qs[b], qe[b] = s, e
        cs, ce = max(s, 0), min(e, P)
        if ce > cs and b % 3 < 2:
            target[b] = cs if b % 3 == 0 else ce - 1
    hit = target >= 0
    lo[target[hit]] = hi[target[hit]] = 1000 + target[hit, None]
    c = np.broadcast_to(np.where(hit, 1000 + target, -500.0)[:, None],
                        (B, dim))
    rsoa = np.concatenate([c - 0.25, c + 0.25], 1).T.astype(np.float32)
    esoa = np.concatenate([lo.T, hi.T]).astype(np.float32).reshape(
        2 * dim, P)
    return [np.ascontiguousarray(a) for a in (
        esoa, rsoa, qs.astype(np.int32), qe.astype(np.int32))], hit


@pytest.mark.parametrize("P", [0, 1000, 1001, 40000])
@pytest.mark.parametrize("B", [1, TB, 3 * TB, 33, 256, 2048])
@pytest.mark.parametrize("dim", [2, 3])
def test_range_query_kernel_matches_plain(cuda, dim, B, P):
    seed = dim * 1000 + B + P
    if B > 1:                                  # query 1 hits
        args = [torch.as_tensor(a, device=cuda)
                for a in _leafscan_case(seed, dim, B, P)]
        launches = L.range_query.launches
        got = L.range_query(*args, dim=dim)
        assert L.range_query.launches == launches + 1
        assert torch.equal(got, L.range_query_torch(*args, dim=dim))
        if P:
            assert 0 < int(got.sum()) < B
    # unaligned, clipped and empty slices, hits at the first and the
    # last entry; on planes with a misaligned base too
    arrays, hit = slice_edge_case(seed, dim, B, P)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    spare = torch.empty(args[0].numel() + 1, device=cuda)[1:]
    shifted = spare.view(args[0].shape).copy_(args[0])
    assert L.vector_planes(args[0]) == (P % 4 == 0)
    assert not L.vector_planes(shifted) or not P
    for esoa in (args[0], shifted):
        launches = L.range_query.launches
        got = L.range_query(esoa, *args[1:], dim=dim)
        assert L.range_query.launches == launches + 1
        assert torch.equal(got, L.range_query_torch(*args, dim=dim))
        assert np.array_equal(got.cpu().numpy(), hit.astype(np.int32))


def test_range_query_rejects_what_it_does_not_take(cuda):
    esoa, rsoa, qs, qe = [torch.as_tensor(a, device=cuda)
                          for a in _leafscan_case(0, 2, TB, 300)]
    with pytest.raises(ValueError, match="dim"):
        L.range_query(esoa, rsoa, qs, qe, dim=4)
    with pytest.raises(ValueError, match="shape"):
        L.range_query(esoa, rsoa, qs, qe, dim=3)
    with pytest.raises(ValueError, match="dtype"):
        L.range_query(esoa, rsoa, qs.long(), qe, dim=2)
    with pytest.raises(ValueError, match="contiguous"):
        L.range_query(esoa, rsoa.t().contiguous().t(), qs, qe, dim=2)
    with pytest.raises(ValueError, match="lies on"):
        L.range_query(esoa.cpu(), rsoa, qs, qe, dim=2)


@pytest.mark.parametrize("method", ["2dreach", "2dreach-comp", "3dreach"])
def test_leafscan_and_wavefront_on_card_match_host(cuda, method):
    """The two engines on the card: the leaf scan one K9 launch per
    batch and one upload per forest, equal to the host descent; the
    wavefront equal to its CPU run, hit and overflow."""
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, method)
    us, rects = workload(g, 300, extent_ratio=0.05, seed=4)
    if method == "3dreach":
        z = (np.arange(len(us)) % idx.cond.n_comps).astype(np.float32)
        rects = np.concatenate([rects[:, :2], z[:, None] - 0.5, rects[:, 2:],
                                z[:, None] + 0.5], 1).astype(np.float32)
        tids = np.where(np.arange(len(us)) % 7 == 0, -1, 0)
    else:
        tids = idx.lookup_tree(us)
    uploads = UPLOAD_COUNTERS["host_uploads"]
    launches = L.range_query.launches
    got = np.concatenate([L.range_query_forest(idx.forest, tids[s:s + 100],
                                               rects[s:s + 100])
                          for s in range(0, 300, 100)])
    assert L.range_query.launches == launches + 3
    assert UPLOAD_COUNTERS["host_uploads"] == uploads + 1
    if method != "3dreach":       # the serving engine shares the planes
        eng = QueryEngine(idx)
        assert UPLOAD_COUNTERS["host_uploads"] == uploads + 1
        assert eng._arena.entries is forest_planes(idx.forest, cuda)[0]
    want = query_host(idx.forest, tids, rects)
    assert np.array_equal(got, want)
    for cap in (128, 2):
        hit, over = query_wavefront(idx.forest, tids, rects, capacity=cap)
        chit, cover = query_wavefront(idx.forest, tids, rects, capacity=cap,
                                      device="cpu")
        assert np.array_equal(hit, chit) and np.array_equal(over, cover)
        assert np.array_equal(hit[~over], want[~over])


@pytest.mark.parametrize("method", ["2dreach", "3dreach"])
def test_closure_torch_on_card_matches_cpu(cuda, method):
    """The boolean sweep closure on the card equals its CPU run after one
    sweep and after as many sweeps as the DAG has levels."""
    g = get_dataset("yelp", scale=0.05)
    c = build_index(g, method).cond
    own = np.random.default_rng(c.n_comps).random((c.n_comps, 37)) < 0.1
    for sweeps in (1, max(c.n_levels, 1)):
        got = closure_torch(c.n_comps, c.dag_edges, own, sweeps)
        want = closure_torch(c.n_comps, c.dag_edges, own, sweeps,
                             device="cpu")
        assert got.dtype == bool and np.array_equal(got, want)


def _bag_case(seed, V, B, maxlen, tail=3):
    """Bags of 0..maxlen lookups into V rows, the last ``tail`` empty."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, maxlen + 1, size=B)
    lens[max(B - tail, 0):] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return rng, rng.integers(0, V, int(offsets[-1])), offsets


def _within_sum_bound(got, dev, B):
    """K10's sums against the card's plain version (atomic adds, any
    order) within ``sum_error_bound``: 2 n_b 2^-24 times each bag's
    magnitude sum plus an ulp of it; NaN bags NaN in both."""
    plain = SB.segment_bag_torch(*dev, n_segments=B)
    bound = SB.sum_error_bound(*dev, n_segments=B)
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(got), nan)
    diff = (got - plain).abs().masked_fill(nan, 0)
    assert bool((diff <= bound.masked_fill(nan, 0)).all()), (
        float((diff / bound.masked_fill(nan, 1)).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,B,maxlen", [
    (10, 18, 1, 3), (1000, 18, 33, 100), (100, 32, 17, 7), (64, 128, 9, 0),
    (257, 128, 40, 12), (1_000_000, 18, 512, 100)])
def test_segment_bag_kernel_matches_plain(cuda, V, D, B, maxlen, dtype):
    """K10 adds the same float32 products in the same ascending order as
    the plain version on the CPU: equal bit for bit.  Against the plain
    version on the card, whose ``index_add_`` adds atomically in any
    order: within the summation bound (``_within_sum_bound``)."""
    rng, idx, offsets = _bag_case(V * 7 + D + B, V, B, maxlen)
    table = torch.as_tensor(
        rng.standard_normal((V, D)).astype(np.float32)).to(dtype)
    i, s, w = SB.pack_bags(idx, offsets)
    w[: len(idx)] = rng.uniform(0.5, 2.0, len(idx)).astype(np.float32)
    args = [table] + [torch.as_tensor(a) for a in (i, s, w)]
    dev = [a.to(cuda) for a in args]
    launches = SB.segment_bag.launches
    got = SB.segment_bag(*dev, n_segments=B)
    assert SB.segment_bag.launches == launches + 1
    assert got.dtype == torch.float32 and got.shape == (B, D)
    assert torch.equal(got.cpu(), SB.segment_bag_torch(*args, n_segments=B))
    _within_sum_bound(got, dev, B)
    assert not got[B - min(B, 3):].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_on_card_matches_cpu(cuda, mode):
    rng, idx, offsets = _bag_case(9, 5000, 300, 100)
    table = torch.as_tensor(rng.standard_normal((5000, 18)).astype(
        np.float32))
    launches = SB.segment_bag.launches
    got = SB.embedding_bag(table.to(cuda), idx, offsets, mode)
    assert SB.segment_bag.launches == launches + 1
    assert torch.equal(got.cpu(), SB.embedding_bag(table, idx, offsets, mode,
                                                   device="cpu"))
    empty = SB.embedding_bag(table.to(cuda), [], [0], mode)
    assert empty.shape == (0, 18)


def test_segment_bag_rejects_what_it_does_not_take(cuda):
    table = torch.zeros(7, 18, device=cuda)
    i, s, w = (torch.as_tensor(a, device=cuda)
               for a in SB.pack_bags(np.array([1, 2, 3]), np.array([0, 3])))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SB.segment_bag(table.double(), i, s, w, n_segments=1)
    with pytest.raises(ValueError, match="dtype"):
        SB.segment_bag(table, i.long(), s, w, n_segments=1)
    with pytest.raises(ValueError, match="shape"):
        SB.segment_bag(table, i, s, w[:4], n_segments=1)
    with pytest.raises(ValueError, match="contiguous"):
        SB.segment_bag(table.t().contiguous().t(), i, s, w, n_segments=1)
    with pytest.raises(ValueError, match="lies on"):
        SB.segment_bag(table, i.cpu(), s, w, n_segments=1)
    with pytest.raises(ValueError, match="lies on"):
        SB.embedding_bag(table.cpu(), np.array([1]), np.array([0, 1]))
    # a table of no rows: lookups raise, as the plain version's gather
    # does; no lookup gives zeros
    with pytest.raises(IndexError):
        SB.segment_bag(table[:0], i, s, w, n_segments=1)
    with pytest.raises(IndexError):
        SB.segment_bag_torch(table[:0].cpu(), i.cpu(), s.cpu(), w.cpu(),
                             n_segments=1)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert torch.equal(SB.segment_bag(table[:0], none, none, none.float(),
                                      n_segments=2),
                       torch.zeros(2, 18, device=cuda))


def _bag_operands(seed, lens, V, D, dtype, pad=0, exact=False):
    """CPU operands for bags of the given lengths (``None``: L = 0, no
    padding either) into a random (V, D) table, random weights and
    ``pad`` more lookups of padding at the end.  ``exact`` draws the
    table from the integers -8..8 and the weights from 0.5, 1, 1.5 and
    2, so every sum of up to 10^6 products is exact in float32 in any
    order of the adds."""
    rng = np.random.default_rng(seed)
    if lens is None:
        i = s = np.zeros(0, np.int32)
        w = np.zeros(0, np.float32)
    else:
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        L = int(offsets[-1])
        i, s, w = SB.pack_bags(rng.integers(0, V, L), offsets)
        w[:L] = (rng.integers(1, 5, L) / 2 if exact
                 else rng.uniform(0.5, 2.0, L)).astype(np.float32)
        i = np.concatenate([i, np.zeros(pad, np.int32)])
        s = np.concatenate([s, np.full(pad, len(lens), np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    table = torch.as_tensor((rng.integers(-8, 9, (V, D)) if exact else
                             rng.standard_normal((V, D))).astype(
                                 np.float32)).to(dtype)
    return [table] + [torch.as_tensor(a) for a in (i, s, w)]


def _check_bag(args, B, cuda, table=None):
    """K10 on the card (``table``: a card table to use instead of
    ``args[0]``'s copy), one launch, bit for bit equal to the plain
    version on the CPU and within the summation bound of the plain
    version on the card (``_within_sum_bound``)."""
    dev = [table if table is not None else args[0].to(cuda)] + [
        a.to(cuda) for a in args[1:]]
    launches = SB.segment_bag.launches
    got = SB.segment_bag(*dev, n_segments=B)
    assert SB.segment_bag.launches == launches + 1
    assert got.dtype == torch.float32 and got.shape == (B, args[0].shape[1])
    assert torch.equal(got.cpu(), SB.segment_bag_torch(*args, n_segments=B))
    _within_sum_bound(got, dev, B)
    return got


_RAGGED = np.random.default_rng(11).integers(0, 101, 1001)
_RAGGED[200:700] = 0
BAG_EDGES = {   # what -> (bag lengths, V, D, padding lookups)
    "one bag of 5,000": ([5000], 100_000, 18, 0),
    "one bag of 200,000": ([200_000], 1_000_000, 18, 0),
    "empty stretches, a padding tail": (
        [0] * 5000 + [40] * 50 + [0] * 20_000 + [3], 1000, 18, 1000),
    "L = 0": (None, 10, 18, 0),
    "L = 33": ([33], 50, 18, 0),
    "L = 95": ([31, 0, 64], 50, 18, 0),
    "1,001 ragged bags": (list(_RAGGED), 5000, 18, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", list(BAG_EDGES))
def test_segment_bag_kernel_on_edge_cases(cuda, what, dtype):
    """Bags longer than a batch of 32 lookups and than a warp's window,
    runs crossing batches, stretches of empty bags and a tail of
    padding, L = 0 and L not a multiple of 32, 1,001 bags (not a
    multiple of a block's 4 warps): bit for bit as on the CPU.  The
    card's plain version adds atomically in any order: within the
    summation bound, which grows with a bag's length; a bag of over
    1,000 lookups is held against it on exactly summable data too,
    where every order gives the same sums."""
    lens, V, D, pad = BAG_EDGES[what]
    B = 1 if lens is None else len(lens)
    long = lens is not None and max(lens) > 1000
    got = _check_bag(_bag_operands(len(what), lens, V, D, dtype, pad), B,
                     cuda)
    if long:
        _check_bag(_bag_operands(len(what), lens, V, D, dtype, pad, True),
                   B, cuda)
    if lens is not None:
        empty = torch.as_tensor(np.asarray(lens) == 0, device=got.device)
        assert not got[empty].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2, 17, 18, 19, 32, 128, 129])
def test_segment_bag_kernel_at_each_width(cuda, D, dtype):
    """Every width, each copy width it takes (``copy_bytes``: 4 to 16
    bytes in float32, 2 to 16 in bf16), 301 ragged bags."""
    lens = np.random.default_rng(D).integers(0, 101, 301)
    args = _bag_operands(D, list(lens), 5000, D, dtype)
    _check_bag(args, len(lens), cuda)


@pytest.mark.parametrize("spw", [1, 2, 3, 4, 8, 16, 32, 64, 1000, 5000])
def test_segment_bag_kernel_at_forced_launch_shapes(cuda, monkeypatch, spw):
    """K10 with ``warp_segments`` forced to each segments-a-warp the
    ``--ab`` sweep takes and beyond (one warp for all 1,001 bags), in
    float32 and bf16."""
    from repro_torch.kernels.segment_bag import ops

    monkeypatch.setattr(ops, "warp_segments", lambda *_: spw)
    for dtype in (torch.float32, torch.bfloat16):
        _check_bag(_bag_operands(spw, list(_RAGGED), 5000, 18, dtype, 77),
                   len(_RAGGED), cuda)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 18, 4), (torch.float32, 32, 4), (torch.bfloat16, 18, 2),
    (torch.bfloat16, 128, 2)])
def test_segment_bag_kernel_on_a_shifted_table(cuda, dtype, D, want):
    """A table one element past an aligned base takes the narrowest copy
    (``copy_bytes``), a table cut by rows (``t[1:]``) keeps its width
    where its rows stay aligned; both bit for bit as on the CPU."""
    lens = list(np.random.default_rng(D).integers(0, 41, 77))
    args = _bag_operands(D + 1, lens, 500, D, dtype)
    flat = torch.empty(500 * D + 1, dtype=dtype, device=cuda)
    flat[1:].copy_(args[0].flatten())
    shifted = flat[1:].view(500, D)
    assert SB.copy_bytes(shifted) == want
    _check_bag(args, len(lens), cuda, shifted)
    full = torch.cat([args[0][:1], args[0]]).to(cuda)
    assert SB.copy_bytes(full[1:]) == SB.copy_bytes(args[0])
    _check_bag(args, len(lens), cuda, full[1:])


BAD_IDS = (-1, "-V", "-V-1", "V", -(2 ** 31), 2 ** 31 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [18, 128])
def test_segment_bag_kernel_on_bad_ids(cuda, D, dtype):
    """Ids -1, -V, -V - 1, V and the int32 extremes, each in a bag of
    several lookups and in a bag of one: K10 wraps the first two and
    sums NaN for the rest, reading nothing outside the table; NaN where
    the plain version has NaN (on the CPU and on the card), bit for bit
    equal to the CPU's elsewhere, and the card serves on."""
    V = 500
    lens = [7, 1] * len(BAD_IDS) + [40, 3]
    args = _bag_operands(D, lens, V, D, dtype, 5)
    i = args[1].numpy().copy()
    offsets = np.concatenate([[0], np.cumsum(lens)])
    for b, bad in enumerate(BAD_IDS):
        bad = {"-V": -V, "-V-1": -V - 1, "V": V}.get(bad, bad)
        i[offsets[2 * b] + 3] = bad          # in a bag of 7
        i[offsets[2 * b + 1]] = bad          # in a bag of one
    args[1] = torch.as_tensor(i)
    B = len(lens)
    launches = SB.segment_bag.launches
    got = SB.segment_bag(*(a.to(cuda) for a in args), n_segments=B)
    assert SB.segment_bag.launches == launches + 1
    cpu = SB.segment_bag_torch(*args, n_segments=B)
    card = SB.segment_bag_torch(*(a.to(cuda) for a in args), n_segments=B)
    nan = torch.isnan(cpu)
    assert nan.any(1).tolist() == [False] * 4 + [True] * 8 + [False] * 2
    assert torch.equal(torch.isnan(got).cpu(), nan)
    assert torch.equal(torch.isnan(card).cpu(), nan)
    assert torch.equal(got.cpu()[~nan], cpu[~nan])
    _within_sum_bound(got, [a.to(cuda) for a in args], B)
    again = _bag_operands(D + 1, [5, 2], V, D, dtype)
    _check_bag(again, 2, cuda)


@pytest.mark.parametrize("indices,want", [
    ([0, 7], [[np.nan] * 4]), ([-1, 0], [[24.0, 26.0, 28.0, 30.0]]),
    ([0, -8], [[np.nan] * 4])])
def test_embedding_bag_on_the_card_gives_the_reference_rows(cuda, indices,
                                                             want):
    """The reference's ``embedding_bag(use_ref=True)`` rows for the
    table arange(28).reshape(7, 4) and one bag of two lookups."""
    table = torch.arange(28, dtype=torch.float32).reshape(7, 4).to(cuda)
    got = SB.embedding_bag(table, np.array(indices), np.array([0, 2]))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.asarray(want, np.float32))


@pytest.fixture
def no_tf32():
    """float32 matrix products in full precision on the card."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("fn", ["apply", "score_candidates"])
def test_din_on_card_matches_cpu(cuda, no_tf32, fn):
    """DIN at its published widths (1M items) on a batch of 64, and
    retrieval scoring of 64 candidates in chunks of 16, on the card
    against the same parameters on the CPU: within 1e-5 absolute and
    relative (the products sum in another order)."""
    cfg = make_config()
    cpu = din.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card = din.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(card["item_emb"]["emb"].cpu(), cpu["item_emb"]["emb"])
    b = next(din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, 64))
    if fn == "apply":
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        got = din.apply(card, tree_to(batch, cuda), cfg)
        want = din.apply(cpu, batch, cfg)
    else:
        cand = np.random.default_rng(0).integers(0, cfg.n_items, 64)
        batch = {"hist_items": torch.as_tensor(b["hist_items"][0]),
                 "hist_mask": torch.as_tensor(b["hist_mask"][0]),
                 "candidates": torch.as_tensor(cand.astype(np.int32))}
        got = din.score_candidates(card, tree_to(batch, cuda), cfg, chunk=16)
        want = din.score_candidates(cpu, batch, cfg, chunk=16)
    assert got.shape == (64,) and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The cluster's sharded engine and the dynamic index on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 4, 8])
def test_sharded_engine_on_card(cuda, S):
    """Both paths on the card equal the host index at S shards: K1 once
    per shard a fused batch (plus S per ratchet re-run), K2 and K3 once
    per shard a two-phase batch."""
    from repro_torch.cluster import ShardedEngine

    g = get_dataset("yelp", scale=0.1)
    idx = build_index(g, "2dreach-comp")
    eng = ShardedEngine(idx, n_shards=S, device=cuda)
    us, rects = workload(g, 512, extent_ratio=0.05, seed=3)
    want = idx.query_batch(us, rects)
    for b in range(0, 512, 256):
        k1, reruns = F.fused_serve.launches, eng.stats["fused_reruns"]
        assert np.array_equal(eng.query_batch(us[b:b + 256],
                                              rects[b:b + 256]),
                              want[b:b + 256])
        assert F.fused_serve.launches - k1 == S * (
            1 + eng.stats["fused_reruns"] - reruns)
        k2, k3 = D.prune_tiles.launches, D.descent_scan.launches
        assert np.array_equal(eng.query_batch_two_phase(
            us[b:b + 256], rects[b:b + 256]), want[b:b + 256])
        assert (D.prune_tiles.launches - k2, D.descent_scan.launches - k3) \
            == (S, S)


def test_shard_arenas_device_path_on_card(cuda):
    """A forest built on the card: its shard stacks gathered and reduced
    there (K8 twice per shard: the fine and the coarse level) equal the
    host path's, with one adoption and no upload."""
    from repro_torch.cluster import partition_forest, shard_arenas

    g = get_dataset("yelp", scale=0.1)
    host = build_index(g, "2dreach-comp")
    dev = build_index(g, "2dreach-comp", backend="device", device=cuda)
    for S in (1, 4, 8):
        want = shard_arenas(host.forest, partition_forest(host.forest, S))
        k8 = FB.seg_mbr.launches
        up = UPLOAD_COUNTERS["host_uploads"]
        got = shard_arenas(dev.forest, partition_forest(dev.forest, S))
        assert FB.seg_mbr.launches - k8 == 2 * S
        assert UPLOAD_COUNTERS["host_uploads"] == up
        for a, b in zip(got[:3], want[:3]):
            assert a.is_cuda and np.array_equal(a.cpu().numpy(), b)


def test_dynamic_index_device_engine_on_card(cuda):
    """DynamicIndex(engine="device") on the card answers as the host
    engine's across a compaction, with every base adopted (no upload)."""
    from repro_torch.core import build_dynamic_index
    from repro_torch.data import apply_stream_op, streaming_workload
    from repro_torch.dynamic import NEVER

    g = get_dataset("yelp", scale=0.1)
    up = UPLOAD_COUNTERS["host_uploads"]
    dev = build_dynamic_index(g, "2dreach-comp", policy=NEVER,
                              engine="device", device=cuda)
    host = build_dynamic_index(g, "2dreach-comp", policy=NEVER)
    us, rects = workload(g, 256, extent_ratio=0.05, seed=5)
    for op in streaming_workload(g, n_steps=200, seed=5, p_query=0.0,
                                 p_edge=0.6, p_vertex=0.2, p_spatial=0.2):
        apply_stream_op(dev, op)
        apply_stream_op(host, op)
    assert np.array_equal(dev.query_batch(us, rects),
                          host.query_batch(us, rects))
    assert np.array_equal(dev.count_batch(us, rects),
                          host.count_batch(us, rects))
    dev.compact(background=False)
    assert dev.base_engine.stats["adopted"] == 1
    assert np.array_equal(dev.query_batch(us, rects),
                          host.query_batch(us, rects))
    assert UPLOAD_COUNTERS["host_uploads"] == up


# --------------------------------------------------------------------------
# The dense closure product, the unscheduled closure, DIN's train step and
# the serving launcher on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f,m,W", [(1, 1, 1), (65, 128, 9), (512, 512, 64),
                                   (2000, 3000, 95)])
def test_bitset_mm_mxu_on_card_matches_plain(cuda, f, m, W):
    """The dense bf16 product on the card (``torch.matmul``) equals K7's
    plain version on the CPU bit for bit, and K7 on the card."""
    from repro_torch.core.reachability import pack_rows

    rng = np.random.default_rng(f + m + W)
    a = BM.uint32_bits(pack_rows(rng.random((f, m)) < 0.05), cuda)
    r = BM.uint32_bits(pack_rows(rng.random((m, 32 * W)) < 0.1), cuda)
    got = BM.bitset_mm_mxu(a, r)
    assert got.is_cuda and got.shape == (f, W)
    assert torch.equal(got.cpu(), BM.bitset_mm_torch(a.cpu(), r.cpu()))
    assert torch.equal(got, BM.bitset_mm(a, r))


@pytest.mark.parametrize("scale", [0.05, 0.1])
def test_closure_fixpoint_k7_arm_matches_mxu_arm_on_card(cuda, scale):
    """The unscheduled closure on the card: its K7 arm (one K7 launch a
    step) equals its MXU arm and the CPU's run."""
    from repro_torch.core import closure_np, condense, scc_np
    from repro_torch.core.reachability import pack_rows

    g = get_dataset("yelp", scale=scale)
    cond = condense(g.n_nodes, g.edges, scc_np(g.n_nodes, g.edges))
    clo = closure_np(cond, g.n_nodes, g.spatial_ids)
    d, p = cond.n_comps, clo.p
    own = np.zeros((d, p), dtype=bool)
    own[np.repeat(np.arange(d), np.diff(clo.own_indptr)),
        clo.own_cols] = True
    A = np.zeros((d, d), dtype=bool)
    A[cond.dag_edges[:, 0], cond.dag_edges[:, 1]] = True
    ob, ab = pack_rows(own), pack_rows(A)
    n = cond.n_levels + 1
    k7 = BM.bitset_mm.launches
    got = BM.closure_fixpoint(ob, ab, n)
    assert 1 <= BM.bitset_mm.launches - k7 <= n
    np.testing.assert_array_equal(got, BM.closure_fixpoint(ob, ab, n,
                                                           use_mxu=True))
    np.testing.assert_array_equal(got, BM.closure_fixpoint(ob, ab, n,
                                                           device="cpu"))


def test_din_train_step_on_card_matches_cpu(cuda, no_tf32):
    """One AdamW step of DIN at its published widths (1M items) on a
    batch of 64, on the card against the same parameters on the CPU: the
    loss within 1e-5 relative, every parameter and moment within 1e-4
    relative in norm (the embedding's backward adds with atomics on the
    card, in another order)."""
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.optim import tree_leaves

    cfg = make_config()
    cpu = din.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card = tree_to(cpu, cuda)
    step = make_train_step(lambda p, b: (din.loss_fn(p, b, cfg), {}),
                           AdamWConfig())
    b = {k: torch.as_tensor(v) for k, v in next(din_batches(
        cfg.n_items, cfg.n_cates, cfg.seq_len, 64)).items()}
    p1, o1, m1 = step(card, adamw_init(card), tree_to(b, cuda))
    p0, o0, m0 = step(cpu, adamw_init(cpu), b)
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-5)
    for got, want in zip(tree_leaves(p1) + tree_leaves(o1.m),
                         tree_leaves(p0) + tree_leaves(o0.m)):
        assert got.is_cuda
        err = float((got.cpu().double() - want.double()).norm())
        assert err <= 1e-4 * max(float(want.double().norm()), 1e-30)


@pytest.mark.parametrize("engine", ["device", "cluster"])
def test_serve_launcher_on_card_matches_host(cuda, engine):
    """The launcher's device arm (K1) and cluster arm (the sharded engine
    behind the frontend) on the card answer as the host engine, the
    cluster with no new shape in its steady state."""
    from repro_torch.launch import serve

    k1 = F.fused_serve.launches
    got = serve.main(["--dataset", "yelp", "--scale", "0.1", "--queries",
                      "600", "--batch", "128", "--engine", engine,
                      "--verify", "32"])
    assert F.fused_serve.launches > k1
    np.testing.assert_array_equal(got["answers"], got["host"])
    if engine == "cluster":
        c = got["cluster"]
        assert c["n_compiles"] == c["n_compiles_warm"]


LM_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma3-12b",
            "h2o-danube-1.8b", "gemma2-2b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_on_card_matches_cpu(cuda, no_tf32, arch):
    """Each reduced LM config (float32) on the card against the same
    parameters on the CPU: prefill of 16 tokens and 4 decode steps
    (logits within 1e-4 (1 + |CPU|)), ``lm_loss``, and one AdamW step
    (the loss within 1e-4, every parameter within 1e-4 relative in
    norm; MoE's combine adds with atomics on the card)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batches
    from repro_torch.models.lm import (decode_step, init_params, lm_loss,
                                       prefill)
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.optim import tree_leaves

    cfg = get_arch(arch).make_config(reduced=True)
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = next(lm_batches(cfg.vocab, 32, 2, seed=1))
    step = make_train_step(lambda p, bb: lm_loss(p, bb, cfg), AdamWConfig())
    out = []
    for dev, params in (("cpu", cpu), (cuda, tree_to(cpu, cuda))):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        lg, cache = prefill(params, batch["tokens"][:, :16], cfg, 22)
        seq = [lg]
        for i in range(4):
            lg, cache = decode_step(params, cache,
                                    batch["tokens"][:, 16 + i], cfg)
            seq.append(lg)
        with torch.no_grad():
            loss = float(lm_loss(params, batch, cfg)[0])
        p1, _, m = step(params, adamw_init(params), batch)
        out.append((torch.stack(seq).cpu(), loss, float(m["loss"]),
                    [x.cpu() for x in tree_leaves(p1)]))
    (l0, s0, t0, p0), (l1, s1, t1, p1) = out
    assert ((l1 - l0).abs() <= 1e-4 * (1 + l0.abs())).all()
    assert abs(s1 - s0) <= 1e-4 * (1 + abs(s0))
    assert abs(t1 - t0) <= 1e-4 * (1 + abs(t0))
    for got, want in zip(p1, p0):
        err = float((got.double() - want.double()).norm())
        assert err <= 1e-4 * max(float(want.double().norm()), 1e-30)


def test_lm_checkpoint_from_card_tensors_restores_bit_for_bit(cuda,
                                                              tmp_path):
    """A checkpoint of card tensors (float32 parameters, their bf16
    casts, an AdamW state) restores onto the card with the same dtype
    and every bit."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import restore_checkpoint, save_checkpoint
    from repro_torch.distributed.tree import walk
    from repro_torch.models.lm import init_params
    from repro_torch.train import adamw_init

    cfg = get_arch("deepseek-v3-671b").make_config(reduced=True)
    p = init_params(torch.Generator().manual_seed(3), cfg, device=cuda)
    tree = {"params": p, "opt": adamw_init(p),
            "bf16": [x.to(torch.bfloat16) for _, x in walk(p)]}
    save_checkpoint(str(tmp_path), 1, tree)
    back, man = restore_checkpoint(str(tmp_path), tree)
    assert man["keys"] == [k for k, _ in walk(tree)]
    for (ka, a), (kb, b) in zip(walk(tree), walk(back)):
        assert ka == kb and b.is_cuda and a.dtype == b.dtype
        assert torch.equal(a, b), ka


def test_train_launcher_crash_and_resume_on_card(cuda, tmp_path):
    """The launcher on the card with the reduced gemma2: a crash at step
    15, the resume from step 10, and a clean run end within 1e-5 at
    step 30."""
    from repro_torch.distributed import latest_step
    from repro_torch.launch import train as LT

    base = ["--arch", "gemma2-2b", "--steps", "30", "--ckpt-every", "10"]
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected crash at step 15"):
        LT.main(base + ["--ckpt-dir", d1, "--crash-at", "15"])
    assert latest_step(d1) == 10
    params, _, resumed = LT.main(base + ["--ckpt-dir", d1, "--resume"])
    _, _, clean = LT.main(base + ["--ckpt-dir", d2])
    assert all(x.is_cuda for x in params["ln_f"].values())
    assert abs(float(resumed["loss"]) - float(clean["loss"])) < 1e-5
