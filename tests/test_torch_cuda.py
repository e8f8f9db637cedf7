"""GPU tests of the port: each CUDA kernel (fused serve, tile prune,
descent / count / collect scans) against its plain PyTorch version, the
wrappers' input checks, and the engine on the card (both paths) against
the engine on the CPU.  Every test needs a CUDA device and skips where
there is none.
This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import QueryEngine, build_index
from repro_torch.data import get_dataset, workload
from repro_torch.kernels.range_query import analytics as A
from repro_torch.kernels.range_query import descent as D
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query.layout import TB, TP, build_tile_pyramid

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
    assert gpu.stats == cpu.stats


@pytest.mark.parametrize("B", [TB, 3 * TB, 32 * TB])
def test_prune_kernel_matches_plain(cuda, B):
    _, T, _, _ = _two_phase(B, B, 300, cuda)
    args = (T["fine"], T["coarse"], T["rsoa"], T["qs"], T["qe"])
    launches = D.prune_tiles.launches
    got = D.prune_tiles(*args)
    assert D.prune_tiles.launches == launches + 1
    assert torch.equal(got, D.prune_tiles_torch(*args))
    assert got.any()


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
