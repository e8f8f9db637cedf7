"""GPU tests of the port: the CUDA fused serve kernel against its plain
PyTorch version, and the engine on the card against the engine on the
CPU.  Every test needs a CUDA device and skips where there is none.
This file imports neither ``jax`` nor ``repro``, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import QueryEngine, build_index
from repro_torch.data import get_dataset, workload
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query.layout import TB, TP, build_tile_pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(seed, B, n_tiles, device):
    """Random serving inputs: lattice points sorted along x in three
    tree slices, rects with edges on venue coordinates, empty slices."""
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
    T = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    grid = F.make_quant_grid(
        np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64), 2,
        device)
    r16, r32 = F.quantize_rects(grid, T(rsoa), 2)
    return nt, (F.quantize_fine(grid, T(fine), 2),
                F.quantize_coarse(grid, T(coarse), 2), T(esoa), T(ids),
                r16, r32, T(rsoa), T(qs), T(qe))


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
