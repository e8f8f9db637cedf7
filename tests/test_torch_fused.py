"""The port's fused serve (``repro_torch.kernels.range_query``) against the
JAX package's: quantization, tile pyramid, prune mask, compaction, and
``fused_serve_torch`` against both ``fused_serve_xla`` and the
interpreted ``fused_serve_pallas``, for every mode.  Inputs come from
numpy seeds and are fed to both sides; every comparison is exact.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.range_query import fused as RF
from repro.kernels.range_query.descent import (
    build_tile_pyramid as ref_build_tile_pyramid,
)
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query.layout import TB, TP, build_tile_pyramid

CPU = torch.device("cpu")


def _edge_arena(rng, P):
    """Entry arena whose venue boxes end exactly on tile-MBR edges
    (lattice coordinates), with impossible-box padding past P."""
    pts = (np.round(rng.uniform(0, 100, (P, 2)) * 4) / 4).astype(np.float32)
    Pp = max(TP, -(-P // TP) * TP)
    esoa = np.empty((4, Pp), np.float32)
    esoa[:2] = 1.0
    esoa[2:] = 0.0
    esoa[:2, :P] = pts.T
    esoa[2:, :P] = pts.T                      # degenerate boxes = points
    return esoa, pts


def _inputs(seed, B, P=5 * TP + 3):
    """Numpy serving inputs: an edge arena cut into tree slices, rects
    whose edges sit on venue coordinates, empty slices and ±inf
    padding rects at the tail."""
    rng = np.random.default_rng(seed)
    esoa, pts = _edge_arena(rng, P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    extent = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float64)
    off = np.array([0, P // 3, P // 2, P], np.int32)
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    qs[: B // 4] = 0                      # slices spanning several trees
    qe[B // 4: B // 3] = qs[B // 4: B // 3]   # empty slices
    lo = pts[rng.integers(0, P, B)]
    hi = np.maximum(lo, pts[rng.integers(0, P, B)])
    rsoa = np.concatenate([lo, hi], axis=1).T.astype(np.float32)
    rsoa[:2, -2:] = np.inf                # padding rects: never intersect
    rsoa[2:, -2:] = -np.inf
    ids = np.full((1, esoa.shape[1]), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P).astype(np.int32)
    return dict(esoa=esoa, fine=fine, coarse=coarse, nt=nt, extent=extent,
                rsoa=np.ascontiguousarray(rsoa), qs=qs, qe=qe, ids=ids)


def _t(a):
    return torch.as_tensor(np.asarray(a), device=CPU)


def _quantized(d):
    """Port-side quantized planes of an input dict (numpy)."""
    grid = F.make_quant_grid(d["extent"], 2, CPU)
    r16, r32 = F.quantize_rects(grid, _t(d["rsoa"]), 2)
    return (F.quantize_fine(grid, _t(d["fine"]), 2).numpy(),
            F.quantize_coarse(grid, _t(d["coarse"]), 2).numpy(),
            r16.numpy(), r32.numpy())


def test_tile_pyramid_matches():
    for seed, P in ((0, 5 * TP + 3), (1, 1), (2, 130 * TP)):
        esoa, _ = _edge_arena(np.random.default_rng(seed), P)
        got = build_tile_pyramid(esoa, 2)
        want = ref_build_tile_pyramid(esoa, 2)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("extent", ["data", "none", "degenerate"])
def test_quantize_matches(extent):
    d = _inputs(0, 4 * TB)
    ext = {"data": d["extent"], "none": None,
           "degenerate": np.array([5.0, 5.0, 5.0, 5.0])}[extent]
    rgrid = RF.make_quant_grid(ext, 2)
    grid = F.make_quant_grid(ext, 2, CPU)
    for a, b in ((grid.mid, rgrid.mid), (grid.s16, rgrid.s16),
                 (grid.s32, rgrid.s32)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # planes with ±inf padding, values exactly on tile edges and far
    # outside the extent (clipped codes)
    plane = np.concatenate([d["fine"], d["coarse"], d["rsoa"],
                            np.array([[-1e9], [1e9], [1e9], [-1e9]],
                                     np.float32)], axis=1)
    plane = np.ascontiguousarray(plane)
    q16, q32 = F.quantize_rects(grid, _t(plane), 2)
    r16, r32 = RF.quantize_rects(rgrid, jnp.asarray(plane), 2)
    assert q16.dtype == torch.int16 and q32.dtype == torch.int32
    assert np.array_equal(q16.numpy(), np.asarray(r16))
    assert np.array_equal(q32.numpy(), np.asarray(r32))
    assert np.array_equal(F.quantize_fine(grid, _t(plane), 2).numpy(),
                          np.asarray(RF.quantize_fine(rgrid, plane, 2)))
    assert np.array_equal(F.quantize_coarse(grid, _t(plane), 2).numpy(),
                          np.asarray(RF.quantize_coarse(rgrid, plane, 2)))


@pytest.mark.parametrize("B", [TB, 2 * TB])
def test_prune_and_compaction_match(B):
    d = _inputs(1, B)
    qf, qc, r16, r32 = _quantized(d)
    mask = F.quantized_prune_mask(_t(qf), _t(qc), _t(r16), _t(r32),
                                  _t(d["qs"]), _t(d["qe"]))
    rmask = RF.quantized_prune_mask(jnp.asarray(qf), jnp.asarray(qc),
                                    jnp.asarray(r16), jnp.asarray(r32),
                                    jnp.asarray(d["qs"]),
                                    jnp.asarray(d["qe"]))
    assert np.array_equal(mask.numpy(), np.asarray(rmask))
    # real masks plus random ones with empty and full rows
    rng = np.random.default_rng(B)
    masks = [mask.numpy(), rng.random((5, 40)) < 0.3]
    masks[1][0] = False
    masks[1][1] = True
    for m in masks:
        nt = min(m.shape[1], d["nt"]) if m is masks[0] else 37
        cand, cnt = F.compact_ascending(_t(m), nt)
        rcand, rcnt = RF.compact_ascending(jnp.asarray(m), nt)
        assert cand.dtype == torch.int32 and cnt.dtype == torch.int32
        assert np.array_equal(cand.numpy(), np.asarray(rcand))
        assert np.array_equal(cnt.numpy(), np.asarray(rcnt))


@pytest.mark.parametrize("kcap_kind", ["below", "nt", "above"])
@pytest.mark.parametrize("B", [TB, 2 * TB])
@pytest.mark.parametrize("mode", ["reach", "count", "collect"])
def test_fused_serve_torch_matches_reference(mode, B, kcap_kind):
    d = _inputs(2, B)
    qf, qc, r16, r32 = _quantized(d)
    nt = d["nt"]
    args = (qf, qc, d["esoa"], d["ids"], r16, r32, d["rsoa"], d["qs"],
            d["qe"])
    _, cnt = F.fused_serve_torch(*map(_t, args), mode="reach", kcap=nt,
                                 nt=nt)
    mx = int(cnt.max())
    assert mx >= 2, "inputs must allow a truncated scan"
    kcap = {"below": mx // 2, "nt": nt, "above": nt + 2}[kcap_kind]
    out, cnt = F.fused_serve_torch(*map(_t, args), mode=mode, kcap=kcap,
                                   nt=nt)
    jargs = [jnp.asarray(a) for a in args]
    rx = RF.fused_serve_xla(*jargs, mode=mode, kcap=kcap, nt=nt)
    rp = RF.fused_serve_pallas(*jargs, mode=mode, kcap=kcap, nt=nt,
                               interpret=True)
    shape = (B, kcap * TP) if mode == "collect" else (B,)
    assert tuple(out.shape) == shape and out.dtype == torch.int32
    for ro, rc in (rx, rp):
        assert np.array_equal(out.numpy(), np.asarray(ro))
        assert np.array_equal(cnt.numpy(), np.asarray(rc))


def test_fused_serve_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; an unknown mode raises."""
    d = _inputs(3, TB)
    qf, qc, r16, r32 = _quantized(d)
    args = [_t(a) for a in (qf, qc, d["esoa"], d["ids"], r16, r32,
                            d["rsoa"], d["qs"], d["qe"])]
    before = F.fused_serve.launches
    for mode in F.MODES:
        got = F.fused_serve(*args, mode=mode, kcap=3, nt=d["nt"],
                            device="cpu")
        want = F.fused_serve_torch(*args, mode=mode, kcap=3, nt=d["nt"])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert F.fused_serve.launches == before
    with pytest.raises(ValueError, match="mode"):
        F.fused_serve(*args, mode="nope", kcap=3, nt=d["nt"], device="cpu")
