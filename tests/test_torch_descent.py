"""The port's two-phase descent (``repro_torch.kernels.range_query.descent``)
against the JAX package's: ``prune_tiles_torch`` against the interpreted
``prune_tiles_pallas`` and ``prune_tiles_ref``, the candidate compaction
(``compact_ascending``) against the reference engine's
``compact_candidates``, and ``descent_scan_torch`` against the
interpreted ``descent_scan_pallas`` (also with a last row of padding
only); K3's cluster size.  Inputs come from numpy seeds and
are fed to both sides; every comparison is exact.
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

from repro.core.engine import compact_candidates as ref_compact_candidates
from repro.kernels.range_query import descent as RD
from repro_torch.kernels.range_query import descent as D
from repro_torch.kernels.range_query import fused as F
from repro_torch.kernels.range_query.layout import TB, TP, build_tile_pyramid
from test_torch_fused import _inputs, _quantized, _t


def scan_inputs(seed, B, P=40 * TP + 7):
    """Scan inputs: lattice venues sorted along x (so leaf tiles are
    x-bands), three tree slices plus slices spanning trees and empty
    ones, the rects of each query tile clustered around one x with edges
    on the lattice, and (where B > TB) a last query tile of empty slices
    whose candidate count is 0; its last two rects are ±inf padding.
    Adds the port's prune mask and compacted candidates."""
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(0, 100, (P, 2)) * 4) / 4).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    Pp = -(-P // TP) * TP
    esoa = np.empty((4, Pp), np.float32)
    esoa[:2], esoa[2:] = 1.0, 0.0
    esoa[:2, :P] = esoa[2:, :P] = pts.T
    ids = np.full((1, Pp), np.iinfo(np.int32).max, np.int32)
    ids[0, :P] = rng.permutation(P)
    fine, coarse, nt = build_tile_pyramid(esoa, 2)
    off = np.array([0, P // 3, P // 2, P], np.int32)
    t = rng.integers(0, 3, B)
    qs, qe = off[t].copy(), off[t + 1].copy()
    qs[: B // 4] = 0
    qe[B // 4: B // 3] = qs[B // 4: B // 3]
    if B > TB:
        qs[-TB:] = qe[-TB:] = 0
    centre = np.repeat(rng.uniform(5, 95, B // TB), TB)
    lo = np.stack([centre + rng.uniform(-2, 2, B),
                   rng.uniform(0, 80, B)], axis=1)
    hi = lo + rng.uniform(0, 2, (B, 1)) * np.array([1.0, 10.0])
    rsoa = np.round(np.concatenate([lo, hi], axis=1).T * 4) / 4
    rsoa = np.ascontiguousarray(rsoa.astype(np.float32))
    rsoa[:2, -2:], rsoa[2:, -2:] = np.inf, -np.inf
    d = dict(esoa=esoa, ids=ids, fine=fine, coarse=coarse, nt=nt, qs=qs,
             qe=qe, rsoa=rsoa)
    mask = D.prune_tiles_torch(_t(d["fine"]), _t(d["coarse"]), _t(d["rsoa"]),
                               _t(d["qs"]), _t(d["qe"]))
    cand, cnt = F.compact_ascending(mask, d["nt"])
    d.update(mask=mask, cand=cand, cnt=cnt)
    return d


def k_cases(d):
    """K below, at and above the largest true candidate count (K <= 16);
    "above" leaves repeated padding in every row."""
    mx = int(d["cnt"].max())
    assert 2 <= mx <= 13, d["cnt"]
    assert len(d["cnt"]) == 1 or int(d["cnt"][-1]) == 0
    return {"below": mx // 2, "at": mx, "above": mx + 3}


@pytest.mark.parametrize("ntp", [128, 256])
@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_prune_tiles_matches_reference(B, ntp):
    P = 5 * TP + 3 if ntp == 128 else 130 * TP
    d = _inputs(B + ntp, B, P)
    assert d["fine"].shape[1] == ntp
    args = (d["fine"], d["coarse"], d["rsoa"], d["qs"], d["qe"])
    got = D.prune_tiles_torch(*map(_t, args))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B // TB, ntp)
    jargs = [jnp.asarray(a) for a in args]
    for want in (RD.prune_tiles_pallas(*jargs, interpret=True),
                 RD.prune_tiles_ref(*jargs)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def test_prune_tiles_coarse_gate_prunes_whole_blocks():
    """Rects that miss every coarse node of a 128-tile block: the
    reference skips the fine test there, and both answer zeros."""
    d = _inputs(5, 2 * TB, 130 * TP)
    rsoa = d["rsoa"].copy()
    rsoa[:2, :TB] = 1e6                       # far outside the extent
    rsoa[2:, :TB] = 2e6
    args = (d["fine"], d["coarse"], rsoa, d["qs"], d["qe"])
    got = D.prune_tiles_torch(*map(_t, args)).numpy()
    want = RD.prune_tiles_pallas(*[jnp.asarray(a) for a in args],
                                 interpret=True)
    assert np.array_equal(got, np.asarray(want))
    assert not got[0].any() and got[1].any()


@pytest.mark.parametrize("B", [2 * TB, 3 * TB])
def test_compaction_matches_reference(B):
    d = scan_inputs(B, B)
    rng = np.random.default_rng(B)
    rand = rng.random((6, 50)) < 0.2
    rand[0] = False                            # an empty row
    rand[1] = True                             # a full row
    for m, nt in ((d["mask"].numpy(), d["nt"]), (rand.astype(np.int32), 41)):
        cand, cnt = F.compact_ascending(_t(m), nt)
        rcand, rcnt = ref_compact_candidates(jnp.asarray(m), nt)
        assert cand.dtype == torch.int32 and cnt.dtype == torch.int32
        assert np.array_equal(cand.numpy(), np.asarray(rcand))
        assert np.array_equal(cnt.numpy(), np.asarray(rcnt))
    # a row with no active tile fills with tile 0
    assert int(d["cnt"][-1]) == 0 and not d["cand"][-1].any()


@pytest.mark.parametrize("kind", ["below", "at", "above"])
@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_descent_scan_matches_reference(B, kind):
    d = scan_inputs(10 + B, B)
    K = k_cases(d)[kind]
    cand = D.take_candidates(d["cand"], K)
    args = (d["esoa"], d["rsoa"], d["qs"], d["qe"])
    got = D.descent_scan_torch(cand, *map(_t, args))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    want = RD.descent_scan_pallas(jnp.asarray(cand.numpy()),
                                  *[jnp.asarray(a) for a in args],
                                  interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if kind != "below":       # every candidate scanned: the dense truth
        from repro.kernels.range_query.analytics import count_scan_ref

        dense = np.asarray(count_scan_ref(*[jnp.asarray(a) for a in args]))
        assert np.array_equal(got.numpy(), (dense > 0).astype(np.int32))
        assert got.any()


def last_row_padding(seed, B):
    """``scan_inputs`` whose last query tile takes the first one's
    slices and rects (``scan_inputs`` leaves it empty where B > TB), its
    compacted candidates cut at K above the largest true count, and the
    last row then all padding: its first tile in every slot."""
    d = scan_inputs(seed, B)
    d["qs"][-TB:], d["qe"][-TB:] = d["qs"][:TB], d["qe"][:TB]
    d["rsoa"][:, -TB:] = d["rsoa"][:, :TB]
    mask = D.prune_tiles_torch(_t(d["fine"]), _t(d["coarse"]), _t(d["rsoa"]),
                               _t(d["qs"]), _t(d["qe"]))
    cand, cnt = F.compact_ascending(mask, d["nt"])
    assert int(cnt[-1]) >= 2
    cand = D.take_candidates(cand, int(cnt.max()) + 3).clone()
    cand[-1] = int(cand[-1, 0])
    return d, cand


@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_descent_scan_on_a_last_row_of_padding_matches_reference(B):
    """K above the true count and the last row all padding: equal to the
    interpreted Pallas kernel, and the padded row answers as its first
    slot alone."""
    d, cand = last_row_padding(50 + B, B)
    args = (d["esoa"], d["rsoa"], d["qs"], d["qe"])
    got = D.descent_scan_torch(cand, *map(_t, args))
    want = RD.descent_scan_pallas(jnp.asarray(cand.numpy()),
                                  *[jnp.asarray(a) for a in args],
                                  interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    first = D.descent_scan_torch(cand[:, :1].contiguous(), *map(_t, args))
    assert torch.equal(got[-TB:], first[-TB:]) and got[-TB:].any()


def test_take_candidates_pads_with_the_last_column():
    d = scan_inputs(3, 2 * TB)
    nt = d["nt"]
    wide = D.take_candidates(d["cand"], nt + 5)
    assert tuple(wide.shape) == (2, nt + 5) and wide.is_contiguous()
    assert torch.equal(wide[:, :nt], d["cand"])
    assert (wide[:, nt:] == d["cand"][:, -1:]).all()
    assert D.take_candidates(d["cand"], 2).is_contiguous()


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    d = scan_inputs(4, 2 * TB)
    before = (D.prune_tiles.launches, D.descent_scan.launches)
    args = [_t(a) for a in (d["fine"], d["coarse"], d["rsoa"], d["qs"],
                            d["qe"])]
    assert torch.equal(D.prune_tiles(*args, device="cpu"),
                       D.prune_tiles_torch(*args))
    sargs = [D.take_candidates(d["cand"], 4)] + [
        _t(a) for a in (d["esoa"], d["rsoa"], d["qs"], d["qe"])]
    assert torch.equal(D.descent_scan(*sargs, device="cpu"),
                       D.descent_scan_torch(*sargs))
    assert (D.prune_tiles.launches, D.descent_scan.launches) == before


# the slice rule (layout.slice_tile_spans, mirrored by csrc/slice_span.cuh):
# per case, the TB slices [qs, qe) of one query tile over an arena of
# P = 40 * TP + 7 entries (nt = 41 leaf tiles, NTp = 128)
SPAN_P = 40 * TP + 7
SPAN_NT = -(-SPAN_P // TP)
SPAN_CASES = {
    # qs == qe inside a tile still passes that tile; on a tile edge none
    "degenerate": [(5, 5), (130, 130), (256, 256), (600, 600),
                   (1000, 1000), (3, 3), (129, 129), (5000, 5000)],
    "empty": [(0, 0)] * TB,
    "to_nt": [(SPAN_P - 3, SPAN_P), (SPAN_NT * TP - 1, SPAN_NT * TP),
              (0, SPAN_P), (SPAN_P, SPAN_P), (4000, SPAN_NT * TP),
              (40 * TP, 40 * TP + 1), (0, 0), (SPAN_P - 1, SPAN_P)],
    "overlapping": [(100, 900), (300, 500), (800, 1500), (1400, 1401),
                    (0, 50), (2000, 3000), (2500, 2600), (2999, 3500)],
    "disjoint": [(i * 600 + 10, i * 600 + 300) for i in range(TB)],
}


def _span_slices(case):
    if case != "random":
        qs, qe = np.asarray(SPAN_CASES[case], np.int32).T
        return qs.copy(), qe.copy()
    rng = np.random.default_rng(17)               # four query tiles
    qs = rng.integers(0, SPAN_P, 4 * TB)
    qe = np.minimum(qs + rng.integers(0, 700, 4 * TB), SPAN_P)
    qe[::5] = qs[::5]                             # degenerate ones
    return qs.astype(np.int32), qe.astype(np.int32)


@pytest.mark.parametrize("case", [*SPAN_CASES, "random"])
def test_slice_tile_spans_bound_the_prunes(case):
    """Every leaf tile outside a query tile's merged spans fails the slice
    test for all of its queries, so both prunes (the float32
    ``prune_tiles_torch`` and the quantized ``quantized_prune_mask``)
    give it 0; the spans are exactly the tiles that pass it, merged into
    disjoint ascending intervals."""
    from repro_torch.kernels.range_query.layout import slice_tile_spans

    qs, qe = _span_slices(case)
    B = len(qs)
    d = _inputs(len(case), B, SPAN_P)
    rsoa = d["rsoa"].copy()
    rsoa[:2, ::TB], rsoa[2:, ::TB] = -1e9, 1e9    # one rect covers all
    d.update(rsoa=rsoa, qs=qs, qe=qe)
    ntp = d["fine"].shape[1]
    nt = d["nt"]
    assert nt == SPAN_NT and ntp == 128
    spans = slice_tile_spans(qs, qe, ntp)
    assert len(spans) == B // TB
    inside = np.zeros((B // TB, ntp), bool)
    for i, iv in enumerate(spans):
        assert iv.shape[1] == 2 and len(iv) <= TB
        assert (iv[:, 0] < iv[:, 1]).all() and (iv[1:, 0] > iv[:-1, 1]).all()
        for lo, hi in iv:
            inside[i, lo:hi] = True
    g = np.arange(ntp)[None, :] * TP
    passes = ((g < qe[:, None]) & (g + TP > qs[:, None]))
    assert np.array_equal(inside, passes.reshape(-1, TB, ntp).any(axis=1))
    qf, qc, r16, r32 = _quantized(d)
    masks = (D.prune_tiles_torch(*map(_t, (d["fine"], d["coarse"], rsoa, qs,
                                           qe))).numpy() > 0,
             F.quantized_prune_mask(*map(_t, (qf, qc, r16, r32, qs, qe))
                                    ).numpy())
    full = passes[::TB, :nt]                      # the covering rect's tiles
    for mask in masks:
        assert not mask[~inside].any()
        assert mask[:, :nt][full].all()
    if case == "empty":
        assert not inside.any()
    else:
        assert masks[0].any()
    if case == "degenerate":
        assert [tuple(r) for r in spans[0]] == [(0, 2), (4, 5), (7, 8),
                                                (39, 40)]
    if case == "to_nt":
        assert spans[0][-1, 1] == nt


@pytest.mark.parametrize("K", [1, 3, 16, 64])
@pytest.mark.parametrize("n_query_tiles", [1, 32, 256])
def test_descent_scan_cluster_size(n_query_tiles, K):
    """K3's CTAs per query tile on 132 multiprocessors, K4's and K6's
    choice: 8 (capped at K) while fewer than 132 query tiles leave
    multiprocessors idle, 1 at 256 query tiles."""
    want = {1: 8, 32: 8, 256: 1}[n_query_tiles]
    assert D.scan_cluster_size(n_query_tiles, K, 132) == min(want, K)


@pytest.mark.parametrize("nb,ntp,want", [(32, 77440, 16), (1, 77440, 76),
                                         (32, 12288, 12), (256, 77440, 2),
                                         (1024, 128, 1)])
def test_prune_stripes_fill_the_card(nb, ntp, want):
    """K2's blocks per mask row on a 132-SM card: one wave of 4 blocks of
    256 threads per multiprocessor, never more than one 4-tile step per
    thread, at least one block per row."""
    assert D.prune_stripes(nb, ntp, 132) == want
