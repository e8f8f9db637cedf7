"""The port's analytics leaf scans (``repro_torch.kernels.range_query
.analytics``) against the JAX package's: ``count_scan_torch`` and
``collect_scan_torch`` against the interpreted ``count_scan_pallas`` /
``collect_scan_pallas`` and the dense references, over compacted
candidate lists cut below, at and above the true candidate count, at
K = 3 and with a row of padding only (rows with no candidate, rows of
repeated padding); tiles outside the arena, which the plain versions
count as misses as the kernels do; ``collect_scan_torch`` with a last
row of padding only; the cluster size of K4's and K6's kernel and K5's
warps per CTA.  Every comparison is exact.
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

from repro.kernels.range_query import analytics as RA
from repro_torch.kernels.range_query import analytics as A
from repro_torch.kernels.range_query.descent import (
    descent_scan_torch,
    prune_tiles_torch,
    take_candidates,
    tile_hits,
)
from repro_torch.kernels.range_query.fused import compact_ascending
from repro_torch.kernels.range_query.layout import ID_SENTINEL, TB, TP
from test_torch_descent import k_cases, last_row_padding, scan_inputs
from test_torch_fused import _t


# K below, at and above the largest true count; K = 3, which no cluster
# of 2, 4 or 8 CTAs divides; K above the count with row 0 all padding
KINDS = ["below", "at", "above", "odd", "padding"]


def cut(cand, mx, kind):
    """Compacted candidates ``cand`` (largest true count ``mx``) cut to
    the K of ``kind`` (see ``KINDS``); "padding" repeats row 0's first
    tile in every slot of the row."""
    K = {"below": max(1, mx // 2), "at": mx, "above": mx + 3, "odd": 3,
         "padding": mx + 3}[kind]
    ck = take_candidates(cand, K).clone()
    if kind == "padding":
        ck[0] = int(ck[0, 0])
    return ck


def _args(d, kind):
    if isinstance(kind, int):
        cand = take_candidates(d["cand"], kind)
    else:
        cand = cut(d["cand"], int(d["cnt"].max()), kind)
    return cand, (d["esoa"], d["rsoa"], d["qs"], d["qe"])


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_count_scan_matches_reference(B, kind):
    d = scan_inputs(20 + B, B)
    k_cases(d)                # the shape the K cases assume
    cand, args = _args(d, kind)
    got = A.count_scan_torch(cand, *map(_t, args))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    want = RA.count_scan_pallas(*_j(cand, *args), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dense = A.count_scan_ref(*map(_t, args))
    assert np.array_equal(dense.numpy(),
                          np.asarray(RA.count_scan_ref(*_j(*args))))
    if kind in ("at", "above"):   # every candidate scanned: the dense truth
        assert torch.equal(got, dense) and got.sum() > 0
    else:
        assert (got <= dense).all()
    if kind == "padding":     # only row 0's first slot counts
        one = take_candidates(d["cand"][:, :1], cand.shape[1])
        first = A.count_scan_torch(one, *map(_t, args))
        assert torch.equal(got[:TB], first[:TB])


@pytest.mark.parametrize("kind", ["below", "at", "above"])
@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_collect_scan_matches_reference(B, kind):
    d = scan_inputs(30 + B, B)
    K = k_cases(d)[kind]
    cand, (esoa, rsoa, qs, qe) = _args(d, K)
    got = A.collect_scan_torch(cand, *map(_t, (esoa, d["ids"], rsoa, qs, qe)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, K * TP)
    want = RA.collect_scan_pallas(*_j(cand, esoa, d["ids"], rsoa, qs, qe),
                                  interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dense = A.collect_scan_ref(*map(_t, (esoa, d["ids"], rsoa, qs, qe)))
    assert np.array_equal(dense.numpy(), np.asarray(
        RA.collect_scan_ref(*_j(esoa, d["ids"], rsoa, qs, qe))))
    if kind != "below":       # the same hit ids as the dense scan
        for b in range(B):
            row, drow = got[b].numpy(), dense[b].numpy()
            assert np.array_equal(np.sort(row[row != ID_SENTINEL]),
                                  np.sort(drow[drow != ID_SENTINEL]))
        assert (got != int(ID_SENTINEL)).any()


@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_collect_scan_on_a_last_row_of_padding_matches_reference(B):
    """K above the true count and the last row all padding: equal to the
    interpreted Pallas kernel; the padded row's first slot holds its
    tile's hits and every later slot of the row is sentinels."""
    d, cand = last_row_padding(60 + B, B)
    args = (d["esoa"], d["ids"], d["rsoa"], d["qs"], d["qe"])
    got = A.collect_scan_torch(cand, *map(_t, args))
    want = RA.collect_scan_pallas(*_j(cand, *args), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    first = A.collect_scan_torch(cand[:, :1].contiguous(), *map(_t, args))
    assert torch.equal(got[-TB:, :TP], first[-TB:])
    assert (first[-TB:] != int(ID_SENTINEL)).any()
    assert (got[-TB:, TP:] == int(ID_SENTINEL)).all()


def test_padding_slots_count_nothing():
    """Compacted rows cut past their count hold repeats of their last
    active tile (query 0 covers the whole arena, so its row's last tile
    holds hits); the repeats add no count, while a scan of the same
    tiles without the duplicate mask would count them again."""
    d = scan_inputs(7, 2 * TB)
    d["qs"][0], d["qe"][0] = 0, d["esoa"].shape[1]
    d["rsoa"][:, 0] = [0.0, 0.0, 100.0, 100.0]
    mask = prune_tiles_torch(*map(_t, (d["fine"], d["coarse"], d["rsoa"],
                                         d["qs"], d["qe"])))
    d["cand"], d["cnt"] = compact_ascending(mask, d["nt"])
    cand, args = _args(d, d["nt"] + 3)
    dup = A.dup_slots(cand)
    live = torch.arange(cand.shape[1])[None, :] < d["cnt"][:, None]
    assert torch.equal(dup[:, 1:], ~live[:, 1:])
    counts = A.count_scan_torch(cand, *map(_t, args))
    assert torch.equal(counts, A.count_scan_ref(*map(_t, args)))
    raw, _ = tile_hits(cand, *map(_t, args))
    raw = raw.sum(dim=2, dtype=torch.int32).reshape(-1)
    assert (raw >= counts).all() and raw[0] > counts[0]


def test_wrappers_on_cpu_run_the_plain_versions():
    d = scan_inputs(8, 2 * TB)
    cand, (esoa, rsoa, qs, qe) = _args(d, 3)
    before = (A.count_scan.launches, A.collect_scan.launches)
    ta = [_t(a) for a in (esoa, rsoa, qs, qe)]
    assert torch.equal(A.count_scan(cand, *ta, device="cpu"),
                       A.count_scan_torch(cand, *ta))
    ca = [_t(a) for a in (esoa, d["ids"], rsoa, qs, qe)]
    assert torch.equal(A.collect_scan(cand, *ca, device="cpu"),
                       A.collect_scan_torch(cand, *ca))
    assert (A.count_scan.launches, A.collect_scan.launches) == before


def _slot_hits(cand, d):
    """(B, K) int — each slot's hits in NumPy, every slot scanned; a
    tile outside the arena hits nothing."""
    cand = cand.numpy()
    ntiles = d["esoa"].shape[1] // TP
    out = np.zeros((len(d["qs"]), cand.shape[1]), np.int64)
    for b in range(len(d["qs"])):
        for k, t in enumerate(cand[b // TB]):
            if not 0 <= t < ntiles:
                continue
            g = np.arange(t * TP, t * TP + TP)
            e, r = d["esoa"][:, g], d["rsoa"][:, b]
            out[b, k] = ((g >= d["qs"][b]) & (g < d["qe"][b])
                         & (e[0] <= r[2]) & (e[1] <= r[3])
                         & (e[2] >= r[0]) & (e[3] >= r[1])).sum()
    return out


def test_tiles_outside_the_arena_are_misses():
    """A slot naming a tile below 0 or at or past P // TP hits nothing
    in the plain versions, as in the kernels, which never read it; the
    padding rule still compares each slot with slot k-1 as it stands."""
    d = scan_inputs(9, 3 * TB)
    ntiles = d["esoa"].shape[1] // TP
    d["qs"][0], d["qe"][0] = 0, d["esoa"].shape[1]    # hits in every tile
    d["rsoa"][:, 0] = [0.0, 0.0, 100.0, 100.0]
    mask = prune_tiles_torch(*map(_t, (d["fine"], d["coarse"], d["rsoa"],
                                         d["qs"], d["qe"])))
    cand, _ = compact_ascending(mask, d["nt"])
    cand = take_candidates(cand, 6).clone()
    cand[0, 2] = ntiles               # past the arena: slots 3.. padding
    cand[1, 0] = -1
    cand[1, 3:] = ntiles + 7
    args = [_t(a) for a in (d["esoa"], d["rsoa"], d["qs"], d["qe"])]
    hits = _slot_hits(cand, d)
    live = ~A.dup_slots(cand).numpy().repeat(TB, axis=0)
    assert np.array_equal(A.count_scan_torch(cand, *args).numpy(),
                          (hits * live).sum(1))
    assert np.array_equal(descent_scan_torch(cand, *args).numpy(),
                          (hits > 0).any(1))
    got = A.collect_scan_torch(cand, _t(d["esoa"]), _t(d["ids"]),
                               *args[1:]).reshape(len(d["qs"]), 6, TP)
    assert np.array_equal((got != int(ID_SENTINEL)).sum(2).numpy(),
                          hits * live)
    assert hits.sum() > 0 and (hits * ~live).sum() > 0


@pytest.mark.parametrize("K", [1, 2, 16])
@pytest.mark.parametrize("n_query_tiles", [1, 32, 132, 256])
def test_scan_cluster_size(n_query_tiles, K):
    """K4's and K6's CTAs per query tile on 132 multiprocessors: K1's
    choice, at most K."""
    want = {1: 8, 32: 8, 132: 1, 256: 1}[n_query_tiles]
    assert A.scan_cluster_size(n_query_tiles, K, 132) == min(want, K)


@pytest.mark.parametrize("K", [1, 3, 16, 64])
@pytest.mark.parametrize("n_query_tiles", [1, 32, 256])
def test_collect_warps(n_query_tiles, K):
    """K5's warps (slots) per CTA on 132 multiprocessors: of 1, 2, 4 and
    8, at most K, the one whose (B/8) * ceil(K / w) CTAs come nearest to
    one a multiprocessor, the wider on a tie."""
    want = {1: {1: 1, 3: 1, 16: 1, 64: 1},
            32: {1: 1, 3: 1, 16: 4, 64: 8},
            256: {1: 1, 3: 2, 16: 8, 64: 8}}[n_query_tiles][K]
    assert A.collect_warps(n_query_tiles, K, 132) == want
