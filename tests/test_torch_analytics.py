"""The port's analytics leaf scans (``repro_torch.kernels.range_query
.analytics``) against the JAX package's: ``count_scan_torch`` and
``collect_scan_torch`` against the interpreted ``count_scan_pallas`` /
``collect_scan_pallas`` and the dense references, over compacted
candidate lists cut below, at and above the true candidate count (rows
with no candidate, rows of repeated padding).  Every comparison is
exact.
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
    prune_tiles_torch,
    take_candidates,
    tile_hits,
)
from repro_torch.kernels.range_query.fused import compact_ascending
from repro_torch.kernels.range_query.layout import ID_SENTINEL, TB, TP
from test_torch_descent import k_cases, scan_inputs
from test_torch_fused import _t


def _args(d, K):
    cand = take_candidates(d["cand"], K)
    return cand, (d["esoa"], d["rsoa"], d["qs"], d["qe"])


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", ["below", "at", "above"])
@pytest.mark.parametrize("B", [TB, 3 * TB])
def test_count_scan_matches_reference(B, kind):
    d = scan_inputs(20 + B, B)
    cand, args = _args(d, k_cases(d)[kind])
    got = A.count_scan_torch(cand, *map(_t, args))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    want = RA.count_scan_pallas(*_j(cand, *args), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    dense = A.count_scan_ref(*map(_t, args))
    assert np.array_equal(dense.numpy(),
                          np.asarray(RA.count_scan_ref(*_j(*args))))
    if kind != "below":       # every candidate scanned: the dense truth
        assert torch.equal(got, dense) and got.sum() > 0
    else:
        assert (got <= dense).all()


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
