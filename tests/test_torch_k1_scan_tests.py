"""``QueryEngine.stats["k1_scan_tests"]`` on the CPU: the box tests the
fused serve's scan performs, summed over every launch with the ratchet's
re-runs, against ``sum(min(cnt, kcap)) * TP * TB`` computed from each
launch's own ``cnt``; on batches that need no re-run, ``tiles_scanned *
TP * TB``; and nothing on the two-phase path, which never launches the
fused kernel."""

import numpy as np
import pytest

from repro_torch.core import QueryEngine, build_index
from repro_torch.core import engine as E
from repro_torch.data import get_dataset, workload
from repro_torch.kernels.range_query.layout import TB, TP


@pytest.fixture(scope="module")
def served():
    g = get_dataset("yelp", scale=0.05)
    idx = build_index(g, "2dreach-comp")
    batches = [workload(g, 300, extent_ratio=0.05, seed=s) for s in (1, 2)]
    return g, idx, batches


@pytest.fixture
def launches(monkeypatch):
    """Every fused launch's ``(kcap, cnt)``."""
    seen = []

    def fused_serve(*args, **kw):
        out, cnt = real(*args, **kw)
        seen.append((kw["kcap"], cnt.clone()))
        return out, cnt

    real = E.fused_serve
    monkeypatch.setattr(E, "fused_serve", fused_serve)
    return seen


def _tests(launches):
    return sum(int(np.minimum(cnt.numpy(), kcap).sum())
               for kcap, cnt in launches) * TP * TB


def _call(eng, mode, us, rects):
    if mode == "reach":
        return eng.query_batch(us, rects)
    if mode == "count":
        return eng.count_batch(us, rects)
    if mode == "collect":
        return eng.collect_batch(us, rects, 4)
    pts = np.asarray(rects)[:, :2]
    return eng.knn_batch(us, pts, 3)


@pytest.mark.parametrize("mode", ["reach", "count", "collect", "knn"])
def test_scan_tests_over_a_rerun(served, launches, mode):
    _, idx, batches = served
    eng = QueryEngine(idx, device="cpu")       # capacity 1: re-runs
    _call(eng, mode, *batches[0])
    assert eng.stats["fused_reruns"] >= 1
    # the truncated launch scanned its capacity, not its count
    kcap, cnt = launches[0]
    assert int(cnt.max()) > kcap
    assert eng.stats["k1_scan_tests"] == _tests(launches) > 0


@pytest.mark.parametrize("mode", ["reach", "count", "collect"])
def test_scan_tests_without_a_rerun(served, launches, mode):
    _, idx, batches = served
    eng = QueryEngine(idx, device="cpu")
    for b in batches:                          # ratchet the capacity
        _call(eng, mode, *b)
    before = dict(eng.stats)
    del launches[:]
    for b in batches:
        _call(eng, mode, *b)
    d = {k: eng.stats[k] - before[k] for k in before}
    assert d["fused_reruns"] == 0 and len(launches) == len(batches)
    assert d["k1_scan_tests"] == d["tiles_scanned"] * TP * TB > 0
    assert d["k1_scan_tests"] == _tests(launches)


def test_two_phase_path_counts_no_fused_scan(served, launches):
    _, idx, batches = served
    eng = QueryEngine(idx, device="cpu", path="two_phase")
    for mode in ("reach", "count", "collect"):
        _call(eng, mode, *batches[0])
    assert eng.stats["k1_scan_tests"] == 0 and not launches
    assert eng.stats["tiles_scanned"] > 0
