"""Paper Figure 3: query-time sweeps over the three parameters x methods
(the port of the reference's ``benchmarks/paper_fig3.py``).

1000 queries per parameter value (paper §5.1), median of ``repeats``
runs, µs/query of each method's host path (``batch_query`` with
``engine="host"``, as the reference times it; ``perf_queries`` gives
the device engine's numbers).  A sample of each workload is verified
against the BFS oracle before timing — a benchmark that returns wrong
answers is not a benchmark — on every method's host path and on the
device engine of each 2DReach method (on ``device``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..core import (
    METHODS,
    batch_query,
    build_index,
    engine_for,
    rangereach_oracle_batch,
)
from ..data import get_dataset, workload
from ..data.queries import (
    DEGREE_BUCKETS,
    REGION_EXTENT_VALUES,
    SELECTIVITY_VALUES,
)
from ..device import DeviceLike, resolve_device

DATASETS = ("foursquare", "gowalla", "weeplaces", "yelp")
BENCH_SCALE = 0.5
N_QUERIES = 1000


def _run(indexes, g, us, rects, repeats=3, verify=32,
         device: DeviceLike = None) -> Dict[str, float]:
    want = rangereach_oracle_batch(g, us[:verify], rects[:verify])
    out = {}
    for method, idx in indexes.items():
        got = batch_query(idx, us[:verify], rects[:verify])
        assert (got == want).all(), f"{method} wrong answers"
        if engine_for(idx, device=device) is not None:
            got = batch_query(idx, us[:verify], rects[:verify],
                              engine="device", device=device)
            assert (got == want).all(), f"{method} device wrong answers"
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            batch_query(idx, us, rects)
            times.append(time.perf_counter() - t0)
        out[method] = round(np.median(times) / len(us) * 1e6, 3)
    return out


def sweep(dataset: str, scale: float = BENCH_SCALE,
          n_queries: int = N_QUERIES, repeats: int = 3,
          device: DeviceLike = None) -> List[Dict]:
    dev = resolve_device(device)
    g = get_dataset(dataset, scale=scale)
    indexes = {m: build_index(g, m) for m in METHODS}
    rows = []
    for ratio in REGION_EXTENT_VALUES:
        us, rects = workload(g, n_queries, extent_ratio=ratio, seed=17)
        rows.append(dict(
            dataset=dataset, param="extent", value=ratio,
            **_run(indexes, g, us, rects, repeats, device=dev)))
    for lo, hi in DEGREE_BUCKETS:
        us, rects = workload(g, n_queries, degree_bucket=(lo, hi), seed=18)
        rows.append(dict(
            dataset=dataset, param="degree", value=f"{lo}-{hi}",
            **_run(indexes, g, us, rects, repeats, device=dev)))
    for sel in SELECTIVITY_VALUES:
        us, rects = workload(g, n_queries, selectivity=sel, seed=19)
        rows.append(dict(
            dataset=dataset, param="selectivity", value=sel,
            **_run(indexes, g, us, rects, repeats, device=dev)))
    return rows


def stability(rows: List[Dict]) -> Dict[str, float]:
    """max/min query-time ratio per method across all parameter values —
    the paper's 'stable response times' claim (2DReach ~flat, 3DReach
    spikes orders of magnitude)."""
    out = {}
    for m in METHODS:
        vals = [r[m] for r in rows if m in r]
        out[m] = round(max(vals) / max(min(vals), 1e-9), 1)
    return out
