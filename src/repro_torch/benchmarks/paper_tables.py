"""Paper Tables 2-4: graph statistics, build time, index size (the port of
the reference's ``benchmarks/paper_tables.py``).

Datasets are the scaled synthetic LBSNs shaped to the paper's Table 2
statistics (see data/lbsn.py); absolute numbers therefore differ from the
paper by the scale factor, but the paper's *claims* — relative build
times (2DReach < 3DReach), relative sizes (Pointer smallest), SCC
structure — are what these tables verify.  Every build here is the host
build (NumPy), as the paper's and the reference's are.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..core import METHODS, build_index, index_nbytes
from ..data import SPECS, dataset_stats, get_dataset

DATASETS = ("foursquare", "gowalla", "weeplaces", "yelp")
BENCH_SCALE = 0.5


def table2(scale: float = BENCH_SCALE) -> List[Dict]:
    rows = []
    for name in DATASETS:
        g = get_dataset(name, scale=scale)
        s = dataset_stats(g)
        ref = SPECS[name].ref
        idx = build_index(g, "2dreach-comp")
        s["distinct_rtrees"] = int(idx.stats["distinct_rtrees"])
        s["dataset"] = name
        s["paper_user_scc_pct"] = round(
            100 * ref["user_sccs"] / ref["sccs"], 1)
        s["ours_user_scc_pct"] = round(100 * s["user_sccs"] / s["sccs"], 1)
        rows.append(s)
    return rows


def table3(scale: float = BENCH_SCALE, repeats: int = 3) -> List[Dict]:
    rows = []
    for name in DATASETS:
        g = get_dataset(name, scale=scale)
        row = {"dataset": name}
        for method in METHODS:
            if method == "georeach":
                continue  # the paper's Table 3 lists the five index methods
            best = min(
                _timed_build(g, method) for _ in range(repeats)
            )
            row[method] = round(best, 3)
        rows.append(row)
    return rows


def _timed_build(g, method):
    t0 = time.perf_counter()
    build_index(g, method)
    return time.perf_counter() - t0


def table4(scale: float = BENCH_SCALE,
           raw: Optional[List[Dict]] = None) -> List[Dict]:
    """Table 4's cells, ``total (rtree/aux)`` in MB, formatted from
    ``raw`` (:func:`table4_raw`'s rows) when given, else from fresh
    builds at ``scale``."""
    rows = []
    for r in raw if raw is not None else table4_raw(scale):
        row = {"dataset": r["dataset"]}
        for method, nb in r.items():
            if method == "dataset":
                continue
            row[method] = (
                f"{nb['total'] / 1e6:.1f} "
                f"({nb['rtree'] / 1e6:.1f}/{nb['aux'] / 1e6:.1f})"
            )
        rows.append(row)
    return rows


def check_claims(t3: List[Dict], t4raw: List[Dict]) -> List[str]:
    """The paper's headline claims, asserted on our data."""
    out = []
    for row in t3:
        fastest_3d = min(row["3dreach"], row["3dreach-rev"])
        ok = all(
            row[m] < fastest_3d
            for m in ("2dreach", "2dreach-comp", "2dreach-pointer")
        )
        out.append(
            f"T3 {row['dataset']}: all 2DReach builds faster than "
            f"3DReach(-Rev): {'PASS' if ok else 'FAIL'}"
        )
    for row in t4raw:
        sizes = {m: row[m]["total"] for m in row if m != "dataset"}
        smallest = min(sizes, key=sizes.get)
        ok = smallest == "2dreach-pointer"
        out.append(
            f"T4 {row['dataset']}: 2DReach-Pointer smallest index "
            f"({'PASS' if ok else f'FAIL: {smallest}'})"
        )
    return out


def table4_raw(scale: float = BENCH_SCALE) -> List[Dict]:
    rows = []
    for name in DATASETS:
        g = get_dataset(name, scale=scale)
        row = {"dataset": name}
        for method in METHODS:
            if method == "georeach":
                continue
            row[method] = index_nbytes(build_index(g, method))
        rows.append(row)
    return rows
