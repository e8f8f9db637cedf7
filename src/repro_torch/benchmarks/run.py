"""Benchmark harness — one section per paper table/figure (the port of the
reference's ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full]
        [--scale 0.5] [--queries 400] [--skip-fig3] [--device cpu]

Sections:
    [table2] graph/SCC statistics per dataset vs the paper's structure
    [table3] index construction time (5 methods x 4 datasets) + claims
    [table4] index size decomposition + claims
    [fig3]   query-time sweeps (3 parameters x 6 methods x 4 datasets)
             + the stability ratio behind the paper's headline claim
    [kernels] the leaf-scan probe (K9, ``range_query_forest``) against
             the host descent on gowalla x0.1, and the dense closure
             product (``bitset_mm_mxu``) at d = 512, on ``--device``

The tables and Figure 3's times are the host's (NumPy builds and
descents, as in the paper); ``--device`` is where Figure 3's oracle
gate also checks each 2DReach method's device engine (the GPU by
default) and where the kernel section runs.  The reference's
``[roofline]`` section (the LM/GNN/recsys dry runs) is not ported: it
waits for the dry runs of ROADMAP Queue 1 item 13.  Writes
``results/torch/paper.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import build_kernels, device_name, result_path


def _section(name):
    print(f"\n===== [{name}] " + "=" * (60 - len(name)))


def report(scale: float, n_q: int, skip_fig3: bool = False,
           device: DeviceLike = None, kernels: bool = False) -> Dict:
    """Every section's rows: ``table2``, ``table3``, ``table4`` (and its
    ``table4_raw`` bytes), ``claims``, unless ``skip_fig3`` the Figure 3
    ``fig3`` rows with each dataset's ``stability``, and with
    ``kernels`` the ``[kernels]`` rows (:func:`kernel_bench`); the
    seconds each took under ``seconds``."""
    from . import paper_fig3, paper_tables

    dev = resolve_device(device)
    out: Dict = {"scale": scale, "queries": n_q, "device": device_name(dev),
                 "seconds": {}}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        out["seconds"][key] = round(time.perf_counter() - t0, 3)

    timed("table2", lambda: paper_tables.table2(scale))
    timed("table3", lambda: paper_tables.table3(scale))
    timed("table4_raw", lambda: paper_tables.table4_raw(scale))
    out["table4"] = paper_tables.table4(raw=out["table4_raw"])
    out["claims"] = paper_tables.check_claims(out["table3"],
                                              out["table4_raw"])
    if not skip_fig3:
        def fig3():
            rows, stab = [], {}
            for ds in paper_fig3.DATASETS:
                r = paper_fig3.sweep(ds, scale, n_queries=n_q, repeats=2,
                                     device=dev)
                rows.extend(r)
                stab[ds] = paper_fig3.stability(r)
            return {"rows": rows, "stability": stab}

        timed("fig3", fig3)
    if kernels:
        timed("kernels", lambda: kernel_bench(dev))
    return out


def kernel_bench(device: DeviceLike = None) -> List[Dict]:
    """The ``[kernels]`` rows: the host descent and the K9 leaf scan on
    512 queries of gowalla x0.1 2dreach-comp (µs/query, answers equal),
    and ``bitset_mm_mxu`` at d = 512 (ms/iter, equal to K7's product);
    each timed on its second call."""
    from ..core import build_index, query_host
    from ..core.reachability import pack_rows
    from ..data import get_dataset, workload
    from ..kernels.bitset_mm import bitset_mm, bitset_mm_mxu, uint32_bits
    from ..kernels.range_query.leafscan import range_query_forest

    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def once(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    g = get_dataset("gowalla", scale=0.1)
    idx = build_index(g, "2dreach-comp")
    us, rects = workload(g, 512, seed=3)
    tid = idx.lookup_tree(us)
    rows = []
    want = None
    for name, fn in (
        ("host_wavefront", lambda: query_host(idx.forest, tid, rects)),
        ("range_query_forest (K9)",
         lambda: range_query_forest(idx.forest, tid, rects, device=dev)),
    ):
        got, dt = once(fn)
        if want is None:
            want = got
        assert (got == want).all(), f"{name} disagrees with the host"
        rows.append({"kernel": name, "us_per_query": dt / len(us) * 1e6,
                     "queries": len(us)})
    rng = np.random.default_rng(0)
    d = 512
    A = uint32_bits(pack_rows(rng.random((d, d)) < 0.01), dev)
    R = uint32_bits(pack_rows(rng.random((d, 2048)) < 0.05), dev)
    got, dt = once(lambda: bitset_mm_mxu(A, R, device=dev))
    assert torch.equal(got, bitset_mm(A, R, device=dev)), \
        "bitset_mm_mxu disagrees with bitset_mm"
    rows.append({"kernel": f"bitset_mm_mxu d={d}", "ms_per_iter": dt * 1e3})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--skip-fig3", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where Figure 3's oracle gate checks the device "
                         "engines (default: the GPU)")
    args = ap.parse_args(argv)
    scale = args.scale or (0.5 if args.full else 0.25)
    n_q = args.queries or (1000 if args.full else 400)
    dev = resolve_device(args.device)

    from . import paper_fig3

    t_start = time.perf_counter()
    build_kernels(dev)
    rep = report(scale, n_q, args.skip_fig3, device=dev, kernels=True)

    _section("table2: graph + SCC statistics (scaled synthetic vs paper)")
    for row in rep["table2"]:
        print(
            f"{row['dataset']:<11} nodes={row['nodes']:>7} "
            f"edges={row['edges']:>8} sccs={row['sccs']:>7} "
            f"user_sccs={row['user_sccs']:>7} "
            f"({row['ours_user_scc_pct']:>5.1f}% ours vs "
            f"{row['paper_user_scc_pct']:>5.1f}% paper) "
            f"distinct_rtrees={row['distinct_rtrees']}"
        )

    _section("table3: index construction time [secs]")
    t3 = rep["table3"]
    methods = [k for k in t3[0] if k != "dataset"]
    print(f"{'dataset':<12}" + "".join(f"{m:>18}" for m in methods))
    for row in t3:
        print(f"{row['dataset']:<12}"
              + "".join(f"{row[m]:>18.3f}" for m in methods))

    _section("table4: index size [MB] (rtree/aux)")
    print(f"{'dataset':<12}" + "".join(f"{m:>22}" for m in methods))
    for row in rep["table4"]:
        print(f"{row['dataset']:<12}"
              + "".join(f"{row[m]:>22}" for m in methods))

    _section("paper claims")
    for line in rep["claims"]:
        print(line)

    if not args.skip_fig3:
        _section("fig3: query time sweeps [us/query]")
        for r in rep["fig3"]["rows"]:
            vals = "".join(f"{r[m]:>12.2f}" for m in paper_fig3.METHODS)
            print(f"{r['dataset']:<11} {r['param']:<12}"
                  f"{str(r['value']):<10}" + vals)
        for ds, stab in rep["fig3"]["stability"].items():
            print(f"{ds:<11} stability max/min ratio: "
                  + ", ".join(f"{m}={v}" for m, v in stab.items()))

    _section(f"kernels on {rep['device']}")
    for r in rep["kernels"]:
        if "us_per_query" in r:
            print(f"{r['kernel']:<26} {r['us_per_query']:>9.2f} us/query "
                  f"({r['queries']} queries)")
        else:
            print(f"{r['kernel']:<26} {r['ms_per_iter']:>9.2f} ms/iter")

    with open(result_path("paper.json"), "w") as f:
        json.dump(rep, f, indent=1)
    print(f"\n[benchmarks] total {time.perf_counter() - t_start:.1f}s")


if __name__ == "__main__":
    main()
