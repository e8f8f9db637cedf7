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

The tables and Figure 3's times are the host's (NumPy builds and
descents, as in the paper); ``--device`` is where Figure 3's oracle
gate also checks each 2DReach method's device engine (the GPU by
default).  The reference's ``[kernels]`` section (the leaf-scan probe
and the MXU closure product, which the port lacks) and its
``[roofline]`` section (LM dry runs) are not ported.  Writes
``results/torch/paper.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

from ..device import DeviceLike, resolve_device
from . import build_kernels, device_name, result_path


def _section(name):
    print(f"\n===== [{name}] " + "=" * (60 - len(name)))


def report(scale: float, n_q: int, skip_fig3: bool = False,
           device: DeviceLike = None) -> Dict:
    """Every section's rows: ``table2``, ``table3``, ``table4`` (and its
    ``table4_raw`` bytes), ``claims``, and unless ``skip_fig3`` the
    Figure 3 ``fig3`` rows with each dataset's ``stability``; the
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
    return out


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
    rep = report(scale, n_q, args.skip_fig3, device=dev)

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

    with open(result_path("paper.json"), "w") as f:
        json.dump(rep, f, indent=1)
    print(f"\n[benchmarks] total {time.perf_counter() - t_start:.1f}s")


if __name__ == "__main__":
    main()
