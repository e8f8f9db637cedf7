"""Quickstart: build a 2DReach index and answer RangeReach queries (the
port of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The index is built on the host; the queries are answered by the host
descent and by the device engine on ``--device`` (the GPU by default),
which must agree.
"""

import argparse

from ..core import (
    batch_query,
    build_index,
    index_nbytes,
    rangereach_oracle_batch,
)
from ..data import get_dataset, workload
from ..device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the device engine serves (default: the "
                         "GPU)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a geosocial graph (scaled synthetic Gowalla: one giant social
    #    SCC, 87% of nodes are venues; see data/lbsn.py for the shaping)
    g = get_dataset("gowalla", scale=0.1)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"{g.n_spatial} spatial (venues)")

    # 2. build the paper's index (compressed variant) and two baselines
    for method in ("2dreach-comp", "2dreach-pointer", "3dreach"):
        idx = build_index(g, method)
        nb = index_nbytes(idx)
        print(f"{method:17s} size {nb['total'] / 1e6:6.2f} MB "
              f"(rtree {nb['rtree'] / 1e6:.2f} / aux {nb['aux'] / 1e6:.2f})")

    # 3. a RangeReach workload (paper defaults: 5% region extent), on the
    #    host and on the device engine
    us, rects = workload(g, n_queries=200, extent_ratio=0.05, seed=0)
    idx = build_index(g, "2dreach-comp")
    ans = batch_query(idx, us, rects)
    dev_ans = batch_query(idx, us, rects, engine="device", device=dev)
    assert (dev_ans == ans).all(), "device engine disagrees with the host"
    print(f"answered 200 queries, {int(ans.sum())} TRUE, the same on "
          f"{dev.type}")

    # 4. verify against the brute-force BFS oracle
    want = rangereach_oracle_batch(g, us[:50], rects[:50])
    assert (ans[:50] == want).all()
    print("first 50 verified against BFS oracle: OK")

    # 5. single-query API (the paper's Fig. 1 running example)
    tiny = get_dataset("tiny")
    idx = build_index(tiny, "2dreach-comp")
    print("Fig.1 RangeReach(a, R) =", idx.query(0, [5.5, 1.5, 6.5, 2.5]))


if __name__ == "__main__":
    main()
