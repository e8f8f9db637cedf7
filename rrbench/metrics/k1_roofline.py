"""k1_roofline: the least time the traced window's batches need from the
leaf scan (``rrbench/bench/work.py``: counted from the index's forest and
the queries, bounded by operations or bytes), over the device time of the
fused serve kernel (K1, ``fused_serve_kernel``) in that window.

Every batch of the window is new, so the least time is counted exactly
for ``SAMPLED_BATCHES`` of its batches, drawn from the seed, and their
mean is taken for each batch: the batches are draws of 65,536 queries
from one distribution, whose least times differ by a fraction of a
percent."""

import sys

import numpy as np

from rrbench.bench import trace, work

SAMPLED_BATCHES = 4


def read(ctx):
    k1_s = trace.kernel_seconds(ctx["trace"], "fused_serve_kernel")
    if k1_s <= 0:
        return None
    index, stream, seq = ctx["index"], ctx["stream"], ctx["sequence"]
    forest = index.forest
    tiles = work.Tiles(forest.entries, forest.entry_off, forest.fanout,
                       ctx["device"])
    picks = np.random.default_rng([4, ctx["seed"]]).choice(
        len(seq), size=min(SAMPLED_BATCHES, len(seq)), replace=False)
    ws = []
    for i in picks:
        us, rects = stream.queries(seq[i])
        trees = np.where(index.excluded[us], -1, index.lookup_tree(us))
        ws.append(work.batch_work(tiles, trees, rects, ctx["mode"]))
    per = {k: float(np.mean([w[k] for w in ws]))
           for k in ("bound_s", "op_s", "byte_s", "tests")}
    spread = (max(w["bound_s"] for w in ws) / min(w["bound_s"] for w in ws)
              - 1.0) if min(w["bound_s"] for w in ws) > 0 else 0.0
    bound_s = per["bound_s"] * len(seq)
    print(f"k1_roofline: K1 {k1_s:.6f} s over {len(seq)} batches; least "
          f"time a batch {per['bound_s']:.9f} s (operations "
          f"{per['op_s']:.9f} s, bytes {per['byte_s']:.9f} s, "
          f"{per['tests'] / stream.batch:.1f} box tests a query; "
          f"{len(ws)} batches counted, spread {100 * spread:.3f}%)",
          file=sys.stderr, flush=True)
    return 100.0 * bound_s / k1_s
