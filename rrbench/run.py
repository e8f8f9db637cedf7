"""Run one cell of the benchmark once on this machine's card.

    python3 rrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, configurations, traffic mixes
and metrics are those of ``BENCHMARK.json`` (see ``rrbench/bench/spec.py``).
The last line of standard output is the result, one JSON object; the
numbers compared for ``correct``, each beside its limit, are the last
lines of standard error.  Exits non-zero, and prints no result, without a
CUDA card, without the program (``src/repro_torch``), or where JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"rrbench: the program is missing ({exc})", file=sys.stderr)
        return 2
    import torch

    from rrbench.bench import cell, spec

    sp = spec.cell_spec(args.workload)
    chips = int(sp["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rrbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    return cell.report(cell.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), device="cuda", cell_spec=sp))


if __name__ == "__main__":
    sys.exit(main())
