"""The control of a cell's correctness check, through a run's own check:
the plain reference put in the program's place with its region test in
bfloat16, the precision next below the float32 that the configurations
state.  The check has to find it wrong.

    python3 rrbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it makes a run of the cell as ``rrbench/run.py`` does, at
the cell's sizes, with ``control=True`` (``rrbench/bench/cell.py``): the
graph, the query stream and the window's batches are the run's, the
answers the bfloat16 reference's, and the check and its limits the run's.
It prints one JSON line a seed: ``correct`` and the compared numbers.
It does not run the program, and the benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from rrbench.bench import cell, spec

    sp = spec.cell_spec(args.workload)
    for seed in args.seeds:
        res = cell.run(args.workload, seed, args.seconds, False,
                       device=args.device, cell_spec=sp, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "limits": res["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
