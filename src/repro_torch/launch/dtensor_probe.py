"""Which DTensor calls a gloo rank survives on a CUDA ``DeviceMesh``: the
case behind ``distributed.collectives.full``'s plain gathers.

Each case runs in four gloo ranks of its own (a (2, 2) process mesh,
every rank on the one card, ``launch.mesh.init_ranks``) on an (8, 4)
float32 tensor split as ``[Shard(0), Shard(1)]``:

* ``distribute_tensor`` — ``distribute_tensor(x, mesh, places,
  src_data_rank=None)`` (what ``elastic.reshard`` calls; no collective);
* ``all_gather`` — ``collectives.full``, plain ``all_gather``s over each
  mesh dim's group;
* ``full_tensor`` — DTensor's own gather.

Each case prints its exit code (a negative code is the signal that
killed a rank) and whether its gathered tensor equals ``x``.  Needs a
GPU:

    PYTHONPATH=src python -m repro_torch.launch.dtensor_probe
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

CASES = ("distribute_tensor", "all_gather", "full_tensor")


def _rank(r: int, world: int, store: str, case: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.distributed import collectives as CO
    from repro_torch.launch.mesh import init_ranks, make_process_mesh

    faulthandler.enable()
    dev = init_ranks("gloo", store=store, rank=r, world_size=world,
                     device="cuda")
    pm = make_process_mesh(2, 2, dev)
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    places = [Shard(0), Shard(1)]
    d0, m0 = divmod(r, 2)
    mine = x[4 * d0:4 * d0 + 4, 2 * m0:2 * m0 + 2]
    if case == "distribute_tensor":
        d = distribute_tensor(x, pm, places, src_data_rank=None)
        ok = torch.equal(d.to_local().cpu(), mine)
    else:
        d = DTensor.from_local(mine.to(dev), pm, places, run_check=False,
                               shape=x.shape, stride=x.stride())
        got = CO.full(d) if case == "all_gather" else d.full_tensor()
        ok = torch.equal(got.cpu(), x)
    if not ok:
        raise AssertionError(f"{case}: rank {r}'s tensor differs")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) > 1:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as d:
            mp.spawn(_rank, args=(4, os.path.join(d, "store"), sys.argv[1]),
                     nprocs=4)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("dtensor_probe: needs a GPU", file=sys.stderr)
        return 2
    out = {"torch": torch.__version__, "cases": {}}
    for case in CASES:
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dtensor_probe",
             case], capture_output=True, text=True, timeout=300)
        died = [ln for ln in p.stderr.splitlines()
                if "terminated with signal" in ln or "Error" in ln]
        out["cases"][case] = {"rc": p.returncode, "died": died[-1:]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
