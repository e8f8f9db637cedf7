"""Dry run: every (arch x shape) cell's step counted on ``meta`` tensors
(the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell for a 256- or 512-chip TPU
pod and reads XLA's memory, cost and collective analyses.  The port
compiles no SPMD program: it builds the port's ``Cell`` (inputs as
``meta`` tensors), runs its step once under
:func:`repro_torch.analysis.count_step` (autograd included for train
cells), and also rank 0's step of the production mesh on a
``collectives.CountingMesh``, and records:

    n_devices            1: the count is of the whole cell's step on one
                         device, so ``flops`` and the byte counts are
                         that device's (``benchmarks.roofline`` reads
                         these one-card fields)
    flops, bytes_accessed, hlo_stats
                         the counts (``hlo_stats`` under the reference's
                         name, so ``benchmarks.roofline`` reads both
                         packages' records alike)
    arg_bytes_per_device the inputs' bytes on each chip of the production
                         mesh (``--multi-pod``: 2 x 16 x 16), from the
                         port's sharding rules: a tensor's bytes over the
                         product of the mesh sizes of its sharded dims
    memory_analysis      ``argument_size_in_bytes`` / ``output_size_in_bytes``
                         of the meta inputs and outputs (a decode step's
                         cache, written in place and returned, counts
                         once).  A meta run allocates nothing, so its
                         peak is not measured and there is no
                         ``temp_size_in_bytes``
    mesh_step            rank 0's step of the production mesh
                         (``n_devices`` 256 or 512), its inputs cut to
                         rank 0's blocks by the family's rule
                         (``lm_param_spec``; ``mlp_param_spec`` for the
                         GNN and recsys cells), ZeRO-1's
                         ``opt_state_specs`` and the batch specs (a full
                         graph's nodes and edges over the data axes),
                         run under ``OpStats`` on the counting mesh:
                         ``flops``, ``bytes_accessed`` and
                         ``collectives`` (bytes by kind, the reference's
                         names) per device
    collectives          ``mesh_step``'s, the bytes every crossing of a
                         mesh axis moves per device, under the
                         reference's key and kind names (counted by the
                         code the ranks run, not measured on NCCL)
    outputs              the step's output leaves, (key path, shape, dtype)

Results land in ``results/torch/dryrun/<arch>__<shape>__<mesh>.json``;
``repro_torch.benchmarks.roofline`` reads them.  Nothing here touches a
card: the dry run runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch

from ..analysis.op_stats import OpStats, io_bytes
from ..distributed.collectives import CountingMesh
from ..benchmarks.roofline import RESULTS_DIR
from ..configs import all_cells, get_arch
from ..distributed.sharding import (
    MeshAxes,
    batch_spec,
    lm_param_spec,
    mesh_sizes,
    mlp_param_spec,
    opt_state_specs,
    param_specs,
)
from ..distributed.tree import at, map_leaves, walk
from .mesh import make_production_mesh, mesh_axes

NOTES = {
    "memory_analysis": "argument and output bytes of the meta inputs and "
                       "outputs (an input written in place and returned "
                       "counts once); a meta run allocates nothing, so its "
                       "peak (temp) is not measured",
    "collectives": "mesh_step's collectives, the bytes of each "
                   "collective's result on rank 0 of the production mesh "
                   "(the reference's convention) under lm_param_spec (LM "
                   "cells) or mlp_param_spec (GNN and recsys cells) and "
                   "ZeRO-1, a full graph's nodes and edges split over the "
                   "data axes, tallied by the crossings the process "
                   "mesh's ranks run, not measured on NCCL",
}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def shard_bytes(x: torch.Tensor, spec, mesh) -> float:
    """``x``'s bytes on one device of ``mesh`` under ``spec``."""
    sizes = mesh_sizes(mesh)
    div = 1
    for part in spec:
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax is not None:
                div *= sizes.get(ax, 1)
    return _nbytes(x) / div


def cache_spec(shape, batch: int, axes: MeshAxes, mesh):
    """A decode cache leaf's spec (the reference's ``cache_spec``): the
    dim equal to ``batch`` over the data axes where it divides, then the
    first later dim the model axis divides."""
    if len(shape) == 0:
        return ()
    tp, dsize = axes.model_size(mesh), axes.data_size(mesh)
    parts = [None] * len(shape)
    bi = len(shape) - (3 if len(shape) in (3, 4) else 4)
    for i, d in enumerate(shape):
        if d == batch and batch % dsize == 0 and batch >= dsize:
            parts[i] = axes.data
            bi = i
            break
    for i in range(len(shape)):
        if parts[i] is None and i != 0 and shape[i] % tp == 0 \
                and shape[i] >= tp and i > bi:
            parts[i] = axes.model
            break
    return tuple(parts)


def arg_bytes_per_device(kind: str, family: str, args, mesh,
                         axes: MeshAxes) -> float:
    """Bytes of a cell's inputs on each device of ``mesh``: parameters by
    the family's rule (``lm_param_spec``, else ``mlp_param_spec``), a
    train cell's AdamW state by ZeRO-1 (``opt_state_specs``), a decode
    cell's cache by :func:`cache_spec`, every other input by
    ``batch_spec`` on its leading dim where the data axes divide it."""
    params, rest = args[0], list(args[1:])
    rule = lm_param_spec if family == "lm" else mlp_param_spec
    pspecs = param_specs(params, rule, axes, mesh)
    trees = [(params, pspecs)]
    if kind == "train":
        opt = rest.pop(0)
        trees.append((opt, opt_state_specs(opt, params, pspecs, axes,
                                           mesh)))
    if kind == "decode":
        cache, token = rest
        B = token.shape[0]
        trees.append((cache, map_leaves(
            lambda _, x: cache_spec(tuple(x.shape), B, axes, mesh), cache)))
        rest = [token]
    dsize = axes.data_size(mesh)

    def lead(_, x):
        if x.dim() and x.shape[0] % dsize == 0 and x.shape[0] >= dsize:
            return batch_spec(axes)
        return ()

    trees += [(t, map_leaves(lead, t)) for t in rest]
    total = 0.0
    for tree, specs in trees:
        for path, x in walk(tree):
            total += shard_bytes(x, at(specs, path), mesh)
    return total


def compute_dtype(arch: str) -> str:
    """The dtype of a cell's products: the LM config's, float32 for the
    GNN and recsys families (cuBLAS without TF32)."""
    spec = get_arch(arch)
    if spec.family == "lm":
        return str(spec.make_config().dtype).replace("torch.", "")
    return "float32"


def _leaves(out) -> list:
    return [[path, list(x.shape), str(x.dtype).replace("torch.", "")]
            for path, x in walk(out) if isinstance(x, torch.Tensor)]


def mesh_step(cell, mesh) -> Dict[str, Any]:
    """Rank 0's step of ``cell`` on the mesh ``mesh`` (``{axis: size}``)
    counted on a counting mesh: per device ``flops``, ``bytes_accessed``
    and ``collectives`` (bytes by kind and ``total``)."""
    fn, args = cell.build(CountingMesh(mesh))
    with OpStats() as st:
        fn(*args)
    stats = st.stats()
    return {"n_devices": math.prod(mesh.values()), "flops": stats["flops"],
            "bytes_accessed": stats["bytes"],
            "collectives": stats["collectives"], "ok": True}


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             save: bool = True) -> Dict[str, Any]:
    """Count one cell's step on meta and record it (saved under
    ``RESULTS_DIR`` with ``save``); ``ok`` is false, with the error,
    where the step raised."""
    mesh, axes = make_production_mesh(multi_pod=multi_pod), mesh_axes(
        multi_pod)
    spec = get_arch(arch)
    cell = spec.cells[shape]
    meshname = mesh_name(multi_pod)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": meshname, "n_devices": 1,
        "mesh_devices": math.prod(mesh.values()),
        "kind": cell.kind, "family": spec.family,
    }
    t0 = time.perf_counter()
    try:
        fn, args = cell.build()
        with OpStats() as st:
            out = fn(*args)
        stats = st.stats()
        rec["compute_dtype"] = compute_dtype(arch)
        rec["flops"] = stats["flops"]
        rec["bytes_accessed"] = stats["bytes"]
        rec["hlo_stats"] = stats
        io = io_bytes(args, out)
        rec["memory_analysis"] = {
            "argument_size_in_bytes": io["argument"],
            "output_size_in_bytes": io["output"]}
        rec["arg_bytes_per_device"] = arg_bytes_per_device(
            cell.kind, spec.family, args, mesh, axes)
        rec["mesh_step"] = mesh_step(cell, mesh)
        rec["collectives"] = rec["mesh_step"]["collectives"]
        rec["notes"] = NOTES
        rec["outputs"] = _leaves(out)
        rec["t_count_s"] = round(time.perf_counter() - t0, 2)
        rec["ok"] = True
        print(f"[dryrun] {arch} x {shape} x {meshname}: OK "
              f"(count {rec['t_count_s']:.1f}s, flops {rec['flops']:.3e}, "
              f"hbm floor {stats['hbm_floor_bytes']:.3e} B, "
              f"{stats['n_ops']} ops)")
    except Exception as e:    # recorded: the --all run goes on
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape} x {meshname}: FAIL {rec['error']}")
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{meshname}.json")
        with open(path, "w") as f:
            json.dump({k: v for k, v in rec.items() if k != "traceback"}, f,
                      indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        ok = fail = 0
        t0 = time.perf_counter()
        for arch, shape, _ in all_cells():
            path = os.path.join(
                RESULTS_DIR,
                f"{arch}__{shape}__{mesh_name(args.multi_pod)}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        ok += 1
                        continue
            rec = run_cell(arch, shape, args.multi_pod)
            ok += rec["ok"]
            fail += not rec["ok"]
        print(f"[dryrun] done: {ok} ok, {fail} failed "
              f"({time.perf_counter() - t0:.1f}s)")
        return 1 if fail else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    return 0 if run_cell(args.arch, args.shape, args.multi_pod)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
