"""Training launcher with checkpoint/restart fault tolerance (the port of
``repro.launch.train``), its LM, GNN and recsys arms.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b [--steps 100] [--lr 3e-3] [--batch B] \\
        [--full] [--device cpu] \\
        [--ckpt-dir DIR [--ckpt-every 25] [--resume] [--crash-at N]]

Parameters come from ``init_params`` with an explicit
``torch.Generator`` (seed 0); batches from ``lm_batches`` (8 rows of 32
tokens, as the reference's), ``din_batches`` (64 rows) or, for a GNN,
``molecule_batches`` (8 molecules of 12 atoms and 32 edges; DimeNet's
triplets built on the host with a budget of 128 a molecule); the step from
``make_train_step`` with the reference's AdamW settings (warm-up 10
steps, cosine to ``--steps``).  ``--reduced`` (the default) selects the
smoke-scale config, ``--full`` the published widths.  It trains on
``--device`` (the GPU by default; without CUDA it raises unless
``--device cpu`` is given).

The loop shows the reference's posture end to end: step-keyed data
(a resumed run skips the stream forward to its step), bounded-async
checkpoints every ``--ckpt-every`` steps and at the end (with
``--ckpt-dir``), restore on ``--resume``, and crash injection with
``--crash-at`` (after that step's checkpoint is on disk).  It prints the
reference's lines: ``[train] resumed from step N``, ``[train] step N
loss X (Ts)`` every 10 steps and at the first, ``[train] done``.

GraphCast regresses node features: the reference draws them inside its
loss from ``PRNGKey(1)``, the same every step; the port draws them once
from a ``torch.Generator`` seeded 1 and ``to_dev`` attaches them to
every batch as ``feat``, with the target 0.9 times them.
"""

from __future__ import annotations

import argparse
import time

import importlib

import numpy as np
import torch

from ..configs.registry import get_arch
from ..data import din_batches, lm_batches, molecule_batches
from ..device import DeviceLike, resolve_device
from ..distributed import CheckpointManager, latest_step, restore_checkpoint
from ..train import AdamWConfig, adamw_init, make_train_step

# rows (molecules for a GNN) a batch when --batch is not given: the
# reference's
BATCH = {"lm": 8, "recsys": 64, "gnn": 8}
LM_SEQ = 32
GNN_NODES, GNN_EDGES, GNN_TRIPLETS = 12, 32, 128   # a molecule


def build(arch_name: str, reduced: bool = True, batch=None,
          device: DeviceLike = None):
    """-> ``(params, loss_fn, data, to_dev)`` for ``arch_name`` (the
    reference's ``build_reduced``, and the published widths when
    ``reduced`` is false)."""
    dev = resolve_device(device)
    spec = get_arch(arch_name)
    cfg = spec.make_config(reduced=reduced)
    batch = BATCH[spec.family] if batch is None else batch
    gen = torch.Generator().manual_seed(0)
    if spec.family == "lm":
        from ..models.lm import init_params, lm_loss

        params = init_params(gen, cfg, device=dev)

        def loss(p, b):
            return lm_loss(p, b, cfg)

        data = lm_batches(cfg.vocab, LM_SEQ, batch)
    elif spec.family == "gnn":
        return _build_gnn(arch_name, cfg, batch, gen, dev)
    else:
        from ..models.recsys import din

        params = din.init_params(gen, cfg, device=dev)

        def loss(p, b):
            return din.loss_fn(p, b, cfg), {}

        data = din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, batch)

    def to_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    return params, loss, data, to_dev


def _build_gnn(arch_name, cfg, batch, gen, dev):
    """The GNN arm of :func:`build`: batched molecules (GraphCast's
    carry its features, ``feat``, the same every step)."""
    mod = importlib.import_module(
        f"..models.gnn.{arch_name.replace('-', '_')}", __package__)
    params = mod.init_params(gen, cfg, device=dev)
    data = molecule_batches(GNN_NODES, GNN_EDGES, batch)
    extra = {}
    if arch_name == "graphcast":
        extra["feat"] = torch.randn(
            (batch, GNN_NODES, cfg.n_vars),
            generator=torch.Generator().manual_seed(1)).to(dev)

    def to_dev(b):
        if arch_name == "dimenet":
            trip = [mod.build_triplets(s, d, GNN_NODES, GNN_TRIPLETS)
                    for s, d in zip(b["edge_src"], b["edge_dst"])]
            b = dict(b, **{k: np.stack(v) for k, v in zip(
                ("id_kj", "id_ji", "triplet_mask"), zip(*trip))})
        return {**{k: torch.as_tensor(v, device=dev) for k, v in b.items()},
                **extra}

    if arch_name == "graphcast":
        def loss(p, b):
            b = {k: v for k, v in b.items() if k != "energy"}
            return mod.molecule_loss(p, dict(b, target=b["feat"] * 0.9),
                                     cfg), {}
    else:
        def loss(p, b):
            return mod.loss_fn(p, b, cfg), {}
    return params, loss, data, to_dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published widths instead of the reduced "
                         "config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a batch (default: 8 for an LM or a GNN's "
                         "molecules, 64 for DIN)")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the GPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint of --ckpt-dir")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="inject a crash after this step (testing)")
    args = ap.parse_args(argv)
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume needs --ckpt-dir")

    params, loss_fn, data, to_dev = build(args.arch, args.reduced,
                                          args.batch, args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    opt = adamw_init(params)
    step_fn = make_train_step(loss_fn, opt_cfg)

    start = 0
    if args.resume:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state, _ = restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    # skip the pipeline forward to the resume point (step-keyed data)
    for _ in range(start):
        next(data)
    t0 = time.perf_counter()
    metrics = {}
    for step in range(start, args.steps):
        batch = to_dev(next(data))
        params, opt, metrics = step_fn(params, opt, batch)
        if (step + 1) % 10 == 0 or step == start:
            print(f"[train] step {step + 1} loss "
                  f"{float(metrics['loss']):.4f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt})
        if args.crash_at == step + 1:
            if mgr:
                mgr.close()
            raise RuntimeError(f"injected crash at step {step + 1}")
    if mgr:
        mgr.save_async(args.steps, {"params": params, "opt": opt})
        mgr.close()
    print(f"[train] done: {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    return params, opt, metrics


if __name__ == "__main__":
    main()
