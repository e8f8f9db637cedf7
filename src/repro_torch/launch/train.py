"""Training launcher, the recsys arm (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch din \\
        [--steps 100] [--lr 3e-3] [--batch 64] [--full] [--device cpu]

DIN's parameters come from ``init_params`` with an explicit
``torch.Generator`` (seed 0), its batches from ``din_batches`` (64 rows,
as the reference's), and the step from ``make_train_step`` with the
reference's AdamW settings (warm-up 10 steps, cosine to ``--steps``);
the loop prints the reference's lines.  ``--reduced`` (the default)
selects the smoke-scale config, ``--full`` the published widths.  It
trains on ``--device`` (the GPU by default; without CUDA it raises
unless ``--device cpu`` is given).

The LM and GNN families and the reference's checkpoint/restart flags
(``--ckpt-dir``, ``--resume``, ``--crash-at``) wait for their port,
ROADMAP Queue 1 item 13 (``distributed/`` and the model families).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs.registry import get_arch
from ..data import din_batches
from ..device import DeviceLike, resolve_device
from ..train import AdamWConfig, adamw_init, make_train_step

# the reference's other architectures, each waiting for its family's port
LM_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma3-12b",
            "h2o-danube-1.8b", "gemma2-2b")
GNN_ARCHS = ("graphcast", "dimenet", "equiformer-v2", "schnet")


def build(arch_name: str, reduced: bool = True, batch: int = 64,
          device: DeviceLike = None):
    """-> ``(params, loss_fn, data, to_dev)`` for ``arch_name``."""
    dev = resolve_device(device)
    if arch_name in LM_ARCHS or arch_name in GNN_ARCHS:
        family = "lm" if arch_name in LM_ARCHS else "gnn"
        raise NotImplementedError(
            f"{arch_name}: the {family} family comes with the port of its "
            f"models (ROADMAP Queue 1, item 13)")
    spec = get_arch(arch_name)
    cfg = spec.make_config(reduced=reduced)
    from ..models.recsys import din

    params = din.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)

    def loss(p, b):
        return din.loss_fn(p, b, cfg), {}

    data = din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, batch)

    def to_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    return params, loss, data, to_dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="din")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published widths instead of the reduced "
                         "config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the GPU)")
    args = ap.parse_args(argv)

    params, loss_fn, data, to_dev = build(args.arch, args.reduced,
                                          args.batch, args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    opt = adamw_init(params)
    step_fn = make_train_step(loss_fn, opt_cfg)

    t0 = time.perf_counter()
    metrics = {}
    for step in range(args.steps):
        batch = to_dev(next(data))
        params, opt, metrics = step_fn(params, opt, batch)
        if (step + 1) % 10 == 0 or step == 0:
            print(f"[train] step {step + 1} loss "
                  f"{float(metrics['loss']):.4f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
    print(f"[train] done: {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    return params, opt, metrics


if __name__ == "__main__":
    main()
