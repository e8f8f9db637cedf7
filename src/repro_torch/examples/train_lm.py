"""Train a small LM end to end with checkpointing (the port of the
reference's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

The gemma2-style reduced config (softcaps, alternating local/global
attention) on the synthetic token stream, on ``--device`` (the GPU by
default): the loss descends over 120 steps of two microbatches each,
and a checkpoint written at step 60 restores bit for bit.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from ..configs import get_arch
from ..data import lm_batches
from ..device import resolve_device
from ..distributed import restore_checkpoint, save_checkpoint
from ..models.lm import init_params, lm_loss
from ..train import AdamWConfig, adamw_init, make_train_step
from ..train.optim import tree_leaves

STEPS = 120
SAVE_AT = 60


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where to train (default: the GPU)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_arch("gemma2-2b").make_config(reduced=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=STEPS)
    step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt_cfg,
                              grad_accum=2)
    opt = adamw_init(params)

    data = lm_batches(cfg.vocab, seq_len=64, global_batch=16, seed=7)
    t0 = time.perf_counter()
    losses = []
    with tempfile.TemporaryDirectory() as ckdir:
        for step in range(STEPS):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(data).items()}
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            if (step + 1) % 20 == 0:
                print(f"step {step + 1:4d}  loss {losses[-1]:.4f}  "
                      f"lr {float(m['lr']):.2e}  "
                      f"|g| {float(m['grad_norm']):.2f}")
            if step + 1 == SAVE_AT:
                saved = {"params": params, "opt": opt}
                save_checkpoint(ckdir, SAVE_AT, saved)
        # restore and confirm bit-exact parameters and state
        restored, _ = restore_checkpoint(ckdir, saved, step=SAVE_AT)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(restored["params"]) + tree_leaves(restored["opt"].m),
        tree_leaves(saved["params"]) + tree_leaves(saved["opt"].m)))
    print(f"\nfirst-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 {np.mean(losses[-10:]):.4f} "
          f"({time.perf_counter() - t0:.1f}s on {dev.type})")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss must descend"
    print("checkpoint roundtrip + loss descent: OK")
    return losses


if __name__ == "__main__":
    main()
