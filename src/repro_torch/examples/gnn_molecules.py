"""Train SchNet on batched synthetic molecules; check EquiformerV2's
rotation invariance on the same data (the port of the reference's
``examples/gnn_molecules.py``).

    PYTHONPATH=src python -m repro_torch.examples.gnn_molecules [--device cpu]

On ``--device`` (the GPU by default): the reduced SchNet's MSE descends
over 80 AdamW steps, and a small EquiformerV2's energy of one molecule
is the same, within 1e-3, after a random rotation of its positions.
"""

import argparse
import time

import numpy as np
import torch

from ..data import molecule_batches
from ..device import resolve_device
from ..models.gnn import equiformer_v2, schnet
from ..train import AdamWConfig, adamw_init, make_train_step

STEPS = 80


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where to train (default: the GPU)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = schnet.SchNetConfig(n_interactions=2, d_hidden=32, n_rbf=30)
    params = schnet.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    step_fn = make_train_step(
        lambda p, b: (schnet.loss_fn(p, b, cfg), {}),
        AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=STEPS))
    opt = adamw_init(params)

    data = molecule_batches(n_nodes=12, n_edges=40, batch=16, seed=0)
    losses = []
    t0 = time.perf_counter()
    for step in range(STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 20 == 0:
            print(f"schnet step {step + 1:3d} mse {losses[-1]:.4f}")
    print(f"schnet: {np.mean(losses[:5]):.3f} -> {np.mean(losses[-5:]):.3f} "
          f"({time.perf_counter() - t0:.1f}s on {dev.type})")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "loss must descend"

    # ---- EquiformerV2: energies are rotation-invariant ------------------
    ecfg = equiformer_v2.EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4, n_rbf=8)
    ep = equiformer_v2.init_params(torch.Generator().manual_seed(1), ecfg,
                                   device=dev)
    b = {k: torch.as_tensor(v[0], device=dev)
         for k, v in next(data).items()}
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    rotated = b["pos"] @ torch.as_tensor(Q.T, dtype=torch.float32,
                                         device=dev)
    with torch.no_grad():
        e0 = float(equiformer_v2.apply(ep, b, ecfg))
        e1 = float(equiformer_v2.apply(ep, dict(b, pos=rotated), ecfg))
    print(f"equiformer-v2 energy {e0:.5f} vs rotated {e1:.5f} "
          f"(delta {abs(e0 - e1):.2e})")
    assert abs(e0 - e1) < 1e-3, "energy must be rotation-invariant"
    print("equivariance: OK")
    return losses, (e0, e1)


if __name__ == "__main__":
    main()
