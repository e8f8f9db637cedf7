"""The two sides of ``tests/test_torch_mesh_mlp.py``, each run in a
process of its own on the CPU, each writing what it computed to
``.npz`` files:

    python tests/torch_mesh_mlp_runs.py ranks INPUTS OUT
        the port: four gloo ranks (``torch.multiprocessing`` spawn, a
        ``file://`` store under OUT) over the meshes of ``MESHES``; one
        ``rank<r>.npz`` a rank.  Imports no JAX.
    python tests/torch_mesh_mlp_runs.py reference INPUTS OUT PART
        the reference on four CPU devices, part PART (0 or 1) of its
        cases (``reference_part``: two processes halve the compile
        time); the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (it must
        be set before JAX is imported).  Writes ``reference<PART>.npz``.

INPUTS is an ``.npz`` of what both take (``tests/test_torch_mesh_mlp.py``
makes it: the reduced GNNs' and DIN's parameters from the reference's
``init_params``, carried across by ``convert``, and NumPy batches).
Keys are ``/``-joined paths; a rank's results are its local shards, the
reference's the global arrays.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from torch_mesh_runs import ADAMW, MESHES, _path, tree_from

GNN_ARCHS = ("schnet", "dimenet", "graphcast", "equiformer-v2")
CELLS = ("graph", "molecule")       # a full graph, a batch of molecules
GNN_CASES = tuple((m, a, c) for m in ("1x4", "2x2") for a in GNN_ARCHS
                  for c in CELLS) + (("4x1", "dimenet", "graph"),)
DIN_MESHES = ("1x4", "2x2")
SERVE_MESH = "1x4"
RETRIEVAL_MESHES = ("2x2", "4x1")   # 48 and 24 candidates a rank
TALLY_CASES = (("2x2", "dimenet", "graph"), ("2x2", "din", "train"))
# the full graph: nodes, edges (the last N_PAD masked 0 -> 0), DimeNet's
# triplet budget, the feature width of the non-GraphCast models; each
# divides over 4 data ranks
GRAPH = dict(n=16, e=48, n_pad=8, triplets=128, d_feat=6)
# the molecules: the launcher's 12 atoms and 32 edges, 8 a batch, species
# from the whole table (so each rank of a row-split table looks some up)
MOLECULES = dict(n=12, e=32, batch=8, triplets=128, n_species=100)
DIN_B, DIN_SERVE_B = 16, 8
DIN_CANDIDATES, DIN_CHUNK = 96, 32
# ids outside [-V, V) (NaN in both) and in [-V, 0) (wrap), V = 1,000:
# (row, column or -1 for the target, id)
DIN_BAD = ((0, 3, 1000), (1, -1, -1001), (2, 5, -7), (3, -1, -1000))


def reference_part(case) -> int:
    """Which reference process computes a GNN case, or ``"din"``: the
    (1, 4) GNN cases and DIN in one, the rest in the other."""
    return 0 if case == "din" or case[0] == "1x4" else 1


def gnn_key(mesh: str, arch: str, cell: str) -> str:
    return f"gnn/{mesh}/{arch}/{cell}"


def gnn_config(arch: str, cell: str, configs):
    """The reduced config of ``arch`` (``configs``: either package's
    registry), with a feature encoder on the full graph."""
    import dataclasses

    cfg = configs.get_arch(arch).make_config(reduced=True)
    if cell == "graph" and arch != "graphcast":
        cfg = dataclasses.replace(cfg, d_feat=GRAPH["d_feat"])
    return cfg


def graph_batch(rng, arch: str, cfg) -> dict:
    """One graph: ``n`` nodes, ``e`` edges whose last ``n_pad`` are
    masked 0 -> 0, the last node masked; features (GraphCast: ``n_vars``
    and a target; the others ``d_feat`` and an energy); DimeNet's
    triplets."""
    from repro_torch.models.gnn.dimenet import build_triplets

    n, e, n_pad = GRAPH["n"], GRAPH["e"], GRAPH["n_pad"]
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    src[e - n_pad:] = dst[e - n_pad:] = 0
    b = {"pos": rng.standard_normal((n, 3)).astype(np.float32) * 1.5,
         "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
         "edge_mask": np.arange(e) < e - n_pad,
         "node_mask": np.arange(n) < n - 1}
    if arch == "graphcast":
        b["feat"] = rng.standard_normal((n, cfg.n_vars)).astype(np.float32)
        b["target"] = rng.standard_normal((n, cfg.n_vars)).astype(
            np.float32)
    else:
        b["feat"] = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
        b["energy"] = np.asarray(rng.standard_normal(), np.float32)
    if arch == "dimenet":
        kj, ji, tm = build_triplets(src, dst, n, GRAPH["triplets"])
        b.update(id_kj=kj, id_ji=ji, triplet_mask=tm)
    return b


def molecule_batch(arch: str, cfg, seed: int) -> dict:
    """The pipeline's molecules (DimeNet's triplets a molecule, GraphCast's
    features and target in place of the energy)."""
    from repro_torch.data import molecule_batches
    from repro_torch.models.gnn.dimenet import build_triplets

    m = MOLECULES
    b = next(molecule_batches(m["n"], m["e"], m["batch"],
                              n_species=m["n_species"], seed=seed))
    if arch == "dimenet":
        trip = [build_triplets(s, d, m["n"], m["triplets"])
                for s, d in zip(b["edge_src"], b["edge_dst"])]
        b.update({k: np.stack(v) for k, v in zip(
            ("id_kj", "id_ji", "triplet_mask"), zip(*trip))})
    if arch == "graphcast":
        rng = np.random.default_rng(seed)
        b.pop("energy")
        b["feat"] = rng.standard_normal(b["pos"].shape[:2] + (
            cfg.n_vars,)).astype(np.float32)
        b["target"] = b["feat"] * 0.9
    return b


def din_batches(rng, cfg) -> dict:
    """DIN's train batch, serving batch (with DIN_BAD's ids written in a
    copy) and one user's history with its candidates."""
    V = cfg.n_items

    def rows(B, label):
        b = {"hist_items": rng.integers(0, V, (B, cfg.seq_len)).astype(
                np.int32),
             "hist_mask": rng.random((B, cfg.seq_len)) < 0.8,
             "target_item": rng.integers(0, V, B).astype(np.int32)}
        if label:
            b["label"] = (rng.random(B) < 0.3).astype(np.float32)
        return b

    serve = rows(DIN_SERVE_B, False)
    bad = {k: v.copy() for k, v in serve.items()}
    for r, c, v in DIN_BAD:
        if c < 0:
            bad["target_item"][r] = v
        else:
            bad["hist_items"][r, c] = v
    return {"train": rows(DIN_B, True), "serve": serve, "bad": bad,
            "retrieval": {
                "hist_items": rng.integers(0, V, cfg.seq_len).astype(
                    np.int32),
                "hist_mask": rng.random(cfg.seq_len) < 0.8,
                "candidates": rng.integers(0, V, DIN_CANDIDATES).astype(
                    np.int32)}}


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------

def _tensors(tree):
    import torch
    from repro_torch.distributed.tree import map_leaves

    return map_leaves(lambda _, v: torch.as_tensor(v), tree)


def gnn_case(z, arch, cell, mesh):
    """(loss function, parameters, batch, batch specs) of a GNN case on
    ``mesh``, the cell's own loss as ``configs.base`` builds it."""
    from repro_torch import configs
    from repro_torch.configs import base as CB

    pre = f"gnn/{arch}/{cell}"
    cfg = gnn_config(arch, cell, configs)
    module = __import__(f"repro_torch.models.gnn.{arch.replace('-', '_')}",
                        fromlist=["apply"])
    batched = cell == "molecule"
    batch = _tensors(tree_from(z, f"{pre}/batch/"))
    return (CB._gnn_loss(arch, module, cfg, batched, mesh),
            _tensors(tree_from(z, f"{pre}/params/")), batch,
            CB.gnn_batch_specs(batch, batched, mesh))


def din_case(z, mesh):
    from repro_torch import configs

    cfg = configs.get_arch("din").make_config(reduced=True)
    return cfg, _tensors(tree_from(z, "din/params/"))


def step_tally(loss_fn, params, batch, mesh, specs=None):
    """The bytes by kind of one train step's crossings on ``mesh``."""
    from repro_torch.configs.base import train_state
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed import mlp_param_spec
    from repro_torch.train import AdamWConfig, make_train_step

    dt, opt = train_state(params, mlp_param_spec, mesh)
    step = make_train_step(loss_fn, AdamWConfig(**ADAMW), mesh=mesh,
                           batch_specs=specs)
    with CO.Tally() as t:
        step(dt, opt, batch)
    return t.bytes


def split_leaves(tree) -> int:
    """How many placed leaves of ``tree`` this rank holds a block of."""
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed.tree import walk

    return sum(CO.local(v).shape != v.shape for _, v in walk(tree))


def _grads_and_step(pm, loss_fn, params, batch, specs, res, key):
    """The loss and every gradient (summed over ``data``) on this rank's
    leaves and batch block, then one AdamW step of ``make_train_step``."""
    import torch
    from repro_torch.configs.base import train_state
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed import mlp_param_spec
    from repro_torch.distributed.tree import map_leaves, walk
    from repro_torch.train import AdamWConfig, make_train_step

    dt, opt = train_state(params, mlp_param_spec, pm)
    xs = {}
    local = map_leaves(lambda k, v: xs.setdefault(
        k, CO.local(v).detach().requires_grad_(True)), dt)
    if specs is None:
        blk = {k: CO.rows_of(v, pm) for k, v in batch.items()}
    else:
        blk = {k: CO.block(v, pm, specs[k]) for k, v in batch.items()}
    loss, _ = loss_fn(local, blk)
    grads = torch.autograd.grad(loss, list(xs.values()), allow_unused=True)
    res[f"{key}/loss"] = loss.detach().numpy()
    for (k, x), g in zip(xs.items(), grads):
        g = torch.zeros_like(x) if g is None else g
        res[f"{key}/grad/{k}"] = CO.all_reduce(g, pm, "data").numpy()
    res[f"{key}/split"] = np.asarray(
        split_leaves((dt, opt)) + sum(b.shape != v.shape for b, v in zip(
            blk.values(), batch.values())))
    step = make_train_step(loss_fn, AdamWConfig(**ADAMW), mesh=pm,
                           batch_specs=specs)
    p1, o1, m = step(dt, opt, batch)
    res[f"{key}/step/loss"] = m["loss"].numpy()
    res[f"{key}/step/grad_norm"] = m["grad_norm"].numpy()
    for k, v in walk({"params": p1, "opt": o1}):
        res[f"{key}/step/{k}"] = CO.local(v).numpy()


def _port_din(pm, name, z, res):
    from repro_torch.configs.base import train_state
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed import mlp_param_spec
    from repro_torch.models.recsys import din

    cfg, params = din_case(z, pm)
    if name in DIN_MESHES:
        batch = _tensors(tree_from(z, "din/batch/train/"))
        _grads_and_step(pm, lambda p, b: (din.loss_fn(p, b, cfg, pm), {}),
                        params, batch, None, res, f"din/{name}/train")
    dt = train_state(params, mlp_param_spec, pm)[0]
    if name == SERVE_MESH:
        for which in ("serve", "bad"):
            b = _tensors(tree_from(z, f"din/batch/{which}/"))
            b = {k: CO.rows_of(v, pm) for k, v in b.items()}
            res[f"din/{name}/{which}"] = din.apply(dt, b, cfg,
                                                   pm).detach().numpy()
            res[f"din/{name}/{which}/split"] = np.asarray(split_leaves(dt))
    if name in RETRIEVAL_MESHES:
        b = _tensors(tree_from(z, "din/batch/retrieval/"))
        cand = b["candidates"]
        b["candidates"] = CO.rows_of(cand, pm)
        res[f"din/{name}/retrieval"] = din.score_candidates(
            dt, b, cfg, chunk=DIN_CHUNK, mesh=pm).detach().numpy()
        res[f"din/{name}/retrieval/split"] = np.asarray(
            split_leaves(dt) + (b["candidates"].shape != cand.shape))


def _port_crossings(pm, res):
    """``gather_sum`` and ``reduce_scatter`` over ``data`` under a loss
    whose weights differ on every rank: each rank's gradient of its
    block."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as CO

    r, n = dist.get_rank(), 4
    x = (torch.arange(6.0).reshape(2, 3) + 10 * r).requires_grad_(True)
    w = torch.arange(n * 2 * 3.0).reshape(n * 2, 3) * (r + 1)
    y = CO.gather_sum(x, pm, "data", 0)
    (g,) = torch.autograd.grad((w * y).sum(), x)
    res["cross/gather/y"] = y.detach().numpy()
    res["cross/gather/grad"] = g.numpy()
    x = (torch.arange(n * 2 * 3.0).reshape(n * 2, 3) * (r + 1)
         ).requires_grad_(True)
    w = torch.arange(6.0).reshape(2, 3) + 10 * r
    y = CO.reduce_scatter(x, pm, "data", 0)
    (g,) = torch.autograd.grad((w * y).sum(), x)
    res["cross/scatter/y"] = y.detach().numpy()
    res["cross/scatter/grad"] = g.numpy()


def _rank(rank, world, inputs, out, store):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_process_mesh
    from repro_torch.models.recsys import din

    torch.set_num_threads(1)
    dev = init_ranks("gloo", store=store, rank=rank, world_size=world)
    z = dict(np.load(inputs))
    res = {}
    for name, (dp, tp) in MESHES.items():
        pm = make_process_mesh(dp, tp, dev)
        if name == "4x1":
            _port_crossings(pm, res)
        for mesh, arch, cell in GNN_CASES:
            if mesh == name:
                loss_fn, params, batch, specs = gnn_case(z, arch, cell, pm)
                _grads_and_step(pm, loss_fn, params, batch, specs, res,
                                gnn_key(name, arch, cell))
        _port_din(pm, name, z, res)
        for mesh, arch, cell in TALLY_CASES:
            if mesh != name:
                continue
            if arch == "din":
                cfg, params = din_case(z, pm)
                t = step_tally(lambda p, b: (din.loss_fn(p, b, cfg, pm), {}),
                               params, _tensors(tree_from(
                                   z, "din/batch/train/")), pm)
            else:
                loss_fn, params, batch, specs = gnn_case(z, arch, cell, pm)
                t = step_tally(loss_fn, params, batch, pm, specs)
            for kind, nbytes in t.items():
                res[f"tally/{mesh}/{arch}/{cell}/{kind}"] = np.asarray(
                    nbytes)
        del pm
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(inputs: str, out: str) -> None:
    import torch.multiprocessing as mp

    store = tempfile.mktemp(prefix="store-", dir=out)
    mp.spawn(_rank, args=(4, inputs, out, store), nprocs=4, join=True)


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------

def run_reference(inputs: str, out: str, part: str) -> None:
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        # the reference's rtree imports this name, which newer JAX moved
        jax.experimental.enable_x64 = jax.enable_x64
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.configs as RCF
    import repro.configs.base as RCB
    from repro.distributed import sharding as RSH
    from repro.models.recsys import din as RD
    from repro.train import optim as RO

    assert len(jax.devices()) == 4, jax.devices()
    z = dict(np.load(inputs))
    res = {}
    axes = RSH.MeshAxes()

    def mesh_of(name):
        # Auto axes, as the LM's mesh tests run the reference (R12)
        return jax.make_mesh(MESHES[name], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def placed_ref(rp, mesh):
        specs = RSH.param_specs(rp, RSH.mlp_param_spec, axes, mesh)
        o = RO.adamw_init(rp)
        ospecs = RSH.opt_state_specs(o, rp, specs, axes, mesh)
        return (jax.device_put(rp, RSH.named(mesh, specs)),
                jax.device_put(o, RSH.named(mesh, ospecs)))

    def put_batch(b, mesh, specs):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, specs[k])) for k, v in b.items()}

    def grads_and_step(loss_fn, rp, batch, mesh, key):
        rp, ro = placed_ref(rp, mesh)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(rp, batch)
        res[f"{key}/loss"] = np.asarray(loss)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            res[f"{key}/grad/{_path(path)}"] = np.asarray(g)
        # the reference's train step at grad_accum 1: these gradients,
        # then adamw_update
        p1, o1, m = jax.jit(lambda g, o, p: RO.adamw_update(
            RO.AdamWConfig(**ADAMW), g, o, p))(grads, ro, rp)
        res[f"{key}/step/loss"] = np.asarray(loss)
        res[f"{key}/step/grad_norm"] = np.asarray(m["grad_norm"])
        for path, v in jax.tree_util.tree_flatten_with_path(
                {"params": p1, "opt": o1})[0]:
            res[f"{key}/step/{_path(path)}"] = np.asarray(v)

    def jnp_tree(pre):
        return jax.tree.map(jnp.asarray, tree_from(z, pre))

    part = int(part)
    for mesh_name, arch, cell in GNN_CASES:
        if reference_part((mesh_name, arch, cell)) != part:
            continue
        mesh = mesh_of(mesh_name)
        pre = f"gnn/{arch}/{cell}"
        rcfg = gnn_config(arch, cell, RCF)
        module = __import__(f"repro.models.gnn.{arch.replace('-', '_')}",
                            fromlist=["apply"])
        batched = cell == "molecule"
        b = tree_from(z, f"{pre}/batch/")
        specs = {k: P() if not batched and k == "energy" else P(axes.data)
                 for k in b}
        grads_and_step(RCB._gnn_loss(arch, module, rcfg, batched),
                       jnp_tree(f"{pre}/params/"), put_batch(b, mesh, specs),
                       mesh, gnn_key(mesh_name, arch, cell))

    cfg = RCF.get_arch("din").make_config(reduced=True)
    din_meshes = DIN_MESHES + (SERVE_MESH,) + RETRIEVAL_MESHES
    for name in dict.fromkeys(din_meshes if reference_part("din") == part
                              else ()):
        mesh = mesh_of(name)
        rp = jnp_tree("din/params/")
        row = {"hist_items": P(axes.data, None),
               "hist_mask": P(axes.data, None), "target_item": P(axes.data),
               "label": P(axes.data)}
        if name in DIN_MESHES:
            grads_and_step(lambda p, b: (RD.loss_fn(p, b, cfg), {}), rp,
                           put_batch(tree_from(z, "din/batch/train/"), mesh,
                                     row), mesh, f"din/{name}/train")
        dp = placed_ref(rp, mesh)[0]
        if name == SERVE_MESH:
            for which in ("serve", "bad"):
                res[f"din/{name}/{which}"] = np.asarray(jax.jit(
                    lambda p, b: RD.apply(p, b, cfg))(dp, put_batch(
                        tree_from(z, f"din/batch/{which}/"), mesh, row)))
        if name in RETRIEVAL_MESHES:
            b = put_batch(tree_from(z, "din/batch/retrieval/"), mesh, {
                "hist_items": P(), "hist_mask": P(),
                "candidates": P(axes.data)})
            res[f"din/{name}/retrieval"] = np.asarray(jax.jit(
                lambda p, b: RD.score_candidates(p, b, cfg,
                                                 chunk=DIN_CHUNK))(dp, b))
    np.savez(os.path.join(out, f"reference{part}.npz"), **res)


if __name__ == "__main__":
    {"ranks": run_ranks, "reference": run_reference}[sys.argv[1]](
        *sys.argv[2:])
