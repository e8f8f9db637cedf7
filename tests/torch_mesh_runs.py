"""The two sides of ``tests/test_torch_mesh.py``, each run in a process
of its own on the CPU, each writing what it computed to ``.npz`` files:

    python tests/torch_mesh_runs.py ranks INPUTS OUT
        the port: four gloo ranks (``torch.multiprocessing`` spawn, a
        ``file://`` store under OUT) over the meshes of ``MESHES``, then
        two ranks for the autograd check; one ``rank<r>.npz`` and one
        ``trap<r>.npz`` a rank.  Imports no JAX.
    python tests/torch_mesh_runs.py reference INPUTS OUT
        the reference on four CPU devices; the caller sets
        ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (it must
        be set before JAX is imported).  Writes ``reference.npz``.

INPUTS is an ``.npz`` of the inputs both take (``make_inputs``).  Keys
are ``/``-joined paths; a rank's results are its local shards, the
reference's the global arrays (its ``addressable_shards`` for
``reshard``).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}   # (data, model)
LM_MESHES = ("1x4", "2x2")
SERVE_MESH = "1x4"
SERVE_SPLIT_MESH = "2x2"            # whole heads: each rank's cache its KV's
RESTORE_MESHES = ("1x4", "4x1")     # the (2, 2) checkpoint restored here
# the LM family under lm_param_spec: on (1, 4) llama4's KV 2 and gemma2's
# KV 2 split a head (the gather arm), deepseek's MLA 4 heads fall whole;
# on (2, 2) every one falls on whole heads
LM_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma2-2b")
CKPT_ARCH = LM_ARCHS[0]
ACCUM = ("2x2", LM_ARCHS[0], 2)     # mesh, arch, grad_accum of one more step
TALLY_CASES = (("1x4", "gemma2-2b"), ("2x2", LM_ARCHS[0]))
B, S, PROMPT, DECODE = 4, 32, 16, 4
# the vocab-parallel lookup and loss on (1, 4), gemma2 tied and untied:
# token and label ids outside [-V, V) give NaN, ids in [-V, 0) wrap
VOCAB_ARCH, VOCAB_MESH, V = "gemma2-2b", "1x4", 512
BAD_TOKENS = ((0, 5, V), (1, 9, -V - 1), (2, 3, -3))   # (row, col, id)
BAD_LABELS = {"over": ((1, 7, V + 5),), "under": ((3, 30, -V - 2),),
              "wrap": ((0, 4, -2), (2, 20, -V))}
# the MoE layer alone: 32 tokens of width 16, 8 experts of 16, top 2;
# the shared expert's 24 splits over 1, 2 and 4 model ranks
MOE = dict(n_experts=8, top_k=2, d_expert=16)
D, T, D_SHARED = 16, 32, 24
BALANCE = (0.5, 8.0)                # 0.5 drops assignments, 8.0 none
AUX_WEIGHT = 3.0                    # the aux loss's weight in the test's loss
SHARED = (0, 1)
# one AdamW step: clip_norm below both reduced configs' gradient norms,
# so the clip engages; lr 1e-3 at step 1.  eps 1e-3 bounds the step's
# sensitivity to a gradient near 0 by lr / eps = 1 (at the default 1e-8
# an element whose gradient is ~1e-8 moves by up to 2 lr on noise in
# the last bits of a float32 sum)
ADAMW = dict(lr=1e-3, warmup_steps=1, clip_norm=1.0, eps=1e-3)
TRAP_MESH = (1, 2)
RESHARD = {     # name: (shape, spec); every one divides on every mesh
    "rows_cols": ((8, 4), ("data", "model")),
    "cols": ((8, 4), (None, "model")),
    "joint": ((16,), (("data", "model"),)),
    "swapped": ((4, 8), ("model", "data")),
    "replicated": ((3,), ()),
}
# per mesh, a dim its axis does not divide
NO_DIVIDE = {"1x4": ((6,), ("model",)), "2x2": ((5, 4), ("data", None)),
             "4x1": ((6,), ("data",))}


def moe_key(shared: int, bf: float) -> str:
    return f"shared{shared}_bf{bf}"


def make_inputs(rng: np.random.Generator) -> dict:
    """The MoE inputs, made with NumPy: per ``shared``, the layer's
    parameters at the reference's ``moe_init`` scales; tokens ``x``; the
    output's weights ``r`` in the test's loss; the reshard arrays."""
    z = {}
    E, f = MOE["n_experts"], MOE["d_expert"]
    for shared in SHARED:
        p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
             "w_gu": rng.standard_normal((E, D, 2 * f)) * D ** -0.5,
             "w_d": rng.standard_normal((E, f, D)) * f ** -0.5}
        if shared:
            p["sh_gu"] = rng.standard_normal((D, 2, D_SHARED)) * D ** -0.5
            p["sh_d"] = rng.standard_normal((D_SHARED, D)) * D_SHARED ** -0.5
        for k, v in p.items():
            z[f"moe/{shared}/{k}"] = v.astype(np.float32)
    z["moe/x"] = rng.standard_normal((T, D)).astype(np.float32)
    z["moe/r"] = rng.standard_normal((T, D)).astype(np.float32)
    for name, (shape, _) in RESHARD.items():
        z[f"reshard/{name}"] = np.arange(np.prod(shape), dtype=np.float32
                                         ).reshape(shape)
    return z


def tree_from(z, prefix: str) -> dict:
    """The nested dict of ``z``'s arrays under ``prefix``."""
    out: dict = {}
    for k in z:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[k]
    return out


def moe_spec(shared: int, bf: float):
    from repro_torch.models.lm import MoESpec

    return MoESpec(**MOE, n_shared=shared, d_shared=D_SHARED if shared
                   else None, balance_factor=bf)


# --------------------------------------------------------------------------
# the port's side
# --------------------------------------------------------------------------

def _port_moe(pm, z, shared, bf, res, key):
    """``moe_ffn`` on this rank's rows, its parameters as the trainer
    holds them (``reshard`` under ``lm_expert_param_spec``, then the
    local shards): the output, aux and every gradient, the parameters'
    summed over ``data``."""
    import torch
    from repro_torch.distributed import MeshAxes, param_specs, reshard
    from repro_torch.distributed.sharding import lm_expert_param_spec
    from repro_torch.distributed import collectives as CO
    from repro_torch.models.lm.moe import moe_ffn

    spec = moe_spec(shared, bf)
    tree = {"seg0": {"moe": {k: torch.as_tensor(v) for k, v in tree_from(
        z, f"moe/{shared}/").items()}}}
    dt = reshard(tree, pm, param_specs(tree, lm_expert_param_spec,
                                       MeshAxes(), pm))["seg0"]["moe"]
    leaves = {k: CO.local(v).detach().requires_grad_(True)
              for k, v in dt.items()}
    x = CO.rows_of(torch.as_tensor(z["moe/x"]), pm).requires_grad_(True)
    r = CO.rows_of(torch.as_tensor(z["moe/r"]), pm)
    out, aux = moe_ffn(leaves, x, spec, mesh=pm, data_axes=("data",))
    loss = (out * r).sum() + AUX_WEIGHT * aux
    gx, *gp = torch.autograd.grad(loss, [x, *leaves.values()])
    res[f"{key}/out"] = out.detach().numpy()
    res[f"{key}/aux"] = aux.detach().numpy()
    res[f"{key}/grad/x"] = gx.numpy()
    for k, g in zip(leaves, gp):
        res[f"{key}/grad/{k}"] = CO.all_reduce(g, pm, "data").numpy()


def lm_placed(params, mesh):
    """The parameters ``reshard``ed by ``lm_param_spec`` onto ``mesh``
    (a process or counting mesh), and AdamW's zero state placed by
    ``opt_state_specs`` (ZeRO-1: the moments split over ``data`` too)."""
    from repro_torch.distributed import (MeshAxes, lm_param_spec,
                                         opt_state_specs, param_specs,
                                         reshard)
    from repro_torch.train import adamw_init

    specs = param_specs(params, lm_param_spec, MeshAxes(), mesh)
    opt = adamw_init(params)
    return reshard(params, mesh, specs), reshard(opt, mesh, opt_state_specs(
        opt, params, specs, MeshAxes(), mesh))


def lm_inputs(z, arch):
    """The reduced config, parameters and batch of ``arch``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.tree import map_leaves

    cfg = get_arch(arch).make_config(reduced=True)
    params = map_leaves(lambda _, v: torch.as_tensor(v),
                        tree_from(z, f"lm/{arch}/params/"))
    batch = {k: torch.as_tensor(z[f"lm/{arch}/batch/{k}"])
             for k in ("tokens", "labels")}
    return cfg, params, batch


def lm_step_tally(cfg, params, batch, mesh):
    """The bytes by kind of one train step's crossings on ``mesh``."""
    from repro_torch.distributed import collectives as CO
    from repro_torch.models.lm import lm_loss
    from repro_torch.train import AdamWConfig, make_train_step

    dt, opt = lm_placed(params, mesh)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, mesh=mesh),
                           AdamWConfig(**ADAMW), mesh=mesh)
    with CO.Tally() as t:
        step(dt, opt, batch)
    return t.bytes


def _port_lm(pm, mesh_name, arch, z, res, ckpt):
    import torch
    from repro_torch.distributed import save_checkpoint
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed.tree import map_leaves, walk
    from repro_torch.models.lm import lm_loss
    from repro_torch.train import AdamWConfig, make_train_step

    cfg, params, batch = lm_inputs(z, arch)
    dt, opt = lm_placed(params, pm)
    key = f"lm/{mesh_name}/{arch}"
    xs = {}
    local = map_leaves(lambda k, v: xs.setdefault(
        k, CO.local(v).detach().requires_grad_(True)), dt)
    loss, metrics = lm_loss(local, {k: CO.rows_of(v, pm) for k, v in
                                    batch.items()}, cfg, mesh=pm)
    grads = torch.autograd.grad(loss, list(xs.values()), allow_unused=True)
    res[f"{key}/loss"] = loss.detach().numpy()
    for k, v in metrics.items():
        res[f"{key}/metrics/{k}"] = v.detach().numpy()
    for (k, x), g in zip(xs.items(), grads):
        g = torch.zeros_like(x) if g is None else g
        res[f"{key}/grad/{k}"] = CO.all_reduce(g, pm, "data").numpy()

    step = make_train_step(lambda p, b: lm_loss(p, b, cfg, mesh=pm),
                           AdamWConfig(**ADAMW), mesh=pm)
    p1, o1, m = step(dt, opt, batch)
    res[f"{key}/step/loss"] = m["loss"].numpy()
    res[f"{key}/step/grad_norm"] = m["grad_norm"].numpy()
    for k, v in walk({"params": p1, "opt": o1}):
        res[f"{key}/step/{k}"] = CO.local(v).numpy()
    if ckpt is not None:
        save_checkpoint(ckpt, 1, {"params": p1, "opt": o1})
    if (mesh_name, arch) == ACCUM[:2]:
        step = make_train_step(lambda p, b: lm_loss(p, b, cfg, mesh=pm),
                               AdamWConfig(**ADAMW), grad_accum=ACCUM[2],
                               mesh=pm)
        p2, o2, m = step(dt, opt, batch)
        res[f"{key}/accum/loss"] = m["loss"].numpy()
        res[f"{key}/accum/grad_norm"] = m["grad_norm"].numpy()
        for k, v in walk({"params": p2, "opt": o2}):
            res[f"{key}/accum/{k}"] = CO.local(v).numpy()
    if (mesh_name, arch) in TALLY_CASES:
        for kind, n in lm_step_tally(cfg, params, batch, pm).items():
            res[f"tally/{mesh_name}/{arch}/{kind}"] = np.asarray(n)


def _port_vocab(pm, z, res):
    """The vocab-parallel lookup and loss on ids outside the vocabulary:
    ``forward``'s hidden states for BAD_TOKENS, and ``lm_loss`` for each
    case of BAD_LABELS, the head tied and untied."""
    import dataclasses

    import torch
    from repro_torch.distributed import (MeshAxes, lm_param_spec,
                                         param_specs, reshard)
    from repro_torch.distributed.tree import map_leaves
    from repro_torch.models.lm import forward, lm_loss

    cfg, _, batch = lm_inputs(z, VOCAB_ARCH)
    for tied in (True, False):
        c = dataclasses.replace(cfg, tie_embeddings=tied)
        params = map_leaves(lambda _, v: torch.as_tensor(v), tree_from(
            z, f"vocab/{int(tied)}/params/"))
        dt = reshard(params, pm, param_specs(params, lm_param_spec,
                                             MeshAxes(), pm))
        toks = bad_ids(batch["tokens"], BAD_TOKENS)
        key = f"vocab/{int(tied)}"
        res[f"{key}/hidden"] = forward(dt, toks, c, mesh=pm)[0].numpy()
        for name, bad in BAD_LABELS.items():
            b = dict(batch, labels=bad_ids(batch["labels"], bad))
            res[f"{key}/loss/{name}"] = lm_loss(
                dt, b, c, mesh=pm)[0].detach().numpy()


def bad_ids(ids, cases):
    """``ids`` with the (row, col, id) ``cases`` written in."""
    ids = ids.clone() if hasattr(ids, "clone") else ids.copy()
    for r, c, v in cases:
        ids[r, c] = v
    return ids


def _port_restore(pm, mesh_name, z, res, ckpt):
    """The (2, 2) checkpoint restored onto this mesh: a template of
    zeros placed by ``lm_expert_param_spec`` here."""
    import torch
    from repro_torch.distributed import (CheckpointManager, MeshAxes,
                                         param_specs, reshard,
                                         restore_checkpoint)
    from repro_torch.distributed.sharding import lm_expert_param_spec
    from repro_torch.distributed import collectives as CO
    from repro_torch.distributed.tree import map_leaves, walk
    from repro_torch.train import adamw_init

    zeros = map_leaves(lambda _, v: torch.zeros(v.shape),
                       tree_from(z, f"lm/{CKPT_ARCH}/params/"))
    specs = param_specs(zeros, lm_expert_param_spec, MeshAxes(), pm)
    params = reshard(zeros, pm, specs)
    tree, manifest = restore_checkpoint(
        ckpt, {"params": params, "opt": adamw_init(params)})
    key = f"restore/{mesh_name}"
    res[f"{key}/step"] = np.asarray(manifest["step"])
    for k, v in walk(tree):
        res[f"{key}/local/{k}"] = CO.local(v).numpy()
        full = CO.full(v)
        if pm.get_rank() == 0:
            res[f"{key}/full/{k}"] = full.numpy()
    mgr = CheckpointManager(os.path.join(ckpt, "async"))
    try:
        mgr.save_async(2, tree)
        res[f"{key}/save_async"] = np.asarray("no error")
    except ValueError as e:
        res[f"{key}/save_async"] = np.asarray(f"ValueError: {e}")
    finally:
        mgr.close()


def serve_key(mesh_name: str, arch: str) -> str:
    return (f"serve/{arch}" if mesh_name == SERVE_MESH
            else f"serve/{mesh_name}/{arch}")


def _port_serve(pm, arch, z, res, key):
    """Prefill and decode with the parameters under ``lm_param_spec``
    (this rank's blocks) and the whole batch (the serving path); the
    cache's KV heads, this rank's or all."""
    import torch
    from repro_torch.models.lm import decode_step, prefill

    cfg, params, batch = lm_inputs(z, arch)
    params, toks = lm_placed(params, pm)[0], batch["tokens"]
    lg, cache = prefill(params, toks[:, :PROMPT], cfg,
                        max_len=PROMPT + DECODE + 2, mesh=pm)
    if cfg.attn != "mla":
        res[f"{key}/kv_heads"] = np.asarray(
            cache["seg0"]["u0"]["k"].shape[-2])
    steps = [lg]
    for i in range(DECODE):
        lg, cache = decode_step(params, cache, toks[:, PROMPT + i], cfg,
                                mesh=pm)
        steps.append(lg)
    res[key] = torch.stack(steps).numpy()


def _port_reshard(pm, mesh_name, z, res):
    import torch
    from repro_torch.distributed import reshard
    from repro_torch.distributed import collectives as CO

    tree = {k: torch.as_tensor(z[f"reshard/{k}"]) for k in RESHARD}
    out = reshard(tree, pm, {k: spec for k, (_, spec) in RESHARD.items()})
    for k, v in out.items():
        res[f"reshard/{mesh_name}/{k}"] = CO.local(v).numpy()
        res[f"reshard/{mesh_name}/{k}/full"] = CO.full(v).numpy()
    shape, spec = NO_DIVIDE[mesh_name]
    try:
        reshard({"w": torch.zeros(shape)}, pm, {"w": spec})
        res[f"reshard/{mesh_name}/no_divide"] = np.asarray("no error")
    except ValueError as e:
        res[f"reshard/{mesh_name}/no_divide"] = np.asarray(
            f"ValueError: {e}")


def _rank(rank, world, inputs, out, store):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_process_mesh

    torch.set_num_threads(1)
    dev = init_ranks("gloo", store=store, rank=rank, world_size=world)
    z = dict(np.load(inputs))
    res = {}
    ckpt = os.path.join(out, "ckpt")
    for name, (dp, tp) in MESHES.items():
        pm = make_process_mesh(dp, tp, dev)
        for shared in SHARED:
            for bf in BALANCE:
                _port_moe(pm, z, shared, bf, res,
                          f"moe/{name}/{moe_key(shared, bf)}")
        _port_reshard(pm, name, z, res)
        if name in LM_MESHES:
            for arch in LM_ARCHS:
                _port_lm(pm, name, arch, z, res,
                         ckpt if (name, arch) == ("2x2", CKPT_ARCH)
                         else None)
        if name in (SERVE_MESH, SERVE_SPLIT_MESH):
            for arch in LM_ARCHS:
                _port_serve(pm, arch, z, res, serve_key(name, arch))
        if name == VOCAB_MESH:
            _port_vocab(pm, z, res)
        if name in RESTORE_MESHES:
            _port_restore(pm, name, z, res, ckpt)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def _trap(rank, world, inputs, out, store):
    """The MoE layer's gradients on two model ranks, with the port's
    sum (``reduce_from``) and with
    ``torch.distributed.nn.functional.all_reduce`` in its place."""
    import torch
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn
    from repro_torch.distributed import collectives as CO
    from repro_torch.launch.mesh import init_ranks, make_process_mesh

    torch.set_num_threads(1)
    dev = init_ranks("gloo", store=store, rank=rank, world_size=world)
    pm = make_process_mesh(*TRAP_MESH, dev)
    z = dict(np.load(inputs))
    res = {}
    _port_moe(pm, z, 1, BALANCE[1], res, "port")
    ours = CO.reduce_from
    CO.reduce_from = lambda x, mesh, axis: dnn.all_reduce(
        x, group=mesh.get_group(axis))
    try:
        _port_moe(pm, z, 1, BALANCE[1], res, "torch")
    finally:
        CO.reduce_from = ours
    np.savez(os.path.join(out, f"trap{rank}.npz"), **res)
    dist.destroy_process_group()


def run_ranks(inputs: str, out: str) -> None:
    import torch.multiprocessing as mp

    for fn, world in ((_rank, 4), (_trap, 2)):
        store = tempfile.mktemp(prefix="store-", dir=out)
        mp.spawn(fn, args=(world, inputs, out, store), nprocs=world,
                 join=True)


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------

def run_reference(inputs: str, out: str) -> None:
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        # the reference's rtree imports this name, which newer JAX moved
        jax.experimental.enable_x64 = jax.enable_x64
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    import dataclasses

    import repro.configs as RCF
    from repro.distributed import sharding as RSH
    from repro.models.lm import model as RM
    from repro.models.lm import moe as RMOE
    from repro.models.lm.config import MoESpec
    from repro.train import optim as RO
    from repro.train import steps as RS

    assert len(jax.devices()) == 4, jax.devices()
    z = dict(np.load(inputs))
    res = {}

    def mesh_of(shape):
        # Auto axes: under JAX 0.9's default Explicit axes the
        # reference's lm_loss raises (ROADMAP R12)
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def moe_grads(mesh, shared, bf):
        spec = MoESpec(**MOE, n_shared=shared,
                       d_shared=D_SHARED if shared else None,
                       balance_factor=bf)
        p = {k: jnp.asarray(v) for k, v in tree_from(
            z, f"moe/{shared}/").items()}

        def loss(p, x):
            out, aux = RMOE.moe_ffn(p, x, spec, mesh=mesh,
                                    data_spec=P("data"))
            return (out * z["moe/r"]).sum() + AUX_WEIGHT * aux, (out, aux)

        (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(z["moe/x"]))
        return o, a, gx, gp

    def placed(rp, mesh):
        """``rp`` placed by the reference's ``lm_param_spec`` and its
        zero AdamW state by ``opt_state_specs`` (ZeRO-1)."""
        axes = RSH.MeshAxes()
        specs = RSH.param_specs(rp, RSH.lm_param_spec, axes, mesh)
        o = RO.adamw_init(rp)
        ospecs = RSH.opt_state_specs(o, rp, specs, axes, mesh)
        return (jax.device_put(rp, RSH.named(mesh, specs)),
                jax.device_put(o, RSH.named(mesh, ospecs)))

    def put(key, o, a, gx, gp):
        res[f"{key}/out"] = np.asarray(o)
        res[f"{key}/aux"] = np.asarray(a)
        res[f"{key}/grad/x"] = np.asarray(gx)
        for k, v in gp.items():
            res[f"{key}/grad/{k}"] = np.asarray(v)

    for name, shape in MESHES.items():
        mesh = mesh_of(shape)
        for shared in SHARED:
            for bf in BALANCE:
                put(f"moe/{name}/{moe_key(shared, bf)}",
                    *moe_grads(mesh, shared, bf))
        coord = {d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
        for k, (_, spec) in RESHARD.items():
            arr = jax.device_put(z[f"reshard/{k}"],
                                 NamedSharding(mesh, P(*spec)))
            for s in arr.addressable_shards:
                i, j = coord[s.device.id]
                res[f"reshard/{name}/{k}/{i * shape[1] + j}"] = np.asarray(
                    s.data)
        try:
            shp, spec = NO_DIVIDE[name]
            jax.device_put(np.zeros(shp, np.float32),
                           NamedSharding(mesh, P(*spec)))
            res[f"reshard/{name}/no_divide"] = np.asarray("no error")
        except ValueError as e:
            res[f"reshard/{name}/no_divide"] = np.asarray(
                f"ValueError: {e}")

        for arch in LM_ARCHS if name in LM_MESHES else ():
            rcfg = RCF.get_arch(arch).make_config(reduced=True)
            rp, ro = placed(jax.tree.map(jnp.asarray, tree_from(
                z, f"lm/{arch}/params/")), mesh)
            batch = {k: jnp.asarray(z[f"lm/{arch}/batch/{k}"])
                     for k in ("tokens", "labels")}
            act = P(("data",), None, None)
            with jax.set_mesh(mesh):
                (loss, metrics), grads = jax.jit(jax.value_and_grad(
                    lambda p, b: RM.lm_loss(p, b, rcfg, mesh=mesh,
                                            act_spec=act),
                    has_aux=True))(rp, batch)
            key = f"lm/{name}/{arch}"
            res[f"{key}/loss"] = np.asarray(loss)
            for k, v in metrics.items():
                res[f"{key}/metrics/{k}"] = np.asarray(v)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                res[f"{key}/grad/{_path(path)}"] = np.asarray(g)
            # the reference's train step at grad_accum 1: these
            # gradients, then adamw_update
            p1, o1, m = jax.jit(lambda g, o, p: RO.adamw_update(
                RO.AdamWConfig(**ADAMW), g, o, p))(grads, ro, rp)
            res[f"{key}/step/loss"] = np.asarray(loss)
            res[f"{key}/step/grad_norm"] = np.asarray(m["grad_norm"])
            for path, v in jax.tree_util.tree_flatten_with_path(
                    {"params": p1, "opt": o1})[0]:
                res[f"{key}/step/{_path(path)}"] = np.asarray(v)
            if (name, arch) == ACCUM[:2]:
                step = RS.make_train_step(
                    lambda p, b: RM.lm_loss(p, b, rcfg, mesh=mesh,
                                            act_spec=act),
                    RO.AdamWConfig(**ADAMW), grad_accum=ACCUM[2])
                with jax.set_mesh(mesh):
                    p2, o2, m = jax.jit(step)(rp, ro, batch)
                res[f"{key}/accum/loss"] = np.asarray(m["loss"])
                res[f"{key}/accum/grad_norm"] = np.asarray(m["grad_norm"])
                for path, v in jax.tree_util.tree_flatten_with_path(
                        {"params": p2, "opt": o2})[0]:
                    res[f"{key}/accum/{_path(path)}"] = np.asarray(v)

        if name in (SERVE_MESH, SERVE_SPLIT_MESH):
            for arch in LM_ARCHS:
                rcfg = RCF.get_arch(arch).make_config(reduced=True)
                rp = placed(jax.tree.map(jnp.asarray, tree_from(
                    z, f"lm/{arch}/params/")), mesh)[0]
                toks = jnp.asarray(z[f"lm/{arch}/batch/tokens"])
                lg, cache = jax.jit(lambda p, t: RM.prefill(
                    p, t, rcfg, max_len=PROMPT + DECODE + 2, mesh=mesh))(
                    rp, toks[:, :PROMPT])
                dec = jax.jit(lambda p, c, t: RM.decode_step(
                    p, c, t, rcfg, mesh=mesh))
                steps = [np.asarray(lg)]
                for i in range(DECODE):
                    lg, cache = dec(rp, cache, toks[:, PROMPT + i])
                    steps.append(np.asarray(lg))
                res[serve_key(name, arch)] = np.stack(steps)

        if name == VOCAB_MESH:
            rcfg = RCF.get_arch(VOCAB_ARCH).make_config(reduced=True)
            batch = {k: z[f"lm/{VOCAB_ARCH}/batch/{k}"]
                     for k in ("tokens", "labels")}
            act = P(("data",), None, None)
            for tied in (True, False):
                c = dataclasses.replace(rcfg, tie_embeddings=tied)
                rp = placed(jax.tree.map(jnp.asarray, tree_from(
                    z, f"vocab/{int(tied)}/params/")), mesh)[0]
                key = f"vocab/{int(tied)}"
                with jax.set_mesh(mesh):
                    res[f"{key}/hidden"] = np.asarray(jax.jit(
                        lambda p, t: RM.forward(p, t, c, mesh=mesh,
                                                act_spec=act)[0])(
                        rp, jnp.asarray(bad_ids(batch["tokens"],
                                                BAD_TOKENS))))
                    for bname, bad in BAD_LABELS.items():
                        b = {"tokens": jnp.asarray(batch["tokens"]),
                             "labels": jnp.asarray(bad_ids(
                                 batch["labels"], bad))}
                        res[f"{key}/loss/{bname}"] = np.asarray(jax.jit(
                            lambda p, b: RM.lm_loss(p, b, c, mesh=mesh,
                                                    act_spec=act)[0])(
                            rp, b))

    # the autograd check's two model ranks, and R13's two data shards
    put("trap", *moe_grads(mesh_of(TRAP_MESH), 1, BALANCE[1]))
    np.savez(os.path.join(out, "reference.npz"), **res)


def _path(path) -> str:
    """A JAX key path as the port's ``/``-joined one."""
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                v = getattr(k, attr)
                parts.append(f".{v}" if attr == "name" else str(v))
                break
    return "/".join(parts)


if __name__ == "__main__":
    role, inputs, out = sys.argv[1:]
    {"ranks": run_ranks, "reference": run_reference}[role](inputs, out)
