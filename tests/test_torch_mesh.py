"""The port's multi-rank arms (``launch.mesh.init_ranks`` /
``make_process_mesh``, ``distributed.collectives``, ``sharding.
placements``, ``elastic.reshard`` onto a process mesh, the MoE layer's
expert-parallel arm, the LM family tensor-parallel under
``lm_param_spec`` with ZeRO-1 moments: ``lm_loss``, ``make_train_step``,
``prefill`` and ``decode_step`` under a mesh, the vocab-parallel lookup
and loss, the collectives' tally and the counting mesh, DTensor
checkpoints) on four gloo ranks on the CPU, held to the reference on
four forced CPU devices (Auto axes: ROADMAP R12), its parameters placed
by its own ``lm_param_spec`` and ``named``.

Both sides run once per module, in processes of their own and at the
same time (``tests/torch_mesh_runs.py``): ``XLA_FLAGS`` must be set
before JAX is imported, which this process has done already, and the
port's ranks are spawned.  Every input is made here: the MoE layer's
with NumPy from a seed, the reduced LM configs' parameters by the
reference's ``init_params`` (gemma2's also untied, for the vocab-split
head).

Tolerances: the MoE layer's output, aux and every gradient within 2e-5;
the LM losses, gradients, the AdamW step's norm, moments and parameters
within 1e-5 (1 + |ref|) (both sum float32 in other orders: XLA against
PyTorch, one process against four).  ``reshard``'s shards, the
checkpoint and the ranks' agreement are exact.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RCF
import repro.data.pipeline as RP
from repro.models.lm import model as RM
from repro.models.lm import moe as RMOE
from repro.models.lm.config import MoESpec as RMoESpec
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import MeshAxes, restore_checkpoint
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.tree import walk
from repro_torch import configs as C
from repro_torch.launch import mesh as LM
from repro_torch.models.lm import MoESpec
from repro_torch.models.lm import model as LMM
from repro_torch.models.lm import moe as MOE
from repro_torch.train import adamw_init

import torch_mesh_runs as R

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MOE_TOL = 2e-5
LM_TOL = 1e-5
RUN_TIMEOUT_S = 240


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                       else []))
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results: the reference's arrays, the port's per rank
    (``ranks[r]``, mesh coordinate ``divmod(r, model)``) and the two
    autograd-check ranks', and the checkpoint's directory."""
    tmp = tmp_path_factory.mktemp("mesh")
    z = R.make_inputs(np.random.default_rng(0))
    for arch in R.LM_ARCHS:
        rcfg = RCF.get_arch(arch).make_config(reduced=True)
        rp = jax.jit(RM.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), rcfg)
        for path, v in walk(jax.tree.map(np.asarray, rp)):
            z[f"lm/{arch}/params/{path}"] = v
        batch = next(RP.lm_batches(rcfg.vocab, R.S, R.B, seed=3))
        for k in ("tokens", "labels"):
            z[f"lm/{arch}/batch/{k}"] = np.asarray(batch[k])
    for tied in (1, 0):
        rcfg = dataclasses.replace(RCF.get_arch(R.VOCAB_ARCH).make_config(
            reduced=True), tie_embeddings=bool(tied))
        rp = jax.jit(RM.init_params, static_argnums=1)(
            jax.random.PRNGKey(1), rcfg)
        for path, v in walk(jax.tree.map(np.asarray, rp)):
            z[f"vocab/{tied}/params/{path}"] = v
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    script = os.path.join(HERE, "torch_mesh_runs.py")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, script, "reference", inputs, str(tmp)],
            # unoptimised XLA compiles in about half the CPU time, and
            # runs the same operations unfused
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_DISABLE_MOST_OPTIMIZATIONS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "ranks": subprocess.Popen(
            [sys.executable, script, "ranks", inputs, str(tmp)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    try:
        logs = {k: p.communicate(timeout=RUN_TIMEOUT_S)[0]
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} exited {p.returncode}:\n{logs[k]}"
    load = lambda name: dict(np.load(tmp / name))
    return types.SimpleNamespace(
        ref=load("reference.npz"),
        ranks=[load(f"rank{r}.npz") for r in range(4)],
        trap=[load(f"trap{r}.npz") for r in range(2)],
        inputs=z, ckpt=str(tmp / "ckpt"))


def _rows(a, d, dp):
    n = a.shape[0] // dp
    return a[d * n:(d + 1) * n]


def _block(a, dim, m, tp):
    n = a.shape[dim] // tp
    return np.take(a, np.arange(m * n, (m + 1) * n), axis=dim)


def _ranks(mesh_name):
    dp, tp = R.MESHES[mesh_name]
    return [(r, *divmod(r, tp)) for r in range(dp * tp)]


# the dim each MoE leaf is split on over ``model`` (None: replicated)
MOE_SPLIT = {"router": None, "w_gu": 0, "w_d": 0, "sh_gu": 2, "sh_d": 0}


def _lm_split(path, shape, tp):
    """The dim ``lm_expert_param_spec`` splits a parameter, or a moment
    or the step of a ``{"params", "opt"}`` state, on (None: replicated)."""
    for pre in ("params/", "opt/.m/", "opt/.v/"):
        if path.startswith(pre):
            path = path[len(pre):]
    spec = SH.lm_expert_param_spec(path, shape, SH.MeshAxes(), tp)
    return next((i for i, s in enumerate(spec) if s is not None), None)


def _expert_block(want, path, m, tp):
    dim = _lm_split(path, want.shape, tp)
    return want if dim is None else _block(want, dim, m, tp)


def _lm_spec(path, shape, dp, tp):
    """The spec a leaf of ``{"params", "opt"}`` or a gradient is placed
    by: ``lm_param_spec`` for a parameter or a gradient (summed over
    ``data``), ZeRO-1's for a moment (``zero1_specs``: also over
    ``data`` on its first replicated dim ``data`` divides)."""
    moment = path.startswith(("opt/.m/", "opt/.v/"))
    for pre in ("params/", "opt/.m/", "opt/.v/"):
        if path.startswith(pre):
            path = path[len(pre):]
    if path == "opt/.step":
        return ()
    mesh = {"data": dp, "model": tp}
    spec = SH.lm_param_spec(path, shape, MeshAxes(), tp)
    if moment:
        tree = {"w": torch.empty(shape, device="meta")}
        spec = SH.zero1_specs(tree, {"w": spec}, MeshAxes(), mesh)["w"]
    return spec


def _my_block(want, path, d, m, dp, tp):
    """Rank (d, m)'s block of the logical ``want`` under ``_lm_spec``."""
    for dim, entry in enumerate(_lm_spec(path, want.shape, dp, tp)):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            for a in axes:
                n, i = (dp, d) if a == "data" else (tp, m)
                want = _block(want, dim, i, n)
    return want


# ----------------------------------------------------------- the MoE layer

MOE_CASES = [(m, s, bf) for m in R.MESHES for s in R.SHARED
             for bf in R.BALANCE]


@pytest.mark.parametrize("mesh,shared,bf", MOE_CASES)
def test_moe_ffn_matches_reference(runs, mesh, shared, bf):
    """Output rows, aux, x's gradient rows, and every parameter's
    gradient (summed over ``data``; each model rank's block of the
    split ones) against the reference's ``shard_map`` arm."""
    key = f"moe/{mesh}/{R.moe_key(shared, bf)}"
    dp, tp = R.MESHES[mesh]
    ref = runs.ref
    for r, d, m in _ranks(mesh):
        got = runs.ranks[r]
        for k in ("out", "grad/x"):
            np.testing.assert_allclose(got[f"{key}/{k}"], _rows(
                ref[f"{key}/{k}"], d, dp), rtol=0, atol=MOE_TOL)
        np.testing.assert_allclose(got[f"{key}/aux"], ref[f"{key}/aux"],
                                   rtol=0, atol=MOE_TOL)
        for leaf, dim in MOE_SPLIT.items():
            if f"{key}/grad/{leaf}" not in ref:
                assert not shared and leaf.startswith("sh_")
                continue
            want = ref[f"{key}/grad/{leaf}"]
            if dim is not None:
                want = _block(want, dim, m, tp)
            np.testing.assert_allclose(got[f"{key}/grad/{leaf}"], want,
                                       rtol=0, atol=MOE_TOL)


def _r13_shards():
    """The reference's own parts on each (2, 2) data shard of the MoE
    case with a shared expert at ``balance_factor`` 0.5: each shard's
    aux, and its output packed at the capacity of all 32 tokens."""
    shared, bf = 1, R.BALANCE[0]
    z = R.make_inputs(np.random.default_rng(0))
    spec = RMoESpec(**R.MOE, n_shared=shared, d_shared=R.D_SHARED,
                    balance_factor=bf)
    p = {k: jnp.asarray(v) for k, v in R.tree_from(
        z, f"moe/{shared}/").items()}
    cap = max(1, int(bf * R.T * spec.top_k / spec.n_experts))
    auxes, outs = [], []
    for half in np.split(z["moe/x"], 2):
        half = jnp.asarray(half)
        w, e, a = RMOE._routing(half, p["router"], spec)
        auxes.append(float(a))
        outs.append(np.asarray(
            RMOE._expert_ffn_local(half, w, e, p["w_gu"], p["w_d"], spec,
                                   0, spec.n_experts, cap, "silu")
            + RMOE._shared_ffn(half, p["sh_gu"], p["sh_d"], "silu")))
    return auxes, np.concatenate(outs)


def test_r13_shards_differ():
    """The two data shards' aux differ, so taking shard 0's is not
    taking their mean; and a shard's own capacity (its 16 tokens) is
    below the whole batch's, which the (2, 2) arm packs with."""
    auxes, _ = _r13_shards()
    assert auxes[0] != pytest.approx(np.mean(auxes), rel=1e-3)
    bf, k, E = R.BALANCE[0], R.MOE["top_k"], R.MOE["n_experts"]
    assert int(bf * (R.T // 2) * k / E) < int(bf * R.T * k / E)


def test_r13_mesh_results_follow_the_shards(runs):
    """R13 as the port follows it: on (2, 2) the aux of both packages is
    data shard 0's alone, and the output is each shard packed at the
    whole batch's capacity."""
    auxes, out = _r13_shards()
    key = f"moe/2x2/{R.moe_key(1, R.BALANCE[0])}"
    assert float(runs.ref[f"{key}/aux"]) == pytest.approx(auxes[0],
                                                          rel=1e-6)
    np.testing.assert_allclose(runs.ref[f"{key}/out"], out, atol=MOE_TOL)
    for r, d, _ in _ranks("2x2"):
        assert float(runs.ranks[r][f"{key}/aux"]) == pytest.approx(
            auxes[0], rel=1e-6)
        np.testing.assert_allclose(runs.ranks[r][f"{key}/out"],
                                   _rows(out, d, 2), atol=MOE_TOL)


def test_autograd_trap_of_torch_all_reduce(runs):
    """Two model ranks: ``torch.distributed.nn.functional.all_reduce``
    in place of the port's ``reduce_from`` sums in its backward too and
    hands x and every parameter twice its gradient; the port's gives the
    reference's.  The forward pass is the same."""
    ref = runs.ref
    for m, got in enumerate(runs.trap):
        for k in ("out", "aux"):
            np.testing.assert_allclose(got[f"port/{k}"], ref[f"trap/{k}"],
                                       rtol=0, atol=MOE_TOL)
            np.testing.assert_allclose(got[f"torch/{k}"], got[f"port/{k}"],
                                       rtol=0, atol=0)
        for leaf in ("x", *MOE_SPLIT):
            dim = MOE_SPLIT.get(leaf)
            want = ref[f"trap/grad/{leaf}"]
            if dim is not None:
                want = _block(want, dim, m, 2)
            np.testing.assert_allclose(got[f"port/grad/{leaf}"], want,
                                       rtol=0, atol=MOE_TOL)
            np.testing.assert_allclose(got[f"torch/grad/{leaf}"],
                                       2 * want, rtol=0, atol=2 * MOE_TOL)
            assert np.abs(want).max() > 100 * MOE_TOL


# ------------------------------------------------------------ the LM family

def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - LM_TOL * (1 + np.abs(want))
    assert err.max(initial=-1) <= 0, (what, float(np.abs(got - want).max()))


def _lm_leaves(ref, key):
    pre = f"{key}/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.mark.parametrize("mesh", R.LM_MESHES)
@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_lm_loss_and_grads_match_reference(runs, arch, mesh):
    """``lm_loss(mesh=...)`` on each rank's rows: the global loss and
    metrics (cross-entropy, aux, deepseek's MTP) on every rank, and
    every parameter's gradient summed over ``data`` (each model rank's
    block of the experts')."""
    key = f"lm/{mesh}/{arch}"
    dp, tp = R.MESHES[mesh]
    ref = runs.ref
    grads = _lm_leaves(ref, f"{key}/grad")
    assert len(grads) == len(list(walk(R.tree_from(
        runs.inputs, f"lm/{arch}/params/"))))
    for r, d, m in _ranks(mesh):
        got = runs.ranks[r]
        _close(got[f"{key}/loss"], ref[f"{key}/loss"], "loss")
        for k, v in _lm_leaves(ref, f"{key}/metrics").items():
            _close(got[f"{key}/metrics/{k}"], v, k)
        for path, want in grads.items():
            _close(got[f"{key}/grad/{path}"],
                   _my_block(want, path, d, m, 1, tp), path)


@pytest.mark.parametrize("mesh", R.LM_MESHES)
@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_train_step_matches_reference(runs, arch, mesh):
    """``make_train_step(mesh=...)`` on the whole batch: the loss, the
    global clip norm (it engages: the norm is above ``clip_norm``), the
    moments and the parameters after one AdamW step, against the
    reference's gradients through its ``adamw_update``."""
    key = f"lm/{mesh}/{arch}/step"
    dp, tp = R.MESHES[mesh]
    ref = runs.ref
    assert float(ref[f"{key}/grad_norm"]) > R.ADAMW["clip_norm"]
    leaves = _lm_leaves(ref, key)
    for r, d, m in _ranks(mesh):
        got = runs.ranks[r]
        _close(got[f"{key}/loss"], ref[f"{key}/loss"], "loss")
        _close(got[f"{key}/grad_norm"], ref[f"{key}/grad_norm"], "norm")
        for path, want in leaves.items():
            if path not in ("loss", "grad_norm"):
                _close(got[f"{key}/{path}"],
                       _my_block(want, path, d, m, dp, tp), path)


def test_train_step_grad_accum_matches_reference(runs):
    """``grad_accum`` 2 on (2, 2): each microbatch is the reference's
    (the whole batch's rows cut in two, then each half's rows split
    over ``data``), so capacity, aux and the summed gradients follow
    its ``lax.scan`` over microbatches."""
    mesh, arch, _ = R.ACCUM
    key = f"lm/{mesh}/{arch}/accum"
    dp, tp = R.MESHES[mesh]
    ref = runs.ref
    leaves = _lm_leaves(ref, key)
    assert len(leaves) > 20
    for r, d, m in _ranks(mesh):
        for path, want in leaves.items():
            _close(runs.ranks[r][f"{key}/{path}"],
                   _my_block(want, path, d, m, dp, tp), path)


@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_prefill_and_decode_on_a_model_axis(runs, arch):
    """``prefill`` of 16 tokens and 4 ``decode_step``s on (1, 4), the
    whole parameters on every rank: every rank's logits equal the
    reference's on its (1, 4) mesh."""
    want = runs.ref[f"serve/{arch}"]
    assert want.shape == (1 + R.DECODE, R.B, 512)
    for got in runs.ranks:
        np.testing.assert_allclose(got[f"serve/{arch}"], want, rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_prefill_and_decode_with_each_ranks_kv_heads(runs, arch):
    """``prefill`` and 4 ``decode_step``s on (2, 2), where every arch's
    heads fall whole on a rank: each rank's cache holds its KV heads
    (KV / 2; MLA's latent cache whole), and every rank's logits equal
    the reference's on its (2, 2) mesh within 1e-5 (1 + |ref|); on
    (1, 4) the KV 2 caches stay whole."""
    key = R.serve_key(R.SERVE_SPLIT_MESH, arch)
    cfg = C.get_arch(arch).make_config(reduced=True)
    for got in runs.ranks:
        _close(got[key], runs.ref[key], key)
        if cfg.attn != "mla":
            assert int(got[f"{key}/kv_heads"]) == cfg.n_kv_heads // 2
            assert int(got[f"serve/{arch}/kv_heads"]) == cfg.n_kv_heads


# the attention arm of each case: True where the heads fall whole on a
# rank, False where a split projection cuts a head (its outputs gathered)
HEAD_ARMS = [
    ("llama4-maverick-400b-a17b", True, (1, 4), False),  # wk: half a head
    ("gemma2-2b", True, (1, 4), False),                  # wk: half a head
    ("deepseek-v3-671b", True, (1, 4), True),            # MLA, 4 heads
    ("llama4-maverick-400b-a17b", True, (2, 2), True),
    ("gemma2-2b", True, (2, 2), True),
    ("gemma2-2b", False, (1, 4), True),      # published: 8 heads, KV 4
    ("gemma2-2b", False, (16, 16), False),   # wq's 2,048: half a head
]


@pytest.mark.parametrize("arch,reduced,shape,whole", HEAD_ARMS)
def test_head_arms_are_pinned(arch, reduced, shape, whole):
    """Which arm each layout runs: the blocks ``reshard`` cuts by
    ``lm_param_spec`` (rank 0's, on a counting mesh) split every
    projection, and fall on whole heads or cut one; the cache keeps
    ``KV / tp`` heads only where they fall whole."""
    from repro_torch.distributed import lm_param_spec, param_specs, reshard

    cfg = C.get_arch(arch).make_config(reduced=reduced)
    cm = CO.CountingMesh(dict(zip(("data", "model"), shape)))
    meta = LMM.param_shapes(cfg)
    params = reshard(meta, cm, param_specs(meta, lm_param_spec,
                                           MeshAxes(), cm))
    split, split_o, own = LMM._heads(params["seg0"]["u0"]["attn"], cfg,
                                     shape[1])
    assert all(split.values()) and split_o and own == whole
    if cfg.attn != "mla":
        kv = cfg.n_kv_heads // shape[1] if whole else cfg.n_kv_heads
        assert LMM.cache_shapes(cfg, 2, 8, cm)["seg0"]["u0"]["k"].shape[
            -2] == kv


@pytest.mark.parametrize("tied", [1, 0])
def test_vocab_parallel_ids_outside_the_vocabulary(runs, tied):
    """gemma2 on (1, 4), the embedding (and the untied head) split on the
    vocabulary: token ids outside [-V, V) give NaN where the reference's
    ``forward`` does (its rows and the positions after them), ids in
    [-V, 0) wrap, and the rest agrees within 1e-5 (1 + |ref|); a label
    outside [-V, V) makes the loss NaN in both, labels in [-V, 0) wrap."""
    key = f"vocab/{tied}"
    want = runs.ref[f"{key}/hidden"]
    nan = np.isnan(want)
    for r, c, v in R.BAD_TOKENS:
        assert nan[r, c].all() == (not -R.V <= v < R.V)
    for got in runs.ranks:
        h = got[f"{key}/hidden"]
        np.testing.assert_array_equal(np.isnan(h), nan)
        _close(np.where(nan, 0, h), np.where(nan, 0, want), "hidden")
        for name in R.BAD_LABELS:
            lw, lg = runs.ref[f"{key}/loss/{name}"], got[f"{key}/loss/{name}"]
            assert np.isnan(lw) == (name != "wrap") == np.isnan(lg), name
            if name == "wrap":
                _close(lg, lw, name)


def _tally_of(res, mesh, arch):
    pre = f"tally/{mesh}/{arch}/"
    return {k[len(pre):]: int(v) for k, v in res.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("mesh,arch", R.TALLY_CASES)
def test_live_tally_equals_the_counting_mesh(runs, mesh, arch):
    """One train step's collective bytes, kind by kind, on each of the
    four gloo ranks equal the counting mesh's for the same config, mesh
    shape and batch (rank 0's blocks, no process group)."""
    cfg, params, batch = R.lm_inputs(runs.inputs, arch)
    dp, tp = R.MESHES[mesh]
    want = R.lm_step_tally(cfg, params, batch, CO.CountingMesh(
        {"data": dp, "model": tp}))
    assert want["total"] > 0 and want["all-reduce"] > 0
    assert ("reduce-scatter" in want) == (dp > 1)
    for res in runs.ranks:
        assert _tally_of(res, mesh, arch) == want


def test_hand_count_of_a_forward_on_a_model_axis():
    """The reduced gemma2-2b's forward and loss on (1, 4), B = 4, S = 32,
    float32, counted by hand: the embedding's lookup (rows summed over
    the vocabulary's 4 blocks) and each layer's ``wo`` and FFN
    ``reduce_from``, a (B, S, d) all-reduce each; KV 2 cuts a head on 4
    ranks, so each layer gathers q, k and v whole; the loss reduces its
    row maxima and its (sum of exp, gold) pair."""
    from repro_torch.distributed import lm_param_spec, param_specs, reshard

    cfg = C.get_arch("gemma2-2b").make_config(reduced=True)
    B, S, f32 = 4, 32, 4
    d, H, KV, dh, n_layers = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.n_layers)
    cm = CO.CountingMesh({"data": 1, "model": 4})
    meta = LMM.param_shapes(cfg)
    params = reshard(meta, cm, param_specs(meta, lm_param_spec, MeshAxes(),
                                           cm))
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with torch.no_grad(), CO.Tally() as t:
        LMM.lm_loss(params, batch, cfg, mesh=cm)
    act = B * S * d * f32
    embed = act
    layer_reduce = 2 * act                                  # wo, FFN
    layer_gather = B * S * (H * dh + 2 * KV * dh) * f32     # q, k, v
    loss = B * S * f32 + 2 * B * S * f32                    # max; exp, gold
    want = {"all-reduce": embed + n_layers * layer_reduce + loss,
            "all-gather": n_layers * layer_gather}
    want["total"] = sum(want.values())
    assert t.bytes == want
    assert want == {"all-reduce": 296448, "all-gather": 262144,
                    "total": 558592}


def test_counting_mesh_crossings_and_tally():
    """Each crossing on a counting mesh returns the live result's shape
    and tallies its bytes by kind (a backward crossing when autograd
    runs it); an axis the mesh lacks or of one rank crosses nothing, and
    outside a ``Tally`` nothing is counted."""
    cm = CO.CountingMesh({"data": 2, "model": 4})
    x = torch.ones(3, 8, requires_grad=True)
    n = 3 * 8 * 4
    CO.reduce_from(x, cm, "model")                      # no tally open
    with CO.Tally() as t:
        assert CO.reduce_from(x, cm, "model").shape == (3, 8)
        g = CO.all_gather(x, cm, "model", 1)
        assert g.shape == (3, 32)
        assert CO.reduce_scatter(x.detach(), cm, "data", 1).shape == (3, 4)
        assert not CO.max_over(x, cm, "model").requires_grad
        CO.first_of(x, cm, "data")
        (gx,) = torch.autograd.grad(CO.copy_to(x, cm, "model").sum()
                                    + g.sum(), x)
        assert CO.all_reduce(x.detach(), cm, ("pod", "model")).shape == (
            3, 8)
    assert torch.equal(gx, torch.full((3, 8), 2.0))   # sum's + own block
    assert t.bytes == {"all-reduce": 4 * n, "all-gather": 4 * n,
                       "reduce-scatter": n // 2,
                       "collective-permute": n, "total": 19 * n // 2}
    one = CO.CountingMesh({"data": 1, "model": 4})
    with CO.Tally() as t:
        assert CO.all_reduce(x, one, "data") is x
        assert CO.all_gather(x, one, "pod", 0) is x
    assert t.bytes == {}


def test_reshard_onto_a_counting_mesh():
    """``reshard`` onto a counting mesh: rank 0's block of each leaf,
    recorded with its spec; the process mesh's refusals (an axis the
    mesh lacks, a dim its axes do not divide)."""
    from repro_torch.distributed import reshard

    cm = CO.CountingMesh({"data": 2, "model": 4})
    x = torch.arange(32.0).reshape(4, 8)
    out = reshard({"a": x, "b": x}, cm, {"a": ("data", "model"),
                                         "b": ()})
    assert torch.equal(out["a"], x[:2, :2]) and out["b"] is x
    assert CO.spec_of(out["a"]) == ("data", "model")
    assert CO.mesh_of(out["a"]) is cm and CO.spec_of(out["b"]) == ()
    with pytest.raises(ValueError, match="no axis"):
        reshard({"a": x}, cm, {"a": ("pod",)})
    with pytest.raises(ValueError, match="evenly divide"):
        reshard({"a": torch.zeros(6)}, cm, {"a": ("model",)})


# ------------------------------------------------------ reshard, checkpoint

@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_reshard_shards_match_reference(runs, mesh):
    """Each rank's local shard equals the reference's addressable shard
    at the same mesh coordinate, bit for bit, and ``collectives.full``
    puts the logical array back together on every rank; a dim the axis
    does not divide raises ``ValueError`` in both."""
    for r, _, _ in _ranks(mesh):
        for name in R.RESHARD:
            np.testing.assert_array_equal(
                runs.ranks[r][f"reshard/{mesh}/{name}"],
                runs.ref[f"reshard/{mesh}/{name}/{r}"])
            np.testing.assert_array_equal(
                runs.ranks[r][f"reshard/{mesh}/{name}/full"],
                runs.inputs[f"reshard/{name}"])
        for side in (runs.ranks[r], runs.ref):
            msg = str(side[f"reshard/{mesh}/no_divide"])
            assert msg.startswith("ValueError"), msg
    assert "evenly divide" in str(runs.ranks[0][f"reshard/{mesh}/no_divide"])


def _saved(runs):
    """The checkpoint read back as logical arrays, in one process."""
    params = jax.tree.map(lambda a: torch.tensor(np.array(a)), R.tree_from(
        runs.inputs, f"lm/{R.CKPT_ARCH}/params/"))
    tree, manifest = restore_checkpoint(
        runs.ckpt, {"params": params, "opt": adamw_init(params)})
    return dict(walk(tree)), manifest


def test_checkpoint_saved_on_2x2_holds_the_trained_state(runs):
    """Rank 0 wrote the (2, 2) run's state after its step as logical
    arrays: each rank's shards are its blocks of them."""
    saved, manifest = _saved(runs)
    assert manifest["step"] == 1
    key = f"lm/2x2/{R.CKPT_ARCH}/step"
    for r, d, m in _ranks("2x2"):
        for path, v in saved.items():
            np.testing.assert_array_equal(
                runs.ranks[r][f"{key}/{path}"],
                _my_block(v.numpy(), path, d, m, 2, 2))


@pytest.mark.parametrize("mesh", R.RESTORE_MESHES)
def test_checkpoint_restores_on_another_mesh(runs, mesh):
    """The (2, 2) checkpoint restored onto (1, 4) and (4, 1) through a
    template of DTensors placed there: each rank's shard is its block of
    the saved tree, and ``collectives.full`` gives the saved tree back."""
    saved, _ = _saved(runs)
    tp = R.MESHES[mesh][1]
    key = f"restore/{mesh}"
    for r, _, m in _ranks(mesh):
        got = runs.ranks[r]
        assert int(got[f"{key}/step"]) == 1
        for path, v in saved.items():
            np.testing.assert_array_equal(
                got[f"{key}/local/{path}"],
                _expert_block(v.numpy(), path, m, tp))
    for path, v in saved.items():
        np.testing.assert_array_equal(runs.ranks[0][f"{key}/full/{path}"],
                                      v.numpy())


@pytest.mark.parametrize("mesh", R.RESTORE_MESHES)
def test_save_async_refuses_dtensor_leaves(runs, mesh):
    """The asynchronous writer takes no DTensor leaves: every rank of
    the restored tree's mesh is told to use ``save_checkpoint``."""
    for r, _, _ in _ranks(mesh):
        msg = str(runs.ranks[r][f"restore/{mesh}/save_async"])
        assert msg.startswith("ValueError") and "save_checkpoint" in msg, \
            msg


# ------------------------------------------------- one process, no ranks

def _named_mesh(shape):
    """A stand-in with a process mesh's names and sizes (what
    ``placements`` reads)."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: shape[i])


@pytest.mark.parametrize("spec,want", [
    (("data", "model"), ("S0", "S1")),
    ((None, "model"), ("R", "S1")),
    ((("data", "model"),), ("S0", "S0")),
    (("model", "data"), ("S1", "S0")),
    ((), ("R", "R")),
    ((None, None), ("R", "R")),
])
def test_placements_follow_the_spec(spec, want):
    from torch.distributed.tensor import Replicate, Shard

    got = SH.placements(spec, _named_mesh((2, 2)), (8, 4))
    assert got == tuple(Replicate() if w == "R" else Shard(int(w[1]))
                        for w in want)


@pytest.mark.parametrize("spec,shape,match", [
    (("model",), (6,), "evenly divide"),
    ((("data", "model"),), (6,), "evenly divide"),
    ((("model", "data"),), (16,), "mesh's order"),
    (("pod",), (16,), "no axis"),
    (("data", "data"), (4, 4), "used twice"),
    ((("model", "model"),), (16,), "used twice"),
    ((None, None, "model"), (4, 4), "more entries"),
])
def test_placements_refuse_what_jax_refuses(spec, shape, match):
    with pytest.raises(ValueError, match=match):
        SH.placements(spec, _named_mesh((2, 4)), shape)


def test_lm_expert_param_spec_splits_only_the_experts():
    axes = SH.MeshAxes()
    rule = SH.lm_expert_param_spec
    assert rule("seg1/u1/moe/w_gu", (4, 8, 64, 256), axes, 4) == (
        None, "model", None, None)
    assert rule("seg1/u1/moe/sh_gu", (4, 64, 2, 128), axes, 4) == (
        None, None, None, "model")
    assert rule("seg1/u1/moe/router", (4, 64, 8), axes, 4) == (
        None, None, None)
    assert rule("seg0/u0/attn/wq", (64, 64), axes, 4) == (None, None)
    assert rule("embed/emb", (512, 64), axes, 4) == (None, None)


def test_process_mesh_refuses_a_single_process_mesh_of_several_devices():
    cpu = torch.device("cpu")
    assert CO.process_mesh(None) is None
    assert CO.process_mesh(LM.ShardMesh((cpu,))) is None
    with pytest.raises(ValueError, match="process mesh"):
        CO.process_mesh(LM.ShardMesh((cpu, cpu)))
    with pytest.raises(ValueError, match="process mesh"):
        CO.process_mesh({"data": 1, "model": 2})


@pytest.mark.parametrize("backend,kw,match", [
    ("mpi", {}, "backend"),
    ("nccl", dict(store="s", rank=0, world_size=2), "one card a rank"),
    ("nccl", dict(store="s", rank=0, world_size=1, device="cpu"),
     "no device"),
    ("gloo", dict(store="s"), "rank and world_size"),
])
def test_init_ranks_refuses(backend, kw, match):
    """An unknown backend, NCCL with more ranks than cards (none here)
    or with a device, and a file store without a rank all raise before
    any group is joined."""
    with pytest.raises(ValueError, match=match):
        LM.init_ranks(backend, **kw)
    assert not torch.distributed.is_initialized()


def test_collectives_are_identities_off_the_mesh_axes():
    mesh = types.SimpleNamespace(mesh_dim_names=("data",))
    x = torch.arange(3.0)
    for fn in (CO.reduce_from, CO.copy_to, CO.first_of, CO.all_reduce):
        assert fn(x, mesh, "model") is x
