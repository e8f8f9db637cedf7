"""The GNN and DIN families on the process mesh under ``mlp_param_spec``
(the Megatron MLP pairs and row-split tables of ``models.nn``, a full
graph's nodes, edges and triplets split over ``data`` by
``models.gnn.common.GraphSplit``, ZeRO-1 moments), on four gloo ranks
on the CPU, held to the reference on four forced CPU devices (Auto axes:
ROADMAP R12) under its own ``NamedSharding``s: its parameters placed by
``param_specs(..., mlp_param_spec, ...)``, its AdamW state by
``opt_state_specs`` and its batches by the ``_gnn_batch_sds`` /
``_din_batch_sds`` specs, GSPMD partitioning the step.

Both sides run once per module, in processes of their own and at the
same time (``tests/torch_mesh_mlp_runs.py``: the reference's cases in
two processes).  Every input is made here with NumPy from a seed: the
reduced configs' parameters in the reference's trees (``jax.
eval_shape`` of its ``init_params``), carried across by ``convert``,
and the batches.

Tolerance: losses, the AdamW step's norm, moments and parameters,
serving logits and retrieval scores within 1e-5 (1 + |ref|); gradients
within that plus ULPS float32 ulps of the leaf's largest |ref|.  Both
sides sum float32 in other orders (XLA against PyTorch, one process
against four), and a gradient summed from terms of its leaf's largest
size rounds at that size: EquiformerV2's molecule `embed/emb` gradient
reaches 3,030 and holds entries near 1 left by cancelling sums, and the
reference's own (1, 4) and (2, 2) runs differ there by 4.7e-5
(1 + |ref|), 0.38 ulps of the leaf's scale beyond the first term
(and by up to 0.29 on its `so2_m0` and `ffn_scalar` gradients).  The
port goes beyond the first term on eight gradient leaves, by at most
1.27 ulps of their scale (EquiformerV2's molecule `rad`, `embed`,
`so2_m0` and `ffn_scalar` gradients on (2, 2) and (1, 4), DimeNet's
graph `msg_init/l0/w` on (4, 1) and (2, 2)); no other leaf does.
EquiformerV2's last attention biases
(``layer*/attn/l1/b``) shift every logit of a head by the same amount,
which the softmax over a node's edges normalises away: their gradient is
zero in exact arithmetic, and on both sides rounding noise whose value
depends on the order of the sums, so it is held to be noise in both,
below NOISE times the case's largest gradient (``chip_smoke.py``'s GNN
check exempts them alike).  The new crossings and the tallies are
exact.
"""

import os
import re
import subprocess
import sys
import types

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.configs as RCF
from repro_torch import configs as C
from repro_torch.configs.base import train_state
from repro_torch.convert import din_params_from_jax, gnn_params_from_jax
from repro_torch.distributed import MeshAxes
from repro_torch.distributed import collectives as CO
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.tree import walk
from repro_torch.models import nn as NN
from repro_torch.models.recsys import din as DIN

import torch_mesh_mlp_runs as R
from torch_mesh_runs import MESHES

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 1e-5
ULPS = 2
NOISE = 1e-6
ZERO_IN_EXACT = re.compile(r"equiformer-v2/.*/grad/layer\d+/attn/l1/b$")
RUN_TIMEOUT_S = 240


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                       else []))
    return env


def draw_params(init_params, cfg, rng) -> dict:
    """Seeded NumPy values in the reference's parameter tree (``jax.
    eval_shape`` of its ``init_params``: no draw compiled) at its
    initialisers' scales: a weight N(0, 1 / d_in), a table N(0, 0.02^2),
    a norm's scale 1 + N(0, 0.1^2), a bias N(0, 0.1^2) (not zero, so
    each rank's slice of it and its one addition after a sum show)."""
    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape)
        if name == "emb":
            x = x * 0.02
        elif name == "scale":
            x = 1 + 0.1 * x
        elif len(s.shape) >= 2:
            x = x / np.sqrt(s.shape[-2])
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_inputs() -> dict:
    """The parameters (NumPy, seed 0, in the reference's trees, carried
    across by ``convert``) and the batches (NumPy, seed 0) of every
    case."""
    rng = np.random.default_rng(0)
    z = {}
    for arch in R.GNN_ARCHS:
        rmod = __import__(f"repro.models.gnn.{arch.replace('-', '_')}",
                          fromlist=["init_params"])
        for i, cell in enumerate(R.CELLS):
            rcfg = R.gnn_config(arch, cell, RCF)
            rp = draw_params(rmod.init_params, rcfg, rng)
            pre = f"gnn/{arch}/{cell}"
            for path, v in walk(gnn_params_from_jax(rp, "cpu")):
                z[f"{pre}/params/{path}"] = v.numpy()
            b = (R.graph_batch(rng, arch, rcfg) if cell == "graph"
                 else R.molecule_batch(arch, rcfg, seed=i))
            for k, v in b.items():
                z[f"{pre}/batch/{k}"] = np.asarray(v)
    from repro.models.recsys import din as RD

    rcfg = RCF.get_arch("din").make_config(reduced=True)
    rp = draw_params(RD.init_params, rcfg, rng)
    for path, v in walk(din_params_from_jax(rp, "cpu")):
        z[f"din/params/{path}"] = v.numpy()
    for which, b in R.din_batches(rng, rcfg).items():
        for k, v in b.items():
            z[f"din/batch/{which}/{k}"] = v
    return z


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results: the reference's arrays and the port's per rank
    (``ranks[r]``, mesh coordinate ``divmod(r, model)``)."""
    tmp = tmp_path_factory.mktemp("mesh_mlp")
    z = make_inputs()
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    script = os.path.join(HERE, "torch_mesh_mlp_runs.py")
    procs = {
        f"reference {part}": subprocess.Popen(
            [sys.executable, script, "reference", inputs, str(tmp),
             str(part)],
            # unoptimised XLA compiles in about half the CPU time, and
            # runs the same operations unfused
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_DISABLE_MOST_OPTIMIZATIONS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in (0, 1)}
    procs["ranks"] = subprocess.Popen(
        [sys.executable, script, "ranks", inputs, str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
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
        ref={**load("reference0.npz"), **load("reference1.npz")},
        ranks=[load(f"rank{r}.npz") for r in range(4)], inputs=z)


def _ranks(mesh_name):
    dp, tp = MESHES[mesh_name]
    return [(r, *divmod(r, tp)) for r in range(dp * tp)]


def _close(got, want, what, scale=None):
    """``got`` within TOL (1 + |want|), plus ULPS float32 ulps of
    ``scale`` where one is given (a gradient: its whole leaf's largest
    |ref|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ulp = 0.0 if scale is None else float(np.spacing(np.float32(scale)))
    err = np.abs(got - want) - TOL * (1 + np.abs(want)) - ULPS * ulp
    assert err.max(initial=-1) <= 0, (what, float(np.abs(got - want).max()))


def _leaves(res, key):
    pre = f"{key}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _spec(path, shape, dp, tp):
    """The spec a leaf of ``{"params", "opt"}`` or a gradient is placed
    by: ``mlp_param_spec`` for a parameter or a gradient (summed over
    ``data``), ZeRO-1's for a moment."""
    moment = path.startswith(("opt/.m/", "opt/.v/"))
    for pre in ("params/", "opt/.m/", "opt/.v/"):
        if path.startswith(pre):
            path = path[len(pre):]
    if path == "opt/.step":
        return ()
    spec = SH.mlp_param_spec(path, shape, MeshAxes(), tp)
    if moment:
        tree = {"w": torch.empty(shape, device="meta")}
        spec = SH.zero1_specs(tree, {"w": spec}, MeshAxes(),
                              {"data": dp, "model": tp})["w"]
    return spec


def _block(a, dim, i, n):
    b = a.shape[dim] // n
    return np.take(a, np.arange(i * b, (i + 1) * b), axis=dim)


def _my_block(want, path, d, m, dp, tp):
    """Rank (d, m)'s block of the logical ``want`` under ``_spec``."""
    for dim, entry in enumerate(_spec(path, want.shape, dp, tp)):
        if entry is not None:
            for a in (entry,) if isinstance(entry, str) else entry:
                n, i = (dp, d) if a == "data" else (tp, m)
                want = _block(want, dim, i, n)
    return want


def _check_train(runs, key, mesh):
    """The loss on every rank, every gradient (summed over ``data``, each
    model rank's block of the split ones), then the AdamW step's loss,
    clip norm, moments and parameters, against the reference; and the
    specs split at least one parameter, moment or batch leaf on this
    mesh."""
    dp, tp = MESHES[mesh]
    ref = runs.ref
    grads = _leaves(ref, f"{key}/grad")
    step = {k: v for k, v in _leaves(ref, f"{key}/step").items()
            if k not in ("loss", "grad_norm")}
    assert grads and step
    noise = NOISE * max(np.abs(g).max() for g in grads.values())
    for r, d, m in _ranks(mesh):
        got = runs.ranks[r]
        assert int(got[f"{key}/split"]) >= 1
        _close(got[f"{key}/loss"], ref[f"{key}/loss"], "loss")
        for path, want in grads.items():
            g = got[f"{key}/grad/{path}"]
            if ZERO_IN_EXACT.search(f"{key}/grad/{path}"):
                assert max(np.abs(g).max(), np.abs(want).max()) < noise
                continue
            _close(g, _my_block(want, path, d, m, 1, tp), path,
                   np.abs(want).max())
        for k in ("loss", "grad_norm"):
            _close(got[f"{key}/step/{k}"], ref[f"{key}/step/{k}"], k)
        for path, want in step.items():
            _close(got[f"{key}/step/{path}"],
                   _my_block(want, path, d, m, dp, tp), path)


@pytest.mark.parametrize("mesh,arch,cell", R.GNN_CASES)
def test_gnn_train_step_matches_reference(runs, mesh, arch, cell):
    """A reduced GNN's loss, gradients and one AdamW step on a full graph
    (nodes, edges and DimeNet's triplets split over ``data``, the energy
    whole) or a batch of molecules (split by molecule), its MLPs and
    species table under ``mlp_param_spec`` over ``model``."""
    _check_train(runs, R.gnn_key(mesh, arch, cell), mesh)


@pytest.mark.parametrize("mesh", R.DIN_MESHES)
def test_din_train_step_matches_reference(runs, mesh):
    """DIN's loss, gradients and one AdamW step, its tables split on
    their rows and both MLPs in the Megatron pairing over ``model``, the
    batch's rows over ``data``."""
    _check_train(runs, f"din/{mesh}/train", mesh)


def test_din_serving_rows_match_reference(runs):
    """``apply`` on each rank's rows of a serving batch on (1, 4): the
    reference's logits for them."""
    dp, _ = MESHES[R.SERVE_MESH]
    want = runs.ref[f"din/{R.SERVE_MESH}/serve"]
    for r, d, _ in _ranks(R.SERVE_MESH):
        n = len(want) // dp
        _close(runs.ranks[r][f"din/{R.SERVE_MESH}/serve"],
               want[d * n:(d + 1) * n], "serve")
        assert int(runs.ranks[r][f"din/{R.SERVE_MESH}/serve/split"]) >= 1


def test_din_ids_outside_the_table_give_nan_as_the_reference(runs):
    """Item ids outside [-V, V) in the history or the target make the
    row's logit NaN in both packages, through the row-split tables; ids
    in [-V, 0) wrap; the rest agrees."""
    key = f"din/{R.SERVE_MESH}/bad"
    want = runs.ref[key]
    nan = np.isnan(want)
    V = C.get_arch("din").make_config(reduced=True).n_items
    assert [bool(nan[r]) for r, _, _ in R.DIN_BAD] == [
        not -V <= v < V for _, _, v in R.DIN_BAD]
    for got in runs.ranks:
        np.testing.assert_array_equal(np.isnan(got[key]), nan)
        _close(np.where(nan, 0, got[key]), np.where(nan, 0, want), key)
        assert int(got[f"{key}/split"]) >= 1


@pytest.mark.parametrize("mesh", R.RETRIEVAL_MESHES)
def test_din_retrieval_matches_reference(runs, mesh):
    """``score_candidates`` with the candidates split over ``data``: 48
    and 24 a rank, neither a multiple of the chunk of 32, so each rank's
    last chunk is partial; its block of the reference's scores."""
    dp, _ = MESHES[mesh]
    want = runs.ref[f"din/{mesh}/retrieval"]
    n = R.DIN_CANDIDATES // dp
    assert n % R.DIN_CHUNK
    for r, d, _ in _ranks(mesh):
        _close(runs.ranks[r][f"din/{mesh}/retrieval"],
               want[d * n:(d + 1) * n], "retrieval")
        assert int(runs.ranks[r][f"din/{mesh}/retrieval/split"]) >= 1


def test_gather_and_scatter_gradients_over_data(runs):
    """The two crossings a split graph adds, on (4, 1), each rank's loss
    weighting the result by weights of its own: ``gather_sum``'s
    gradient is the ranks' weights summed, cut to this rank's block (a
    reduce-scatter); ``reduce_scatter``'s is the ranks' weight blocks
    joined (an all-gather).  Exact."""
    n = 4
    xs = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(n)]
    ws = [np.arange(n * 2 * 3.0).reshape(n * 2, 3) * (r + 1)
          for r in range(n)]
    for r, res in enumerate(runs.ranks):
        np.testing.assert_array_equal(res["cross/gather/y"],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(res["cross/gather/grad"],
                                      sum(ws)[2 * r:2 * r + 2])
    xs = [np.arange(n * 2 * 3.0).reshape(n * 2, 3) * (r + 1)
          for r in range(n)]
    ws = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(n)]
    for r, res in enumerate(runs.ranks):
        np.testing.assert_array_equal(res["cross/scatter/y"],
                                      sum(xs)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["cross/scatter/grad"],
                                      np.concatenate(ws))


def _tally_of(res, mesh, arch, cell):
    pre = f"tally/{mesh}/{arch}/{cell}/"
    return {k[len(pre):]: int(v) for k, v in res.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("mesh,arch,cell", R.TALLY_CASES)
def test_live_tally_equals_the_counting_mesh(runs, mesh, arch, cell):
    """One train step's collective bytes, kind by kind, on each of the
    four gloo ranks equal the counting mesh's for the same case and mesh
    shape (rank 0's blocks, no process group)."""
    dp, tp = MESHES[mesh]
    cm = CO.CountingMesh({"data": dp, "model": tp})
    if arch == "din":
        cfg, params = R.din_case(runs.inputs, cm)
        want = R.step_tally(lambda p, b: (DIN.loss_fn(p, b, cfg, cm), {}),
                            params, R._tensors(R.tree_from(
                                runs.inputs, "din/batch/train/")), cm)
    else:
        loss_fn, params, batch, specs = R.gnn_case(runs.inputs, arch, cell,
                                                   cm)
        want = R.step_tally(loss_fn, params, batch, cm, specs)
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(want)
    for res in runs.ranks:
        assert _tally_of(res, mesh, arch, cell) == want


def test_hand_count_of_a_din_forward_on_a_model_axis():
    """The reduced DIN's loss on (1, 4), B rows of S history items,
    float32, counted by hand: each table's lookup sums its row blocks
    over ``model`` (the history's (B, S, d) and the target's (B, d), for
    the item and the category table); each MLP's second layer meets the
    first's column block and sums its (.., h2) output, and its third,
    row-split on a replicated input, sums its (.., 1) output; the mean
    crosses no data axis of one rank."""
    cfg = C.get_arch("din").make_config(reduced=True)
    B, S, d, f32 = R.DIN_B, cfg.seq_len, cfg.embed_dim, 4
    cm = CO.CountingMesh({"data": 1, "model": 4})
    meta = DIN.param_shapes(cfg)
    params = train_state(meta, SH.mlp_param_spec, cm)[0]
    batch = {"hist_items": torch.empty((B, S), dtype=torch.int32,
                                       device="meta"),
             "hist_mask": torch.empty((B, S), dtype=torch.bool,
                                      device="meta"),
             "target_item": torch.empty((B,), dtype=torch.int32,
                                        device="meta"),
             "label": torch.empty((B,), dtype=torch.float32, device="meta")}
    with torch.no_grad(), CO.Tally() as t:
        DIN.loss_fn(params, batch, cfg, cm)
    tables = 2 * (B * S * d + B * d)
    attn = B * S * (cfg.attn_hidden[1] + 1)
    head = B * (cfg.mlp_hidden[1] + 1)
    want = {"all-reduce": f32 * (tables + attn + head)}
    want["total"] = want["all-reduce"]
    assert t.bytes == want
    assert want["all-reduce"] == 86336


@pytest.mark.parametrize("arch,tp,want", [
    ("schnet", 4, 14), ("dimenet", 4, 22), ("graphcast", 4, 10),
    ("equiformer-v2", 4, 98), ("din", 4, 8),
    ("schnet", 16, 14), ("dimenet", 16, 21), ("graphcast", 16, 10),
    ("equiformer-v2", 16, 98), ("din", 16, 4)])
def test_leaves_the_rule_splits_at_published_widths(arch, tp, want):
    """How many leaves ``mlp_param_spec`` splits at the published widths
    of the feature-graph cells (on meta): DIN's item table at both
    sizes, its category table and its head's first two layers only where
    4 divides them."""
    spec = C.get_arch(arch)
    cell = spec.cells["train_batch" if arch == "din" else "full_graph_sm"]
    meta = cell.build()[1][0]
    n = sum(any(e is not None for e in SH.mlp_param_spec(
        p, tuple(x.shape), MeshAxes(), tp)) for p, x in walk(meta))
    assert n == want


def test_mlp_refuses_a_layer_without_its_bias_under_a_model_axis():
    """Under a model axis an MLP layer's split is read from its bias;
    one without a bias raises rather than guess, and a width that is
    neither the logical one nor its block raises."""
    cm = CO.CountingMesh({"data": 1, "model": 4})
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="bias"):
        NN.mlp({"l0": {"w": torch.zeros(8, 2)}}, x, mesh=cm)
    with pytest.raises(ValueError, match="neither"):
        NN.mlp({"l0": {"w": torch.zeros(8, 3), "b": torch.zeros(8)}}, x,
               mesh=cm)


@pytest.mark.parametrize("arm,w,b,width,kind", [
    ("cols", (8, 4), 16, 16, "all-gather"),
    ("rows", (2, 5), 5, 5, "all-reduce"),
    ("whole", (8, 5), 5, 5, None)])
def test_dense_arms_on_a_counting_mesh(arm, w, b, width, kind):
    """A one-layer ``mlp`` on rank 0 of a (1, 4) counting mesh: a
    column-split ``w`` (its width a quarter of its bias's) has no
    row-split partner and gathers its output over ``model``, a row-split
    one on a replicated input cuts its slice and sums, a whole one
    crosses nothing; each output has the logical width and the tally its
    result's bytes."""
    cm = CO.CountingMesh({"data": 1, "model": 4})
    p = {"l0": {"w": torch.ones(w), "b": torch.zeros(b)}}
    with CO.Tally() as t:
        y = NN.mlp(p, torch.ones(3, 8), mesh=cm)
    assert y.shape == (3, width)
    n = 3 * width * 4
    assert t.bytes == ({kind: n, "total": n} if kind else {})
