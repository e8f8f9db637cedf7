"""The port's GNN family (``repro_torch.models.gnn``: the segment
substrate, SchNet, DimeNet, GraphCast; its configs and cells,
``molecule_batches``, the neighbour sampler, ``gnn_params_from_jax``,
the launcher's GNN arm and the ``gnn_molecules`` example) against the
JAX package's, on the CPU; and the exports of every package that both
have (ROADMAP F5).  EquiformerV2 and the SO(3) machinery are in
``test_torch_gnn_so3.py``.

The same inputs, made from a seed with NumPy (or the reference's
parameters, carried over by ``gnn_params_from_jax``), go through both.
Both compute in float32 and the CPU matrix products of XLA and PyTorch
may sum in another order, so energies and losses are held within 1e-5
absolute plus 1e-5 relative (``TOL``) and gradients within 1e-4 of the
larger of 1 and each tensor's largest magnitude (``GRAD_TOL``; a bias
before a softmax has a gradient that is zero in exact arithmetic, so a
bound relative to the tensor alone says nothing there).  Measured here:
outputs at most 8.8e-6 apart (GraphCast's published widths, outputs up
to 7.2), losses 7.6e-6 (of about 107), gradients at most 1.1e-6 of the
bound's scale.  Host arrays (batches, triplets, blocks) must be
equal.

Each reference output is computed once per module (``_ref_*``, cached).
"""

import ast
import functools
import pathlib

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
from repro.core.graph import build_csr as r_build_csr
from repro.data import pipeline as RP
from repro.data import sampler as RS
from repro.models.gnn import common as RG
from repro.models.gnn import dimenet as RDN
from repro.models.gnn import graphcast as RGC
from repro.models.gnn import schnet as RSN
from repro_torch import configs as C
from repro_torch.configs import base as CB
from repro_torch.convert import gnn_params_from_jax
from repro_torch.core.graph import build_csr
from repro_torch.data import (
    ShardInfo,
    molecule_batches,
    pad_block,
    sample_blocks,
)
from repro_torch.launch import train as LT
from repro_torch.models.gnn import common as G
from repro_torch.models.gnn import dimenet as DN
from repro_torch.models.gnn import graphcast as GC
from repro_torch.models.gnn import schnet as SN
from repro_torch.train.optim import tree_leaves

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
MODELS = {"schnet": (RSN, SN), "dimenet": (RDN, DN),
          "graphcast": (RGC, GC)}
GNN_ARCHS = ("graphcast", "dimenet", "equiformer-v2", "schnet")
# the launcher's molecules (the reference's ``build_reduced``)
N_NODES, N_EDGES, BATCH, TRIPLETS = 12, 32, 8, 128


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _with_triplets(b, n_nodes, budget):
    """``b`` with DimeNet's triplets per molecule, from the reference's
    ``build_triplets``."""
    trip = [RDN.build_triplets(s, d, n_nodes, budget)
            for s, d in zip(b["edge_src"], b["edge_dst"])]
    return dict(b, **{k: np.stack(v) for k, v in zip(
        ("id_kj", "id_ji", "triplet_mask"), zip(*trip))})


def graph_case(seed=3, n=14, e=40, n_pad=6, d_feat=None, n_vars=None):
    """One graph of ``n`` nodes and ``e`` edges, the last ``n_pad``
    masked padding edges 0 -> 0 and the last node masked; species (or
    ``d_feat`` features, or GraphCast's ``n_vars`` features and target)
    and DimeNet's triplets (budget 256)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (src + 1 + rng.integers(0, n - 1, e)) % n
    src[e - n_pad:] = dst[e - n_pad:] = 0
    emask = np.arange(e) < e - n_pad
    g = {"pos": rng.standard_normal((n, 3)).astype(np.float32) * 1.5,
         "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
         "edge_mask": emask, "node_mask": np.arange(n) < n - 1,
         "species": rng.integers(0, 10, n).astype(np.int32)}
    if d_feat is not None:
        g["feat"] = rng.standard_normal((n, d_feat)).astype(np.float32)
    if n_vars is not None:
        g["feat"] = rng.standard_normal((n, n_vars)).astype(np.float32)
        g["target"] = rng.standard_normal((n, n_vars)).astype(np.float32)
    kj, ji, tm = RDN.build_triplets(src, dst, n, 256)
    return dict(g, id_kj=kj, id_ji=ji, triplet_mask=tm)


def molecules(seed=0, start=0):
    b = next(RP.molecule_batches(N_NODES, N_EDGES, BATCH, seed=seed,
                                 start_step=start))
    return _with_triplets(b, N_NODES, TRIPLETS)


def _graphcast_molecules(b, n_vars, seed=1):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal(b["pos"].shape[:2] + (n_vars,)).astype(
        np.float32)
    b = {k: v for k, v in b.items() if k != "energy"}
    return dict(b, feat=feat, target=feat * 0.9)


# --------------------------------------------------------------------------
# the segment substrate
# --------------------------------------------------------------------------

def _seg_inputs(seed=0, E=50, n=9, D=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, D)).astype(np.float32)
    idx = rng.integers(0, n - 2, E).astype(np.int32)   # n-2, n-1 empty
    return x, idx, n


COMMON = {
    "seg_sum": lambda m, x, i, n: m.seg_sum(x, i, n),
    "seg_mean": lambda m, x, i, n: m.seg_mean(x, i, n),
    "seg_max": lambda m, x, i, n: m.seg_max(x, i, n),
    "seg_softmax": lambda m, x, i, n: m.seg_softmax(x, i, n),
    "gaussian_rbf": lambda m, x, i, n: m.gaussian_rbf(abs(x[:, 0]) * 4,
                                                      30, 10.0),
    "bessel_rbf": lambda m, x, i, n: m.bessel_rbf(abs(x[:, 0]) * 4, 8,
                                                  5.0),
    "smooth_cutoff": lambda m, x, i, n: m.smooth_cutoff(abs(x[:, 0]) * 4,
                                                        5.0),
    "masked_graph_readout": lambda m, x, i, n: m.masked_graph_readout(
        x, x[:, 0] > 0),
    "masked_graph_readout_none": lambda m, x, i, n:
        m.masked_graph_readout(x, None),
}


@pytest.mark.parametrize("name", COMMON)
def test_common_matches_reference(name):
    """Each segment reduction and basis of ``common`` against the
    reference's on the same inputs; the two empty segments give 0 (sum,
    mean) and -inf (max), as ``jax.ops.segment_*`` gives them."""
    x, idx, n = _seg_inputs()
    want = np.asarray(COMMON[name](RG, jnp.asarray(x), jnp.asarray(idx), n))
    got = COMMON[name](G, torch.as_tensor(x), torch.as_tensor(idx),
                       n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "seg_max":
        assert np.isneginf(got[n - 2:]).all()


def test_edge_vectors_match_reference():
    g = graph_case()
    rv, rd = RG.edge_vectors(jnp.asarray(g["pos"]),
                             jnp.asarray(g["edge_src"]),
                             jnp.asarray(g["edge_dst"]))
    v, d = G.edge_vectors(torch.as_tensor(g["pos"]),
                          torch.as_tensor(g["edge_src"]).long(),
                          torch.as_tensor(g["edge_dst"]).long())
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-7)
    assert float(d[-1]) == pytest.approx(1e-6)     # a 0 -> 0 padding edge


def test_seg_sum_refuses_ids_out_of_range():
    """``index_add`` raises on an id outside [0, n) where
    ``jax.ops.segment_sum`` drops it."""
    x = torch.ones(3, 2)
    with pytest.raises((IndexError, RuntimeError)):
        G.seg_sum(x, torch.tensor([0, 1, 4]), 4)
    with pytest.raises((IndexError, RuntimeError)):
        G.seg_sum(x, torch.tensor([0, -1, 2]), 4)


def test_paddings_point_inside_range():
    """Every padding the batches make points inside the range that the
    segment sums take: masked molecule edges at node 0, masked triplets
    at edge 0, ``pad_block``'s edges at the last node, also after
    ``flatten_molecules`` offsets them."""
    b = molecules()
    assert ((b["edge_src"][~b["edge_mask"]] == 0).all()
            and (b["edge_dst"][~b["edge_mask"]] == 0).all())
    assert ((b["id_kj"][~b["triplet_mask"]] == 0).all()
            and (b["id_ji"][~b["triplet_mask"]] == 0).all())
    flat = G.flatten_molecules(_t(b))
    n, e = BATCH * N_NODES, BATCH * N_EDGES
    for k in ("edge_src", "edge_dst"):
        assert 0 <= int(flat[k].min()) and int(flat[k].max()) < n
    for k in ("id_kj", "id_ji"):
        assert 0 <= int(flat[k].min()) and int(flat[k].max()) < e
    assert flat["graph"].tolist() == np.repeat(np.arange(BATCH),
                                               N_NODES).tolist()
    csr = build_csr(50, np.random.default_rng(0).integers(0, 50, (300, 2)))
    blk = sample_blocks(csr, np.arange(4), (3, 2),
                        np.random.default_rng(1), pad_to=64)
    for s, d in blk.layers:
        assert 0 <= min(s.min(), d.min()) and max(s.max(), d.max()) < 64
        assert s[-1] == d[-1] == 63


# --------------------------------------------------------------------------
# host data: triplets, molecules, the sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,e,budget", [
    (4, 8, 20, 4096), (5, 8, 20, 7), (6, 30, 200, 256), (7, 3, 12, 64),
    (8, 5, 0, 16), (9, 40, 120, 1)])
def test_build_triplets_matches_reference(seed, n, e, budget):
    """Equal to the reference's, its truncation order too; graphs with
    self-loops and repeated edges, no edges, and budgets below the
    triplet count."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    want = RDN.build_triplets(src, dst, n, budget)
    got = DN.build_triplets(src, dst, n, budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,e,B,seed,shard,start", [
    (12, 32, 8, 0, (0, 1), 0), (30, 64, 16, 3, (1, 2), 5),
    (5, 40, 4, 1, (0, 1), 2), (3, 2, 2, 7, (0, 4), 0)])
def test_molecule_batches_match_reference(n, e, B, seed, shard, start):
    got = molecule_batches(n, e, B, seed=seed, shard=ShardInfo(*shard),
                           start_step=start)
    want = RP.molecule_batches(n, e, B, seed=seed,
                               shard=RP.ShardInfo(*shard), start_step=start)
    for _ in range(2):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("seeds,fanouts,pad", [
    (np.arange(16), (5, 3), None), (np.arange(16), (5, 3), 512),
    (np.array([7, 3, 250]), (40,), None), (np.arange(0, 300, 7), (2, 2, 2),
                                           None)])
def test_sample_blocks_match_reference(seeds, fanouts, pad):
    """The same blocks from the same ``rng`` and graph; nodes without
    neighbours, fan-outs above the degree, three layers."""
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 300, size=(3000, 2))
    edges = edges[edges[:, 0] % 17 != 0]         # some nodes have none
    got = sample_blocks(build_csr(300, edges), seeds, fanouts,
                        np.random.default_rng(0), pad_to=pad)
    want = RS.sample_blocks(r_build_csr(300, edges), seeds, fanouts,
                            np.random.default_rng(0), pad_to=pad)
    assert got.n_seeds == want.n_seeds and got.n_nodes == want.n_nodes
    assert np.array_equal(got.node_ids, want.node_ids)
    assert len(got.layers) == len(want.layers)
    for (s, d), (rs, rd) in zip(got.layers, want.layers):
        assert np.array_equal(s, rs) and np.array_equal(d, rd)
        assert s.dtype == rs.dtype


def test_pad_block_matches_reference_and_refuses_a_small_pad():
    edges = np.random.default_rng(2).integers(0, 100, size=(800, 2))
    blk = sample_blocks(build_csr(100, edges), np.arange(8), (4, 3),
                        np.random.default_rng(3))
    rblk = RS.SampledBlock(blk.node_ids, blk.n_seeds, blk.layers)
    got, want = pad_block(blk, 200), RS.pad_block(rblk, 200)
    assert np.array_equal(got.node_ids, want.node_ids)
    for (s, d), (rs, rd) in zip(got.layers, want.layers):
        assert np.array_equal(s, rs) and np.array_equal(d, rd)
    with pytest.raises(ValueError, match="does not pad"):
        pad_block(blk, blk.n_nodes - 1)


# --------------------------------------------------------------------------
# the models against the reference
# --------------------------------------------------------------------------

def _cfg(arch, reduced, d_feat=None):
    return (RCF.get_arch(arch).make_config(reduced=reduced, d_feat=d_feat),
            C.get_arch(arch).make_config(reduced=reduced, d_feat=d_feat))


@functools.lru_cache(maxsize=None)
def _ref_published(arch):
    """The reference at its published widths on ``graph_case``: its
    parameters (seed 0) and its output, once per module."""
    rcfg, _ = _cfg(arch, False)
    R = MODELS[arch][0]
    p = R.init_params(jax.random.PRNGKey(0), rcfg)
    g = graph_case(n_vars=16 if arch == "graphcast" else None)
    out = np.asarray(jax.jit(lambda p, b: R.apply(p, b, rcfg))(p, _jnp(g)))
    return _np_tree(p), g, out


@pytest.mark.parametrize("arch", list(MODELS))
def test_published_widths_forward_matches_reference(arch):
    """SchNet, DimeNet and GraphCast at their published widths on a
    14-node, 40-edge graph with masked edges and a masked node: the
    port's output from the converted parameters equals the
    reference's within TOL."""
    p, g, want = _ref_published(arch)
    _, cfg = _cfg(arch, False)
    with torch.no_grad():
        got = MODELS[arch][1].apply(gnn_params_from_jax(p, "cpu"), _t(g),
                                    cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _ref_loss(arch, rcfg):
    R = MODELS[arch][0]
    if arch == "graphcast":
        return lambda p, b: jax.vmap(
            lambda x: R.loss_fn(p, x, rcfg))(b).mean()
    return lambda p, b: R.loss_fn(p, b, rcfg)


def _port_loss(arch, cfg):
    M = MODELS[arch][1]
    if arch == "graphcast":
        return lambda p, b: M.molecule_loss(p, b, cfg)
    return lambda p, b: M.loss_fn(p, b, cfg)


@functools.lru_cache(maxsize=None)
def _ref_reduced(arch):
    """The reduced reference on the launcher's molecules: parameters,
    the batch, per-molecule outputs, the loss and its gradients."""
    rcfg, cfg = _cfg(arch, True)
    R = MODELS[arch][0]
    p = R.init_params(jax.random.PRNGKey(0), rcfg)
    b = molecules()
    if arch == "graphcast":
        b = _graphcast_molecules(b, rcfg.n_vars)
    out = jax.jit(jax.vmap(lambda x: R.apply(p, x, rcfg)))(_jnp(b))
    loss, grads = jax.jit(jax.value_and_grad(_ref_loss(arch, rcfg)))(
        p, _jnp(b))
    return (_np_tree(p), b, np.asarray(out), float(loss),
            [np.asarray(x) for x in jax.tree.leaves(grads)])


def _grads(loss_fn, params, batch):
    xs = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, xs)
    return float(loss.detach()), [g.numpy() for g in gs]


@pytest.mark.parametrize("arch", list(MODELS))
def test_reduced_forward_loss_grads_match_reference(arch):
    """The reduced configs on 8 molecules of 12 atoms (the launcher's):
    per-molecule outputs (the port flattens the batch into one graph,
    the reference ``vmap``s), the loss and every gradient."""
    p, b, want, rloss, rgrads = _ref_reduced(arch)
    _, cfg = _cfg(arch, True)
    M = MODELS[arch][1]
    params = gnn_params_from_jax(p, "cpu")
    tb = _t(b)
    with torch.no_grad():
        got = M.apply(params, G.flatten_molecules(tb), cfg)
    if arch == "graphcast":
        got = got.reshape(want.shape)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    loss, grads = _grads(_port_loss(arch, cfg), params, tb)
    assert loss == pytest.approx(rloss, rel=TOL["rtol"], abs=TOL["atol"])
    assert len(grads) == len(rgrads)
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape
        bound = GRAD_TOL * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g - r).max()) <= bound


def test_dimenet_padded_energy_pins_r11():
    """ROADMAP R11: the reference's DimeNet sums every edge's message in
    its output block, masked ones included, so padding a graph with
    masked edges changes its energy (here -0.250119 on the 24 real
    edges, -0.270650 with the 8 masked ones).  The port keeps the
    reference's energy on the padded graph (a later fix shows as a
    parity failure here) and the two energies differ in both."""
    rcfg, cfg = _cfg("dimenet", True)
    p = RDN.init_params(jax.random.PRNGKey(0), rcfg)
    g = graph_case(seed=11, n=10, e=32, n_pad=8)
    g.pop("node_mask")
    real = {k: v[:24] if k.startswith("edge_") else v for k, v in g.items()}
    real.update(zip(("id_kj", "id_ji", "triplet_mask"), RDN.build_triplets(
        real["edge_src"], real["edge_dst"], 10, 256)))
    params = gnn_params_from_jax(_np_tree(p), "cpu")
    energies = []
    for case in (real, g):
        want = float(RDN.apply(p, _jnp(case), rcfg))
        with torch.no_grad():
            got = float(DN.apply(params, _t(case), cfg))
        assert got == pytest.approx(want, rel=TOL["rtol"], abs=TOL["atol"])
        energies.append(got)
    assert abs(energies[0] - energies[1]) > 1e-4


def test_graphcast_graph_loss_matches_reference():
    """GraphCast's single-graph ``loss_fn`` (a graph cell's loss) with
    and without a node mask."""
    p, g, _ = _ref_published("graphcast")
    rcfg, cfg = _cfg("graphcast", False)
    params = gnn_params_from_jax(p, "cpu")
    for case in (g, {k: v for k, v in g.items() if k != "node_mask"}):
        want = float(jax.jit(lambda p, b: RGC.loss_fn(p, b, rcfg))(
            _ref_published("graphcast")[0], _jnp(case)))
        with torch.no_grad():
            got = float(GC.loss_fn(params, _t(case), cfg))
        assert got == pytest.approx(want, rel=TOL["rtol"], abs=TOL["atol"])


def test_gnn_params_from_jax_checks_the_tree(monkeypatch):
    """Each GNN's tree converts leaf for leaf (bit for bit, GraphCast's
    stacked ``proc`` kept); a tree that is not a GNN's is refused; the
    default device is the card."""
    for arch in MODELS:
        p = _ref_reduced(arch)[0]
        t = gnn_params_from_jax(p, "cpu")
        leaves = jax.tree.leaves(p)
        assert all(np.array_equal(a.numpy(), b)
                   for a, b in zip(tree_leaves(t), leaves))
    proc = gnn_params_from_jax(_ref_reduced("graphcast")[0], "cpu")["proc"]
    assert proc["edge"]["mlp"]["l0"]["w"].shape == (2, 96, 32)
    for bad in ({"emb": np.zeros(3)}, {"item_emb": 0, "cate_emb": 0,
                                       "attn": 0, "mlp": 0},
                {"out": {}, "int0": {}, "layer0": {}, "embed": {}},
                {"out": {}, "embed": {}}):
        with pytest.raises(ValueError, match="GNN"):
            gnn_params_from_jax(bad, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn_params_from_jax(_ref_reduced("schnet")[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        SN.init_params(torch.Generator(), SN.SchNetConfig())


@pytest.mark.parametrize("arch", list(MODELS))
def test_init_params_match_reference_shapes(arch):
    """``init_params`` (and ``param_shapes`` on meta) give the
    reference's tree, shapes and dtypes, at published and reduced
    widths, with and without ``d_feat``."""
    for reduced, d_feat in ((False, None), (True, None), (False, 100)):
        if reduced and d_feat:
            continue
        rcfg, cfg = _cfg(arch, reduced, d_feat)
        want = jax.eval_shape(lambda k: MODELS[arch][0].init_params(k, rcfg),
                              jax.random.PRNGKey(0))
        M = MODELS[arch][1]
        for tree in (M.param_shapes(cfg),
                     M.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")):
            got = jax.tree_util.tree_flatten_with_path(tree)[0]
            ref = jax.tree_util.tree_flatten_with_path(want)[0]
            assert [str(k) for k, _ in got] == [str(k) for k, _ in ref]
            for (_, a), (_, b) in zip(got, ref):
                assert tuple(a.shape) == b.shape
                assert str(a.dtype).split(".")[1] == str(b.dtype)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_chip_smoke_small_case_on_cpu(arch):
    """``chip_smoke.gnn_small_case`` with the CPU in the card's place:
    the two runs agree exactly; the leaves it exempts by their CPU
    gradient (not zero, below ``GNN_NOISE`` of the largest) are
    EquiformerV2's last attention biases, whose gradient is zero in
    exact arithmetic, and no leaf of the other three (EquiformerV2's
    ``so2_m1`` weights, whose gradient is exactly zero, stay compared);
    it reports the worst leaf's float32 error against a float64
    gradient."""
    import sys

    sys.path.insert(0, str(SRC.parent))
    import chip_smoke

    rec = chip_smoke.gnn_small_case(arch, torch.device("cpu"))
    assert rec["forward_rel_err_norm"] == rec["loss_rel_err"] == 0
    assert rec["state_rel_err_norm"] == 0
    want = ([f"layer{i}/attn/l1/b" for i in range(2)]
            if arch == "equiformer-v2" else [])
    assert rec["exempt_leaves"] == want
    assert 0 <= rec["worst_leaf_float32_err"] < chip_smoke.GNN_TOL


# --------------------------------------------------------------------------
# configs, cells, registry
# --------------------------------------------------------------------------

def test_registry_names_and_order_match_reference():
    assert C.arch_names() == RCF.arch_names()
    assert len(C.all_cells()) == len(RCF.all_cells()) == 40
    assert [(a, s) for a, s, _ in C.all_cells()] == [
        (a, s) for a, s, _ in RCF.all_cells()]
    assert CB.GNN_SHAPES == RCF.base.GNN_SHAPES


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_cells_match_reference_shapes(arch):
    """Each of the arch's four cells builds on meta: parameters, AdamW
    state and batch with the shapes and dtypes of the reference's cell
    on a one-device mesh (``_gnn_batch_sds``); the configs and notes are
    the reference's."""
    from repro.distributed.sharding import MeshAxes

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    spec, rspec = C.get_arch(arch), RCF.get_arch(arch)
    assert (spec.name, spec.family, spec.notes) == (
        rspec.name, rspec.family, rspec.notes)
    assert list(spec.cells) == list(rspec.cells) == list(CB.GNN_SHAPES)
    for reduced in (True, False):
        a = spec.make_config(reduced=reduced)
        b = rspec.make_config(reduced=reduced)
        assert a.__dict__ == b.__dict__
    for shape, cell in spec.cells.items():
        rcell = rspec.cells[shape]
        assert (cell.kind, cell.shape) == (rcell.kind, rcell.shape)
        fn, args = cell.build()
        _, rargs = rcell.build(mesh, MeshAxes())
        assert callable(fn) and len(args) == len(rargs)
        got = jax.tree_util.tree_flatten_with_path(args)[0]
        want = jax.tree_util.tree_flatten_with_path(rargs)[0]
        assert [str(k) for k, _ in got] == [str(k) for k, _ in want], shape
        for (k, a), (_, b) in zip(got, want):
            assert a.device.type == "meta"
            assert (tuple(a.shape), str(a.dtype).split(".")[1]) == (
                b.shape, str(b.dtype)), (shape, k)


def test_molecule_cell_step_runs_on_small_molecules():
    """The molecule cell's step (``_gnn_loss``'s batched arm) on real
    tensors at reduced width: SchNet's and GraphCast's losses equal
    the reference's batched loss on the same molecules."""
    for arch in ("schnet", "graphcast"):
        p, b, _, rloss, _ = _ref_reduced(arch)
        _, cfg = _cfg(arch, True)
        loss = CB._gnn_loss(arch, MODELS[arch][1], cfg, batched=True)
        with torch.no_grad():
            got = float(loss(gnn_params_from_jax(p, "cpu"), _t(b))[0])
        assert got == pytest.approx(rloss, rel=TOL["rtol"], abs=TOL["atol"])


# --------------------------------------------------------------------------
# the launcher's GNN arm and the example
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_launcher_gnn_arm_on_cpu(arch, capsys):
    """The GNN arm (the reference's ``build_reduced``): the reduced
    config, ``molecule_batches(12, 32, 8)`` (DimeNet's triplets at 128 a
    molecule), two steps; its loss from the reference's parameters
    (converted) equals the reference's loss on the same batch (for
    GraphCast: the reference's ``loss_fn`` on the port's features)."""
    from repro.models.gnn import equiformer_v2 as REQ

    params, opt, metrics = LT.main(["--arch", arch, "--steps", "2",
                                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "[train] done: 2 steps" in out
    assert int(opt.step) == 2 and np.isfinite(float(metrics["loss"]))
    _, loss_fn, data, to_dev = LT.build(arch, device="cpu")
    b = to_dev(next(data))
    want = next(RP.molecule_batches(N_NODES, N_EDGES, BATCH))
    if arch == "dimenet":
        want = _with_triplets(want, N_NODES, TRIPLETS)
    rcfg = RCF.get_arch(arch).make_config(reduced=True)
    if arch == "graphcast":   # the features, drawn once (seed 1)
        feat = torch.randn((BATCH, N_NODES, rcfg.n_vars),
                           generator=torch.Generator().manual_seed(1))
        assert torch.equal(b["feat"], feat)
        assert torch.equal(to_dev(next(data))["feat"], feat)
        want = dict(want, feat=feat.numpy())
    assert b.keys() == want.keys()
    assert all(np.array_equal(b[k].numpy(), want[k]) for k in b)
    R = {**{k: v[0] for k, v in MODELS.items()}, "equiformer-v2": REQ}[arch]
    rp = R.init_params(jax.random.PRNGKey(0), rcfg)
    got = float(loss_fn(gnn_params_from_jax(_np_tree(rp), "cpu"), b)[0])
    if arch == "graphcast":
        want = _graphcast_molecules(want, rcfg.n_vars)
        want.update(feat=feat.numpy(), target=(feat * 0.9).numpy())
        rl = float(_ref_loss(arch, rcfg)(rp, _jnp(want)))
    else:
        rl = float(R.loss_fn(rp, _jnp(want), rcfg))
    assert got == pytest.approx(rl, rel=1e-5, abs=1e-5)


def test_train_launcher_gnn_crash_and_resume(tmp_path, capsys):
    """SchNet through the launcher in one process: a crash at step 15
    leaves step 10 committed, ``--resume`` continues from it, and the
    step-30 loss equals a clean run's (exactly, on the CPU)."""
    from repro_torch.distributed import latest_step

    base = ["--arch", "schnet", "--steps", "30", "--ckpt-every", "10",
            "--device", "cpu"]
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected crash at step 15"):
        LT.main(base + ["--ckpt-dir", d1, "--crash-at", "15"])
    assert latest_step(d1) == 10
    _, _, resumed = LT.main(base + ["--ckpt-dir", d1, "--resume"])
    assert "[train] resumed from step 10" in capsys.readouterr().out
    _, _, clean = LT.main(base + ["--ckpt-dir", d2])
    assert float(resumed["loss"]) == float(clean["loss"])
    assert latest_step(d1) == latest_step(d2) == 30


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_launcher_gnn_arm_asks_for_the_card(arch, monkeypatch):
    """Without CUDA and with no ``--device``, the arm raises; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", arch, "--steps", "1"])


def test_gnn_molecules_example_on_cpu(monkeypatch, capsys):
    """The port's ``examples/gnn_molecules.py``: SchNet's MSE descends
    and EquiformerV2's energy is rotation-invariant (its own asserts);
    without CUDA and no ``--device`` it raises."""
    from repro_torch.examples import gnn_molecules

    losses, (e0, e1) = gnn_molecules.main(["--device", "cpu"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert "equivariance: OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_molecules.main([])


# --------------------------------------------------------------------------
# F5: the exports of every package both have
# --------------------------------------------------------------------------

# names the reference exports that the port gives under another name
# or leaves out, by package
RENAMED = {
    "analysis": {"analyze_hlo"},       # -> count_step (no HLO to read)
    "core": {"closure_jax",            # -> closure_torch
             "query_jax_wavefront",    # -> query_wavefront
             "scc_jax"},               # -> scc_torch
    "distributed": {"named"},          # folded into reshard
    "kernels/forest_build": {"seg_mbr_pallas",   # -> seg_mbr (K8)
                             "seg_mbr_ref",      # -> seg_mbr_torch
                             "default_build_kernel"},
}
# names the port exports that the reference has not
ADDED = {
    "analysis": {"count_step"},
    "core": {"closure_torch", "query_wavefront", "dedup_edges",
             "scc_torch"},
    "data": {"region_for_extent"},
    "distributed": {"index_shard_specs"},
    "kernels/forest_build": {"seg_mbr", "seg_mbr_torch"},
    "models": {"gnn", "lm", "recsys"},
    "models/lm": {"cache_shapes", "param_shapes"},
    "train": {"global_norm"},
}
SHARED = sorted(
    str(p.parent.relative_to(SRC / "repro_torch"))
    for p in (SRC / "repro_torch").rglob("__init__.py")
    if (SRC / "repro" / p.relative_to(SRC / "repro_torch")).exists())


def _exports(path):
    """The public names an ``__init__.py`` binds: its imports, its
    assignments and its definitions (``__all__`` and private names
    aside)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("pkg", SHARED)
def test_package_exports_match_reference(pkg):
    """Every package both have exports the reference's names, but for
    the differences written in RENAMED and ADDED, and each name
    imports."""
    import importlib

    ref = _exports(SRC / "repro" / pkg / "__init__.py")
    got = _exports(SRC / "repro_torch" / pkg / "__init__.py")
    assert ref - got == RENAMED.get(pkg, set())
    assert got - ref == ADDED.get(pkg, set())
    mod = importlib.import_module(
        "repro_torch" + ("" if pkg == "." else "." + pkg.replace("/", ".")))
    assert all(hasattr(mod, n) for n in got)
    if hasattr(mod, "__all__"):
        assert set(mod.__all__) <= got and len(mod.__all__) == len(
            set(mod.__all__))


def test_f5_names_import():
    from repro_torch.core import (  # noqa: F401
        DeviceForest,
        build_forest_device,
        closure_bitset_mm,
        convex_halfplanes,
        points_in_convex_polygon,
        points_in_polygon_region,
        polygon_bbox,
        polygon_oracle,
        polygon_query,
        query_host_collect,
    )
    from repro_torch.kernels.forest_build import TN
    from repro.kernels.forest_build import TN as RTN

    assert TN == RTN
    assert "models/gnn" in SHARED and "." in SHARED
