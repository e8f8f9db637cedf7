"""The port's DIN serving path (``repro_torch.models.recsys.din``, its
config, cells and input pipeline) against the JAX package's.

The same parameters (drawn by the reference's ``init_params`` and
carried over by ``convert.din_params_from_jax``) and the same batches go
through both models at ``make_config(reduced=True)``.  Logits, losses
and candidate scores must agree within 1e-5 absolute and relative: both
compute in float32, and the CPU matrix products of XLA and PyTorch may
sum in another order.  ``din_batches`` must give the reference's arrays
exactly.
"""

import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs.din as RC
import repro.data.pipeline as RP
import repro.models.nn as RN
from repro.distributed.sharding import MeshAxes
from repro.models.recsys import din as RD
from repro_torch import configs as C
from repro_torch.configs import din as PC
from repro_torch.convert import din_params_from_jax
from repro_torch.data import ShardInfo, din_batches
from repro_torch.models import nn as N
from repro_torch.models.recsys import din as D

TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_params(seed, cfg):
    return RD.init_params(jax.random.PRNGKey(seed), cfg)


def _port_params(ref):
    return din_params_from_jax(jax.tree.map(np.asarray, ref), device="cpu")


def _batch(cfg, B, seed, step=0):
    gen = RP.din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, B,
                         seed=seed, start_step=step)
    return next(gen)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("seed,B,shard,start", [
    (0, 32, (0, 1), 0), (3, 48, (1, 3), 5), (7, 16, (2, 4), 2)])
def test_din_batches_match_reference(seed, B, shard, start):
    cfg = PC.make_config(reduced=True)
    args = (cfg.n_items, cfg.n_cates, cfg.seq_len, B)
    got = din_batches(*args, seed=seed, shard=ShardInfo(*shard),
                      start_step=start)
    want = RP.din_batches(*args, seed=seed, shard=RP.ShardInfo(*shard),
                          start_step=start)
    for _ in range(2):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
        lens = g["hist_mask"].sum(1)
        assert lens.min() >= cfg.seq_len // 4


def test_shard_info_rejects_an_uneven_batch():
    with pytest.raises(ValueError, match="split"):
        ShardInfo(0, 3).slice_of(32)


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_and_param_shapes_match_reference(reduced):
    cfg = PC.make_config(reduced=reduced)
    ref_cfg = RC.make_config(reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    want = jax.eval_shape(lambda k: RD.init_params(k, ref_cfg),
                          jax.random.PRNGKey(0))
    got = D.param_shapes(cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), np.dtype(str(t.dtype).split(".")[1])), got,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert [(p, s.shape, s.dtype) for p, s in flat_g] == \
        [(p, s.shape, s.dtype) for p, s in flat_w]
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(
                   got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    n = sum(int(np.prod(s.shape)) for _, s in flat_w)
    assert N.count_params(got) == n and N.param_bytes(got) == 4 * n


def test_init_params_seeded_and_counted():
    cfg = PC.make_config(reduced=True)
    a = D.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    b = D.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    c = D.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    assert torch.equal(a["item_emb"]["emb"], b["item_emb"]["emb"])
    assert torch.equal(a["mlp"]["l2"]["w"], b["mlp"]["l2"]["w"])
    assert not torch.equal(a["item_emb"]["emb"], c["item_emb"]["emb"])
    assert not a["attn"]["l0"]["b"].any()
    ref = _ref_params(0, RC.make_config(reduced=True))
    assert N.count_params(a) == RN.count_params(ref)
    assert N.param_bytes(a) == RN.param_bytes(ref)
    assert abs(float(a["item_emb"]["emb"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("name", sorted(N.ACT))
def test_activations_match_reference(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = N.ACT[name](torch.as_tensor(x)).numpy()
    want = np.asarray(RN.ACT[name](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act,final", [("silu", "identity"),
                                       ("sigmoid", "identity"),
                                       ("relu", "tanh")])
def test_mlp_matches_reference(act, final):
    key = jax.random.PRNGKey(3)
    ref = RN.mlp_init(key, (12, 7, 5, 3))
    x = np.random.default_rng(0).standard_normal((4, 6, 12)).astype(
        np.float32)
    p = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), ref)
    got = N.mlp(p, torch.as_tensor(x), act=act, final_act=final).numpy()
    want = np.asarray(RN.mlp(ref, jnp.asarray(x), act=act, final_act=final))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed,B", [(0, 8), (1, 33), (2, 64)])
@pytest.mark.parametrize("fn", ["apply", "loss_fn"])
def test_apply_and_loss_match_reference(seed, B, fn):
    cfg = PC.make_config(reduced=True)
    ref = _ref_params(seed, RC.make_config(reduced=True))
    batch = _batch(cfg, B, seed)
    got = getattr(D, fn)(_port_params(ref), _t(batch), cfg)
    want = getattr(RD, fn)(ref, {k: jnp.asarray(v) for k, v in batch.items()},
                           RC.make_config(reduced=True))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("where", ["target", "history", "below_minus_v",
                                   "negative_in_range"])
def test_out_of_range_items_follow_the_reference(where):
    """The choice for an item id outside [-V, V): follow the reference,
    whose ``jnp.take`` fills NaN, so that row's embedding and logit are
    NaN and every other row is unchanged.  The port clamps the ids and
    masks the rows on the device, so a bad id neither syncs with the host
    nor fires a device-side assert (which would leave a card's CUDA
    context unusable); it raises nothing.  Ids in [-V, 0) wrap."""
    cfg = PC.make_config(reduced=True)
    ref = _ref_params(5, RC.make_config(reduced=True))
    batch = _batch(cfg, 8, 5)
    V = cfg.n_items
    bad = {"target": V, "history": V, "below_minus_v": -V - 1,
           "negative_in_range": -1}[where]
    if where == "history":
        batch["hist_items"][2, 0] = bad           # a position inside the mask
        assert batch["hist_mask"][2, 0]
    else:
        batch["target_item"][2] = bad
    got = D.apply(_port_params(ref), _t(batch), cfg).numpy()
    want = np.asarray(RD.apply(ref, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                               RC.make_config(reduced=True)))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]) == (where != "negative_in_range")
    assert np.isnan(got).sum() == (where != "negative_in_range")
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)


def test_target_attention_masks_like_reference():
    """Rows with no history pool to zero; masked positions weigh 0."""
    cfg = PC.make_config(reduced=True)
    ref = _ref_params(4, RC.make_config(reduced=True))
    batch = _batch(cfg, 6, 4)
    batch["hist_mask"][0] = False
    batch["hist_mask"][1, 1:] = False
    p = _port_params(ref)
    tb = _t(batch)
    he = D._embed_items(p, tb["hist_items"], cfg)
    te = D._embed_items(p, tb["target_item"], cfg)
    assert he.shape == (6, cfg.seq_len, 2 * cfg.embed_dim)
    got = D.target_attention(p, he, te, tb["hist_mask"])
    rc = RC.make_config(reduced=True)
    rhe = RD._embed_items(ref, jnp.asarray(batch["hist_items"]), rc)
    rte = RD._embed_items(ref, jnp.asarray(batch["target_item"]), rc)
    np.testing.assert_allclose(he.numpy(), np.asarray(rhe), rtol=0, atol=0)
    want = RD.target_attention(ref, rhe, rte, jnp.asarray(batch["hist_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("C,chunk", [(64, 16), (24, 8192), (96, 32)])
def test_score_candidates_matches_reference(C, chunk):
    cfg = PC.make_config(reduced=True)
    rc = RC.make_config(reduced=True)
    ref = _ref_params(5, rc)
    rng = np.random.default_rng(C)
    b = _batch(cfg, 1, 5)
    batch = {"hist_items": b["hist_items"][0], "hist_mask": b["hist_mask"][0],
             "candidates": rng.integers(0, cfg.n_items, C).astype(np.int32)}
    got = D.score_candidates(_port_params(ref), _t(batch), cfg, chunk=chunk)
    want = RD.score_candidates(
        ref, {k: jnp.asarray(v) for k, v in batch.items()}, rc, chunk=chunk)
    assert got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # one user against C targets is DIN's serve on that user replicated
    serve = {"hist_items": np.repeat(b["hist_items"], C, 0),
             "hist_mask": np.repeat(b["hist_mask"], C, 0),
             "target_item": batch["candidates"]}
    np.testing.assert_allclose(
        got.numpy(), D.apply(_port_params(ref), _t(serve), cfg).numpy(),
        **TOL)


def test_score_candidates_rejects_a_ragged_chunk():
    """The reference asserts ``C % chunk == 0``; the port raises."""
    cfg = PC.make_config(reduced=True)
    rc = RC.make_config(reduced=True)
    ref = _ref_params(0, rc)
    b = _batch(cfg, 1, 0)
    batch = {"hist_items": b["hist_items"][0], "hist_mask": b["hist_mask"][0],
             "candidates": np.arange(48, dtype=np.int32)}
    with pytest.raises(AssertionError):
        RD.score_candidates(ref, {k: jnp.asarray(v) for k, v in batch.items()},
                            rc, chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        D.score_candidates(_port_params(ref), _t(batch), cfg, chunk=32)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_serve_cells_match_reference_shapes(shape):
    """Each serve cell's inputs have the reference's shapes and dtypes
    (the reference's built on a one-device mesh)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rfn, (rp, rb) = RC.spec().cells[shape].build(mesh, MeshAxes())
    cell = C.get_arch("din").cells[shape]
    assert (cell.arch, cell.shape, cell.kind) == ("din", shape,
                                                  RC.spec().cells[shape].kind)
    fn, (p, b) = cell.build()
    assert sorted(b) == sorted(rb)
    for k in b:
        assert tuple(b[k].shape) == rb[k].shape
        assert str(b[k].dtype).split(".")[1] == str(rb[k].dtype)
        assert b[k].device.type == "meta"
    assert N.count_params(p) == sum(int(np.prod(x.shape))
                                    for x in jax.tree_util.tree_leaves(rp))


def test_registry_holds_din_and_train_waits():
    """The registry holds DIN with the reference's cells, last, as the
    reference's does (``tests/test_torch_lm.py`` holds the whole order
    to the reference's); the train cell no longer waits: it builds its step on meta parameters, AdamW state
    and batch (``tests/test_torch_train.py`` holds those to the
    reference's)."""
    assert C.arch_names()[-1] == "din"
    spec = C.get_arch("din")
    ref = RC.spec()
    assert (spec.name, spec.family) == (ref.name, ref.family)
    assert list(spec.cells) == list(ref.cells)
    assert [(a, s) for a, s, _ in C.all_cells() if a == "din"] == [
        ("din", s) for s in ref.cells]
    step, (p, o, b) = spec.cells["train_batch"].build()
    assert callable(step) and o.step.device.type == "meta"
    assert b["label"].shape == (65536,)


def test_din_params_from_jax_checks_the_tree(monkeypatch):
    with pytest.raises(ValueError, match="DIN"):
        din_params_from_jax({"emb": np.zeros(3)}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.make_config(reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        din_params_from_jax(_ref_params(0, RC.make_config(reduced=True)))
