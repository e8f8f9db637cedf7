"""The port's LM family (``repro_torch.models.lm``: attention, MoE, the
model's forward, loss, prefill and decode; its configs, cells and
``lm_batches``; ``convert.lm_params_from_jax``) against the JAX
package's, on the CPU.

The same inputs, made from a seed with NumPy (or the reference's
parameters, carried over by ``lm_params_from_jax``), go through both.
Both compute in float32 and the CPU matrix products of XLA and PyTorch
may sum in another order, so values are held within tolerances stated
per test: attention outputs within 1e-5 absolute, the model's logits
and losses within 2e-5 absolute plus 1e-5 relative, gradients within
1e-4 of each tensor's largest magnitude (measured here: at most 6e-7,
1e-6 and 3.2e-6).  Integer and structural results (routing, capacity
drops, shapes, specs, batches) must be equal.

The reference's outputs of each reduced config are computed once per
module (``_ref``), its functions under ``jax.jit``.
"""

import dataclasses
import functools
import os
import subprocess
import sys

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
from repro.models.lm import attention as RA
from repro.models.lm import model as RM
from repro.models.lm import moe as RMOE
from repro.models.recsys import din as RD
from repro_torch import configs as C
from repro_torch.configs import base as CB
from repro_torch.convert import din_params_from_jax, lm_params_from_jax
from repro_torch.data import ShardInfo, lm_batches
from repro_torch.models import nn as N
from repro_torch.models.lm import MoESpec, attention as A
from repro_torch.models.lm import model as M
from repro_torch.models.lm import moe as MOE
from repro_torch.train.optim import tree_leaves
from repro_torch.train.steps import _rebuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma3-12b",
         "h2o-danube-1.8b", "gemma2-2b")
ATT_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = 1e-4
# the model-level runs block attention and the loss at 16 so that
# flash, banded (window 16: two key blocks a band) and the loss all
# take several blocks at S = 32
BLOCKING = dict(blk_q=16, blk_k=16, loss_chunk=16)
B, S, PROMPT, DECODE = 2, 32, 16, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qkv(seed, B, S, H, KV, dh, dv=None, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, dv or dh)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ----------------------------------------------------------- attention

@pytest.mark.parametrize("positions", ["arange", "offset", "random"])
@pytest.mark.parametrize("dh,theta", [(16, 10_000.0), (8, 500_000.0)])
def test_rope_matches_reference(positions, dh, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, dh)).astype(np.float32)
    pos = {"arange": np.broadcast_to(np.arange(12), (2, 12)),
           "offset": np.broadcast_to(np.arange(12) + 4090, (2, 12)),
           "random": rng.integers(0, 524288, (2, 12))}[positions]
    pos = np.ascontiguousarray(pos).astype(np.int32)
    got = A.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    want = RA.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # at positions near 2^19 the angles are large: float32 sin/cos of
    # XLA and torch may differ by an ulp of the angle
    tol = 2e-3 if positions == "random" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("blk", [8, 16, 64])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("block_skip", [False, True])
def test_flash_attention_matches_reference(blk, softcap, block_skip):
    q, k, v = _qkv(0, 2, 64, 4, 2, 16)
    got = A.flash_attention(*_t(q, k, v), causal=True, blk_q=blk,
                            blk_k=blk, softcap=softcap,
                            block_skip=block_skip)
    want = RA.flash_attention(q, k, v, causal=True, blk_q=blk, blk_k=blk,
                              softcap=softcap, block_skip=block_skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("case", ["q_offset", "not_causal", "mla_dv",
                                  "uneven_blocks", "long_keys"])
def test_flash_attention_variants_match_reference(case):
    """A prefill chunk at ``q_offset`` against the whole key range,
    full attention, MLA's value width below the query's, query and key
    blocks of different sizes, and more keys than queries."""
    kw = dict(causal=True, blk_q=16, blk_k=16)
    if case == "q_offset":
        q, k, v = _qkv(2, 1, 32, 4, 4, 8, Sk=96)
        kw["q_offset"] = 64
    elif case == "not_causal":
        q, k, v = _qkv(3, 2, 32, 4, 2, 8)
        kw["causal"] = False
    elif case == "mla_dv":
        q, k, v = _qkv(4, 2, 48, 4, 4, 24, dv=16)
        kw["scale"] = 24 ** -0.5
    elif case == "uneven_blocks":
        q, k, v = _qkv(5, 2, 64, 6, 3, 8)
        kw.update(blk_q=32, blk_k=8, softcap=30.0)
    else:
        q, k, v = _qkv(6, 1, 16, 2, 1, 8, Sk=64)
    got = A.flash_attention(*_t(q, k, v), **kw)
    want = RA.flash_attention(q, k, v, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("window", [4, 12, 16, 63, 64, 200])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_banded_attention_matches_reference(window, softcap):
    """Windows below, at and above the block (16) and the sequence
    (64)."""
    q, k, v = _qkv(7, 2, 64, 4, 2, 16)
    got = A.banded_attention(*_t(q, k, v), window=window, blk=16,
                             softcap=softcap)
    want = RA.banded_attention(q, k, v, window=window, blk=16,
                               softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("ring,cache_len", [
    (False, 1), (False, 7), (False, 24), (True, 1), (True, 7), (True, 24),
    (True, 40)])
def test_decode_attention_matches_reference(ring, cache_len):
    """A linear cache filled to ``cache_len`` of 24 rows, and a ring of
    24 rows before and after it wrapped."""
    q, _, _ = _qkv(8, 3, 1, 8, 2, 16)
    _, k, v = _qkv(9, 3, 24, 8, 2, 16)
    got = A.decode_attention(*_t(q, k, v), cache_len, softcap=30.0,
                             ring=ring)
    want = RA.decode_attention(q, k, v, jnp.int32(cache_len), softcap=30.0,
                               ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("fn", ["flash", "banded"])
def test_attention_rejects_a_ragged_block(fn):
    q, k, v = _t(*_qkv(0, 1, 24, 2, 1, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        if fn == "flash":
            A.flash_attention(q, k, v, blk_q=16, blk_k=16)
        else:
            A.banded_attention(q, k, v, window=4, blk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_softcap_match_reference(dtype):
    """``rmsnorm`` (the mean of squares in float32, the factor cast to
    the input's dtype before the scale), ``layernorm`` and ``softcap``:
    bit for bit in bf16, within 1e-6 in float32."""
    import repro.models.nn as RN

    rng = np.random.default_rng(12)
    x = (rng.standard_normal((3, 5, 48)) * 4).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jd = getattr(jnp, dtype)
    jx = jnp.asarray(x).astype(jd)
    tx = torch.as_tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jp = {"scale": jnp.asarray(scale).astype(jd),
          "bias": jnp.asarray(bias).astype(jd)}
    tp = {k: torch.as_tensor(np.asarray(v.astype(jnp.float32))).to(
        tx.dtype) for k, v in jp.items()}
    pairs = [(N.rmsnorm({"scale": tp["scale"]}, tx, 1e-6),
              RN.rmsnorm({"scale": jp["scale"]}, jx, 1e-6)),
             (N.layernorm(tp, tx), RN.layernorm(jp, jx)),
             (N.softcap(tx, 5.0), RN.softcap(jx, 5.0)),
             (N.softcap(tx, None), RN.softcap(jx, None))]
    for got, want in pairs:
        assert str(got.dtype).split(".")[1] == str(want.dtype)
        got = got.to(torch.float32).numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "bfloat16":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- MoE

def _moe_pair(seed, spec, d, f_default=32):
    p = jax.jit(RMOE.moe_init, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(seed), d, f_default, spec, jnp.float32)
    return p, {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


MOE_CASES = {
    # name: (spec, tokens, router override)
    "overflow_top2": (MoESpec(n_experts=4, top_k=2, d_expert=16,
                              balance_factor=0.5), 40, None),
    "overflow_top1_shared": (MoESpec(n_experts=8, top_k=1, d_expert=16,
                                     n_shared=1, d_shared=24,
                                     balance_factor=1.0), 33, None),
    "tied_router": (MoESpec(n_experts=4, top_k=2, d_expert=16,
                            balance_factor=0.75), 24, "zero"),
    "tied_pairs": (MoESpec(n_experts=6, top_k=3, d_expert=8,
                           balance_factor=1.25), 20, "pairs"),
    "generous": (MoESpec(n_experts=8, top_k=2, d_expert=16,
                         balance_factor=8.0), 32, None),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    """Routing (the same experts, in the same order, with the same
    weights), the capacity drops and the output.  ``tied_router`` gives
    every token equal probabilities; ``tied_pairs`` makes experts 2j and
    2j + 1 equal: the lower id must win, as ``lax.top_k`` has it, and
    the stable sort must drop the same assignments."""
    spec, T, router = MOE_CASES[case]
    d = 16
    rp, p = _moe_pair(3, spec, d)
    if router == "zero":
        rp["router"] = jnp.zeros_like(rp["router"])
    elif router == "pairs":
        r = np.asarray(rp["router"])[:, ::2].repeat(2, axis=1)
        rp["router"] = jnp.asarray(r)
    p["router"] = torch.as_tensor(np.asarray(rp["router"]))
    x = np.random.default_rng(4).standard_normal((T, d)).astype(np.float32)
    rw, re, raux = jax.jit(RMOE._routing, static_argnums=2)(
        jnp.asarray(x), rp["router"], spec)
    w, e, aux = MOE._routing(torch.as_tensor(x), p["router"], spec)
    assert np.array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    got, gaux = MOE.moe_ffn(p, torch.as_tensor(x), spec)
    want, waux = jax.jit(RMOE.moe_ffn, static_argnums=2)(
        rp, jnp.asarray(x), spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)


def test_moe_capacity_drops_follow_the_stable_sort():
    """Every token routed to expert 0 with a capacity of 3: the three
    earliest tokens are kept, as the reference's stable ``argsort``
    keeps them; an unstable sort would keep others."""
    spec = MoESpec(n_experts=4, top_k=1, d_expert=8, balance_factor=1.0)
    T, d = 12, 8
    rp, p = _moe_pair(5, spec, d)
    x = np.random.default_rng(6).standard_normal((T, d)).astype(np.float32)
    e = np.zeros((T, 1), np.int32)
    w = np.ones((T, 1), np.float32)
    args = (spec, 0, 4, 3, "silu")
    got = MOE._expert_ffn_local(torch.as_tensor(x), torch.as_tensor(w),
                                torch.as_tensor(e).long(), p["w_gu"],
                                p["w_d"], *args)
    want = jax.jit(RMOE._expert_ffn_local, static_argnums=(5, 6, 7, 8, 9))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(e), rp["w_gu"],
        rp["w_d"], *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    kept = np.flatnonzero(np.abs(got.numpy()).sum(1))
    assert kept.tolist() == [0, 1, 2]


def test_moe_top_k_breaks_ties_to_the_lower_id():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    w, e = MOE._top_k(probs, 2)
    rw, re = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(e.numpy(), np.asarray(re))
    assert e.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_moe_mesh_with_a_model_axis_waits():
    """A mesh of one device runs the local path; a single process's
    mesh of several devices, or with a model axis but no processes
    behind it, raises ``ValueError`` naming the process mesh (the
    expert-parallel arm runs one process a rank:
    ``tests/test_torch_mesh.py``)."""
    from repro_torch.launch.mesh import ShardMesh

    spec = MoESpec(n_experts=4, top_k=1, d_expert=8)
    _, p = _moe_pair(0, spec, 8)
    x = torch.zeros(4, 8)
    cpu = torch.device("cpu")
    out, _ = MOE.moe_ffn(p, x, spec, mesh=ShardMesh((cpu,)))
    assert out.shape == (4, 8)

    class Mesh2:
        shape = {"data": 1, "model": 2}

    for mesh in (Mesh2(), ShardMesh((cpu, cpu))):
        with pytest.raises(ValueError, match="process mesh"):
            MOE.moe_ffn(p, x, spec, mesh=mesh)


# --------------------------------------------------- the model, per arch

def _configs(arch):
    rcfg = RCF.get_arch(arch).make_config(reduced=True)
    cfg = C.get_arch(arch).make_config(reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    return (dataclasses.replace(cfg, **BLOCKING),
            dataclasses.replace(rcfg, **BLOCKING))


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """The reference's parameters, batch, loss, metrics, gradients,
    hidden states, prefill logits and decode logits for ``arch``'s
    reduced config (computed once)."""
    cfg, rcfg = _configs(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   rcfg)
    batch = next(RP.lm_batches(rcfg.vocab, S, B, seed=3))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.lm_loss(p, b, rcfg), has_aux=True))(rp, batch)
    hidden = jax.jit(lambda p, t: RM.forward(p, t, rcfg)[0])(
        rp, batch["tokens"])
    toks = jnp.asarray(batch["tokens"])
    logits, cache = jax.jit(lambda p, t: RM.prefill(
        p, t, rcfg, max_len=PROMPT + DECODE + 2))(rp, toks[:, :PROMPT])
    dec = jax.jit(lambda p, c, t: RM.decode_step(p, c, t, rcfg))
    steps = []
    for i in range(DECODE):
        lg, cache = dec(rp, cache, toks[:, PROMPT + i])
        steps.append(np.asarray(lg))
    return dict(cfg=cfg, rcfg=rcfg, rp=_np(rp), batch=batch,
                loss=float(loss), metrics=_np(metrics), grads=_np(grads),
                hidden=np.asarray(hidden), prefill=np.asarray(logits),
                decode=steps, cache=_np(cache))


def _port(ref):
    return lm_params_from_jax(ref["rp"], device="cpu")


def _close_rel(got, want, tol):
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """``forward``, ``lm_loss`` (cross-entropy, MoE aux, deepseek's MTP)
    and its gradient with respect to every parameter, against
    ``jax.value_and_grad`` of the reference's ``lm_loss``."""
    ref = _ref(arch)
    cfg = ref["cfg"]
    p = _port(ref)
    tb = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    xs = [x.requires_grad_(True) for x in tree_leaves(p)]
    loss, metrics = M.lm_loss(_rebuild(p, iter(xs)), tb, cfg)
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=1e-5,
                                                 abs=2e-5)
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v.detach().numpy(), ref["metrics"][k],
                                   **LOGIT_TOL)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    rg = jax.tree.leaves(ref["grads"])
    assert len(grads) == len(rg)
    for g, want in zip(grads, rg):
        _close_rel(torch.zeros(want.shape) if g is None else g, want,
                   GRAD_TOL)
    with torch.no_grad():
        hidden, _ = M.forward(p, tb["tokens"], cfg)
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill`` of 16 tokens (past the reduced window of 16 nowhere,
    at it on the ring layers) and 4 ``decode_step``s: the logits, and
    the cache after them equal to the reference's functional cache,
    which the port wrote in place."""
    ref = _ref(arch)
    cfg = ref["cfg"]
    p = _port(ref)
    toks = torch.as_tensor(ref["batch"]["tokens"])
    logits, cache = M.prefill(p, toks[:, :PROMPT], cfg,
                              max_len=PROMPT + DECODE + 2)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **LOGIT_TOL)
    leaves = [id(x) for x in tree_leaves(cache)[1:]]
    for i in range(DECODE):
        logits, cache = M.decode_step(p, cache, toks[:, PROMPT + i], cfg)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i],
                                   **LOGIT_TOL)
    assert [id(x) for x in tree_leaves(cache)[1:]] == leaves   # in place
    assert int(cache["len"]) == int(ref["cache"]["len"]) == PROMPT + DECODE
    want = dict(jax.tree_util.tree_flatten_with_path(ref["cache"])[0])
    for path, x in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), cache))[0]:
        np.testing.assert_allclose(x, want[path], **LOGIT_TOL)


def test_decode_ring_wraps_past_the_window():
    """gemma2's reduced config (window 16) decoding 24 tokens past a
    32-token prompt into a cache of 40: the ring slots wrap, and past
    position 39 the global layers write slot ``min(pos, L - 1)``; every
    step's logits equal the reference's."""
    cfg, rcfg = _configs("gemma2-2b")
    rp = _ref("gemma2-2b")["rp"]
    p = lm_params_from_jax(rp, device="cpu")
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 56))
    toks = toks.astype(np.int32)
    rl, rc = RM.prefill(rp, jnp.asarray(toks[:, :32]), rcfg, max_len=40)
    pl, pc = M.prefill(p, torch.as_tensor(toks[:, :32]), cfg, max_len=40)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **LOGIT_TOL)
    dec = jax.jit(lambda pp, c, t: RM.decode_step(pp, c, t, rcfg))
    for i in range(32, 56):
        rl, rc = dec(rp, rc, jnp.asarray(toks[:, i]))
        pl, pc = M.decode_step(p, pc, torch.as_tensor(toks[:, i]), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **LOGIT_TOL)


def test_remat_gives_the_same_gradients():
    ref = _ref("llama4-maverick-400b-a17b")
    cfg = ref["cfg"]
    tb = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    out = []
    for remat in (False, True):
        xs = [x.requires_grad_(True) for x in tree_leaves(_port(ref))]
        p = _rebuild(_port(ref), iter(xs))
        loss, _ = M.lm_loss(p, tb, cfg, remat=remat)
        out.append([g for g in torch.autograd.grad(loss, xs,
                                                   allow_unused=True)])
    for a, b in zip(*out):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("where", ["tokens", "decode", "labels"])
def test_ids_outside_the_vocabulary_follow_the_reference(where):
    """Token ids -1 and -V wrap; V and -V - 1 give NaN rows (the
    reference's ``jnp.take``), in the forward pass, at decode and, as
    labels, in the loss (``take_along_axis``)."""
    ref = _ref("gemma2-2b")
    cfg, rcfg, rp = ref["cfg"], ref["rcfg"], ref["rp"]
    p = _port(ref)
    V = cfg.vocab
    toks = np.array(ref["batch"]["tokens"])
    labels = np.array(ref["batch"]["labels"])
    bad = np.array([-1, -V, V, -V - 1], np.int32)
    if where == "tokens":
        toks[0, 3:7] = bad
        got, _ = M.forward(p, torch.as_tensor(toks), cfg)
        want, _ = RM.forward(rp, jnp.asarray(toks), rcfg)
        got, want = got.detach().numpy(), np.asarray(want)
    elif where == "decode":
        _, c = M.prefill(p, torch.as_tensor(toks[:, :PROMPT]), cfg, 24)
        _, rc = RM.prefill(rp, jnp.asarray(toks[:, :PROMPT]), rcfg, 24)
        got = np.stack([M.decode_step(p, c, torch.tensor([t, 5]), cfg)[0]
                        .numpy()[0] for t in bad])
        want = []
        for t in bad:
            lg, rc = RM.decode_step(rp, rc, jnp.array([t, 5]), rcfg)
            want.append(np.asarray(lg)[0])
        want = np.stack(want)
    else:
        labels[1, 2:6] = bad
        b = {"tokens": toks, "labels": labels}
        got = float(M.lm_loss(p, {k: torch.as_tensor(v) for k, v in
                                  b.items()}, cfg)[0])
        want = float(RM.lm_loss(rp, {k: jnp.asarray(v) for k, v in
                                     b.items()}, rcfg)[0])
        got, want = np.array([got]), np.array([want])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               **LOGIT_TOL)


def test_chunked_loss_rejects_a_ragged_chunk():
    ref = _ref("gemma2-2b")
    p = _port(ref)
    with pytest.raises(ValueError, match="loss chunk"):
        M.chunked_ce_loss(p, torch.zeros(1, 24, ref["cfg"].d_model),
                          torch.zeros(1, 24, dtype=torch.int32), ref["cfg"],
                          chunk=16)


# --------------------------------------------- configs, shapes, cells

@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_counts_match_reference(arch):
    """The full config's parameters on ``meta`` against
    ``jax.eval_shape(init_params)``: the same keys, shapes and dtypes in
    the same order, and ``param_counts`` equal; also ``init_params`` of
    the reduced config against the reference's tree."""
    for reduced in (False, True):
        rcfg = RCF.get_arch(arch).make_config(reduced=reduced)
        cfg = C.get_arch(arch).make_config(reduced=reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert cfg.param_counts() == rcfg.param_counts()
        assert cfg.scan_segments() == rcfg.scan_segments()
        want = jax.eval_shape(functools.partial(RM.init_params, cfg=rcfg),
                              jax.random.PRNGKey(0))
        got = (M.param_shapes(cfg) if not reduced else M.init_params(
            torch.Generator().manual_seed(0), cfg, device="cpu"))
        rl = jax.tree_util.tree_flatten_with_path(want)[0]
        pl = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [k for k, _ in pl] == [k for k, _ in rl]
        for (_, a), (_, b) in zip(pl, rl):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[1] == str(b.dtype)
            assert a.device.type == ("cpu" if reduced else "meta")
        n = N.count_params(got)
        assert n == sum(int(np.prod(x.shape)) for _, x in rl)
        if arch == "gemma2-2b" and not reduced:
            # param_counts leaves out the final norm's 2,304 scales
            assert cfg.param_counts()["total"] == 2_614_219_776
            assert n == 2_614_219_776 + cfg.d_model


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cells_match_reference_shapes(arch):
    """Each LM cell's meta inputs against the reference's
    ShapeDtypeStructs on a one-device mesh: parameters, AdamW state,
    batches, caches and tokens."""
    from repro.distributed.sharding import MeshAxes

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    spec, rspec = C.get_arch(arch), RCF.get_arch(arch)
    assert (spec.name, spec.family) == (rspec.name, rspec.family)
    assert list(spec.cells) == list(rspec.cells) == list(CB.LM_SHAPES)
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
            assert (tuple(a.shape), str(a.dtype).split(".")[1]) == (
                b.shape, str(b.dtype)), (shape, k)


def test_registry_order_matches_reference():
    assert C.arch_names() == RCF.arch_names()


@pytest.mark.parametrize("seed,gb,shard,start", [
    (0, 8, (0, 1), 0), (7, 16, (1, 2), 3), (3, 4, (3, 4), 11)])
def test_lm_batches_match_reference(seed, gb, shard, start):
    got = lm_batches(512, 32, gb, seed=seed, shard=ShardInfo(*shard),
                     start_step=start)
    want = RP.lm_batches(512, 32, gb, seed=seed,
                         shard=RP.ShardInfo(*shard), start_step=start)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ------------------------------------------------------------------ F4

def _bits(x):
    """The bytes of an array or tensor, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_convert_keeps_every_bit(dtype):
    """A reference LM tree in bf16 (drawn by the reference in bf16) or
    float8 (cast), which ``torch.from_numpy`` cannot read
    (``ml_dtypes``), converts bit for bit, NaN, infinities and -0
    included where the format has them."""
    rcfg = RCF.get_arch("gemma2-2b").make_config(reduced=True)
    if dtype == "bfloat16":
        rp = _np(jax.jit(RM.init_params, static_argnums=1)(
            jax.random.PRNGKey(1), dataclasses.replace(rcfg, dtype=dtype)))
    else:
        rp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)),
                          _ref("gemma2-2b")["rp"])
    scale = np.array(rp["ln_f"]["scale"])
    scale[:3] = [np.nan, np.inf if dtype != "float8_e4m3fn" else 448.0,
                 -0.0]
    rp["ln_f"]["scale"] = scale
    p = lm_params_from_jax(rp, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(p)[0]
    want = jax.tree_util.tree_flatten_with_path(rp)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert str(a.dtype).split(".")[1] == str(b.dtype), k
        assert tuple(a.shape) == b.shape, k
        assert np.array_equal(_bits(a), _bits(b)), k


def test_convert_din_tree_in_bf16_keeps_every_bit():
    rcfg = RCF.get_arch("din").make_config(reduced=True)
    rp = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                      jax.jit(RD.init_params, static_argnums=1)(
                          jax.random.PRNGKey(0), rcfg))
    p = din_params_from_jax(rp, device="cpu")
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(p)[0],
                              jax.tree_util.tree_flatten_with_path(rp)[0]):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(_bits(a), _bits(b)), k


def test_convert_names_the_key_of_a_bad_leaf():
    rp = _ref("gemma2-2b")["rp"]
    bad = jax.tree.map(lambda x: x, rp)
    bad["seg0"]["u1"]["attn"]["wq"] = np.array(["x"], dtype=object)
    with pytest.raises(TypeError, match="seg0/u1/attn/wq"):
        lm_params_from_jax(bad, device="cpu")
    bad = jax.tree.map(lambda x: x, rp)
    bad["ln_f"]["scale"] = bad["ln_f"]["scale"].astype(
        jnp.float8_e4m3b11fnuz)
    with pytest.raises(TypeError, match="ln_f/scale"):
        lm_params_from_jax(bad, device="cpu")
    with pytest.raises(ValueError, match="not an LM parameter tree"):
        lm_params_from_jax({"embed": rp["embed"], "ln_f": rp["ln_f"]},
                           device="cpu")
    with pytest.raises(ValueError, match="not an LM parameter tree"):
        lm_params_from_jax(dict(rp, extra={}), device="cpu")


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, importlib\n"
        "for m in ('repro_torch.models.lm.model', 'repro_torch.models.lm.'\n"
        "          'attention', 'repro_torch.models.lm.moe',\n"
        "          'repro_torch.distributed.checkpoint',\n"
        "          'repro_torch.distributed.elastic',\n"
        "          'repro_torch.distributed.sharding',\n"
        "          'repro_torch.configs.gemma2_2b',\n"
        "          'repro_torch.launch.train',\n"
        "          'repro_torch.examples.train_lm'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
