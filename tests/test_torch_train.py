"""The port's training substrate (``repro_torch.train``: AdamW, its
schedule, the train and eval steps), DIN's ``train_batch`` cell and the
training launcher, on the CPU, against the JAX package's.

``schedule_lr`` equals the reference's at steps 0, 1, the warm-up's end,
mid-decay and the total for all three schedules; ``adamw_update``, with
clipping on and off, equals the reference's within 1e-6 relative.
Three ``make_train_step`` steps of the reduced DIN from the reference's
parameters (``convert.din_params_from_jax``), at ``grad_accum`` 1 and 2
and continuing from a reference optimizer state that is not zero
(``convert.adamw_state_from_jax``), give the reference's loss within
1e-5 relative and every parameter within 1e-5 relative in norm
(``|port - ref| / |ref|`` per tensor).  Elementwise, a few embedding
entries differ by more: where one item's gradient contributions nearly
cancel, the float32 residual depends on the order of the adds (XLA's
scatter against torch's ``index_put_``), and Adam divides it by its own
small root mean square, so the step there moves by a different amount.

The launcher (``repro_torch.launch.train``): its LM arm's first loss
equals the reference's on the same batch and converted parameters
within 1e-5 relative; ``--ckpt-dir``/``--crash-at``/``--resume`` in
subprocesses (``--device cpu``) for DIN and the reduced gemma2, as the
reference's ``test_crash_resume_end_to_end`` runs them (the step-30
loss within 1e-5 of a clean run's), and in one process, whose
checkpoint the reference restores.
"""

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

from repro.configs import din as RCFG
from repro.data import din_batches as r_din_batches
from repro.models.recsys import din as RDIN
from repro.train import optim as RO
from repro.train import steps as RS
from repro_torch.configs import registry as C
from repro_torch.configs.din import make_config
from repro_torch.convert import adamw_state_from_jax, din_params_from_jax
from repro_torch.launch import train as LT
from repro_torch.models.recsys import din
from repro_torch.train import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    make_eval_step,
    make_train_step,
    schedule_lr,
)
from repro_torch.train.optim import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SCHEDULES = ("cosine", "linear", "constant")
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_with_paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _assert_tree_close(port, ref, rtol):
    """Every tensor within ``rtol`` relative in norm of the reference's."""
    ref = dict(_leaves_with_paths(_np_tree(ref)))
    got = dict(_leaves_with_paths(port))
    assert sorted(got) == sorted(ref)
    for k, want in ref.items():
        have = got[k].detach().cpu().numpy()
        assert have.shape == want.shape and have.dtype == want.dtype, k
        want = want.astype(np.float64)
        err = np.linalg.norm(have - want)
        assert err <= rtol * max(np.linalg.norm(want), 1e-30), (k, err)


# ---------------------------------------------------------------- optim

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=1000,
              schedule=schedule, min_lr_frac=0.1)
    cfg, rcfg = AdamWConfig(**kw), RO.AdamWConfig(**kw)
    for step in (0, 1, 100, 550, 1000, 5000):
        got = schedule_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(RO.schedule_lr(rcfg, jnp.int32(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _grads_and_params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.standard_normal((7, 5)).astype(dtype),
                    "b": np.zeros(5, dtype)},
              "emb": rng.standard_normal((11, 3)).astype(dtype)}
    grads = {"a": {"w": rng.standard_normal((7, 5)).astype(dtype) * 3,
                   "b": rng.standard_normal(5).astype(dtype)},
             "emb": rng.standard_normal((11, 3)).astype(dtype) * 0.1}
    return params, grads


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


@pytest.mark.parametrize("clip_norm", [1.0, None, 100.0])
@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_adamw_update_matches_reference(clip_norm, weight_decay):
    """Three updates from zero state, clipping on (norm 1, which the
    gradients exceed; norm 100, which they do not) and off: parameters,
    moments, step, gradient norm and learning rate within 1e-6
    relative."""
    kw = dict(OPT, clip_norm=clip_norm, weight_decay=weight_decay)
    cfg, rcfg = AdamWConfig(**kw), RO.AdamWConfig(**kw)
    params, _ = _grads_and_params(0)
    p, rp = _t(params), jax.tree.map(jnp.asarray, params)
    o, ro = adamw_init(p), RO.adamw_init(rp)
    for i in range(3):
        _, grads = _grads_and_params(i + 1)
        p, o, m = adamw_update(cfg, _t(grads), o, p)
        rp, ro, rm = RO.adamw_update(rcfg, jax.tree.map(jnp.asarray, grads),
                                     ro, rp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(rm[k]),
                                       rtol=1e-6)
        assert int(o.step) == int(ro.step) == i + 1
        for port, ref in ((p, rp), (o.m, ro.m), (o.v, ro.v)):
            for (_, a), (_, b) in zip(_leaves_with_paths(port),
                                      _leaves_with_paths(_np_tree(ref))):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-6 * np.abs(b).max())


def test_adamw_init_state_and_global_norm():
    params, grads = _grads_and_params(5)
    o = adamw_init(_t(params))
    assert isinstance(o, AdamWState) and o.step.dtype == torch.int32
    assert int(o.step) == 0
    for leaf in tree_leaves(o.m) + tree_leaves(o.v):
        assert leaf.dtype == torch.float32 and not leaf.any()
    np.testing.assert_allclose(
        global_norm(_t(grads)).numpy(),
        np.asarray(RO.global_norm(jax.tree.map(jnp.asarray, grads))),
        rtol=1e-6)
    # bf16 parameters keep their dtype through an update, float32 state
    p16 = jax.tree.map(lambda x: torch.as_tensor(x).bfloat16(), params)
    g16 = jax.tree.map(lambda x: torch.as_tensor(x).bfloat16(), grads)
    o16 = adamw_init(p16)
    new, o16, _ = adamw_update(AdamWConfig(), g16, o16, p16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(new))
    assert all(x.dtype == torch.float32 for x in tree_leaves(o16.m))


# ----------------------------------------------------- the train step

def _din_pair():
    rcfg = RCFG.make_config(reduced=True)
    cfg = make_config(reduced=True)
    rp = RDIN.init_params(jax.random.PRNGKey(0), rcfg)
    return cfg, rcfg, rp, din_params_from_jax(_np_tree(rp), device="cpu")


def _run_both(ga, steps=3, continue_from=0):
    """``steps`` train steps of the reduced DIN on both packages from the
    same parameters and batches (after ``continue_from`` reference steps
    whose state the port takes over)."""
    cfg, rcfg, rp, _ = _din_pair()
    rstep = jax.jit(RS.make_train_step(
        lambda pp, b: (RDIN.loss_fn(pp, b, rcfg), {}), RO.AdamWConfig(**OPT),
        grad_accum=ga))
    step = make_train_step(lambda pp, b: (din.loss_fn(pp, b, cfg), {}),
                           AdamWConfig(**OPT), grad_accum=ga)
    data = r_din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, 64)
    ro = RO.adamw_init(rp)
    for _ in range(continue_from):
        b = next(data)
        rp, ro, _ = rstep(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
    p = din_params_from_jax(_np_tree(rp), device="cpu")
    o = (adamw_state_from_jax(ro, device="cpu") if continue_from
         else adamw_init(p))
    losses = []
    for _ in range(steps):
        b = next(data)
        rp, ro, rm = rstep(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, m = step(p, o, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append((float(m["loss"]), float(rm["loss"])))
        np.testing.assert_allclose(m["lr"].numpy(), np.asarray(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   np.asarray(rm["grad_norm"]), rtol=1e-5)
    return p, o, rp, ro, losses


@pytest.mark.parametrize("ga,continue_from", [(1, 0), (2, 0), (1, 3)])
def test_din_train_steps_match_reference(ga, continue_from):
    p, o, rp, ro, losses = _run_both(ga, continue_from=continue_from)
    for got, want in losses:
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-5)
    _assert_tree_close(p, rp, 1e-5)
    _assert_tree_close(o.m, ro.m, 1e-5)
    assert int(o.step) == int(ro.step) == 3 + continue_from


def test_adamw_state_from_jax_carries_the_state():
    _, _, rp, p = _din_pair()
    ro = RO.adamw_init(rp)
    ro = ro._replace(step=jnp.int32(7),
                     m=jax.tree.map(lambda x: x + 0.5, ro.m))
    o = adamw_state_from_jax(ro, device="cpu")
    assert isinstance(o, AdamWState)
    assert o.step.dtype == torch.int32 and int(o.step) == 7
    _assert_tree_close(o.m, ro.m, 0.0)
    _assert_tree_close(o.v, ro.v, 0.0)


def test_grad_accum_needs_a_divisible_batch():
    cfg, _, _, p = _din_pair()
    step = make_train_step(lambda pp, b: (din.loss_fn(pp, b, cfg), {}),
                           AdamWConfig(), grad_accum=3)
    b = next(r_din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, 64))
    with pytest.raises(ValueError, match="microbatches"):
        step(p, adamw_init(p), {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("has_metrics", [True, False])
def test_eval_step_matches_reference(has_metrics):
    cfg, rcfg, rp, p = _din_pair()
    b = next(r_din_batches(cfg.n_items, cfg.n_cates, cfg.seq_len, 32))
    if has_metrics:
        fn = lambda pp, bb: (din.loss_fn(pp, bb, cfg), {})  # noqa: E731
        rfn = lambda pp, bb: (RDIN.loss_fn(pp, bb, rcfg), {})  # noqa: E731
    else:
        fn = lambda pp, bb: din.loss_fn(pp, bb, cfg)  # noqa: E731
        rfn = lambda pp, bb: RDIN.loss_fn(pp, bb, rcfg)  # noqa: E731
    got = make_eval_step(fn, has_metrics)(
        p, {k: torch.as_tensor(v) for k, v in b.items()})
    want = RS.make_eval_step(rfn, has_metrics)(
        rp, {k: jnp.asarray(v) for k, v in b.items()})
    assert not got.requires_grad
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# ------------------------------------------------- cell and launcher

def test_train_batch_cell_builds_on_meta():
    """The cell gives the step and its meta inputs, as the reference's
    ``_din_builder`` gives a step and ShapeDtypeStructs: the parameters,
    an AdamW state beside them, and a batch of 65,536 rows with labels."""
    from repro.configs import base as RB

    cell = C.get_arch("din").cells["train_batch"]
    assert (cell.kind, RB.RECSYS_SHAPES["train_batch"]["kind"]) == (
        "train", "train")
    step, (p, o, b) = cell.build()
    assert callable(step)
    cfg = make_config()
    for leaf in tree_leaves(p) + tree_leaves(o.m) + tree_leaves(o.v):
        assert leaf.device.type == "meta"
    assert o.step.device.type == "meta" and o.step.dtype == torch.int32
    assert [x.shape for x in tree_leaves(o.m)] == [x.shape for x in
                                                   tree_leaves(p)]
    B = RB.RECSYS_SHAPES["train_batch"]["batch"]
    want = {"hist_items": ((B, cfg.seq_len), torch.int32),
            "hist_mask": ((B, cfg.seq_len), torch.bool),
            "target_item": ((B,), torch.int32),
            "label": ((B,), torch.float32)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == want


def test_train_launcher_two_steps_on_cpu(capsys):
    params, opt, metrics = LT.main(["--arch", "din", "--steps", "2",
                                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "[train] done: 2 steps" in out
    assert int(opt.step) == 2 and np.isfinite(float(metrics["loss"]))
    first, _, _, _ = LT.build("din", device="cpu")
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(first))]
    assert all(moved)


@pytest.mark.parametrize("arch", ["graphcast", "schnet"])
def test_train_launcher_waits_for_lm_and_gnn(arch, capsys):
    """Neither family waits any more: the GNN arm trains on the CPU
    (``tests/test_torch_gnn.py`` holds its loss to the reference's), as
    the LM arm does (``test_train_launcher_lm_arm_on_cpu``)."""
    params, opt, metrics = LT.main(["--arch", arch, "--steps", "2",
                                    "--device", "cpu"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert int(opt.step) == 2 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_train_launcher_lm_arm_on_cpu(arch, capsys):
    """The LM arm is the reference's ``build_reduced``: the reduced
    config, ``init_params`` from seed 0, ``lm_batches(vocab, 32, 8)``;
    its first step's loss equals the reference's first step on the same
    batch from the same parameters (converted) within 1e-5 relative."""
    from repro.configs import get_arch as rget
    from repro.data import lm_batches as r_lm_batches
    from repro.models.lm import model as RM
    from repro_torch.convert import lm_params_from_jax

    params, opt, metrics = LT.main(["--arch", arch, "--steps", "2",
                                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 1 loss" in out and "[train] done: 2 steps" in out
    assert int(opt.step) == 2 and np.isfinite(float(metrics["loss"]))
    p0, loss_fn, data, to_dev = LT.build(arch, device="cpu")
    b = next(data)
    assert b["tokens"].shape == (8, 32)
    rcfg = rget(arch).make_config(reduced=True)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   rcfg)
    want = next(r_lm_batches(rcfg.vocab, 32, 8))
    assert all(np.array_equal(b[k], want[k]) for k in b)
    rl = float(jax.jit(lambda p, bb: RM.lm_loss(p, bb, rcfg)[0])(
        rp, {k: jnp.asarray(v) for k, v in want.items()}))
    got = float(loss_fn(lm_params_from_jax(_np_tree(rp), device="cpu"),
                        to_dev(b))[0])
    assert got == pytest.approx(rl, rel=1e-5)


def _launch(args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "30", "--ckpt-every", "10", *args], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=600)


def _final_loss(out):
    lines = [ln for ln in out.splitlines() if "step 30 loss" in ln]
    return float(lines[-1].split("loss")[1].split("(")[0])


@pytest.mark.parametrize("arch", ["din", "gemma2-2b"])
def test_crash_resume_end_to_end(arch, tmp_path):
    """The reference's ``test_crash_resume_end_to_end`` on the port's
    launcher, in subprocesses: a crash injected at step 15 leaves step
    10 committed, ``--resume`` continues from it, and the step-30 loss
    equals an uninterrupted run's within 1e-5."""
    from repro_torch.distributed import latest_step

    d1 = str(tmp_path / "crash")
    r1 = _launch(["--arch", arch, "--ckpt-dir", d1, "--crash-at", "15"],
                 tmp_path)
    assert r1.returncode != 0 and "injected crash at step 15" in r1.stderr
    assert latest_step(d1) == 10
    r2 = _launch(["--arch", arch, "--ckpt-dir", d1, "--resume"], tmp_path)
    assert r2.returncode == 0, r2.stderr
    assert "[train] resumed from step 10" in r2.stdout
    assert "[train] step 11 loss" in r2.stdout
    d2 = str(tmp_path / "clean")
    r3 = _launch(["--arch", arch, "--ckpt-dir", d2], tmp_path)
    assert r3.returncode == 0, r3.stderr
    assert abs(_final_loss(r2.stdout) - _final_loss(r3.stdout)) < 1e-5
    assert latest_step(d1) == latest_step(d2) == 30
    assert sorted(os.listdir(d2)) == ["step_00000010", "step_00000020",
                                      "step_00000030"]


def test_launcher_checkpoint_flags_in_process(tmp_path, capsys):
    """In one process, as ``chip_smoke.py`` drives it: the crash, the
    resume and a clean run of the reduced gemma2; the resumed run's
    last loss equals the clean one's exactly on the CPU, and a
    checkpoint written by the launcher restores through the
    reference's ``restore_checkpoint`` with the reference's keys."""
    from repro.distributed import restore_checkpoint as r_restore
    from repro.models.lm import model as RM
    from repro.configs import get_arch as rget
    from repro.train import optim as RO2

    base = ["--arch", "gemma2-2b", "--steps", "30", "--ckpt-every", "10",
            "--device", "cpu"]
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected crash at step 15"):
        LT.main(base + ["--ckpt-dir", d1, "--crash-at", "15"])
    _, _, resumed = LT.main(base + ["--ckpt-dir", d1, "--resume"])
    _, _, clean = LT.main(base + ["--ckpt-dir", d2])
    assert float(resumed["loss"]) == float(clean["loss"])
    rcfg = rget("gemma2-2b").make_config(reduced=True)
    tmpl = jax.eval_shape(lambda k: (lambda p: {"params": p,
                                                "opt": RO2.adamw_init(p)})(
        RM.init_params(k, rcfg)), jax.random.PRNGKey(0))
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tmpl)
    state, man = r_restore(d1, tmpl)
    assert man["step"] == 30 and int(state["opt"].step) == 30
    with pytest.raises(SystemExit):
        LT.main(["--arch", "din", "--resume", "--device", "cpu"])


def test_train_launcher_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", "din", "--steps", "1"])


def test_train_lm_example_on_cpu(monkeypatch, capsys):
    """``examples/train_lm.py`` at a cut of its 120 steps: the loss
    descends and the mid-run checkpoint restores bit for bit (its own
    asserts)."""
    from repro_torch.examples import train_lm

    monkeypatch.setattr(train_lm, "STEPS", 30)
    monkeypatch.setattr(train_lm, "SAVE_AT", 20)
    losses = train_lm.main(["--device", "cpu"])
    assert len(losses) == 30
    assert "checkpoint roundtrip + loss descent: OK" in capsys.readouterr(
    ).out
