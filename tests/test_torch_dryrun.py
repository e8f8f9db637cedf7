"""The port's dry run and roofline (``repro_torch.analysis``,
``launch.{mesh,dryrun,perf_lm}``, ``benchmarks.roofline``) against the
JAX package's, on the CPU, and the two repairs the dry run needed.

* F6: the MoE FFN counted its capacity groups with ``torch.bincount``,
  which has no meta kernel; F7: ``prefill`` built its cache with
  ``init_cache``, which refuses ``meta``.  Both ran on real tensors;
  neither ran on the meta tensors of a dry run.
* ``count_step`` against known-FLOPs programs (the reference's
  ``test_roofline`` cases: a product is 2n^3, a loop of L products
  L * 2n^3, a gradient 3 * 2n^3, the port's attention its blocked
  formula), then one reduced step per family (LM train, SchNet, DIN)
  against the reference's ``analyze_hlo`` of the same step compiled for
  the CPU.  FLOPs agree within 1% (measured: equal on the LM steps,
  +0.04% on SchNet, +0.16% on DIN's train step): XLA rewrites a few
  products with a unit dimension into a multiply and a reduce, which its
  count of dots leaves out.  Bytes do not agree and are not compared
  one to one: the reference counts the CPU program's unfused ops, the
  port eager PyTorch's aten ops.  The HBM floor agrees within 10% for
  SchNet and DIN; on the LM step the port's is lower, because the
  blocked attention's block slices are views here and
  dynamic-(update-)slices there.
* ``model_flops`` equal to the reference's for all 40 cells.
* ``run_cell`` at full width on meta for every cell but the LM
  ``train_4k`` ones, which run at reduced configs through the same
  builder (the full width takes 4-18 s a cell on a CPU); prefill_32k at
  its full width but a prompt of 4,096 (the full cell dispatches
  1.3M-5.5M aten ops, 19-178 s on a CPU: ``dryrun --all`` runs them).
  Each cell's outputs (shapes and dtypes) equal the reference's
  ``jax.eval_shape`` of its cell on a (1, 1) mesh with the inputs'
  shardings dropped (with them, JAX 0.9 refuses every cell); the MoE
  cells of llama4-maverick and deepseek-v3 are left out where the
  reference's cell does not trace (its expert-parallel arm on the mesh).
* ``mesh_step``: every cell also counts rank 0's step of the
  production mesh on a counting mesh (``lm_param_spec`` for the LM
  cells, ``mlp_param_spec`` for the GNN and DIN cells, ZeRO-1); its
  record is ok, its per-device FLOPs at or below the one-card count,
  and its collectives (the record's top-level ``collectives``) non-empty
  under the reference's kind names; the roofline reads every record
  with its one-card terms unchanged.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.configs as RCF
import repro.configs.base as RCB
from repro.analysis import analyze_hlo
from repro.distributed.sharding import MeshAxes as RMeshAxes
from repro_torch import configs as C
from repro_torch.analysis import count_step
from repro_torch.analysis.op_stats import OpStats
from repro_torch.benchmarks import roofline
from repro_torch.configs import base as CB
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import KINDS
from repro_torch.distributed.tree import walk
from repro_torch.launch import dryrun, mesh as M, perf_lm
from repro_torch.models.lm import MoESpec, attention as A
from repro_torch.models.lm import model as LM
from repro_torch.models.lm import moe as MOE

MOE_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b")
PREFILL_CUT = dict(kind="prefill", seq=4096, batch=32)
FLOPS_REL = 0.01
FLOOR_REL = 0.10
BLOCKING = dict(blk_q=16, blk_k=16, loss_chunk=16)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _strip(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


def _ref_outputs(rbuild):
    """The reference's cell outputs as [(shape, dtype)], or None where
    its cell does not trace."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn, args = rbuild(mesh, RMeshAxes())
    try:
        with mesh:
            out = jax.eval_shape(fn, *_strip(args))
    except Exception:       # a cell the reference cannot trace here
        return None
    return [(list(x.shape), str(x.dtype)) for x in jax.tree.leaves(out)]


def _port_outputs(rec):
    return [(shape, dtype) for _, shape, dtype in rec["outputs"]]


# ------------------------------------------------------------- F6 and F7

@pytest.mark.parametrize("n_shared", [0, 1])
def test_f6_moe_ffn_runs_on_meta(n_shared):
    spec = MoESpec(n_experts=8, top_k=2, d_expert=16, n_shared=n_shared,
                   d_shared=24, balance_factor=1.0)
    with torch.device("meta"):
        p = MOE.moe_init(torch.Generator(), 32, 64, spec, torch.float32)
    out, aux = MOE.moe_ffn(p, _meta((40, 32)), spec)
    assert out.device.type == "meta" and tuple(out.shape) == (40, 32)
    assert aux.shape == ()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_f6_reduced_moe_forward_runs_on_meta(arch):
    cfg = C.get_arch(arch).make_config(reduced=True)
    params = LM.param_shapes(cfg)
    hidden, _ = LM.forward(params, _meta((2, 32), torch.int32), cfg)
    assert hidden.device.type == "meta"
    assert tuple(hidden.shape) == (2, 32, cfg.d_model)


@pytest.mark.parametrize("arch", ("gemma2-2b", "deepseek-v3-671b"))
def test_f7_prefill_runs_on_meta(arch):
    cfg = C.get_arch(arch).make_config(reduced=True)
    params = LM.param_shapes(cfg)
    logits, cache = LM.prefill(params, _meta((2, 32), torch.int32), cfg,
                               max_len=48)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (2, cfg.vocab)
    want = LM.cache_shapes(cfg, 2, 48)
    got = dict(walk(cache))
    for path, x in walk(want):
        if path == "len":
            assert int(got[path]) == 32
        else:
            assert got[path].device.type == "meta"
            assert got[path].shape == x.shape and got[path].dtype == x.dtype


def test_f7_real_entry_points_still_refuse_meta(monkeypatch):
    cfg = C.get_arch("gemma2-2b").make_config(reduced=True)
    with pytest.raises(ValueError, match="meta"):
        LM.init_cache(cfg, 2, 8, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM.init_cache(cfg, 2, 8)


# ------------------------------------------------------ mesh and perf_lm

def test_mesh_factories(monkeypatch):
    axes = M.mesh_axes(multi_pod=True)
    assert axes.data == ("pod", "data") and axes.model == "model"
    assert M.mesh_axes(multi_pod=False).data == ("data",)
    assert M.make_production_mesh() == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert axes.data_size(M.make_production_mesh(multi_pod=True)) == 32
    assert M.make_host_mesh(device="cpu") == {"data": 1, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_host_mesh()


@pytest.fixture
def ref_perf_lm(monkeypatch):
    """The reference's ``perf_lm`` (its import sets XLA_FLAGS, restored
    after the test; JAX's devices are made before it)."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import perf_lm as ref

    return ref


def test_perf_lm_overrides(ref_perf_lm):
    for v in ("true", "False", "2", "-7", "1.5", "1e-3", "abc", "2x"):
        got, want = perf_lm.parse_val(v), ref_perf_lm.parse_val(v)
        assert got == want and type(got) is type(want), v
    assert perf_lm.parse_val("true") is True
    over = {"attn_block_skip": True, "moe.balance_factor": 1.0,
            "loss_chunk": 256}
    cfg = C.get_arch("deepseek-v3-671b").make_config()
    rcfg = RCF.get_arch("deepseek-v3-671b").make_config()
    out = perf_lm.apply_overrides(cfg, over)
    assert dataclasses.asdict(out) == dataclasses.asdict(
        ref_perf_lm.apply_overrides(rcfg, over))
    assert out.attn_block_skip is True and out.moe.balance_factor == 1.0
    assert out.moe.n_experts == cfg.moe.n_experts


def test_perf_lm_main(tmp_path, monkeypatch):
    monkeypatch.setattr(perf_lm, "RESULTS_DIR", str(tmp_path))
    rec = perf_lm.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                        "--set", "final_softcap=20.0", "--tag", "cap"])
    with open(tmp_path / "gemma2-2b__decode_32k__cap.json") as f:
        assert json.load(f) == rec
    assert rec["overrides"] == {"final_softcap": 20.0}
    base = dryrun.run_cell("gemma2-2b", "decode_32k", save=False)
    # a softcap is elementwise: the products are the cell's
    assert rec["hlo_stats"]["flops"] == base["flops"] > 0


# -------------------------------------------------------------- op stats

def test_count_plain_matmul():
    n = 256
    st = count_step(lambda a, b: a @ b, _meta((n, n)), _meta((n, n)))
    assert st["flops"] == 2 * n ** 3
    assert st["bytes"] == st["hbm_floor_bytes"] == 3 * n * n * 4
    assert st["collective_bytes"] == 0


def test_count_loop_multiplies_layers():
    n, L = 128, 8
    w = _meta((L, n, n))

    def layers(w, x):
        for i in range(L):
            x = x @ w[i]
        return x

    assert count_step(layers, w, _meta((n, n)))["flops"] == 2 * L * n ** 3


def test_count_grad_counts_backward():
    n = 128

    def grad(a, b):
        a, b = a.requires_grad_(), b.requires_grad_()
        return torch.autograd.grad(((a @ b) ** 2).sum(), (a, b))

    st = count_step(grad, _meta((n, n)), _meta((n, n)))
    assert st["flops"] == 3 * 2 * n ** 3       # forward + two backward


def test_attention_flops():
    B, S, H, dh = 1, 512, 4, 64
    q = _meta((B, S, H, dh))
    st = count_step(lambda q: A.flash_attention(q, q, q, causal=True,
                                                blk_q=128, blk_k=128), q)
    # one chunk of query blocks reaches every key block: the masked
    # blocks are computed, as the reference's are
    assert st["flops"] == 2 * 2 * B * H * S * S * dh
    w = 128
    st2 = count_step(lambda q: A.banded_attention(q, q, q, window=w,
                                                  blk=128), q)
    assert st2["flops"] == 2 * 2 * B * H * S * (2 * 128) * dh


def test_attention_flops_follow_the_chunks(monkeypatch):
    """With a score budget of one query block per chunk, causal chunks
    skip the key blocks after their last query: the formula the port's
    flash attention gives."""
    B, S, H, dh, blk = 2, 512, 4, 32, 128
    monkeypatch.setattr(A, "SCORE_BUDGET", B * H * blk * blk * 4)
    q = _meta((B, S, H, dh))
    st = count_step(lambda q: A.flash_attention(q, q, q, causal=True,
                                                blk_q=blk, blk_k=blk), q)
    nq = S // blk
    pairs = sum(i + 1 for i in range(nq))      # key blocks per chunk
    assert st["flops"] == 2 * 2 * B * H * pairs * blk * blk * dh


def test_views_move_nothing_and_slice_copies_are_floor():
    x, c = _meta((64, 32)), _meta((4, 128, 32))

    def write(x, c):
        c[1, :64] = x.t().t()        # views, then a copy into a slice
        return c

    st = count_step(write, x, c)
    assert st["flops"] == 0
    # the copy's destination and source in, the destination out
    assert st["bytes"] == st["hbm_floor_bytes"] == 3 * 64 * 32 * 4


def _lm_case():
    cfg = dataclasses.replace(
        C.get_arch("gemma2-2b").make_config(reduced=True), **BLOCKING)
    rcfg = dataclasses.replace(
        RCF.get_arch("gemma2-2b").make_config(reduced=True), **BLOCKING)
    return (CB._lm_train_builder(lambda: cfg, 64, 4)(),
            RCB._lm_train_builder(lambda: rcfg, 64, 4), False)


def _schnet_case():
    import repro.configs.schnet as RS
    from repro_torch.configs import schnet as PS

    return (CB._gnn_builder("schnet", PS.module, functools.partial(
        PS.make_config, reduced=True), "molecule")(),
        RCB._gnn_builder("schnet", RS.module, functools.partial(
            RS.make_config, reduced=True), "molecule"), True)


def _din_case():
    import repro.configs.din as RD
    from repro_torch.configs import din as PD

    return (CB._din_builder(functools.partial(PD.make_config, reduced=True),
                            "train_batch")(),
            RCB._din_builder(functools.partial(RD.make_config, reduced=True),
                             "train_batch"), True)


@pytest.mark.parametrize("case", ["lm_train", "schnet", "din"])
def test_step_counts_match_reference_hlo(case):
    (fn, args), rbuild, same_floor = {
        "lm_train": _lm_case, "schnet": _schnet_case,
        "din": _din_case}[case]()
    got = count_step(fn, *args)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rfn, rargs = rbuild(mesh, RMeshAxes())
    with mesh:
        want = analyze_hlo(jax.jit(rfn).lower(*_strip(rargs)).compile()
                           .as_text())
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOPS_REL)
    assert 0 < got["hbm_floor_bytes"] <= got["bytes"]
    if same_floor:
        assert got["hbm_floor_bytes"] == pytest.approx(
            want["hbm_floor_bytes"], rel=FLOOR_REL)
    else:
        assert got["hbm_floor_bytes"] < want["hbm_floor_bytes"]


# -------------------------------------------------------------- roofline

def test_model_flops_match_reference():
    from benchmarks.roofline import model_flops as ref

    cells = [(a, s) for a, s, _ in C.all_cells()]
    assert cells == [(a, s) for a, s, _ in RCF.all_cells()]
    assert len(cells) == 40
    for arch, shape in cells:
        got = roofline.model_flops(arch, shape)
        assert got is not None and got > 0, (arch, shape)
        assert got == ref(arch, shape), (arch, shape)


def test_schnet_count_against_model_flops():
    """Why SchNet's model FLOPs exceed its count (a roofline share above
    100% at ogb_products): the formula charges a backward of twice the
    forward for every product, but the filter MLP's first layer takes the
    RBF expansion of the distances, which needs no gradient, so autograd
    runs only its weight gradient.  The formula also counts two of the
    three node products an interaction makes, and leaves out the
    encoder (whose input needs no gradient either) and the readout.  The
    count follows what runs, product by product, on the cell itself."""
    cfg = C.get_arch("schnet").make_config(d_feat=100)
    s = CB.GNN_SHAPES["ogb_products"]
    N, E = CB.round_up(s["n"]), CB.round_up(s["e"])
    L, d, r, f = cfg.n_interactions, cfg.d_hidden, cfg.n_rbf, s["f"]
    fn, args = C.get_arch("schnet").cells["ogb_products"].build()
    counted = count_step(fn, *args)["flops"]
    formula = roofline.model_flops("schnet", "ogb_products")
    rbf_input_grad = L * E * r * d * 2
    third_node_product = 3 * L * N * d * d * 2
    encoder = 2 * N * f * d * 2
    readout = 3 * (N * d * (d // 2) * 2 + N * (d // 2) * 2)
    assert counted == (formula - rbf_input_grad + third_node_product
                       + encoder + readout)
    assert formula / counted > 1.35


def test_roofline_rows_from_records(tmp_path):
    for arch, shape in (("gemma2-2b", "decode_32k"), ("schnet", "molecule"),
                        ("din", "serve_p99")):
        rec = dryrun.run_cell(arch, shape, save=False)
        with open(tmp_path / f"{arch}__{shape}__pod16x16.json", "w") as f:
            json.dump(rec, f)
    (tmp_path / "broken__x__pod16x16.json").write_text(
        json.dumps({"ok": False, "mesh": "pod16x16"}))
    rows = {r["arch"]: r for r in roofline.table(str(tmp_path))}
    assert set(rows) == {"gemma2-2b", "schnet", "din"}
    assert roofline.table(str(tmp_path), mesh="pod2x16x16") == []
    for arch, r in rows.items():
        rec = next(x for x in roofline.load_records(str(tmp_path))
                   if x.get("arch") == arch)
        st, ma = rec["hlo_stats"], rec["memory_analysis"]
        peak = 989e12 if arch == "gemma2-2b" else 67e12
        assert r["t_compute_s"] == st["flops"] / peak
        assert r["t_memory_s"] == (ma["argument_size_in_bytes"]
                                   + ma["output_size_in_bytes"]
                                   + st["hbm_floor_bytes"]) / 3.35e12
        assert r["bytes_dev"] == (ma["argument_size_in_bytes"]
                                  + ma["output_size_in_bytes"]
                                  + st["hbm_floor_bytes"])
        assert r["t_collective_s"] == 0
        assert r["bound_s"] == max(r["t_compute_s"], r["t_memory_s"])
        assert r["model_flops_dev"] == roofline.model_flops(arch,
                                                            rec["shape"])
    assert rows["gemma2-2b"]["dominant"] == "memory"   # decode reads
    text = roofline.format_table(list(rows.values()))
    assert text.splitlines()[0].startswith("arch") and "gemma2-2b" in text


def test_run_prints_the_roofline_section(tmp_path, monkeypatch, capsys):
    from repro_torch.benchmarks import run

    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path / "none"))
    assert roofline.table() == []
    monkeypatch.setattr(run, "report", lambda *a, **k: {
        "table2": [], "table3": [{"dataset": "x"}], "table4": [],
        "claims": [], "kernels": [], "device": "cpu"})
    monkeypatch.setattr(run, "result_path",
                        lambda name: str(tmp_path / name))
    run.main(["--device", "cpu", "--skip-fig3"])
    out = capsys.readouterr().out
    assert "[roofline" in out and "no dry-run results yet" in out


# --------------------------------------------------------------- dry run

NON_TRAIN = [(a, s) for a, s, c in C.all_cells() if c.kind != "train"]
GNN_TRAIN = [(a, s) for a, s, c in C.all_cells()
             if c.kind == "train" and C.get_arch(a).family != "lm"]
# the reference's EquiformerV2 traces in 6-9 s a cell (its inputs'
# shapes are held to the reference's in test_torch_gnn)
REF_SLOW = {("equiformer-v2", s) for s in CB.GNN_SHAPES}


@pytest.fixture
def prefill_cut(monkeypatch):
    monkeypatch.setitem(CB.LM_SHAPES, "prefill_32k", PREFILL_CUT)
    monkeypatch.setitem(RCB.LM_SHAPES, "prefill_32k", PREFILL_CUT)


@pytest.mark.parametrize("arch,shape", NON_TRAIN + GNN_TRAIN)
def test_run_cell_matches_reference_outputs(arch, shape, prefill_cut):
    rec = dryrun.run_cell(arch, shape, save=False)
    assert rec["ok"], rec.get("error")
    assert rec["flops"] > 0 and rec["hlo_stats"]["hbm_floor_bytes"] > 0
    assert rec["n_devices"] == 1
    _check_collectives(rec)
    assert 0 < rec["arg_bytes_per_device"] < rec["memory_analysis"][
        "argument_size_in_bytes"]
    assert rec["compute_dtype"] == ("bfloat16" if rec["family"] == "lm"
                                    else "float32")
    if (arch, shape) in REF_SLOW:
        return
    want = _ref_outputs(RCF.get_arch(arch).cells[shape].build)
    if want is None:
        assert arch in MOE_ARCHS, (arch, shape)
        return
    assert _port_outputs(rec) == want


def _check_collectives(rec):
    """A record's ``mesh_step`` (ok, 256 devices, FLOPs at or below the
    one-card count, collectives under the reference's kinds) is its
    top-level ``collectives``, for every family."""
    assert "queued" not in rec["notes"]["collectives"]
    ms = rec["mesh_step"]
    assert ms["ok"] and ms["n_devices"] == 256
    assert 0 < ms["flops"] <= rec["flops"]
    assert ms["collectives"]["total"] > 0
    assert set(ms["collectives"]) <= {"total", *KINDS}
    assert ms["collectives"]["total"] == sum(
        v for k, v in ms["collectives"].items() if k != "total")
    assert rec["collectives"] == ms["collectives"]
    assert rec["hlo_stats"]["collective_bytes"] == 0


LM_TRAIN = [(a, s) for a, s, c in C.all_cells()
            if c.kind == "train" and C.get_arch(a).family == "lm"]
MLP_CELLS = [(a, s) for a, s, _ in C.all_cells()
             if C.get_arch(a).family != "lm"]


@pytest.mark.parametrize("arch,shape", MLP_CELLS)
def test_mlp_cells_count_the_two_pod_mesh_step(arch, shape):
    """Every GNN and DIN cell at its published widths on rank 0 of the
    two-pod mesh (2 x 16 x 16, the data axes ``("pod", "data")``), its
    inputs cut by ``mlp_param_spec``, ZeRO-1 and the batch specs, through
    the code the ranks run: ok, with collectives under the reference's
    kinds and FLOPs below the (16, 16) mesh's rank 0."""
    cell = C.get_arch(arch).cells[shape]
    ms = dryrun.mesh_step(cell, M.make_production_mesh(multi_pod=True))
    one = dryrun.mesh_step(cell, M.make_production_mesh())
    assert ms["ok"] and ms["n_devices"] == 512
    assert ms["collectives"]["total"] > 0
    assert set(ms["collectives"]) <= {"total", *KINDS}
    assert 0 < ms["flops"] < one["flops"]


@pytest.mark.parametrize("arch,shape", LM_TRAIN)
def test_lm_train_cells_count_the_production_mesh_step(arch, shape):
    """The LM train_4k cells at their full widths: the one-card count
    and rank 0's step of the (16, 16) mesh, its ZeRO-1 update included
    (a reduce-scatter of the gradients, an all-gather of the
    parameters over ``data``); the roofline's row reads the one-card
    fields alone."""
    rec = dryrun.run_cell(arch, shape, save=False)
    assert rec["ok"], rec.get("error")
    _check_collectives(rec)
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(
        rec["collectives"])
    bare = {k: v for k, v in rec.items() if k != "mesh_step"}
    bare["collectives"] = {}
    assert roofline.roofline_row(rec) == roofline.roofline_row(bare)


@pytest.mark.parametrize("arch", [a for a in C.arch_names()
                                  if C.get_arch(a).family == "lm"])
def test_train_4k_runs_reduced(arch):
    s = CB.LM_SHAPES["train_4k"]
    spec, rspec = C.get_arch(arch), RCF.get_arch(arch)
    fn, args = CB._lm_train_builder(
        lambda: spec.make_config(reduced=True), s["seq"], s["batch"])()
    with OpStats() as st:
        out = fn(*args)
    assert st.flops > 0
    got = [(list(x.shape), str(x.dtype).replace("torch.", ""))
           for _, x in walk(out)]
    want = _ref_outputs(RCB._lm_train_builder(
        lambda: rspec.make_config(reduced=True), s["seq"], s["batch"]))
    if want is None:
        assert arch in MOE_ARCHS
    else:
        assert got == want


def test_new_modules_import_neither_jax_nor_repro():
    """The dry run's modules, the roofline and the device SCC import no
    ``jax`` and nothing of ``repro``, and importing them touches no CUDA
    state."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "import repro_torch.analysis, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.perf_lm, repro_torch.launch.mesh\n"
        "import repro_torch.benchmarks.roofline, repro_torch.core.scc\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr


def test_arg_bytes_per_device():
    fn, args = C.get_arch("gemma2-2b").cells["decode_32k"].build()
    one = {"data": 1, "model": 1}
    total = sum(x.numel() * x.element_size()
                for _, x in walk(list(args)))
    axes = M.mesh_axes()
    assert dryrun.arg_bytes_per_device("decode", "lm", args, one,
                                       axes) == total
    pod = dryrun.arg_bytes_per_device("decode", "lm", args,
                                      M.make_production_mesh(), axes)
    pod2 = dryrun.arg_bytes_per_device(
        "decode", "lm", args, M.make_production_mesh(multi_pod=True),
        M.mesh_axes(True))
    assert pod2 < pod < total
    # a (R, B, L, KV, dh) cache leaf: batch over data, length over model
    assert dryrun.cache_spec((13, 128, 4096, 4, 256), 128, axes,
                             M.make_production_mesh()) == (
        None, ("data",), "model", None, None)
    assert dryrun.cache_spec((), 128, axes, one) == ()
    assert dryrun.shard_bytes(_meta((16, 32)), (("data",), "model"),
                              M.make_production_mesh()) == 16 * 32 * 4 / 256


def test_dryrun_all_records_and_skips(tmp_path, monkeypatch, capsys):
    """``--all --skip-existing`` runs only the cells without an ok
    record and ends with the reference's summary line; a cell that
    raises is recorded with its error."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    keep = {("din", "serve_p99"), ("schnet", "molecule")}
    for arch, shape, _ in C.all_cells():
        if (arch, shape) not in keep:
            (tmp_path / f"{arch}__{shape}__pod16x16.json").write_text(
                json.dumps({"ok": True}))
    assert dryrun.main(["--all", "--skip-existing"]) == 0
    out = capsys.readouterr().out
    assert "[dryrun] done: 40 ok, 0 failed" in out
    rec = json.loads((tmp_path / "din__serve_p99__pod16x16.json")
                     .read_text())
    assert rec["ok"] and rec["outputs"] == [["", [512], "float32"]]
    monkeypatch.setattr(CB, "_din_batch_meta", lambda *a, **k: 1 / 0)
    assert dryrun.main(["--arch", "din", "--shape", "serve_p99"]) == 1
    rec = json.loads((tmp_path / "din__serve_p99__pod16x16.json")
                     .read_text())
    assert not rec["ok"] and rec["error"].startswith("ZeroDivisionError")
    assert "traceback" not in rec
