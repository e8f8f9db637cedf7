"""The port's ``repro_torch.distributed`` (sharding rules, checkpoints,
recovery, placement) against the JAX package's ``repro.distributed``,
on the CPU.

* Sharding: every parameter of the five LM configs at their published
  widths (the port's ``param_shapes`` on ``meta``, the reference's
  ``jax.eval_shape``) gets the reference's spec at a model axis of 1,
  16 and 17 (17 divides nothing: every rule falls back to
  replication); DIN's parameters under the MLP rules; ZeRO-1, the AdamW
  state's specs and the batch spec at data axes of 1 and 16.  The
  reference's rules read only ``mesh.shape``, so both are given the
  same ``{axis: size}`` sizes.  A spec is the reference's
  ``PartitionSpec`` as a tuple, exactly.
* ``index_shard_specs`` equals the reference's, and the sharded
  engine's ``_place`` lays its arrays out by it.
* Checkpoints: the reference's own checkpoint tests on the port, and
  cross-reading in both directions: a tree of ``{"params", "opt":
  AdamWState}`` with lists and bf16 leaves saved by one package
  restores in the other bit for bit, with the same manifest keys; the
  manager's queue, garbage collection and error surfacing; shards
  split at ``SHARD_BYTES``.
* ``run_with_recovery`` retries with the reference's backoff, re-raises
  after ``max_failures`` and never catches ``KeyboardInterrupt``;
  ``reshard`` places on one device and refuses a single process's
  mesh of several devices (onto a process mesh:
  ``tests/test_torch_mesh.py``).
"""

import functools
import os
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
import repro.distributed as RDI
import repro.distributed.checkpoint as RCK
from repro.models.lm import model as RM
from repro.models.recsys import din as RD
from repro.train import optim as RO
from repro_torch import configs as C
from repro_torch import distributed as DI
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import elastic as EL
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.tree import walk
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models.lm import model as M
from repro_torch.models.recsys import din as D
from repro_torch.train import AdamWState, adamw_init

LM_ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b", "gemma3-12b",
            "h2o-danube-1.8b", "gemma2-2b")


def _mesh(data=1, model=1):
    """What both packages' rules read of a mesh: its ``shape``."""
    return types.SimpleNamespace(shape={"data": data, "model": model})


def _spec(p):
    """A spec as a plain tuple, a one-axis tuple entry as that axis: the
    reference's ``PartitionSpec`` writes ``("data",)`` as ``"data"``,
    and both mean the same placement."""
    return tuple(x[0] if isinstance(x, tuple) and len(x) == 1 else x
                 for x in p)


def _flat(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    rcfg = RCF.get_arch(arch).make_config()
    ref = jax.eval_shape(functools.partial(RM.init_params, cfg=rcfg),
                         jax.random.PRNGKey(0))
    return ref, M.param_shapes(C.get_arch(arch).make_config())


# ------------------------------------------------------------- sharding

@pytest.mark.parametrize("tp", [1, 16, 17])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_rules_match_reference_on_every_parameter(arch, tp):
    ref, port = _shapes(arch)
    axes, raxes = SH.MeshAxes(), RDI.MeshAxes()
    mesh = _mesh(model=tp)
    got = _flat(SH.param_specs(port, SH.lm_param_spec, axes, mesh),
                is_leaf=lambda x: isinstance(x, tuple))
    want = _flat(RDI.param_specs(ref, RDI.lm_param_spec, raxes, mesh),
                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert sorted(got) == sorted(want)
    sharded = 0
    for k, w in want.items():
        assert got[k] == _spec(w), (k, got[k], w)
        assert len(got[k]) == len(_flat(port)[k].shape)
        sharded += "model" in got[k]
    # the big things shard at 1 and 16 (gemma2's 8 heads x 256 = 2,048
    # too); at 17 every dim falls back to replication
    assert (sharded > 0) == (tp != 17), sharded


@pytest.mark.parametrize("tp", [1, 16])
def test_mlp_rules_match_reference_on_din(tp):
    cfg = C.get_arch("din").make_config()
    ref = jax.eval_shape(functools.partial(
        RD.init_params, cfg=RCF.get_arch("din").make_config()),
        jax.random.PRNGKey(0))
    mesh = _mesh(model=tp)
    got = _flat(SH.param_specs(D.param_shapes(cfg), SH.mlp_param_spec,
                               SH.MeshAxes(), mesh),
                is_leaf=lambda x: isinstance(x, tuple))
    want = _flat(RDI.param_specs(ref, RDI.mlp_param_spec, RDI.MeshAxes(),
                                 mesh),
                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert got == {k: _spec(v) for k, v in want.items()}


@pytest.mark.parametrize("data", [1, 16])
@pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
def test_zero1_and_opt_state_specs_match_reference(data, data_axes):
    ref, port = _shapes("gemma2-2b")
    mesh = types.SimpleNamespace(shape={"pod": 1, "data": data,
                                        "model": 16})
    axes = SH.MeshAxes(data=data_axes)
    raxes = RDI.MeshAxes(data=data_axes)
    ps = SH.param_specs(port, SH.lm_param_spec, axes, mesh)
    rps = RDI.param_specs(ref, RDI.lm_param_spec, raxes, mesh)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    is_t = lambda x: isinstance(x, tuple)  # noqa
    got = _flat(SH.zero1_specs(port, ps, axes, mesh), is_leaf=is_t)
    want = _flat(RDI.zero1_specs(ref, rps, raxes, mesh), is_leaf=is_p)
    assert {k: _spec(v) for k, v in got.items()} == {
        k: _spec(v) for k, v in want.items()}
    if data == 16:
        assert any(data_axes in v for v in got.values())
    o = SH.opt_state_specs(adamw_init(port), port, ps, axes, mesh)
    ro = RDI.opt_state_specs(jax.eval_shape(RO.adamw_init, ref), ref, rps,
                             raxes, mesh)
    assert isinstance(o, AdamWState) and o.step == _spec(ro.step)
    for port_t, ref_t in ((o.m, ro.m), (o.v, ro.v)):
        assert {k: _spec(v) for k, v in _flat(port_t, is_leaf=is_t).items()
                } == {k: _spec(v) for k, v in
                      _flat(ref_t, is_leaf=is_p).items()}
    assert _spec(SH.batch_spec(axes)) == _spec(RDI.batch_spec(raxes))


def test_mesh_axes_read_sizes_as_the_reference_does():
    for shape in ({"data": 4, "model": 2}, {"pod": 2, "data": 3},
                  {"model": 8}):
        mesh = types.SimpleNamespace(shape=shape)
        for data in (("data",), ("pod", "data")):
            a, r = SH.MeshAxes(data=data), RDI.MeshAxes(data=data)
            assert a.data_size(mesh) == r.data_size(mesh)
            assert a.model_size(mesh) == r.model_size(mesh)
            assert a.data_size(shape) == r.data_size(mesh)
    assert SH.MeshAxes().data_size(ShardMesh((torch.device("cpu"),) * 3)
                                   ) == 3


def test_pad_rejects_a_spec_longer_than_the_shape():
    with pytest.raises(ValueError, match="more entries"):
        SH._pad(("model", None, None), 2)


def test_index_shard_specs_match_reference_and_the_placement():
    """The table equals the reference's; ``ShardedEngine._place`` splits
    the arenas on the shard axis and copies the routing arrays whole."""
    from repro.distributed.sharding import index_shard_specs as ris
    from repro_torch.cluster import ShardedEngine
    from repro_torch.core import build_index
    from repro_torch.data import get_dataset

    got, want = SH.index_shard_specs("data"), ris("data")
    assert got == {k: _spec(v) for k, v in want.items()}
    assert SH.index_shard_specs("x")["fine"] == ("x", None, None)

    idx = build_index(get_dataset("yelp", scale=0.02), "2dreach-comp")
    cpu = torch.device("cpu")
    eng = ShardedEngine(idx, n_shards=4, mesh=ShardMesh((cpu, cpu)),
                        device="cpu")
    from repro_torch.cluster.partition import shard_arenas

    entries, fine, coarse, _ = shard_arenas(idx.forest, eng.partition)
    stacks = {"entries": entries, "fine": fine, "coarse": coarse}
    part = eng.partition
    for g in eng._groups:
        L = eng._shards_per_dev
        for name, spec in got.items():
            have = getattr(g, name).numpy()
            if spec[:1] == ("data",):
                whole = np.asarray(stacks[name])
                assert np.array_equal(have, whole[g.first:g.first + L])
            else:
                assert spec == ()
                assert np.array_equal(have, getattr(part, name))


# ---------------------------------------------------------- checkpoints

def _tree(seed=0):
    """The reference's test tree, as tensors."""
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((32, 8), generator=g),
        "nested": {"b": torch.arange(7), "c": torch.tensor(3.5)},
        "list": [torch.ones(3), torch.zeros((2, 2), dtype=torch.bfloat16)],
    }


def _leaves(tree):
    return [x for _, x in walk(tree)]


def test_roundtrip(tmp_path):
    t = _tree()
    CK.save_checkpoint(str(tmp_path), 5, t, extra={"note": "x"})
    assert CK.latest_step(str(tmp_path)) == 5
    r, man = CK.restore_checkpoint(str(tmp_path), t)
    assert man["step"] == 5 and man["extra"]["note"] == "x"
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_ignores_uncommitted(tmp_path):
    CK.save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009")       # torn: no manifest
    os.makedirs(tmp_path / f"step_00000011.tmp-{os.getpid()}")
    assert CK.latest_step(str(tmp_path)) == 3
    _, man = CK.restore_checkpoint(str(tmp_path), _tree())
    assert man["step"] == 3


def test_manager_async_and_gc(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.close()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    r, _ = CK.restore_checkpoint(str(tmp_path), _tree())
    assert torch.equal(r["a"], _tree(4)["a"])
    assert not mgr._thread.is_alive()


def test_manager_copies_before_it_returns(tmp_path):
    """The tree is copied to the host in ``save_async``: a later change
    to the caller's tensors does not reach the file."""
    mgr = CK.CheckpointManager(str(tmp_path))
    t = _tree()
    want = t["a"].clone()
    mgr.save_async(1, t)
    t["a"].add_(1.0)
    mgr.close()
    r, _ = CK.restore_checkpoint(str(tmp_path), _tree())
    assert torch.equal(r["a"], want)


def test_manager_surfaces_a_writer_error(tmp_path):
    """A failed write raises on the next ``save_async``; after that the
    manager writes again; a failure before ``close`` raises there."""
    target = tmp_path / "file"
    target.write_text("not a directory")
    mgr = CK.CheckpointManager(str(target))
    mgr.save_async(1, _tree())
    mgr._q.join()
    with pytest.raises(OSError):
        mgr.save_async(2, _tree())
    mgr.save_async(3, _tree())
    with pytest.raises(OSError):
        mgr.close()
    mgr._q.put(None)
    mgr._thread.join(timeout=10)
    assert not mgr._thread.is_alive()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CK.restore_checkpoint(str(tmp_path / "none"), _tree())
    CK.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="checkpoint missing b"):
        CK.restore_checkpoint(str(tmp_path), {"a": torch.ones(2),
                                              "b": torch.ones(2)})


def _state_pair(seed=0):
    """``{"params", "opt"}`` in both packages, the same values: dicts,
    a list, float32 and bf16 leaves, an AdamW state after one step."""
    rng = np.random.default_rng(seed)
    params = {"b": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "a": [rng.standard_normal(4).astype(np.float32),
                    rng.standard_normal((2, 3)).astype(np.float32)],
              "emb": rng.standard_normal((6, 2)).astype(np.float32)}
    rp = jax.tree.map(jnp.asarray, params)
    rp["emb"] = rp["emb"].astype(jnp.bfloat16)
    ro = RO.adamw_init(rp)
    ro = ro._replace(step=jnp.int32(7),
                     m=jax.tree.map(lambda x: x + 0.25, ro.m))
    p = jax.tree.map(lambda x: torch.as_tensor(np.asarray(x, np.float32)),
                     rp)
    p["emb"] = p["emb"].to(torch.bfloat16)
    o = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                   m=jax.tree.map(lambda x: torch.as_tensor(np.asarray(x)),
                                  ro.m),
                   v=jax.tree.map(lambda x: torch.as_tensor(np.asarray(x)),
                                  ro.v))
    return {"params": rp, "opt": ro}, {"params": p, "opt": o}


def _same(port_tree, ref_tree):
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [str(k) for k, _ in got] == [str(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[1] == str(b.dtype), k
        assert np.array_equal(a.to(torch.float32).numpy(),
                              b.astype(np.float32)), k


def test_checkpoints_cross_load_with_the_same_keys(tmp_path):
    """Port -> reference and reference -> port: the same manifest keys
    (``opt/.step``, ``opt/.m/a/0``, ..., ``params/emb``), every leaf
    restored bit for bit in the template's dtype."""
    ref, port = _state_pair()
    CK.save_checkpoint(str(tmp_path / "port"), 3, port, extra={"by": "p"})
    RCK.save_checkpoint(str(tmp_path / "ref"), 3, ref, extra={"by": "r"})
    man = {}
    for who in ("port", "ref"):
        with open(tmp_path / who / "step_00000003" / "manifest.json") as f:
            import json
            man[who] = json.load(f)
    assert man["port"]["keys"] == man["ref"]["keys"]
    assert man["port"]["keys"][:3] == ["opt/.step", "opt/.m/a/0",
                                       "opt/.m/a/1"]
    assert man["port"]["n_shards"] == man["ref"]["n_shards"] == 1
    # reference reads the port's
    got, m1 = RCK.restore_checkpoint(str(tmp_path / "port"), ref)
    assert m1["extra"] == {"by": "p"}
    _same(port, got)
    # port reads the reference's
    got, m2 = CK.restore_checkpoint(str(tmp_path / "ref"), port)
    assert m2["extra"] == {"by": "r"} and isinstance(got["opt"], AdamWState)
    _same(got, ref)
    with np.load(tmp_path / "port" / "step_00000003" /
                 "shard_00000.npz") as z:
        assert z["params|emb"].dtype == np.float32   # bf16 widened


def test_checkpoint_splits_shards_like_the_reference(tmp_path, monkeypatch):
    ref, port = _state_pair(1)
    monkeypatch.setattr(CK, "SHARD_BYTES", 40)
    monkeypatch.setattr(RCK, "SHARD_BYTES", 40)
    CK.save_checkpoint(str(tmp_path / "port"), 1, port)
    RCK.save_checkpoint(str(tmp_path / "ref"), 1, ref)
    names = {w: sorted(os.listdir(tmp_path / w / "step_00000001"))
             for w in ("port", "ref")}
    assert names["port"] == names["ref"] and len(names["port"]) > 3
    got, man = RCK.restore_checkpoint(str(tmp_path / "port"), ref)
    assert man["n_shards"] == len(names["port"]) - 1
    _same(port, got)


def test_restore_keeps_the_template_device_and_dtype(tmp_path):
    _, port = _state_pair(2)
    CK.save_checkpoint(str(tmp_path), 2, port)
    tmpl = jax.tree.map(lambda x: x, port)
    tmpl["params"]["emb"] = torch.zeros((6, 2), dtype=torch.float32)
    got, _ = CK.restore_checkpoint(str(tmp_path), tmpl)
    assert got["params"]["emb"].dtype == torch.float32
    assert torch.equal(got["params"]["emb"],
                       port["params"]["emb"].to(torch.float32))
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    arrays = jax.tree.map(lambda x: x.to(torch.float32).numpy(),
                          port["params"])
    got, _ = CK.restore_checkpoint(str(tmp_path), {"params": arrays,
                                                   "opt": port["opt"]})
    assert isinstance(got["params"]["emb"], np.ndarray)


# ----------------------------------------------------- recovery, reshard

@pytest.mark.parametrize("fail_times,max_failures", [(0, 3), (2, 5),
                                                     (3, 3), (4, 3)])
def test_run_with_recovery_matches_reference(fail_times, max_failures,
                                             monkeypatch):
    """The same calls, sleeps and outcome as the reference's loop."""
    def run(mod):
        calls, sleeps = [], []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)

        def segment(step):
            calls.append(step)
            if len(calls) <= fail_times:
                raise RuntimeError("transient")
            return 99

        try:
            out = mod.run_with_recovery(segment, start_step=5,
                                        max_failures=max_failures,
                                        backoff_s=0.5)
        except RuntimeError:
            out = "raised"
        return out, calls, sleeps

    import repro.distributed.elastic as REL

    got = run(EL)
    assert got == run(REL)
    assert got[0] == (99 if fail_times <= max_failures else "raised")
    assert got[2] == [0.5 * 2 ** i for i in range(min(fail_times,
                                                      max_failures))]


def test_run_with_recovery_never_catches_keyboard_interrupt():
    calls = []

    def segment(step):
        calls.append(step)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        EL.run_with_recovery(segment, start_step=0, backoff_s=0.0)
    assert calls == [0]


def test_reshard_places_on_one_device():
    _, port = _state_pair(3)
    mesh = ShardMesh((torch.device("cpu"),))
    ps = SH.param_specs(port["params"], lambda *a: (), SH.MeshAxes(), mesh)
    specs = {"params": ps, "opt": AdamWState(step=(), m=ps, v=ps)}
    out = DI.reshard(port, mesh, specs)
    assert isinstance(out["opt"], AdamWState)
    for a, b in zip(_leaves(out), _leaves(port)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    arr = DI.reshard({"w": np.ones((8, 4))}, mesh, {"w": (None, "model")})
    assert torch.equal(arr["w"], torch.ones((8, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="more entries"):
        DI.reshard({"w": np.ones(3)}, mesh, {"w": (None, "model")})


def test_reshard_waits_for_multi_card_work():
    """A single process's mesh of several devices, or with a model axis
    of 2, raises ``ValueError`` naming the process mesh: one process
    holds no global sharded tensor (``reshard`` onto a process mesh:
    ``tests/test_torch_mesh.py``)."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="process mesh"):
        DI.reshard({"w": torch.ones(2)}, ShardMesh((cpu, cpu)),
                   {"w": ()})
    wide = types.SimpleNamespace(devices=(cpu,), shape={"data": 1,
                                                        "model": 2})
    with pytest.raises(ValueError, match="process mesh"):
        DI.reshard({"w": torch.ones(2)}, wide, {"w": ()})
