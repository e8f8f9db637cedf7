"""The port's device build (``build_2dreach(backend="device")``) against
the JAX package's and against the host build: the packed closure product
(``bitset_mm_torch`` against ``bitset_mm_ref`` and the interpreted
``bitset_mm_pallas``), the segmented-MBR reduction and its building
blocks, ``closure_bitset_mm`` against the reference's Pallas closure and
``closure_np``, ``build_forest_device`` (the ``DeviceForest`` tensors
too) against the reference's, whole indexes against the host build, and
the engine's adoption of a device-built forest.  Every comparison is
exact.
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

import repro.core as R
import repro.core.reachability as RR
import repro.core.rtree as RT
import repro.kernels.bitset_mm.kernel as RBK
import repro.kernels.bitset_mm.ops as RBO
import repro.kernels.bitset_mm.ref as RBR
import repro.kernels.forest_build as RF
from conftest import random_geosocial
from repro_torch.convert import index_from_arrays, index_to_arrays
from repro_torch.core import (
    QueryEngine,
    build_2dreach,
    build_index,
    condense,
    make_graph,
    scc_np,
)
from repro_torch.core import engine as E
from repro_torch.core.reachability import closure_bitset_mm, closure_np
from repro_torch.core.rtree import build_forest, build_forest_device
from repro_torch.data import get_dataset, workload
from repro_torch.kernels import bitset_mm as BM
from repro_torch.kernels.bitset_mm import ops as BMO
from repro_torch.kernels import forest_build as FB
from repro_torch.kernels.range_query.layout import (
    COARSE_GROUP,
    TP,
    TPT,
    build_tile_pyramid,
    forest_to_soa,
)

VARIANTS = ("base", "comp", "pointer")
CPU = torch.device("cpu")


def _words(rng, shape, p_zero=0.6):
    """Random uint32 words, many zero, bit 31 common."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    w[rng.random(shape) < p_zero] = 0
    w[rng.random(shape) < 0.2] |= np.uint32(1 << 31)
    return w


def _same_forest(a, b):
    for x, y in ((a.entries, b.entries), (a.entry_ids, b.entry_ids),
                 (a.entry_off, b.entry_off)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.depth == b.depth
    for x, y in zip(a.level_mbr + a.tree_off, b.level_mbr + b.tree_off):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _same_index(a, b):
    assert a.variant == b.variant
    for f in ("excluded", "vertex_comp", "comp_tree", "vertex_tree",
              "tree_ptrs"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    if a.bitrank is not None:
        assert np.array_equal(a.bitrank.bits, b.bitrank.bits)
        assert np.array_equal(a.bitrank.rank, b.bitrank.rank)
    _same_forest(a.forest, b.forest)


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("f,m,W", [(1, 1, 1), (5, 32, 1), (13, 33, 3),
                                   (40, 100, 130), (64, 64, 5),
                                   (9, 61, 1), (7, 93, 33), (4, 200, 129)])
def test_bitset_mm_matches_reference(f, m, W):
    rng = np.random.default_rng(f * m + W)
    Wm = (m + 31) // 32
    a = _words(rng, (f, Wm))
    a[1::4] = 0xFFFFFFFF                      # dense rows
    if m % 32:                                # bits at columns >= m
        a[:, -1] |= np.uint32(0xFFFFFFFF << (m % 32) & 0xFFFFFFFF)
    a[0, 0] |= np.uint32(1)                   # row 0 reaches column 0 ...
    r = _words(rng, (m, W), p_zero=0.3)
    r[0] |= np.uint32(1 << 31)                # ... whose bit 31 is set
    got = BM.bitset_mm_torch(BM.uint32_bits(a, CPU), BM.uint32_bits(r, CPU))
    assert got.dtype == torch.int32 and tuple(got.shape) == (f, W)
    got = got.numpy().view(np.uint32)
    # the reference pads to its tile, as its closure does: its zero
    # rows at and past m stand for the columns the port masks
    r_pad = np.zeros((32 * Wm, W), np.uint32)
    r_pad[:m] = r
    want_ref = np.asarray(RBR.bitset_mm_ref(jnp.asarray(a),
                                            jnp.asarray(r_pad)))
    want_kernel = RBO.bitset_mm(a, r, interpret=True)
    assert np.array_equal(got, want_ref) and np.array_equal(got, want_kernel)
    assert (got[0] >> 31).all() and (f < 13 or (got == 0).any())
    if f > 1:                                 # a dense row ORs all of R
        assert np.array_equal(got[1], np.bitwise_or.reduce(r, axis=0))
    # the wrapper on a CPU tensor runs the plain version, uncounted
    before = BM.bitset_mm.launches
    assert np.array_equal(BM.bitset_mm(
        BM.uint32_bits(a, CPU), BM.uint32_bits(r, CPU),
        device="cpu").numpy().view(np.uint32), got)
    assert BM.bitset_mm.launches == before
    with pytest.raises(ValueError, match="rows"):
        BM.bitset_mm(BM.uint32_bits(a, CPU),
                     BM.uint32_bits(np.zeros((32 * Wm + 1, W)), CPU),
                     device="cpu")


@pytest.mark.parametrize("f,m,want", [
    (1, 1, 0), (1, 63, 0), (1, 64, 8), (1, 977, 8), (8, 512, 8),
    (9, 576, 8), (264, 16896, 4), (528, 33792, 2), (1048, 67072, 2),
    (1056, 67584, 1), (2000, 128000, 1), (2000, 127999, 0),
    (8436, 2383, 0), (17878, 2875, 0)])
def test_bitset_mm_cluster_size(f, m, want):
    """K7's instantiation on 132 multiprocessors: ROWWISE (0) unless the
    f rows average at least HUB = 64 of the m columns; then SPREAD with
    the least of 1, 2, 4, 8 CTAs per 8 rows whose clusters cover the
    multiprocessors."""
    assert BMO.HUB == 64
    assert BMO.cluster_size(f, m, 132) == want


def test_build_keeps_the_compiler_log(tmp_path, monkeypatch):
    """A kernel library built earlier reports its compiler's output
    (the ptxas register lines) again, from the log beside it."""
    from repro_torch.kernels import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info : Used 32 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    path, log = _build.build("bitset_mm")
    assert path.exists() and "Used 32 registers" in log
    assert _build.build("bitset_mm") == (path, log)


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(3)
    rows = rng.random((7, 75)) < 0.4
    rows[:, 31] = True
    packed = BM.pack_bits(torch.as_tensor(rows))
    want = np.asarray(RBR.pack_bits_jnp(jnp.asarray(rows)))
    assert np.array_equal(packed.numpy().view(np.uint32), want)
    assert np.array_equal(BM.unpack_bits(packed, 75).numpy(), rows)
    assert np.array_equal(
        BM.unpack_bits(packed, 75).numpy(),
        np.asarray(RBR.unpack_bits_jnp(jnp.asarray(want), 75)))


# ------------------------------------------------------------------- K8
@pytest.mark.parametrize("fan,n", [(16, 128), (128, 256), (8, 384),
                                   (16, 5)])
def test_seg_mbr_matches_reference(fan, n):
    rng = np.random.default_rng(fan + n)
    c = rng.uniform(-50, 50, (fan, 4, n)).astype(np.float32)
    inert = np.broadcast_to((rng.random((fan, n)) < 0.3)[:, None],
                            (fan, 2, n))
    c[:, :2][inert] = np.inf
    c[:, 2:][inert] = -np.inf
    x = c.reshape(fan * 4, n)
    got = FB.seg_mbr_torch(torch.as_tensor(x), dim=2, fan=fan).numpy()
    assert np.array_equal(got, np.asarray(
        RF.seg_mbr_ref(jnp.asarray(x), dim=2, fan=fan)))
    if n % RF.TN == 0:
        assert np.array_equal(got, np.asarray(RF.seg_mbr_pallas(
            jnp.asarray(x), dim=2, fan=fan, interpret=True)))
    before = FB.seg_mbr.launches
    assert np.array_equal(FB.seg_mbr(torch.as_tensor(x), dim=2, fan=fan,
                                     device="cpu").numpy(), got)
    assert FB.seg_mbr.launches == before


def test_forest_build_blocks_match_reference():
    rng = np.random.default_rng(5)
    src = rng.uniform(0, 10, (4, 300)).astype(np.float32)
    src[2:] = src[:2] + rng.uniform(0, 1, (2, 300)).astype(np.float32)
    assert np.array_equal(
        FB.slot_major(torch.as_tensor(src[:, :288]), 16).numpy(),
        np.asarray(RF.slot_major(jnp.asarray(src[:, :288]), 16)))
    starts = np.array([0, 16, 32, 40, 290], np.int64)
    ends = np.array([16, 32, 40, 41, 300], np.int64)
    got = FB.level_mbr(torch.as_tensor(src), starts, ends, 16, 2,
                       device="cpu").numpy()
    for kernel in ("xla", "pallas"):
        want = np.asarray(RF.level_mbr(jnp.asarray(src), starts, ends, 16, 2,
                                       kernel=kernel, interpret=True))
        assert got.shape == want.shape and np.array_equal(got, want)
    esoa = np.concatenate([src[:, :250], FB.np_inert_plane(2, 6)], 1)
    fine, coarse, nt = FB.tile_pyramid_device(
        torch.as_tensor(np.tile(esoa, (1, 16))), 2, tp=TP, tpt=TPT,
        group=COARSE_GROUP, device="cpu")
    want = build_tile_pyramid(np.tile(esoa, (1, 16)), 2)
    assert np.array_equal(fine.numpy(), want[0])
    assert np.array_equal(coarse.numpy(), want[1]) and nt == want[2]
    assert np.array_equal(FB.np_inert_plane(2, 3), RF.np_inert_plane(2, 3))


# ------------------------------------------------------------------- closure
def _cond(g, variant):
    if variant == "base":
        return condense(g.n_nodes, g.edges, scc_np(g.n_nodes, g.edges)), None
    exc = g.spatial_sink_mask()
    e = g.edges
    dec = e[~(exc[e[:, 0]] | exc[e[:, 1]])]
    cond = condense(g.n_nodes, dec, scc_np(g.n_nodes, dec),
                    include_mask=~exc)
    m = exc[e[:, 1]] & ~exc[e[:, 0]]
    src_c = cond.comp[e[m, 0]]
    ok = src_c >= 0
    return cond, (e[m, 1][ok], src_c[ok])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", ["base", "comp"])
def test_closure_bitset_mm_matches_reference(seed, variant):
    rg = random_geosocial(np.random.default_rng(seed), 120, 400)
    g = make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask)
    cond, extra = _cond(g, variant)
    args = (cond, g.n_nodes, g.spatial_ids)
    got = closure_bitset_mm(*args, extra_vertex_comp=extra, device="cpu",
                            chunk_edges=7 + seed)
    want = RR.closure_bitset_mm(*args, extra_vertex_comp=extra,
                                kernel="pallas", interpret=True)
    host = closure_np(*args, extra_vertex_comp=extra)
    for ref in (want, host):
        assert got.bits.dtype == ref.bits.dtype == np.uint32
        assert np.array_equal(got.bits, ref.bits)
        for f in ("interior_row", "own_indptr", "own_cols", "col_of_vertex"):
            assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.bits.size and got.bits.any()


# ------------------------------------------------------------------- forest
def _forest_cases():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 100, (700, 2)).astype(np.float32)
    pts[100:160] = pts[99]                      # Morton ties
    tree = np.sort(rng.integers(0, 40, 700))
    yield pts, tree, 41, 16                     # an empty last tree
    yield pts[:1], np.zeros(1, np.int64), 1, 16
    yield pts[:0], np.zeros(0, np.int64), 3, 16
    yield pts[:256], np.repeat(np.arange(2), 128), 2, 2
    yield pts[:256], np.zeros(256, np.int64), 1, 16   # fanout**2 entries


def test_build_forest_device_matches_reference():
    for pts, tree, T, fan in _forest_cases():
        boxes = np.concatenate([pts, pts], 1)
        ids = np.arange(len(pts), dtype=np.int32)[::-1].copy()
        got = build_forest_device(boxes, ids, tree, T, fanout=fan,
                                  device="cpu")
        want = RT.build_forest_device(boxes, ids, tree, T, fanout=fan,
                                      kernel="xla")
        _same_forest(got, want)
        _same_forest(got, build_forest(boxes, ids, tree, T, fanout=fan))
        dv, rdv = got.device, want.device
        for f in ("entries", "fine", "coarse", "entry_off"):
            x, y = getattr(dv, f), np.asarray(getattr(rdv, f))
            assert x.device == CPU and x.numpy().dtype == y.dtype
            assert np.array_equal(x.numpy(), y), f
        assert dv.n_tiles == rdv.n_tiles
        esoa, off = forest_to_soa(got)          # what an upload builds
        fine, coarse, _ = build_tile_pyramid(esoa, 2)
        assert np.array_equal(dv.entries.numpy(), esoa)
        assert np.array_equal(dv.entry_off.numpy(), off)
        assert np.array_equal(dv.fine.numpy(), fine)
        assert np.array_equal(dv.coarse.numpy(), coarse)
    with pytest.raises(ValueError, match="tree-contiguous"):
        build_forest_device(np.zeros((2, 4), np.float32), np.zeros(2),
                            np.array([1, 0]), 2, device="cpu")


# ------------------------------------------------------------------- index
def _graph(source):
    if source == "yelp":
        return get_dataset("yelp", scale=0.05)
    rg = random_geosocial(np.random.default_rng(int(source[4:])), 90, 260)
    return make_graph(rg.n_nodes, rg.edges, rg.coords, rg.spatial_mask)


@pytest.mark.parametrize("source", ["yelp", "seed0", "seed1", "seed2"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_device_build_matches_host(source, variant):
    g = _graph(source)
    host = build_2dreach(g, variant=variant)
    dev = build_2dreach(g, variant=variant, backend="device", device="cpu")
    _same_index(host, dev)
    assert host.backend == "host" and dev.backend == "device"
    assert dev.forest.device is not None and host.forest.device is None
    for k in ("t_closure", "t_forest", "t_total"):
        assert k in dev.stats


def test_engine_adopts_device_build():
    g = get_dataset("yelp", scale=0.05)
    dev = build_index(g, "2dreach-comp", backend="device", device="cpu")
    host = build_index(g, "2dreach-comp")
    before = dict(E.UPLOAD_COUNTERS)
    eng = QueryEngine(dev, device="cpu")
    assert E.UPLOAD_COUNTERS == {
        "host_uploads": before["host_uploads"],
        "device_adoptions": before["device_adoptions"] + 1}
    assert eng.stats["adopted"] == 1
    assert eng._arena.entries is dev.forest.device.entries
    heng = QueryEngine(host, device="cpu")
    assert E.UPLOAD_COUNTERS["host_uploads"] == before["host_uploads"] + 1
    assert heng.stats["adopted"] == 0
    # a device forest that lies on another device than the engine's is
    # uploaded, and the engine says so
    real = dev.forest.device
    dev.forest.device = dataclasses.replace(
        real, entries=real.entries.to("meta"))
    try:
        before = dict(E.UPLOAD_COUNTERS)
        cross = QueryEngine(dev, device="cpu")
    finally:
        dev.forest.device = real
    assert E.UPLOAD_COUNTERS == {
        "host_uploads": before["host_uploads"] + 1,
        "device_adoptions": before["device_adoptions"]}
    assert cross.stats["adopted"] == 0
    assert torch.equal(cross._arena.entries, eng._arena.entries)
    for path in ("fused", "two_phase"):
        eng.path = heng.path = path
        us, rects = workload(g, 64, extent_ratio=0.05, seed=3)
        assert np.array_equal(eng.query_batch(us, rects),
                              heng.query_batch(us, rects))
        assert np.array_equal(eng.count_batch(us, rects),
                              heng.count_batch(us, rects))
    # a reference device-built index carried across answers alike and
    # keeps its backend; with no device forest it is uploaded
    ref = R.build_2dreach(g, variant="comp", backend="device",
                          device_kernel="xla")
    _same_index(dev, ref)
    carried = index_from_arrays(index_to_arrays(ref))
    assert carried.backend == "device" and carried.forest.device is None
    assert np.array_equal(QueryEngine(carried, device="cpu").query_batch(
        us, rects), R.batch_query(ref, us, rects))


def test_device_build_needs_cuda(monkeypatch):
    g = get_dataset("tiny")
    with pytest.raises(ValueError, match="backend"):
        build_2dreach(g, variant="comp", backend="nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_2dreach(g, variant="comp", backend="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_index(g, "2dreach-comp", backend="device")
