"""The port's leaf-scan engine (``range_query_forest`` with the plain
version of K9) and wavefront engine (``query_wavefront``) against the
JAX package's.

The plain leaf scan ``range_query_torch`` is held against
``range_query_ref`` and the interpreted Pallas kernel
``range_query_pallas`` on the reference's own sweep; the engines against
the reference's engines and ``query_host``.  Every comparison is exact.
"""

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
import repro.data as RD
from repro.kernels.range_query import ops as RO
from repro.kernels.range_query.kernel import range_query_pallas
from repro.kernels.range_query.ref import range_query_ref
from repro_torch.core import (
    QueryEngine,
    build_forest,
    build_index,
    query_host,
    query_wavefront,
)
from repro_torch.data import get_dataset, workload
from repro_torch.kernels.range_query import layout
from repro_torch.kernels.range_query import leafscan as L

SWEEP = [(0, 1, 8), (7, 1, 3), (130, 4, 33), (513, 7, 64), (1001, 5, 40)]


def _sweep_case(dim, P, T, B):
    """The inputs of the reference's ``test_range_query_sweep``: a port
    forest and a reference forest from the same boxes, tree ids in
    [-1, T), rects."""
    rng = np.random.default_rng(P * 31 + T * 7 + B + dim)
    lo = rng.random((P, dim)).astype(np.float32) * 10
    hi = lo + (0 if dim == 2 else rng.random((P, dim)).astype(np.float32))
    boxes = np.concatenate([lo, hi], axis=1)
    tree_of = rng.integers(0, T, size=P)
    ids = np.arange(P, dtype=np.int32)
    forest = build_forest(boxes, ids, tree_of, T)
    ref = R.build_forest(boxes, ids, tree_of, T)
    tids = rng.integers(-1, T, size=B)
    c = rng.random((B, dim)).astype(np.float32) * 10
    r = rng.random((B, dim)).astype(np.float32) * 3
    return forest, ref, tids, np.concatenate([c - r, c + r], axis=1)


def _edge_slices(rng, P, Bp):
    """(qs, qe) of Bp queries over P entries: starts at every residue
    mod 4, lengths 0 to past P, every fifth slice starting below 0,
    ending past P, empty or reversed in turn."""
    n = rng.choice([0, 1, 3, 4, 5, 127, 128, 129], Bp)
    qs = np.arange(Bp) % 4 + 4 * rng.integers(0, max(1, P // 4), Bp)
    qe = qs + n
    kind = np.where(np.arange(Bp) % 5 == 4, np.arange(Bp) // 5 % 4, -1)
    qs[kind == 0] -= qs[kind == 0] + 3
    qe[kind == 1] = P + 9
    qe[kind == 2] = qs[kind == 2]
    qe[kind == 3] = qs[kind == 3] - 2
    return qs.astype(np.int32), qe.astype(np.int32)


@pytest.mark.parametrize("P,offset,vector", [
    (0, 0, True), (1000, 0, True), (1024, 0, True), (1001, 0, False),
    (40000, 0, True), (1000, 1, False), (1000, 2, False), (1000, 4, True)])
def test_vector_planes(P, offset, vector):
    """K9's instantiation: float4 loads only where every plane starts on
    a 16-byte boundary (P % 4 == 0 and an aligned base)."""
    buf = torch.zeros(4 * P + 8)
    planes = buf[offset:offset + 4 * P].view(4, P)
    assert buf.data_ptr() % 64 == 0
    assert L.vector_planes(planes) == vector


def _slices(off, tids, Bp):
    qs = np.zeros(Bp, np.int32)
    qe = np.zeros(Bp, np.int32)
    ok = tids >= 0
    qs[: len(tids)][ok] = off[tids[ok]]
    qe[: len(tids)][ok] = off[tids[ok] + 1]
    return qs, qe


@pytest.mark.parametrize("P,T,B", SWEEP)
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_scan_matches_ref_and_pallas(dim, P, T, B):
    forest, ref, tids, rects = _sweep_case(dim, P, T, B)
    esoa, off = layout.forest_to_soa(forest)
    resoa, roff = RO.forest_to_soa(ref)
    assert np.array_equal(esoa, resoa) and np.array_equal(off, roff)
    rsoa = L.rects_to_soa(rects, dim)
    assert np.array_equal(rsoa, RO.rects_to_soa(rects, dim))
    qs, qe = _slices(off, tids, rsoa.shape[1])
    got = L.range_query_torch(torch.as_tensor(esoa), torch.as_tensor(rsoa),
                              torch.as_tensor(qs), torch.as_tensor(qe),
                              dim=dim)
    args = [jnp.asarray(a) for a in (esoa, rsoa, qs, qe)]
    want = np.asarray(range_query_ref(*args, dim=dim))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(
        range_query_pallas(*args, dim=dim, interpret=True)))
    # the wrapper on a CPU tensor runs the plain version, not the kernel
    n = L.range_query.launches
    wrapped = L.range_query(torch.as_tensor(esoa), torch.as_tensor(rsoa),
                            torch.as_tensor(qs), torch.as_tensor(qe),
                            dim=dim, device="cpu")
    assert torch.equal(wrapped, got) and L.range_query.launches == n
    # slices with unaligned starts and ends, clipped and empty ones
    rng = np.random.default_rng(P + B)
    qs, qe = _edge_slices(rng, esoa.shape[1], rsoa.shape[1])
    rsoa = rsoa.copy()
    rsoa[:, : len(rects)] = rects.T
    rsoa[:, 1::2] = np.concatenate([np.full((dim, 1), -1e9, np.float32),
                                    np.full((dim, 1), 1e9, np.float32)])
    got = L.range_query_torch(torch.as_tensor(esoa), torch.as_tensor(rsoa),
                              torch.as_tensor(qs), torch.as_tensor(qe),
                              dim=dim)
    args = [jnp.asarray(a) for a in (esoa, rsoa, qs, qe)]
    want = np.asarray(range_query_ref(*args, dim=dim))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(
        range_query_pallas(*args, dim=dim, interpret=True)))
    live = np.minimum(qe, esoa.shape[1]) > np.maximum(qs, 0)
    assert np.array_equal(want[1::2], live[1::2])    # rects over everything


@pytest.mark.parametrize("P,T,B", SWEEP)
@pytest.mark.parametrize("dim", [2, 3])
def test_forest_engine_matches_reference(dim, P, T, B):
    forest, ref, tids, rects = _sweep_case(dim, P, T, B)
    got = L.range_query_forest(forest, tids, rects, device="cpu")
    assert got.dtype == bool and got.shape == (B,)
    assert np.array_equal(got, query_host(forest, tids, rects))
    assert np.array_equal(got, RO.range_query_forest(ref, tids, rects,
                                                     use_ref=True))
    mbr, off = forest.device_arrays(device="cpu")
    rmbr, roff = ref.device_arrays()
    assert mbr.dtype == torch.float32 and off.dtype == torch.int64
    assert np.array_equal(mbr.numpy(), np.asarray(rmbr))
    assert np.array_equal(off.numpy(), np.asarray(roff))
    assert bool((mbr[..., :dim] > mbr[..., dim:]).any(-1).sum()
                == sum(mbr.shape[1] - len(l) for l in forest.level_mbr))


def _wavefront_cases():
    """(name, port forest, reference forest, tree ids, rects): the sweep's
    forests and the yelp x0.05 2dreach-comp and 3dreach forests with
    their workload; tree ids of -1 included in each."""
    for dim, (P, T, B) in ((2, SWEEP[2]), (3, SWEEP[3])):
        forest, ref, tids, rects = _sweep_case(dim, P, T, B)
        yield f"sweep{dim}", forest, ref, tids, rects
    g, rg = get_dataset("yelp", scale=0.05), RD.get_dataset("yelp", scale=0.05)
    us, rects = workload(g, 150, extent_ratio=0.05, seed=5)
    idx, ridx = build_index(g, "2dreach-comp"), R.build_index(rg,
                                                              "2dreach-comp")
    tids = idx.lookup_tree(us)
    tids[idx.excluded[us]] = -1
    tids[::17] = -1
    yield "yelp-comp", idx.forest, ridx.forest, tids, rects
    i3, r3 = build_index(g, "3dreach"), R.build_index(rg, "3dreach")
    z = np.arange(len(us), dtype=np.float32) % i3.cond.n_comps
    rect3 = np.concatenate([rects[:, :2], z[:, None] - 40.5, rects[:, 2:],
                            z[:, None] + 40.5], axis=1).astype(np.float32)
    yield "yelp-3d", i3.forest, r3.forest, np.where(
        np.arange(len(us)) % 11 == 0, -1, 0), rect3


@pytest.mark.parametrize("capacity", [256, 2])
def test_wavefront_matches_reference(capacity):
    """hit and overflow both equal to ``query_jax_wavefront``; where no
    query overflowed, hit equals ``query_host``.  Capacity 2 forces
    overflow on the larger trees."""
    overflowed = 0
    for name, forest, ref, tids, rects in _wavefront_cases():
        hit, over = query_wavefront(forest, tids, rects, capacity=capacity,
                                    device="cpu")
        rhit, rover = R.query_jax_wavefront(ref, tids, rects,
                                            capacity=capacity)
        assert hit.dtype == over.dtype == bool
        assert np.array_equal(over, np.asarray(rover)), name
        assert np.array_equal(hit, np.asarray(rhit)), name
        host = query_host(forest, tids, rects)
        assert np.array_equal(hit[~over], host[~over]), name
        assert not hit[tids < 0].any() and not over[tids < 0].any()
        overflowed += int(over.sum())
    assert (overflowed > 0) == (capacity == 2)


def test_planes_upload_once_and_adopt(monkeypatch):
    """A host-built forest's planes are transposed and uploaded once per
    device, however many batches and engines it serves; a device build's
    planes are adopted with no upload, and answer alike."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(layout, "UPLOAD_COUNTERS",
                        {"host_uploads": 0, "device_adoptions": 0})
    g = get_dataset("yelp", scale=0.05)
    us, rects = workload(g, 64, extent_ratio=0.05, seed=2)
    host = build_index(g, "2dreach-comp")
    tids = host.lookup_tree(us)
    builds = layout.SOA_BUILDS
    a = [L.range_query_forest(host.forest, tids[s:s + 16], rects[s:s + 16],
                              device="cpu") for s in range(0, 64, 16)]
    assert layout.UPLOAD_COUNTERS == {"host_uploads": 1,
                                      "device_adoptions": 0}
    assert layout.SOA_BUILDS - builds <= 1
    # the serving engine over the same forest shares that one copy
    eng = QueryEngine(host, device="cpu")
    assert eng._arena.entries is layout.forest_planes(host.forest, cpu)[0]
    assert layout.UPLOAD_COUNTERS == {"host_uploads": 1,
                                      "device_adoptions": 0}
    dev = build_index(g, "2dreach-comp", backend="device", device="cpu")
    b = L.range_query_forest(dev.forest, tids, rects, device="cpu")
    assert layout.UPLOAD_COUNTERS == {"host_uploads": 1,
                                      "device_adoptions": 1}
    assert layout.forest_planes(dev.forest, cpu)[0] \
        is dev.forest.device.entries
    assert QueryEngine(dev, device="cpu")._arena.entries \
        is dev.forest.device.entries
    assert layout.UPLOAD_COUNTERS == {"host_uploads": 1,
                                      "device_adoptions": 1}
    assert np.array_equal(np.concatenate(a), b)
    assert np.array_equal(b, query_host(host.forest, tids, rects))


def test_engines_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    forest, _, tids, rects = _sweep_case(2, *SWEEP[1])
    for call in (lambda: L.range_query_forest(forest, tids, rects),
                 lambda: query_wavefront(forest, tids, rects),
                 lambda: forest.device_arrays(),
                 lambda: L.range_query(*[None] * 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
