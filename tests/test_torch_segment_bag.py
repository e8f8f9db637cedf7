"""The port's EmbeddingBag op (``repro_torch.kernels.segment_bag``, the
plain version of K10 on the CPU) against the JAX package's.

``pack_bags`` must give the reference's arrays exactly.  The pooled rows
are held against ``segment_bag_ref`` (through the reference's
``embedding_bag(use_ref=True)``) within 1e-5 absolute: both sum float32
products, possibly in another order.  Against a NumPy loop that adds
the float32 products in ascending lookup order they must be equal: the
plain version adds in that order on the CPU.  The interpreted Pallas
kernel is not a reference here: it fails on JAX 0.9 (ROADMAP R3).
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

from repro.kernels.segment_bag import ops as RO
from repro.kernels.segment_bag.ref import segment_bag_ref
from repro_torch.kernels import segment_bag as SB

# the reference's sweep (tests/test_kernels.py::test_segment_bag_sweep)
# plus DIN's width: D = 18, bags of up to seq_len = 100 lookups
SWEEP = [(10, 8, 1, 3), (100, 32, 17, 7), (64, 128, 9, 0), (257, 16, 40, 12),
         (1000, 18, 33, 100)]


def _bags(V, B, maxlen, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, maxlen + 1, size=B)
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    idx = rng.integers(0, V, size=int(lens.sum()))
    return rng, idx, offsets


def _loop(table, idx, offsets, mode):
    """float32 products added in ascending lookup order, per bag."""
    B, D = len(offsets) - 1, table.shape[1]
    want = np.zeros((B, D), np.float32)
    for b in range(B):
        for k in range(offsets[b], offsets[b + 1]):
            want[b] += np.float32(1.0) * table[idx[k]].astype(np.float32)
        if mode == "mean":
            want[b] /= np.float32(max(offsets[b + 1] - offsets[b], 1))
    return want


@pytest.mark.parametrize("lens", [[], [0], [3], [8], [2, 0, 5], [0, 0, 0],
                                  [9, 7, 0, 16]])
def test_pack_bags_matches_reference(lens):
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.random.default_rng(len(lens)).integers(0, 50, int(offsets[-1]))
    got, want = SB.pack_bags(idx, offsets), RO.pack_bags(idx, offsets)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) % SB.TL == 0 and len(got[0]) >= SB.TL


@pytest.mark.parametrize("V,D,B,maxlen", SWEEP)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(V, D, B, maxlen, mode):
    rng, idx, offsets = _bags(V, B, maxlen, V + D * 3 + B * 7 + maxlen)
    table = rng.standard_normal((V, D)).astype(np.float32)
    got = SB.embedding_bag(torch.as_tensor(table), idx, offsets, mode=mode,
                           device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_array_equal(got.numpy(), _loop(table, idx, offsets,
                                                     mode))
    ref = np.asarray(RO.embedding_bag(table, idx, offsets, mode=mode,
                                      use_ref=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("V,D,B,maxlen", SWEEP)
def test_segment_bag_matches_ref_on_packed_bags(V, D, B, maxlen):
    """The wrapper on CPU tensors is the plain version, equal to
    ``segment_bag_ref`` on the same packed operands with random
    weights (padding keeps weight 0)."""
    rng, idx, offsets = _bags(V, B, maxlen, 5 * V + D + B + maxlen)
    table = rng.standard_normal((V, D)).astype(np.float32)
    i, s, w = SB.pack_bags(idx, offsets)
    w[: len(idx)] = rng.uniform(0.5, 2.0, len(idx)).astype(np.float32)
    T = torch.as_tensor
    got = SB.segment_bag(T(table), T(i), T(s), T(w), n_segments=B,
                         device="cpu")
    plain = SB.segment_bag_torch(T(table), T(i), T(s), T(w), n_segments=B)
    assert torch.equal(got, plain)
    ref = np.asarray(segment_bag_ref(jnp.asarray(table), jnp.asarray(i),
                                     jnp.asarray(s), jnp.asarray(w),
                                     n_segments=B))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table_returns_float32_like_the_ref(mode):
    """A bf16 table gives float32 sums of the widened rows, as
    ``segment_bag_ref`` returns them (``bf16 * f32 -> f32``); the Pallas
    kernel would return bf16 (ROADMAP R7)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((32, 16)).astype(np.float32)
    offsets = np.array([0, 2, 5, 5, 8])
    idx = rng.integers(0, 32, size=8)
    tb = torch.as_tensor(table).to(torch.bfloat16)
    got = SB.embedding_bag(tb, idx, offsets, mode=mode, device="cpu")
    assert got.dtype == torch.float32
    ref = RO.embedding_bag(jnp.asarray(table, jnp.bfloat16), idx, offsets,
                           mode=mode, use_ref=True)
    assert ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    widened = tb.float().numpy()
    np.testing.assert_array_equal(got.numpy(),
                                  _loop(widened, idx, offsets, mode))


@pytest.mark.parametrize("B,lens", [(0, []), (3, [0, 0, 0]),
                                    (4, [5, 0, 0, 0])])
def test_empty_bags_and_padding(B, lens):
    """No lookups (one inert tile of padding), empty bags and an
    all-padding tail give zero rows; B = 0 gives (0, D)."""
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.arange(int(offsets[-1])) % 7
    table = torch.arange(7 * 18, dtype=torch.float32).reshape(7, 18)
    for mode in ("sum", "mean"):
        got = SB.embedding_bag(table, idx, offsets, mode=mode, device="cpu")
        assert got.shape == (B, 18)
        want = _loop(table.numpy(), idx, offsets, mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("indices,offsets,mode,match", [
    ([0, 1], [0, 2], "max", "mode"),
    ([0, 1], [1, 2], "sum", "offsets"),
    ([0, 1], [0, 1], "sum", "offsets"),
    ([0, 1], [0, 2, 1, 2], "sum", "offsets"),
])
def test_embedding_bag_rejects_bad_input(indices, offsets, mode, match):
    table = torch.zeros(7, 4)
    with pytest.raises(ValueError, match=match):
        SB.embedding_bag(table, np.array(indices), np.array(offsets),
                         mode=mode, device="cpu")


# an id outside [-V, V) makes its bag NaN, one in [-V, 0) wraps, as the
# reference's jnp.take (fill NaN) and segment_sum make them; the rows
# are the reference's answers (embedding_bag(use_ref=True)) on the table
# arange(28).reshape(7, 4)
BAD_IDS = [([0, 7], [[np.nan] * 4]),
           ([-1, 0], [[24.0, 26.0, 28.0, 30.0]]),
           ([0, -8], [[np.nan] * 4])]


@pytest.mark.parametrize("indices,want", BAD_IDS)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_out_of_range_ids_match_reference(indices, want,
                                                        mode):
    table = np.arange(28, dtype=np.float32).reshape(7, 4)
    offsets = np.array([0, 2])
    ref = np.asarray(RO.embedding_bag(jnp.asarray(table), np.array(indices),
                                      offsets, mode=mode, use_ref=True))
    div = 2.0 if mode == "mean" else 1.0
    np.testing.assert_array_equal(ref, np.asarray(want, np.float32) / div)
    got = SB.embedding_bag(torch.as_tensor(table), np.array(indices),
                           offsets, mode=mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bad", [7, -8, 1000, -(2 ** 31), 2 ** 31 - 1,
                                 2 ** 31, -(2 ** 31) - 1, 2 ** 40])
def test_embedding_bag_id_outside_the_table_or_int32(bad):
    """Only the bag holding the bad id is NaN, in float32 and bf16; an
    id that does not fit int32 is outside the table too (the reference's
    ``pack_bags`` would wrap it into range)."""
    table = torch.arange(28, dtype=torch.float32).reshape(7, 4)
    indices = np.array([1, 2, bad, 3, -7, 6], dtype=np.int64)
    offsets = np.array([0, 2, 4, 4, 6])
    for t in (table, table.bfloat16()):
        got = SB.embedding_bag(t, indices, offsets, device="cpu")
        assert got.dtype == torch.float32
        assert torch.isnan(got[1]).all()
        assert not torch.isnan(got[[0, 2, 3]]).any()
        np.testing.assert_array_equal(
            got[[0, 2, 3]].numpy(),
            [[12, 14, 16, 18], [0, 0, 0, 0], [24, 26, 28, 30]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_bag_bad_ids_match_ref_on_packed_operands(dtype):
    """The plain version against ``segment_bag_ref`` on packed operands
    holding ids at -1, -V, -V - 1, V and the int32 extremes, in bags of
    several lookups and a bag of one, with a bad id in the padding too:
    NaN where the reference has NaN, equal elsewhere."""
    rng = np.random.default_rng(21)
    V, D = 50, 18
    lens = [5, 1, 4, 1, 3, 0, 6, 1, 2]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    B = len(lens)
    idx = rng.integers(0, V, int(offsets[-1]))
    i32 = np.iinfo(np.int32)
    for at, bad in zip((1, 5, 7, 9, 10, 13, 15, 18),
                       (-1, -V, -V - 1, V, V + 3, i32.min, i32.max, -3)):
        idx[at] = bad
    i, s, w = SB.pack_bags(idx, offsets)
    w[: len(idx)] = rng.uniform(0.5, 2.0, len(idx)).astype(np.float32)
    i[-1] = V + 5                  # padding: its NaN row is dropped
    table = torch.as_tensor(rng.standard_normal((V, D)).astype(np.float32)
                            ).to(dtype)
    T = torch.as_tensor
    got = SB.segment_bag(table, T(i), T(s), T(w), n_segments=B,
                         device="cpu")
    ref = np.asarray(segment_bag_ref(
        jnp.asarray(table.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(i), jnp.asarray(s), jnp.asarray(w), n_segments=B))
    nan_bags = np.isnan(ref).all(1)
    assert nan_bags.tolist() == [False, False, True, True, True, False,
                                 True, False, False]
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    np.testing.assert_allclose(got.numpy()[~nan_bags], ref[~nan_bags],
                               rtol=0, atol=1e-5)


def test_no_gpu_raises(monkeypatch):
    """With no device given, the op asks for the GPU and raises where
    CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = torch.zeros(7, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        SB.embedding_bag(table, np.array([0]), np.array([0, 1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        SB.segment_bag(table, *[None] * 3, n_segments=1)


@pytest.mark.parametrize("n_segments,n_sms,want", [
    (0, 132, 1), (1, 132, 1), (37, 132, 1), (512, 132, 1),
    (135_168, 132, 1), (135_169, 132, 2), (262_144, 132, 2),
    (262_144, 66, 4), (2 ** 31 - 2, 132, 15_888)])
def test_warp_segments(n_segments, n_sms, want):
    """K10's segments a warp: 1 on small batches and serve_p99's 512
    bags (one warp each), 2 on serve_bulk's 262,144 on 132
    multiprocessors (WAVES waves of WARPS_PER_SM warps a
    multiprocessor), never 0."""
    got = SB.warp_segments(n_segments, n_sms)
    assert got == want
    warps = -(-max(n_segments, 1) // got)
    assert warps <= max(1, n_sms * SB.ops.WARPS_PER_SM * SB.ops.WAVES)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 1, 4), (torch.float32, 2, 8), (torch.float32, 17, 4),
    (torch.float32, 18, 8), (torch.float32, 32, 16), (torch.float32, 129, 4),
    (torch.bfloat16, 1, 2), (torch.bfloat16, 2, 4), (torch.bfloat16, 17, 2),
    (torch.bfloat16, 18, 4), (torch.bfloat16, 20, 8),
    (torch.bfloat16, 128, 16)])
def test_copy_bytes(dtype, D, want):
    """K10's copy width: the widest of 16, 8, 4 (2 for bf16) bytes that
    divides a row and the base; one element past the base leaves the
    element's own size (the narrowest instantiation)."""
    table = torch.zeros(5, D, dtype=dtype)
    assert table.data_ptr() % 16 == 0
    assert SB.copy_bytes(table) == want
    flat = torch.zeros(5 * D + 1, dtype=dtype)
    assert SB.copy_bytes(flat[1:].view(5, D)) == (
        4 if dtype == torch.float32 else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxlen", [1, 100, 5000])
def test_sum_error_bound_holds_for_another_order(maxlen, dtype):
    """``sum_error_bound`` (what K10 is held to against the card's
    atomic plain version) bounds the gap between the plain version's
    ascending float32 sums and the same products added in descending
    order, bag by bag; a bag of one lookup is exact, and a bag holding
    an id outside the table has a NaN bound, as its sums are NaN."""
    rng = np.random.default_rng(maxlen)
    B = 40
    lens = rng.integers(0, maxlen + 1, size=B)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    L = int(offsets[-1])
    i, s, w = SB.pack_bags(rng.integers(0, 500, L), offsets)
    w[:L] = rng.uniform(0.5, 2.0, L).astype(np.float32)
    table = torch.as_tensor(rng.standard_normal((500, 18)).astype(
        np.float32)).to(dtype)
    ops = (table, *(torch.as_tensor(a) for a in (i, s, w)))
    asc = SB.segment_bag_torch(*ops, n_segments=B)
    bound = SB.sum_error_bound(*ops, n_segments=B)
    rows = (table.float()[torch.as_tensor(i[:L]).long()]
            * torch.as_tensor(w[:L])[:, None]).numpy()
    for b in range(B):
        desc = np.zeros(18, np.float32)
        for k in range(offsets[b + 1] - 1, offsets[b] - 1, -1):
            desc = desc + rows[k]
        gap = np.abs(asc[b].numpy() - desc)
        assert (gap <= bound[b].numpy()).all(), (b, lens[b])
        if lens[b] <= 1:
            assert (gap == 0).all()
    i[0] = 500                                   # outside the table
    bad = SB.sum_error_bound(table, torch.as_tensor(i), *ops[2:],
                             n_segments=B)
    first = int(np.argmax(lens > 0))
    assert torch.isnan(bad[first]).all()
    assert not torch.isnan(bad[first + 1:]).any()
