"""The port's device SCC (``repro_torch.core.scc.scc_torch``) against the
JAX package's ``scc_jax`` and ``scc_np``, on the CPU.

The trim + colouring algorithm is deterministic: a vertex's label is the
largest vertex id of its SCC, and a trimmed vertex keeps its own id.  So
``scc_torch`` is held to ``scc_jax`` with ``np.array_equal``, bit for
bit, not only to the same partition; on a graph too large for the
reference's jit it is held to ``scc_np``'s partition labelled by each
component's largest id.  ``same_partition`` is the reference's, copied.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch
from conftest import given, st

import repro.core.scc as RS
from repro_torch.core import same_partition, scc_np, scc_torch
from repro_torch.data import get_dataset


def _largest_ids(comp):
    """``comp``'s partition, each vertex labelled by its component's
    largest vertex id."""
    top = np.full(int(comp.max()) + 1, -1, np.int64)
    np.maximum.at(top, comp, np.arange(len(comp)))
    return top[comp].astype(np.int32)


@given(st.integers(0, 10_000))
def test_scc_torch_matches_scc_jax(seed):
    """The reference's own hypothesis case (``test_core_scc``), held bit
    for bit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    m = int(rng.integers(0, 4 * n))
    edges = rng.integers(0, n, size=(m, 2))
    got = scc_torch(n, edges, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, RS.scc_jax(n, edges))
    assert same_partition(got, scc_np(n, edges))


@pytest.mark.parametrize("case", ["cycle", "empty", "self_loops", "chain",
                                  "two_cycles"])
def test_scc_torch_small_cases(case):
    n, edges = {
        "cycle": (4, [[0, 1], [1, 2], [2, 0], [2, 3]]),
        "empty": (5, np.zeros((0, 2), np.int64)),
        "self_loops": (4, [[0, 0], [1, 1], [1, 2], [2, 1], [3, 3]]),
        "chain": (6, [[i, i + 1] for i in range(5)]),
        "two_cycles": (7, [[0, 1], [1, 0], [1, 2], [2, 3], [3, 4],
                           [4, 2], [5, 6]]),
    }[case]
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    got = scc_torch(n, edges, device="cpu")
    assert np.array_equal(got, RS.scc_jax(n, edges))
    assert np.array_equal(got, _largest_ids(scc_np(n, edges)))
    if case == "cycle":
        assert got[0] == got[1] == got[2] == 2 != got[3]


def test_scc_torch_on_yelp():
    """yelp x0.05 against the reference bit for bit, with the sweep and
    round counts; yelp x0.25 against ``scc_np``'s largest ids."""
    g = get_dataset("yelp", scale=0.05)
    counts = {}
    got = scc_torch(g.n_nodes, g.edges, device="cpu", counts=counts)
    assert np.array_equal(got, RS.scc_jax(g.n_nodes, g.edges))
    assert set(counts) == {"trim_sweeps", "propagate_sweeps",
                           "mark_sweeps", "rounds"}
    assert counts["rounds"] >= 1 and counts["trim_sweeps"] >= 2
    assert counts["propagate_sweeps"] >= counts["rounds"]
    g = get_dataset("yelp", scale=0.25)
    assert np.array_equal(scc_torch(g.n_nodes, g.edges, device="cpu"),
                          _largest_ids(scc_np(g.n_nodes, g.edges)))


def test_scc_torch_counts_empty_graph():
    counts = {}
    got = scc_torch(3, np.zeros((0, 2)), device="cpu", counts=counts)
    assert np.array_equal(got, np.arange(3))
    assert counts == {"trim_sweeps": 0, "propagate_sweeps": 0,
                      "mark_sweeps": 0, "rounds": 0}


@pytest.mark.parametrize("seed", range(6))
def test_same_partition_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    a = rng.integers(0, max(n // 3, 1), n)
    perm = rng.permutation(int(a.max()) + 1) * 7 + 3   # renamed labels
    pairs = [(a, perm[a]), (a, rng.integers(0, max(n // 3, 1), n)),
             (a, a[::-1].copy()), (a, a[:-1]), (a, np.zeros(n, int))]
    for x, y in pairs:
        assert same_partition(x, y) == RS.same_partition(x, y)
    assert same_partition(a, perm[a])


def test_scc_torch_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scc_torch(3, np.array([[0, 1], [1, 0]]))
