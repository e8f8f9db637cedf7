"""The port's host build (``repro_torch``) against the JAX package's.

Same datasets, same workloads, and the same 2DReach index array for
array, for every variant; the port's host query path against the BFS
oracle.  Every comparison is exact.
"""

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference's rtree imports this name, which newer JAX moved
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

import repro.core as R
import repro.data as RD
from conftest import random_geosocial, random_queries
from repro_torch.convert import index_to_arrays
from repro_torch.core import (
    build_2dreach,
    build_index,
    make_graph,
    rangereach_oracle_batch,
)
from repro_torch.data import get_dataset, workload

VARIANTS = ("base", "comp", "pointer")


def _graphs(source):
    """(reference graph, port graph) for a named source."""
    if source.startswith("seed"):
        rg = random_geosocial(np.random.default_rng(int(source[4:])), 80, 220)
        return rg, make_graph(rg.n_nodes, rg.edges, rg.coords,
                              rg.spatial_mask)
    if source == "tiny":
        return RD.get_dataset("tiny"), get_dataset("tiny")
    return RD.get_dataset("yelp", scale=0.05), get_dataset("yelp", scale=0.05)


@pytest.mark.parametrize("source", ["tiny", "yelp"])
def test_datasets_match(source):
    rg, g = _graphs(source)
    assert g.n_nodes == rg.n_nodes
    for a, b in ((g.edges, rg.edges), (g.coords, rg.coords),
                 (g.spatial_mask, rg.spatial_mask)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_workload_matches():
    rg, g = _graphs("yelp")
    for seed in range(2):
        us, rects = workload(g, 300, extent_ratio=0.05, seed=seed)
        rus, rrects = RD.workload(rg, 300, extent_ratio=0.05, seed=seed)
        assert np.array_equal(us, rus) and np.array_equal(rects, rrects)
        assert rects.dtype == rrects.dtype == np.float32


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("source", ["seed0", "seed1", "seed2", "tiny",
                                    "yelp"])
def test_build_matches_reference(source, variant):
    rg, g = _graphs(source)
    ref = R.build_2dreach(rg, variant=variant)
    got = build_2dreach(g, variant=variant)
    a, b = index_to_arrays(got), index_to_arrays(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k
    for k in ("comp", "dag_edges", "level", "comp_sizes"):
        assert np.array_equal(getattr(got.cond, k), getattr(ref.cond, k)), k
    for k in ("n_comps", "user_comps", "distinct_rtrees", "shared_trees"):
        assert got.stats[k] == ref.stats[k], k


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_query_matches_oracle(variant):
    rg, g = _graphs("yelp")
    idx = build_index(g, {"base": "2dreach", "comp": "2dreach-comp",
                          "pointer": "2dreach-pointer"}[variant])
    us, rects = workload(g, 120, extent_ratio=0.05, seed=3)
    assert (idx.query_batch(us, rects)
            == rangereach_oracle_batch(g, us, rects)).all()
    for seed in range(3):
        rg, g = _graphs(f"seed{seed}")
        idx = build_2dreach(g, variant=variant)
        us, rects = random_queries(np.random.default_rng(seed), g, 60)
        want = rangereach_oracle_batch(g, us, rects)
        assert (idx.query_batch(us, rects) == want).all()
        assert (want == R.rangereach_oracle_batch(rg, us, rects)).all()


def test_unported_paths_raise():
    """The build contract: every method builds on the host; a device
    build of a baseline, an unknown backend and an unknown method
    raise a ValueError naming them."""
    g = get_dataset("tiny")
    with pytest.raises(ValueError, match="backend"):
        build_2dreach(g, variant="comp", backend="nope")
    for method in ("3dreach", "3dreach-rev", "georeach"):
        idx = build_index(g, method)
        assert idx.query(0, np.array([5.5, 1.5, 6.5, 2.5], np.float32))
        with pytest.raises(ValueError, match=method):
            build_index(g, method, backend="device")
    with pytest.raises(ValueError, match="nope"):
        build_index(g, "nope")
