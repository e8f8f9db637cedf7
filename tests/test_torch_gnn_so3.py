"""The port's SO(3) machinery (``repro_torch.models.gnn.so3``) and
EquiformerV2 (``repro_torch.models.gnn.equiformer_v2``) against the JAX
package's, on the CPU.

The reference's own Wigner tests run on the port (D^l rotates real
spherical harmonics at l_max 1, 3 and 6; homomorphism and
orthogonality; ``rot_to_z``), and the port's D stack is held to the
reference's at l_max 6 within 2e-7 (measured: equal to the reference's
eager stack bit for bit; its jitted stack, where XLA may contract
products into FMAs, within 1.9e-7).  EquiformerV2 at its published
widths (l_max 6, 12 layers) on a 14-node, 40-edge graph, forward only,
and reduced on the launcher's molecules (forward, loss, gradients),
with the tolerances of ``test_torch_gnn.py`` (measured: the published
energy, -19.35, 1.5e-5 from the reference's; reduced energies 1.4e-6,
gradients 1.4e-6 of the bound's scale); its energy invariant under
rotations within the reference's bound, 1e-3 relative.

Each reference output is computed once per module (``_ref_*``,
cached): the published model's init and apply take about 16 s here.
"""

import functools

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
from repro.models.gnn import equiformer_v2 as REQ
from repro.models.gnn import so3 as RSO3
from repro_torch import configs as C
from repro_torch.convert import gnn_params_from_jax
from repro_torch.models.gnn import common as G
from repro_torch.models.gnn import equiformer_v2 as EQ
from repro_torch.models.gnn.so3 import (
    real_sph_harm_np,
    rot_to_z,
    wigner_d_stack,
)
from repro_torch.train.optim import tree_leaves

from test_torch_gnn import (
    GRAD_TOL,
    TOL,
    _jnp,
    _np_tree,
    _t,
    graph_case,
    molecules,
)

ARCH = "equiformer-v2"
D_TOL = 2e-7


def _rand_rot(rng):
    A = rng.standard_normal((3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _D(rot, l_max):
    return wigner_d_stack(torch.tensor(np.array(rot), dtype=torch.float32),
                          l_max)


# --------------------------------------------------------------------------
# the reference's SO(3) tests, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("l_max", [1, 3, 6])
def test_wigner_rotates_sph_harm(l_max):
    rng = np.random.default_rng(0)
    Q = _rand_rot(rng)
    n = rng.standard_normal((30, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    D = _D(np.broadcast_to(Q, (30, 3, 3)), l_max)
    Y = real_sph_harm_np(l_max, n)
    Yr = real_sph_harm_np(l_max, n @ Q.T)
    for l in range(l_max + 1):
        got = np.einsum("eab,eb->ea", D[l].numpy(), Y[l])
        np.testing.assert_allclose(got, Yr[l], atol=1e-5)


def test_wigner_homomorphism_and_orthogonality():
    rng = np.random.default_rng(1)
    A, B = _rand_rot(rng), _rand_rot(rng)
    L = 4
    DA, DB, DAB = _D(A[None], L), _D(B[None], L), _D((A @ B)[None], L)
    for l in range(L + 1):
        np.testing.assert_allclose((DA[l][0] @ DB[l][0]).numpy(),
                                   DAB[l][0].numpy(), atol=1e-5)
        np.testing.assert_allclose((DA[l][0] @ DA[l][0].T).numpy(),
                                   np.eye(2 * l + 1), atol=1e-5)


def test_rot_to_z():
    rng = np.random.default_rng(2)
    d = rng.standard_normal((50, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    R = rot_to_z(torch.as_tensor(d, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(
        np.einsum("eij,ej->ei", R, d), np.broadcast_to([0, 0, 1], (50, 3)),
        atol=1e-5)
    want = np.asarray(RSO3.rot_to_z(jnp.asarray(d, jnp.float32)))
    np.testing.assert_allclose(R, want, atol=1e-7)
    # a zero direction (a padding self-loop) gives the identity
    np.testing.assert_array_equal(
        rot_to_z(torch.zeros(1, 3))[0].numpy(), np.eye(3))


@pytest.mark.parametrize("l_max", [0, 2, 6])
def test_wigner_stack_matches_reference(l_max):
    """The port's D stack against the reference's, eager and jitted, on
    50 random rotations (and a batch of (5, 10) rotations)."""
    rng = np.random.default_rng(3)
    Q = np.stack([_rand_rot(rng) for _ in range(50)]).astype(np.float32)
    got = _D(Q, l_max)
    eager = RSO3.wigner_d_stack(jnp.asarray(Q), l_max)
    jitted = jax.jit(lambda q: RSO3.wigner_d_stack(q, l_max))(jnp.asarray(Q))
    assert len(got) == len(eager) == l_max + 1
    for g, e, j in zip(got, eager, jitted):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=D_TOL)
    got2 = _D(Q.reshape(5, 10, 3, 3), l_max)
    for g, g2 in zip(got, got2):
        assert g2.shape == (5, 10) + g.shape[1:]
        np.testing.assert_array_equal(g2.reshape(g.shape).numpy(),
                                      g.numpy())


def test_real_sph_harm_np_matches_reference():
    rng = np.random.default_rng(4)
    n = rng.standard_normal((40, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for a, b in zip(real_sph_harm_np(6, n), RSO3.real_sph_harm_np(6, n)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# EquiformerV2
# --------------------------------------------------------------------------

def _cfg(reduced, **kw):
    return (RCF.get_arch(ARCH).make_config(reduced=reduced, **kw),
            C.get_arch(ARCH).make_config(reduced=reduced, **kw))


@functools.lru_cache(maxsize=None)
def _ref_published():
    rcfg, _ = _cfg(False)
    p = REQ.init_params(jax.random.PRNGKey(0), rcfg)
    g = graph_case()
    return _np_tree(p), g, float(REQ.apply(p, _jnp(g), rcfg))


def test_published_widths_forward_matches_reference():
    """l_max 6, m_max 2, 12 layers of 128 channels and 8 heads on a
    14-node, 40-edge graph with masked edges and a masked node."""
    p, g, want = _ref_published()
    _, cfg = _cfg(False)
    with torch.no_grad():
        got = float(EQ.apply(gnn_params_from_jax(p, "cpu"), _t(g), cfg))
    assert got == pytest.approx(want, rel=TOL["rtol"], abs=TOL["atol"])


def test_published_widths_invariance():
    """At the published widths the energy is invariant under three
    random rotations within the reference's bound (1e-3 relative)."""
    p, g, _ = _ref_published()
    _, cfg = _cfg(False)
    params = gnn_params_from_jax(p, "cpu")
    tg = _t(g)
    with torch.no_grad():
        e0 = float(EQ.apply(params, tg, cfg))
        for seed in range(3):
            Q = torch.as_tensor(_rand_rot(np.random.default_rng(10 + seed)),
                                dtype=torch.float32)
            e1 = float(EQ.apply(params, dict(tg, pos=tg["pos"] @ Q.T), cfg))
            assert abs(e0 - e1) < 1e-3 * max(1.0, abs(e0)), (e0, e1)


def test_equiformer_invariance():
    """The reference's ``test_equiformer_invariance`` on the port."""
    rng = np.random.default_rng(3)
    N, E = 14, 40
    pos = torch.as_tensor(rng.standard_normal((N, 3)), dtype=torch.float32)
    src = rng.integers(0, N, E)
    dst = (src + 1 + rng.integers(0, N - 1, E)) % N
    base = dict(pos=pos, edge_src=torch.as_tensor(src, dtype=torch.int32),
                edge_dst=torch.as_tensor(dst, dtype=torch.int32),
                species=torch.as_tensor(rng.integers(0, 5, N),
                                        dtype=torch.int32))
    cfg = EQ.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2,
                                n_heads=4, n_rbf=8)
    p = EQ.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with torch.no_grad():
        e0 = float(EQ.apply(p, base, cfg))
        for seed in range(3):
            Q = torch.as_tensor(_rand_rot(np.random.default_rng(10 + seed)),
                                dtype=torch.float32)
            e1 = float(EQ.apply(p, dict(base, pos=pos @ Q.T), cfg))
            assert abs(e0 - e1) < 1e-3 * max(1.0, abs(e0)), (e0, e1)


@functools.lru_cache(maxsize=None)
def _ref_reduced():
    rcfg, _ = _cfg(True)
    p = REQ.init_params(jax.random.PRNGKey(0), rcfg)
    b = molecules()
    b = {k: v for k, v in b.items()
         if k not in ("id_kj", "id_ji", "triplet_mask")}
    out = jax.jit(jax.vmap(lambda x: REQ.apply(p, x, rcfg)))(_jnp(b))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bb: REQ.loss_fn(p, bb, rcfg)))(p, _jnp(b))
    return (_np_tree(p), b, np.asarray(out), float(loss),
            [np.asarray(x) for x in jax.tree.leaves(grads)])


def test_reduced_forward_loss_grads_match_reference():
    """The reduced config on 8 molecules of 12 atoms: per-molecule
    energies (flattened into one graph against the reference's
    ``vmap``), the loss and every gradient (the attention's last bias
    has a gradient that is zero in exact arithmetic: both give rounding
    noise below 1e-6 there)."""
    p, b, want, rloss, rgrads = _ref_reduced()
    _, cfg = _cfg(True)
    params = gnn_params_from_jax(p, "cpu")
    tb = _t(b)
    with torch.no_grad():
        got = EQ.apply(params, G.flatten_molecules(tb), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    xs = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = EQ.loss_fn(params, tb, cfg)
    grads = torch.autograd.grad(loss, xs)
    assert float(loss.detach()) == pytest.approx(rloss, rel=TOL["rtol"],
                                                 abs=TOL["atol"])
    assert len(grads) == len(rgrads)
    for g, r in zip(grads, rgrads):
        bound = GRAD_TOL * max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g.numpy() - r).max()) <= bound


@pytest.mark.parametrize("part", ["equiv_norm", "rotate", "rotate_t",
                                  "so2_conv"])
def test_equiformer_parts_match_reference(part):
    """The layer's parts on random inputs at the published widths'
    l_max 6 and m_max 2 (32 channels): the RMS norm per l block, the
    rotation into the edge frame and back, and the SO(2) convolution
    (its out-of-place writes: every m > m_max row zero)."""
    rng = np.random.default_rng(5)
    rcfg, cfg = _cfg(False)
    rcfg = type(rcfg)(**{**rcfg.__dict__, "d_hidden": 32})
    cfg = type(cfg)(**{**cfg.__dict__, "d_hidden": 32})
    E, K, L = 20, cfg.n_coef, cfg.l_max
    x = rng.standard_normal((E, K, 32)).astype(np.float32)
    Q = np.stack([_rand_rot(rng) for _ in range(E)]).astype(np.float32)
    if part == "equiv_norm":
        want = REQ._equiv_norm(jnp.asarray(x), L)
        got = EQ._equiv_norm(torch.as_tensor(x), L)
    elif part.startswith("rotate"):
        tr = part == "rotate_t"
        want = REQ._rotate(jnp.asarray(x), RSO3.wigner_d_stack(
            jnp.asarray(Q), L), L, transpose=tr)
        got = EQ._rotate(torch.as_tensor(x), _D(Q, L), L, transpose=tr)
    else:
        rp = REQ.init_params(jax.random.PRNGKey(1), type(rcfg)(
            **{**rcfg.__dict__, "n_layers": 1}))["layer0"]
        want = REQ._so2_conv(rp, jnp.asarray(x), rcfg)
        got = EQ._so2_conv(gnn_params_from_jax(
            {"out": {}, "layer0": _np_tree(rp), "embed": {}},
            "cpu")["layer0"], torch.as_tensor(x), cfg)
        keep = np.zeros(K, bool)
        for s, l in EQ._l_slices(L):
            keep[s + l - min(l, cfg.m_max): s + l + min(l, cfg.m_max) + 1] = 1
        assert (got.numpy()[:, ~keep] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
