"""Real SO(3) representation machinery for eSCN-style equivariant
models (the port of ``repro.models.gnn.so3``).

``wigner_d_stack`` computes the real Wigner rotation matrices D^l(R) for
l = 0..l_max from batched 3x3 rotation matrices via the
Ivanic-Ruedenberg recursion (J. Phys. Chem. 1996 + errata), with the
reference's convention: real spherical harmonics ordered m = -l..l with
the l=1 basis ordered (y, z, x), so that

    Y_l(R n) = D^l(R) Y_l(n).

The reference unrolls the recursion entry by entry; here each row m of
D^l is one vector operation over the columns m', with the same terms in
the same order and the coefficients u, v, w of the row as a vector
(NumPy, float64, cast to the rotations' dtype as the reference's scalar
products cast them).

``rot_to_z`` builds the rotation aligning an edge direction with +z; in
that frame the edge's own SH embedding collapses onto m=0, which is what
makes the eSCN SO(2) convolution O(L^3) instead of O(L^6).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch


def rot_to_z(d: torch.Tensor) -> torch.Tensor:
    """(E, 3) unit vectors -> (E, 3, 3) rotations R with R d = +z."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    alpha = torch.atan2(y, x)
    beta = torch.atan2(torch.sqrt(x * x + y * y), z)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    # R = Ry(-beta) @ Rz(-alpha)
    rz = torch.stack([
        torch.stack([ca, sa, zero], -1),
        torch.stack([-sa, ca, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    ry = torch.stack([
        torch.stack([cb, zero, -sb], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([sb, zero, cb], -1),
    ], -2)
    return ry @ rz


def _r1_from_rot(rot: torch.Tensor) -> torch.Tensor:
    """Cartesian (x,y,z) rotation -> l=1 real-SH basis (y,z,x)
    rotation."""
    P = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]],
                     dtype=rot.dtype, device=rot.device)
    return P @ rot @ P.T


@functools.lru_cache(maxsize=None)
def _coefficients(l: int):
    """(u, v, w) of level ``l``: float64 (2l+1, 2l+1) arrays over (m,
    m'), the reference's static coefficients."""
    u = np.zeros((2 * l + 1, 2 * l + 1))
    v, w = np.zeros_like(u), np.zeros_like(u)
    for m in range(-l, l + 1):
        for mp in range(-l, l + 1):
            denom = (l + mp) * (l - mp) if abs(mp) < l else \
                (2 * l) * (2 * l - 1)
            d_m0 = 1.0 if m == 0 else 0.0
            u[m + l, mp + l] = np.sqrt((l + m) * (l - m) / denom)
            v[m + l, mp + l] = 0.5 * np.sqrt(
                (1.0 + d_m0) * (l + abs(m) - 1) * (l + abs(m)) / denom) \
                * (1.0 - 2.0 * d_m0)
            w[m + l, mp + l] = -0.5 * np.sqrt(
                (l - abs(m) - 1) * (l - abs(m)) / denom) * (1.0 - d_m0)
    return u, v, w


def _pfn(r1: torch.Tensor, prev: torch.Tensor, i: int) -> torch.Tensor:
    """P_i(mu, m') of the recursion for mu in -(l-1)..l-1 (rows) and m'
    in -l..l (columns): (..., 2l-1, 2l+1)."""
    a = r1[..., i + 1, 2, None]             # R1(i, 1)
    b = r1[..., i + 1, 0, None]             # R1(i, -1)
    c = r1[..., i + 1, 1, None, None]       # R1(i, 0)
    lo, hi = prev[..., :, 0], prev[..., :, -1]   # Rp(mu, -(l-1)), (mu, l-1)
    left = a * lo + b * hi                  # m' = -l
    right = a * hi - b * lo                 # m' = l
    return torch.cat([left[..., None], c * prev, right[..., None]], -1)


def wigner_d_stack(rot: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """(..., 3, 3) rotations -> [D^0 (...,1,1), D^1 (...,3,3), ...]."""
    batch = tuple(rot.shape[:-2])
    out = [torch.ones(batch + (1, 1), dtype=rot.dtype, device=rot.device)]
    if l_max == 0:
        return out
    r1 = _r1_from_rot(rot)
    out.append(r1)
    prev = r1
    for l in range(2, l_max + 1):
        uvw = [torch.as_tensor(c, dtype=rot.dtype, device=rot.device)
               for c in _coefficients(l)]
        P = {i: _pfn(r1, prev, i) for i in (-1, 0, 1)}

        def Pr(i, mu):
            return P[i][..., mu + l - 1, :]

        rows = []
        for m in range(-l, l + 1):
            u, v, w = (c[m + l] for c in uvw)
            if m == 0:
                V = Pr(1, 1) + Pr(-1, -1)
            elif m > 0:
                V = Pr(1, m - 1) * np.sqrt(1.0 + (1.0 if m == 1 else 0.0)) \
                    - Pr(-1, -m + 1) * (0.0 if m == 1 else 1.0)
            else:
                V = Pr(1, m + 1) * (0.0 if m == -1 else 1.0) \
                    + Pr(-1, -m - 1) * np.sqrt(1.0 + (1.0 if m == -1 else 0.0))
            # u is 0 on the rows |m| = l, w on m = 0 and |m| >= l - 1:
            # those terms are left out, as the reference leaves them out
            term = u * Pr(0, m) + v * V if abs(m) < l else v * V
            if m > 0 and m < l - 1:
                term = term + w * (Pr(1, m + 1) + Pr(-1, -m - 1))
            elif m < 0 and -m < l - 1:
                term = term + w * (Pr(1, m - 1) - Pr(-1, -m + 1))
            rows.append(term)
        cur = torch.stack(rows, dim=-2)
        out.append(cur)
        prev = cur
    return out


# --------------------------------------------------------------------------
# real spherical harmonics (host/test oracle)
# --------------------------------------------------------------------------

def real_sph_harm_np(l_max: int, dirs: np.ndarray) -> List[np.ndarray]:
    """Orthonormal real SH evaluated at unit vectors (host oracle for the
    Wigner tests); returns [(N, 2l+1)] ordered m=-l..l."""
    try:
        from scipy.special import sph_harm_y  # (l, m, theta, phi)
    except ImportError:                        # SciPy before 1.15
        from scipy.special import sph_harm    # (m, l, azimuth, polar)

        def sph_harm_y(l, m, theta, phi):
            return sph_harm(m, l, phi, theta)

    dirs = np.asarray(dirs, dtype=np.float64)
    theta = np.arccos(np.clip(dirs[:, 2], -1, 1))       # polar
    phi = np.arctan2(dirs[:, 1], dirs[:, 0])            # azimuth
    out = []
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, abs(m), theta, phi)     # complex
            if m > 0:
                v = np.sqrt(2.0) * (-1.0) ** m * ylm.real
            elif m < 0:
                v = np.sqrt(2.0) * (-1.0) ** m * ylm.imag
            else:
                v = ylm.real
            cols.append(v)
        out.append(np.stack(cols, axis=1))
    return out
