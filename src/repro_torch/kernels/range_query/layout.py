"""Data layout of the serving arena: tile constants, the SoA entry
planes and the leaf-tile MBR pyramid (host NumPy, once per upload).

Copies of ``repro.kernels.range_query``'s layout pieces.  The tile
grain stays the reference's: ``TB = 8`` queries per query tile and
``TP = 128`` arena entries per leaf tile; the pyramid is built and
quantized at that grain, so candidate counts per query tile agree with
the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

TB = 8            # queries per query tile
TP = 128          # arena entries per leaf tile
TPT = 128         # the fine plane is padded to a multiple of TPT tiles
COARSE_GROUP = 8  # leaf tiles per coarse pyramid node

# payload-id sentinel for collect padding/misses: sorts after every real
# vertex id and survives the int32 round trip
ID_SENTINEL = np.int32(np.iinfo(np.int32).max)


def forest_to_soa(forest) -> Tuple[np.ndarray, np.ndarray]:
    """(2*dim, P_padded) SoA entry planes + (T+1,) int32 offsets.

    Padding entries are impossible boxes (min > max) so they never hit.
    """
    dim = forest.dim
    P = len(forest.entries)
    Pp = max(TP, ((P + TP - 1) // TP) * TP)
    soa = np.empty((2 * dim, Pp), dtype=np.float32)
    soa[:dim, :] = 1.0
    soa[dim:, :] = 0.0
    if P:
        soa[:, :P] = forest.entries.T
    return soa, forest.entry_off.astype(np.int32)


def forest_soa(forest) -> Tuple[np.ndarray, np.ndarray]:
    """Cached ``forest_to_soa``, memoised on the (immutable) forest, so
    several engines over one index transpose it once."""
    cached = getattr(forest, "_soa_cache", None)
    if cached is None:
        cached = forest_to_soa(forest)
        forest._soa_cache = cached
    return cached


def build_tile_pyramid(
    entries_soa: np.ndarray, dim: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Aggregate SoA leaf entries into (fine, coarse) MBR planes.

    ``entries_soa`` is the (2*dim, Pp) plane layout of ``forest_to_soa``
    with Pp a multiple of TP; padding entries are impossible boxes
    (min > max) and only ever make tile MBRs *more* permissive along the
    axes they touch, so pruning stays conservative and the exact leaf
    test keeps the answer exact.

    Returns (fine_soa (2*dim, NTp), coarse_soa (2*dim, NCp), n_tiles)
    where n_tiles = Pp // TP is the true fine tile count, NTp rounds it
    up to TPT lanes and NCp = NTp // COARSE_GROUP.
    """
    two_dim, Pp = entries_soa.shape
    assert two_dim == 2 * dim and Pp % TP == 0
    nt = Pp // TP
    tiled = entries_soa.reshape(two_dim, nt, TP)
    fine = np.empty((two_dim, nt), dtype=np.float32)
    fine[:dim] = tiled[:dim].min(axis=2)
    fine[dim:] = tiled[dim:].max(axis=2)

    nc = -(-nt // COARSE_GROUP)
    pad_f = nc * COARSE_GROUP
    fpad = np.empty((two_dim, pad_f), dtype=np.float32)
    fpad[:dim] = np.inf
    fpad[dim:] = -np.inf
    fpad[:, :nt] = fine
    grouped = fpad.reshape(two_dim, nc, COARSE_GROUP)
    coarse = np.empty((two_dim, nc), dtype=np.float32)
    coarse[:dim] = grouped[:dim].min(axis=2)
    coarse[dim:] = grouped[dim:].max(axis=2)

    ntp = max(TPT, -(-nt // TPT) * TPT)
    ncp = ntp // COARSE_GROUP
    # padding tiles can never intersect: min=+inf / max=-inf (extent-proof,
    # unlike a finite sentinel)
    fine_soa = np.empty((two_dim, ntp), dtype=np.float32)
    fine_soa[:dim] = np.inf
    fine_soa[dim:] = -np.inf
    fine_soa[:, :nt] = fine
    coarse_soa = np.empty((two_dim, ncp), dtype=np.float32)
    coarse_soa[:dim] = np.inf
    coarse_soa[dim:] = -np.inf
    coarse_soa[:, :nc] = coarse
    return fine_soa, coarse_soa, nt
