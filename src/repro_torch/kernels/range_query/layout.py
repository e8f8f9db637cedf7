"""Data layout of the serving arena: tile constants, the SoA entry
planes and the leaf-tile MBR pyramid (host NumPy, once per upload), the
one device copy of a forest's planes that every engine shares, and the
thread block cluster size of the kernels that run a cluster per query
tile.

Copies of ``repro.kernels.range_query``'s layout pieces.  The tile
grain stays the reference's: ``TB = 8`` queries per query tile and
``TP = 128`` arena entries per leaf tile; the pyramid is built and
quantized at that grain, so candidate counts per query tile agree with
the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...device import same_device

TB = 8            # queries per query tile
TP = 128          # arena entries per leaf tile
TPT = 128         # the fine plane is padded to a multiple of TPT tiles
COARSE_GROUP = 8  # leaf tiles per coarse pyramid node

MAX_CLUSTER = 8   # CTAs per thread block cluster of K1, K3, K4 and K6

# payload-id sentinel for collect padding/misses: sorts after every real
# vertex id and survives the int32 round trip
ID_SENTINEL = np.int32(np.iinfo(np.int32).max)

# host-side forest transpositions since import: steady-state serving
# leaves it flat (``forest_soa`` memoises one per forest)
SOA_BUILDS = 0

# forest entry planes put on a device by ``forest_planes`` since import:
# ``host_uploads`` from the host transposition, ``device_adoptions`` from
# a ``build_forest_device`` handoff without a copy
UPLOAD_COUNTERS = {"host_uploads": 0, "device_adoptions": 0}


def cluster_size(n_query_tiles: int, n_sms: int) -> int:
    """Blocks per query tile in K1's thread block cluster: the least of
    1, 2, 4, 8 whose clusters cover the ``n_sms`` multiprocessors (8 at
    most), so a small batch still fills the card and a large one keeps
    one block per query tile."""
    c = 1
    while c < MAX_CLUSTER and n_query_tiles * c < n_sms:
        c *= 2
    return c


def forest_to_soa(forest) -> Tuple[np.ndarray, np.ndarray]:
    """(2*dim, P_padded) SoA entry planes + (T+1,) int32 offsets.

    Padding entries are impossible boxes (min > max) so they never hit.
    """
    global SOA_BUILDS
    SOA_BUILDS += 1
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


def forest_planes(forest, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forest's SoA entry planes ``(2*dim, Pp)`` float32 and offsets
    ``(T+1,)`` int32 on ``device``, memoised per device on the
    (immutable) forest, so every engine that serves it shares one copy:
    adopted from its ``build_forest_device`` handoff where that lies on
    ``device``, else uploaded once from the cached host transposition.
    A memo stays valid while the handoff it came from (or its absence)
    does."""
    dforest = getattr(forest, "device", None)
    src = (dforest if dforest is not None
           and same_device(dforest.entries.device, device) else None)
    memo = getattr(forest, "_planes", None) or []
    for dev, s, planes in memo:
        if same_device(dev, device) and s is src:
            return planes
    if src is not None:
        UPLOAD_COUNTERS["device_adoptions"] += 1
        planes = (src.entries, src.entry_off)
    else:
        UPLOAD_COUNTERS["host_uploads"] += 1
        esoa, off = forest_soa(forest)
        planes = (torch.as_tensor(esoa, device=device),
                  torch.as_tensor(off, device=device))
    forest._planes = [m for m in memo if not same_device(m[0], device)] \
        + [(device, src, planes)]
    return planes


def slice_tile_span(qs: int, qe: int, limit: int) -> Tuple[int, int]:
    """The leaf tiles ``[lo, hi)`` whose entries ``[g*TP, g*TP + TP)``
    can overlap the arena slice ``[qs, qe)``, read off the prune's own
    test ``g*TP < qe and g*TP + TP > qs`` and clipped to ``[0, limit)``.
    A slice with ``qs == qe`` inside a tile still passes that test for
    the tile, and ``qs = qe = 0`` passes it for none."""
    lo = max(qs // TP, 0)
    hi = min(-(-qe // TP), limit) if qe > 0 else 0
    return lo, max(hi, lo)


def slice_tile_spans(qstart, qend, nt: int) -> list:
    """Per query tile of ``TB`` queries, the union of its queries'
    :func:`slice_tile_span` as disjoint ascending ``[lo, hi)`` intervals,
    overlapping and touching spans merged: an ``(n, 2)`` int64 array per
    query tile, ``n <= TB``.  Every leaf tile outside a query tile's
    intervals fails the slice test for all of its queries.  The plain
    rule that ``csrc/slice_span.cuh`` computes inside the prune kernels;
    nothing on the serving path calls it."""
    qs = np.asarray(qstart, np.int64).reshape(-1, TB)
    qe = np.asarray(qend, np.int64).reshape(-1, TB)
    out = []
    for row_s, row_e in zip(qs, qe):
        spans = sorted(slice_tile_span(int(a), int(b), nt)
                       for a, b in zip(row_s, row_e))
        merged = []
        for lo, hi in spans:
            if lo >= hi:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        out.append(np.asarray(merged, np.int64).reshape(-1, 2))
    return out


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
