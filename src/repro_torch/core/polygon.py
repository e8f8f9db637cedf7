"""Convex-polygon query regions — the paper's footnote 2 extension (a
copy of ``repro.core.polygon``).

A polygon is canonicalised once into its outward-rounded float32
bounding box plus CCW half-planes ``A*x + B*y <= C`` (coefficients
derived in float64, stored float32).  A point is inside the region iff
it passes the bbox test *and* every half-plane, all arithmetic and
comparisons in float32, each product and the sum rounded on its own —
the same operations the polygon leaf-scan kernel runs, so the host
path, the device path and the NumPy oracle agree bit for bit.

The R-tree descent runs with the bounding box (prefilter); candidates
are postfiltered by the half-planes, and the device engine pushes that
postfilter into the leaf scan itself.

    ans = polygon_query(index, u, vertices)      # (k, 2) convex hull
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .oracle import polygon_reach_oracle
from .two_d_reach import TwoDReachIndex


def _ccw(vertices: np.ndarray) -> np.ndarray:
    """Ensure counter-clockwise orientation."""
    v = np.asarray(vertices, dtype=np.float64).reshape(-1, 2)
    area2 = np.sum(
        v[:, 0] * np.roll(v[:, 1], -1) - np.roll(v[:, 0], -1) * v[:, 1]
    )
    return v if area2 >= 0 else v[::-1]


def points_in_convex_polygon(pts: np.ndarray, vertices: np.ndarray
                             ) -> np.ndarray:
    """(n, 2) points inside/on a convex polygon (any vertex order).

    Float64 cross-product form with a small tolerance — kept for callers
    that want the geometric test; the query path uses the canonical
    float32 half-plane form (``points_in_polygon_region``)."""
    v = _ccw(vertices)
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    inside = np.ones(len(pts), dtype=bool)
    for i in range(len(v)):
        a, b = v[i], v[(i + 1) % len(v)]
        cross = (b[0] - a[0]) * (pts[:, 1] - a[1]) \
            - (b[1] - a[1]) * (pts[:, 0] - a[0])
        inside &= cross >= -1e-9
    return inside


def round_bounds_outward(lo: np.ndarray, hi: np.ndarray):
    """Float64 lo/hi bound arrays -> float32 rounded *outward*: any
    bound the round-to-nearest downcast moved inward is nudged one ulp
    out (nextafter toward ±inf), so the f32 box always contains the f64
    box.  The shared primitive behind every conservative f32 region
    (polygon bboxes, the kNN loop's search boxes)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > lo,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def polygon_bbox(vertices: np.ndarray) -> np.ndarray:
    """Outward-rounded float32 bounding box [xmin, ymin, xmax, ymax].

    Min/max run in float64 *before* the float32 downcast and round
    outward, so a venue exactly on the hull edge stays inside the box
    the R-tree prefilter uses."""
    v = np.asarray(vertices, dtype=np.float64).reshape(-1, 2)
    lo32, hi32 = round_bounds_outward(v.min(axis=0), v.max(axis=0))
    return np.array([lo32[0], lo32[1], hi32[0], hi32[1]], dtype=np.float32)


def convex_halfplanes(vertices: np.ndarray,
                      pad_to: Optional[int] = None) -> np.ndarray:
    """(3, E) float32 half-planes of a convex polygon: row 0 = A, row 1
    = B, row 2 = C with inside ⟺ ``A*x + B*y <= C``.

    Coefficients are derived in float64 from the CCW edge normals
    (A = by - ay, B = ax - bx, C = A*ax + B*ay) and stored float32.
    ``pad_to`` appends inert half-planes (A = B = 0, C = +inf: 0*x + 0*y
    = 0 <= inf for any finite point) so batches bucket to a common edge
    count."""
    v = _ccw(vertices)
    E = len(v)
    if E < 3:
        raise ValueError(f"polygon needs >= 3 vertices, got {E}")
    nxt = np.roll(v, -1, axis=0)
    A = nxt[:, 1] - v[:, 1]
    B = v[:, 0] - nxt[:, 0]
    C = A * v[:, 0] + B * v[:, 1]
    hp = np.stack([A, B, C]).astype(np.float32)
    if pad_to is not None:
        if pad_to < E:
            raise ValueError(f"pad_to={pad_to} < {E} polygon edges")
        pad = np.zeros((3, pad_to - E), dtype=np.float32)
        pad[2] = np.inf
        hp = np.concatenate([hp, pad], axis=1)
    return hp


def points_in_polygon_region(pts: np.ndarray, bbox: np.ndarray,
                             halfplanes: np.ndarray) -> np.ndarray:
    """(n,) bool — the canonical float32 region test: inside the bbox
    AND on the inner side of every half-plane (float32 multiply,
    multiply, add, compare, each rounded on its own)."""
    pts = np.asarray(pts, dtype=np.float32).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    ok = (
        (x >= bbox[0]) & (x <= bbox[2]) & (y >= bbox[1]) & (y <= bbox[3])
    )
    hp = np.asarray(halfplanes, dtype=np.float32)
    for e in range(hp.shape[1]):
        ok = ok & ((hp[0, e] * x + hp[1, e] * y) <= hp[2, e])
    return ok


def polygon_query(index: TwoDReachIndex, u: int, vertices) -> bool:
    """RangeReach with a convex polygon region (Alg. 2 + exact filter):
    one query through the batched host path
    (:func:`repro_torch.queries.polygon_reach_host`)."""
    from ..queries import polygon_reach_host  # deferred: queries imports core

    return bool(polygon_reach_host(index, np.array([u]), [vertices])[0])


# BFS ground truth under the canonical region predicate; the reference
# exposes it under both names.
polygon_oracle = polygon_reach_oracle
