"""Outward rounding of float64 bounds to float32 (a copy of
``repro.core.polygon.round_bounds_outward``), which the kNN loop's
search boxes need.  The rest of the polygon module (bounding boxes,
half-planes, the region predicate) comes with slice 3 of the port."""

from __future__ import annotations

import numpy as np


def round_bounds_outward(lo: np.ndarray, hi: np.ndarray):
    """Float64 lo/hi bound arrays -> float32 rounded *outward*: any
    bound the round-to-nearest downcast moved inward is nudged one ulp
    out (nextafter toward ±inf), so the f32 box always contains the f64
    box."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > lo,
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi,
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32
