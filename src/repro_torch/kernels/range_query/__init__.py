"""RangeReach serving kernels: the arena layout, the fused serve, the
two-phase descent, the analytics scans and the leaf-scan engine."""

from .leafscan import (
    range_query,
    range_query_forest,
    range_query_torch,
    rects_to_soa,
)

__all__ = ["range_query", "range_query_forest", "range_query_torch",
           "rects_to_soa"]
