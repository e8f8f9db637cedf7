"""Analytics query classes beyond boolean RangeReach: RangeCount,
RangeCollect, KNNReach and convex-polygon RangeReach, each with a host
path (NumPy descents) and a device path (``QueryEngine`` methods) that
answer exactly alike.  Entry point: ``core.api.run_queries(index,
program)`` with a :class:`QueryProgram`."""

from .host import (
    collect_csr_host,
    polygon_reach_host,
    range_collect_host,
    range_count_host,
)
from .knn import knn_radius_doubling, knn_reach_host, outward_rect
from .program import QUERY_KINDS, CollectResult, KNNResult, QueryProgram

__all__ = [
    "QUERY_KINDS", "CollectResult", "KNNResult", "QueryProgram",
    "collect_csr_host", "polygon_reach_host", "range_collect_host",
    "range_count_host",
    "knn_radius_doubling", "knn_reach_host", "outward_rect",
]
