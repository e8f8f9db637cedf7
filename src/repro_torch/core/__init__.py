"""Core library: the paper's contribution (2DReach) with its host and
device builds and the device query engine, and the baselines.

Public API:
    build_index(graph, method) / batch_query(index, us, rects, engine=)
    build_dynamic_index(graph, method, policy=, engine=)
    run_queries(index, program, engine=) / index_nbytes(index)
"""

from .api import (
    METHODS,
    batch_query,
    build_dynamic_index,
    build_index,
    index_nbytes,
    run_queries,
)
from .condensation import Condensation, condense
from .engine import QueryEngine, engine_for
from .georeach import GeoReachIndex, build_georeach
from .graph import CSR, GeosocialGraph, build_csr, dedup_edges, make_graph
from .interval_labels import IntervalLabels, build_interval_labels
from .oracle import (
    knn_reach_oracle,
    polygon_reach_oracle,
    range_collect_oracle,
    range_count_oracle,
    rangereach_oracle,
    rangereach_oracle_batch,
    reachable_mask,
)
from .polygon import (
    convex_halfplanes,
    points_in_convex_polygon,
    points_in_polygon_region,
    polygon_bbox,
    polygon_oracle,
    polygon_query,
)
from .reachability import (
    ClosureResult,
    closure_bitset_mm,
    closure_mbr_np,
    closure_np,
    closure_torch,
)
from .rtree import (
    DEFAULT_FANOUT,
    DeviceForest,
    RTreeForest,
    build_forest,
    build_forest_device,
    query_host,
    query_host_collect,
    query_host_collect_batch,
    query_host_count,
    query_host_knn,
    query_wavefront,
)
from .scc import compact_labels, scc_np
from .three_d_reach import ThreeDReachIndex, build_3dreach
from .two_d_reach import BitRank, TwoDReachIndex, build_2dreach

__all__ = [
    "METHODS", "batch_query", "build_dynamic_index", "build_index",
    "index_nbytes", "run_queries",
    "Condensation", "condense",
    "QueryEngine", "engine_for",
    "GeoReachIndex", "build_georeach",
    "CSR", "GeosocialGraph", "build_csr", "dedup_edges", "make_graph",
    "IntervalLabels", "build_interval_labels",
    "knn_reach_oracle", "polygon_reach_oracle",
    "range_collect_oracle", "range_count_oracle", "rangereach_oracle",
    "rangereach_oracle_batch", "reachable_mask",
    "convex_halfplanes", "points_in_convex_polygon",
    "points_in_polygon_region", "polygon_bbox",
    "polygon_oracle", "polygon_query",
    "ClosureResult", "closure_bitset_mm", "closure_mbr_np", "closure_np",
    "closure_torch",
    "DEFAULT_FANOUT", "DeviceForest", "RTreeForest", "build_forest",
    "build_forest_device", "query_host", "query_host_collect",
    "query_host_collect_batch", "query_host_count", "query_host_knn",
    "query_wavefront",
    "compact_labels", "scc_np",
    "ThreeDReachIndex", "build_3dreach",
    "BitRank", "TwoDReachIndex", "build_2dreach",
]
