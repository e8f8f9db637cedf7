"""Core library: the 2DReach host build and the device query engine.

Public API:
    build_index(graph, method) / batch_query(index, us, rects, engine=)
    run_queries(index, program, engine=)
"""

from .api import METHODS, batch_query, build_index, run_queries
from .condensation import Condensation, condense
from .engine import QueryEngine, engine_for
from .graph import CSR, GeosocialGraph, build_csr, dedup_edges, make_graph
from .oracle import (
    knn_reach_oracle,
    polygon_reach_oracle,
    range_collect_oracle,
    range_count_oracle,
    rangereach_oracle,
    rangereach_oracle_batch,
    reachable_mask,
)
from .reachability import ClosureResult, closure_np
from .rtree import (
    DEFAULT_FANOUT,
    RTreeForest,
    build_forest,
    query_host,
    query_host_collect_batch,
    query_host_count,
    query_host_knn,
)
from .scc import compact_labels, scc_np
from .two_d_reach import BitRank, TwoDReachIndex, build_2dreach

__all__ = [
    "METHODS", "batch_query", "build_index", "run_queries",
    "Condensation", "condense",
    "QueryEngine", "engine_for",
    "CSR", "GeosocialGraph", "build_csr", "dedup_edges", "make_graph",
    "knn_reach_oracle", "polygon_reach_oracle",
    "range_collect_oracle", "range_count_oracle", "rangereach_oracle",
    "rangereach_oracle_batch", "reachable_mask",
    "ClosureResult", "closure_np",
    "DEFAULT_FANOUT", "RTreeForest", "build_forest", "query_host",
    "query_host_collect_batch", "query_host_count", "query_host_knn",
    "compact_labels", "scc_np",
    "BitRank", "TwoDReachIndex", "build_2dreach",
]
