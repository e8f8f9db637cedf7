"""Core library: the 2DReach host build and the device query engine.

Public API:
    build_index(graph, method) / batch_query(index, us, rects, engine=)
"""

from .api import METHODS, batch_query, build_index
from .condensation import Condensation, condense
from .engine import QueryEngine, engine_for
from .graph import CSR, GeosocialGraph, build_csr, dedup_edges, make_graph
from .oracle import (
    range_collect_oracle,
    range_count_oracle,
    rangereach_oracle,
    rangereach_oracle_batch,
    reachable_mask,
)
from .reachability import ClosureResult, closure_np
from .rtree import DEFAULT_FANOUT, RTreeForest, build_forest, query_host
from .scc import compact_labels, scc_np
from .two_d_reach import BitRank, TwoDReachIndex, build_2dreach

__all__ = [
    "METHODS", "batch_query", "build_index",
    "Condensation", "condense",
    "QueryEngine", "engine_for",
    "CSR", "GeosocialGraph", "build_csr", "dedup_edges", "make_graph",
    "range_collect_oracle", "range_count_oracle", "rangereach_oracle",
    "rangereach_oracle_batch", "reachable_mask",
    "ClosureResult", "closure_np",
    "DEFAULT_FANOUT", "RTreeForest", "build_forest", "query_host",
    "compact_labels", "scc_np",
    "BitRank", "TwoDReachIndex", "build_2dreach",
]
