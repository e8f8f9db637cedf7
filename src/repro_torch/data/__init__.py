"""Data: synthetic LBSN graphs shaped to the paper's datasets and the
RangeReach query and update workloads, and the recsys input pipeline (copies of
``repro.data``'s generators)."""

from .lbsn import SPECS, LBSNSpec, dataset_stats, generate_lbsn
from .queries import (
    DEGREE_BUCKETS,
    DEGREE_DEFAULT,
    KNN_DEFAULT_K,
    POLYGON_EDGE_VALUES,
    POLYGON_EDGES_DEFAULT,
    REGION_EXTENT_DEFAULT,
    REGION_EXTENT_VALUES,
    SELECTIVITY_VALUES,
    STREAM_OP_KINDS,
    apply_stream_op,
    knn_workload,
    polygon_workload,
    region_for_extent,
    streaming_workload,
    workload,
)
from .pipeline import ShardInfo, din_batches
from .registry import dataset_names, get_dataset

__all__ = [
    "SPECS", "LBSNSpec", "dataset_stats", "generate_lbsn",
    "DEGREE_BUCKETS", "DEGREE_DEFAULT", "KNN_DEFAULT_K",
    "POLYGON_EDGE_VALUES", "POLYGON_EDGES_DEFAULT", "REGION_EXTENT_DEFAULT",
    "REGION_EXTENT_VALUES", "SELECTIVITY_VALUES", "STREAM_OP_KINDS",
    "apply_stream_op", "knn_workload", "polygon_workload",
    "region_for_extent", "streaming_workload", "workload",
    "ShardInfo", "din_batches",
    "dataset_names", "get_dataset",
]
