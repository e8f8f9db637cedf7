"""Data: synthetic LBSN graphs shaped to the paper's datasets and the
RangeReach query workloads, and the recsys input pipeline (copies of
``repro.data``'s generators)."""

from .lbsn import SPECS, LBSNSpec, dataset_stats, generate_lbsn
from .queries import (
    DEGREE_BUCKETS,
    DEGREE_DEFAULT,
    POLYGON_EDGE_VALUES,
    POLYGON_EDGES_DEFAULT,
    REGION_EXTENT_DEFAULT,
    REGION_EXTENT_VALUES,
    SELECTIVITY_VALUES,
    polygon_workload,
    region_for_extent,
    workload,
)
from .pipeline import ShardInfo, din_batches
from .registry import dataset_names, get_dataset

__all__ = [
    "SPECS", "LBSNSpec", "dataset_stats", "generate_lbsn",
    "DEGREE_BUCKETS", "DEGREE_DEFAULT", "POLYGON_EDGE_VALUES",
    "POLYGON_EDGES_DEFAULT", "REGION_EXTENT_DEFAULT",
    "REGION_EXTENT_VALUES", "SELECTIVITY_VALUES", "polygon_workload",
    "region_for_extent", "workload",
    "ShardInfo", "din_batches",
    "dataset_names", "get_dataset",
]
