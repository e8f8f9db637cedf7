"""Data: synthetic LBSN graphs shaped to the paper's datasets and the
RangeReach query workloads (copies of ``repro.data``'s generators)."""

from .lbsn import SPECS, LBSNSpec, dataset_stats, generate_lbsn
from .queries import (
    DEGREE_BUCKETS,
    DEGREE_DEFAULT,
    REGION_EXTENT_DEFAULT,
    REGION_EXTENT_VALUES,
    SELECTIVITY_VALUES,
    region_for_extent,
    workload,
)
from .registry import dataset_names, get_dataset

__all__ = [
    "SPECS", "LBSNSpec", "dataset_stats", "generate_lbsn",
    "DEGREE_BUCKETS", "DEGREE_DEFAULT", "REGION_EXTENT_DEFAULT",
    "REGION_EXTENT_VALUES", "SELECTIVITY_VALUES", "region_for_extent",
    "workload",
    "dataset_names", "get_dataset",
]
