"""Data: synthetic LBSN graphs shaped to the paper's datasets, the
RangeReach query (uniform and Zipf-skewed) and update workloads, the LM,
recsys and molecule input pipelines (copies of ``repro.data``'s
generators), and the GraphSAGE-style neighbour sampler."""

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
    ZIPF_DEFAULT_S,
    apply_stream_op,
    knn_workload,
    polygon_workload,
    region_for_extent,
    streaming_workload,
    workload,
    zipf_workload,
)
from .pipeline import ShardInfo, din_batches, lm_batches, molecule_batches
from .registry import dataset_names, get_dataset
from .sampler import SampledBlock, pad_block, sample_blocks

__all__ = [
    "SPECS", "LBSNSpec", "dataset_stats", "generate_lbsn",
    "DEGREE_BUCKETS", "DEGREE_DEFAULT", "KNN_DEFAULT_K",
    "POLYGON_EDGE_VALUES", "POLYGON_EDGES_DEFAULT", "REGION_EXTENT_DEFAULT",
    "REGION_EXTENT_VALUES", "SELECTIVITY_VALUES", "STREAM_OP_KINDS", "ZIPF_DEFAULT_S",
    "apply_stream_op", "knn_workload", "polygon_workload",
    "region_for_extent", "streaming_workload", "workload", "zipf_workload",
    "ShardInfo", "din_batches", "lm_batches", "molecule_batches",
    "dataset_names", "get_dataset",
    "SampledBlock", "pad_block", "sample_blocks",
]
