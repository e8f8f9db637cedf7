"""Fused EmbeddingBag: gather plus weighted segment sum (K10)."""

from .ops import (
    TL,
    copy_bytes,
    embedding_bag,
    pack_bags,
    segment_bag,
    segment_bag_torch,
    sum_error_bound,
    warp_segments,
)

__all__ = ["TL", "copy_bytes", "embedding_bag", "pack_bags", "segment_bag",
           "segment_bag_torch", "sum_error_bound", "warp_segments"]
