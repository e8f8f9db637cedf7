"""Fused EmbeddingBag: gather plus weighted segment sum (K10)."""

from .ops import (
    TL,
    embedding_bag,
    pack_bags,
    segment_bag,
    segment_bag_torch,
)

__all__ = ["TL", "embedding_bag", "pack_bags", "segment_bag",
           "segment_bag_torch"]
