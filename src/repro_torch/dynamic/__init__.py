"""repro_torch.dynamic — incremental RangeReach over a mutating geosocial
graph (the port of ``repro.dynamic``).

Public API:
    DynamicIndex(graph, method)     # wrap any static method
    .add_edge / .add_vertex / .add_spatial
    .query_batch / .query           # exact answers on the mutated graph
    .compact / .maybe_compact       # overlay -> fresh static base
"""

from .compaction import NEVER, CompactionPolicy, Compactor
from .index import DynamicIndex
from .overlay import DeltaOverlay, SpatialStaging, UnionFind

__all__ = [
    "NEVER", "CompactionPolicy", "Compactor",
    "DynamicIndex",
    "DeltaOverlay", "SpatialStaging", "UnionFind",
]
