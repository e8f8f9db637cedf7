"""repro_torch.cluster — sharded RangeReach serving (the port of
``repro.cluster``).

The 2DReach forest partitions by tree id (each component's R-tree is an
independent lookup target); :class:`ShardedEngine` serves the partition
from per-shard arena stacks on the mesh's devices (the routing side on
every device, one fused kernel launch per shard, the hits OR-ed), and
:class:`Frontend` micro-batches a request stream into the power-of-two
buckets the engines pad to.

    eng  = ShardedEngine(build_index(g, "2dreach-comp"), n_shards=8)
    ans  = eng.query_batch(us, rects)         # bit-identical to host
    with Frontend(eng, max_batch=256) as fe:  # request-at-a-time surface
        fut = fe.submit(u, rect)
"""

from .frontend import Frontend
from .partition import (
    ForestPartition,
    balanced_assignment,
    partition_forest,
    shard_arenas,
)
from .sharded_engine import ShardedEngine, sharded_engine_for

__all__ = [
    "Frontend",
    "ForestPartition",
    "balanced_assignment",
    "partition_forest",
    "shard_arenas",
    "ShardedEngine",
    "sharded_engine_for",
]
