"""The query-serving shard mesh (the port of
``repro.launch.mesh.make_shard_mesh``).

The reference lays the cluster's shards over a 1-D ``jax`` mesh with a
``data`` axis.  Here a mesh is the tuple of torch devices the shards are
placed on: shard ``s`` of ``S`` lives on device ``s // (S // n_dev)``,
its arena planes whole on that device, while the routing side (the
pointer arrays and the partition's per-tree arrays) is copied to every
device.  That is the placement rule of the reference's
``distributed.sharding.index_shard_specs``: arenas split on the shard
axis, the pointer side replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The devices one sharded engine places its shards on, in shard
    order; the first also gathers the hits."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": n_devices}``, as the reference's mesh reports it."""
        return {AXIS: len(self.devices)}


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """Every visible device of ``device``'s type (``None``: the GPU), each
    with its index: the CUDA cards, or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for(n_shards: int, n_avail: int) -> int:
    """Largest device count <= n_avail that divides n_shards evenly."""
    for d in range(min(n_shards, n_avail), 0, -1):
        if n_shards % d == 0:
            return d
    return 1


def make_shard_mesh(n_dev: Optional[int] = None,
                    device: DeviceLike = None) -> ShardMesh:
    """A mesh over the first ``n_dev`` visible devices of ``device``'s
    type (default: all of them), as the reference takes the first
    ``n_dev`` of ``jax.devices()``."""
    avail = visible_devices(device)
    n = len(avail) if n_dev is None else int(n_dev)
    if not 1 <= n <= len(avail):
        raise ValueError(f"n_dev={n} outside [1, {len(avail)}] visible "
                         f"{avail[0].type} devices")
    return ShardMesh(tuple(avail[:n]))
