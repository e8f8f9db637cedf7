"""Launch helpers (the port of ``repro.launch``): so far the shard mesh
of the cluster's sharded engine."""

from .mesh import ShardMesh, make_shard_mesh, visible_devices

__all__ = ["ShardMesh", "make_shard_mesh", "visible_devices"]
