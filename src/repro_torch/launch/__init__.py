"""Launch helpers and entry points (the port of ``repro.launch``): the
shard mesh of the cluster's sharded engine, the serving launcher
(``python -m repro_torch.launch.serve``) and the training launcher
(``python -m repro_torch.launch.train``)."""

from .mesh import ShardMesh, make_shard_mesh, visible_devices
from .serve import serve_chunked

__all__ = ["ShardMesh", "make_shard_mesh", "serve_chunked",
           "visible_devices"]
