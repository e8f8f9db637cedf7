"""Launch helpers and entry points (the port of ``repro.launch``): the
meshes (production and host meshes of the dry run, the shard mesh of
the cluster's sharded engine), the serving launcher (``python -m
repro_torch.launch.serve``), the training launcher (``python -m
repro_torch.launch.train``), the dry run (``python -m
repro_torch.launch.dryrun``) and its per-variant count (``python -m
repro_torch.launch.perf_lm``)."""

from .mesh import (
    ShardMesh,
    make_host_mesh,
    make_production_mesh,
    make_shard_mesh,
    mesh_axes,
    visible_devices,
)
from .serve import serve_chunked

__all__ = ["ShardMesh", "make_host_mesh", "make_production_mesh",
           "make_shard_mesh", "mesh_axes", "serve_chunked",
           "visible_devices"]
