"""Elastic placement + failure-recovery glue (the port of
``repro.distributed.elastic``).

Checkpoints store *logical* (unsharded) arrays, so a job can restart on
another mesh: ``reshard`` places a restored tree onto the mesh under
the partition rules' specs.  Onto a process mesh (a ``DeviceMesh``,
``launch.mesh.make_process_mesh``) every leaf becomes a DTensor whose
local shard on each rank is the block the reference's ``NamedSharding``
gives the device at the same mesh coordinate; every rank holds the same
logical tree, so each keeps its block with no collective.  Onto a mesh
of one device the leaves are placed whole on it.  A single process's
mesh of several devices (``ShardMesh``) raises ``ValueError``: one
process holds no global sharded tensor.

``run_with_recovery`` is the supervisor loop of a training segment: it
retries after transient failures, the segment restoring from the last
committed checkpoint on entry (the single-process stand-in for a
cluster controller's restart-on-node-failure).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from . import collectives as CO
from .collectives import process_mesh
from .sharding import placements
from .tree import at, map_leaves


def reshard(tree: Any, mesh, spec_tree: Any) -> Any:
    """Place (host or device) arrays onto ``mesh`` per ``spec_tree``, a
    tree of specs of ``tree``'s structure: a process mesh (DTensor
    leaves) or a mesh of one device (a ``ShardMesh``: its ``devices``
    and ``shape``), or a counting mesh (rank 0's blocks).  A spec naming
    an axis the mesh lacks, or a dim its axes do not divide, raises
    ``ValueError`` (``sharding.placements``)."""
    pm = process_mesh(mesh)
    if isinstance(pm, CO.CountingMesh):
        def cut(key, x):
            spec = at(spec_tree, key)
            placements(spec, pm, tuple(x.shape))      # the same refusals
            return CO.place_block(CO.block(x, pm, spec), pm, spec)

        return map_leaves(cut, tree)
    if pm is not None:
        from torch.distributed.tensor import distribute_tensor

        def place(key, x):
            x = torch.as_tensor(x)
            return distribute_tensor(
                x, pm, placements(at(spec_tree, key), pm, tuple(x.shape)),
                src_data_rank=None)

        return map_leaves(place, tree)
    devices = tuple(mesh.devices)

    def put(key, x):
        x = torch.as_tensor(x)
        spec = at(spec_tree, key)
        if len(spec) > x.dim():
            raise ValueError(f"{key}: spec {spec} has more entries than "
                             f"{x.dim()} dims")
        return x.to(devices[0])

    return map_leaves(put, tree)


def run_with_recovery(
    segment: Callable[[int], int],
    *,
    start_step: int,
    max_failures: int = 3,
    backoff_s: float = 0.5,
) -> int:
    """Run ``segment(step) -> next_step`` until it finishes, retrying after
    exceptions up to ``max_failures`` times (the caller's segment function
    re-restores from the last checkpoint on entry)."""
    failures = 0
    step = start_step
    while True:
        try:
            return segment(step)
        except KeyboardInterrupt:
            raise
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            time.sleep(backoff_s * (2 ** (failures - 1)))
            # segment re-reads the last committed checkpoint itself
