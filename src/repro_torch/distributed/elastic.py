"""Elastic placement + failure-recovery glue (the port of
``repro.distributed.elastic``).

Checkpoints store *logical* (unsharded) arrays, so a job can restart on
another mesh: ``reshard`` places a restored tree onto the mesh under
the partition rules' specs.  The port places on one device: a mesh of
more than one device, or with any axis of size > 1, needs the
multi-card work of ROADMAP Queue 1 item 13 (``torch.distributed``),
and raises ``NotImplementedError``.

``run_with_recovery`` is the supervisor loop of a training segment: it
retries after transient failures, the segment restoring from the last
committed checkpoint on entry (the single-process stand-in for a
cluster controller's restart-on-node-failure).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from .sharding import mesh_sizes
from .tree import at, map_leaves


def reshard(tree: Any, mesh, spec_tree: Any) -> Any:
    """Place (host or device) arrays onto ``mesh`` (a ``ShardMesh``: its
    ``devices`` and ``shape``) per ``spec_tree``, a tree of specs of
    ``tree``'s structure."""
    devices = tuple(mesh.devices)
    big = {a: n for a, n in mesh_sizes(mesh).items() if n > 1}
    if len(devices) != 1 or big:
        raise NotImplementedError(
            f"reshard onto {len(devices)} devices (axes {big}) waits for "
            f"the port's multi-card work (ROADMAP Queue 1 item 13)")

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
