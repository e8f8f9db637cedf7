"""Meshes (the port of ``repro.launch.mesh``): the production and host
meshes of the dry run, the query-serving shard mesh, and the process
mesh the expert-, tensor- and data-parallel arms run on.

The reference's production meshes are ``jax`` meshes over a v5e pod
(16 × 16 chips, or 2 × 16 × 16 with a ``pod`` axis).  Here a production
or host mesh is the ``{axis: size}`` mapping that ``distributed.
sharding``'s rules take: the dry run divides each input's bytes by it
(``launch.dryrun.arg_bytes_per_device``) and counts rank 0's step of
it on a ``collectives.CountingMesh`` (``launch.dryrun.mesh_step``: its
FLOPs, bytes and the bytes each kind of collective moves per device).
Functions, not constants: importing this module touches no CUDA state.

The reference lays the cluster's shards over a 1-D ``jax`` mesh with a
``data`` axis.  Here a mesh is the tuple of torch devices the shards are
placed on: shard ``s`` of ``S`` lives on device ``s // (S // n_dev)``,
its arena planes whole on that device, while the routing side (the
pointer arrays and the partition's per-tree arrays) is copied to every
device.  That is the placement rule of
``distributed.sharding.index_shard_specs`` (the reference's, ported):
arenas split on the shard axis, the pointer side replicated;
``ShardedEngine._place`` places by that table.

The reference's host mesh ``jax.make_mesh((1, n), ("data", "model"))``
spans the devices of one process.  A PyTorch process drives one device,
so the port's sharded arms run one process a rank: ``init_ranks`` joins
the process group, ``make_process_mesh`` lays the ranks out as a
``DeviceMesh`` with dims ``("data", "model")``, row-major (rank r at
``divmod(r, model)``, as ``jax.make_mesh`` orders its devices).  The
backend is the caller's choice and nothing picks it: ``"nccl"`` puts
rank r on card r (NCCL refuses two ranks on one card), ``"gloo"`` runs
on the CPU, or with ``device`` given, several ranks on one card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import MeshAxes

AXIS = "data"


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """``{"data": 16, "model": 16}`` (256 chips), or with ``multi_pod``
    ``{"pod": 2, "data": 16, "model": 16}`` (512)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_axes(multi_pod: bool = False) -> MeshAxes:
    return MeshAxes(
        data=("pod", "data") if multi_pod else ("data",), model="model")


def make_host_mesh(device: DeviceLike = None) -> Dict[str, int]:
    """``{"data": 1, "model": n}`` over the visible devices of
    ``device``'s type (``None``: the CUDA cards)."""
    return {"data": 1, "model": len(visible_devices(device))}


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


BACKENDS = ("nccl", "gloo")


def init_ranks(backend: str, *, store: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               device: DeviceLike = None) -> torch.device:
    """Join this process to the process group; returns the device its
    tensors live on.

    Without ``store`` the rank, world size and local rank are torchrun's
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; the rendezvous
    ``env://``).  With it, ``rank`` of ``world_size`` ranks meet at the
    file ``store`` (``file://``; local rank = rank).  ``"nccl"`` takes
    no ``device``: local rank r runs on ``cuda:r``, and a world larger
    than the visible cards raises ``ValueError``.  ``"gloo"`` runs on
    the CPU unless ``device`` names a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if store is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("a file store needs rank and world_size")
        local_rank = rank
        init = "file://" + os.path.abspath(store)
    if backend == "nccl":
        if device is not None:
            raise ValueError("nccl places rank r on cuda:r; give no device")
        n = torch.cuda.device_count()
        if world_size > n:
            raise ValueError(f"nccl needs one card a rank: {world_size} "
                             f"ranks, {n} visible card(s)")
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu") if device is None else resolve_device(
            device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(backend, init_method=init,
                                         rank=rank, world_size=world_size)
    return dev


def make_process_mesh(data: int, model: int, device: torch.device):
    """A ``DeviceMesh`` of dims ``("data", "model")`` and sizes ``(data,
    model)`` over the initialised group, for tensors on ``device``'s
    type."""
    from torch.distributed.device_mesh import init_device_mesh

    world = torch.distributed.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh over {world} ranks")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))
