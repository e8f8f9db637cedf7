"""Fault-tolerant checkpointing: sharded npz + manifest, atomic commit
(the port of ``repro.distributed.checkpoint``, with its on-disk format,
so either package reads the other's checkpoints).

Layout of one checkpoint:

    <dir>/step_000123/
        manifest.json          {step, n_shards, keys, time, extra}
        shard_00000.npz        flattened path->array chunks (512 MB each)

* **Keys** are the reference's key paths: dict keys in sorted order,
  list and tuple indices, and a NamedTuple's fields (``AdamWState``) as
  ``.<field>``, joined by ``/`` (``|`` inside the npz): ``{"params":
  p, "opt": adamw_init(p)}`` gives ``opt/.step``, ``opt/.m/...``,
  ``opt/.v/...``, ``params/...``.
* **bf16** (and float8) leaves are widened losslessly to float32 on save
  (npz cannot store them) and cast back to the template's dtype on
  restore.
* **Atomic commit** — writes land in ``step_k.tmp-<pid>``; the rename
  to ``step_k`` is the commit point, so a killed process never leaves a
  half-checkpoint that restore could pick up.
* **Bounded async** — ``CheckpointManager.save_async`` copies the tree
  to the host and hands it to one background writer (queue depth 1):
  training never waits on the disk, and at most one checkpoint of host
  memory is pinned.  A writer's error surfaces on the next save or
  close.
* **Step-keyed data** — the pipelines are deterministic in (seed,
  step), so restore needs no data-loader state.
* **Elastic restart** — a tree with DTensor leaves (a process mesh's
  state) is saved as logical arrays: every rank gathers each leaf
  (``collectives.full``) and rank 0 writes (``save_checkpoint``; the
  asynchronous writer takes no DTensor leaves).  A template leaf
  that is a DTensor restores onto its own mesh and placements, which
  may be another shape's than the saver's (``elastic.reshard`` does the
  same for a tree restored as plain tensors).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import collectives as CO
from .tree import map_leaves, walk

SHARD_BYTES = 512 * 1024 * 1024


def _to_numpy(leaf) -> np.ndarray:
    """A host array npz can store: bf16 and float8 widened to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.is_floating_point() and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            t = t.to(torch.float32)
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        arr = arr.astype(np.float32)    # ml_dtypes: widen losslessly
    return arr


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in walk(tree)}


def _gathered(tree: Any) -> Tuple[Any, bool]:
    """The tree with every DTensor leaf gathered whole (on every rank),
    and whether it had one."""
    sharded = any(CO.is_dtensor(v) for _, v in walk(tree))
    if sharded:
        tree = map_leaves(lambda _, x: CO.full(x), tree)
    return tree, sharded


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Blocking save with atomic rename commit. Returns the final path.
    A tree with DTensor leaves is saved whole by rank 0; every rank of
    the process group calls this, and returns once it is committed."""
    tree, sharded = _gathered(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if sharded and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()
        return final
    try:
        return _write(directory, final, step, tree, extra)
    finally:
        if sharded:
            torch.distributed.barrier()


def _write(directory: str, final: str, step: int, tree: Any,
           extra: Optional[Dict]) -> str:
    flat = _flatten(tree)
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    shards: List[Dict[str, np.ndarray]] = [{}]
    size = 0
    for k, v in flat.items():
        if size > SHARD_BYTES:
            shards.append({})
            size = 0
        shards[-1][k] = v
        size += v.nbytes
    for i, sh in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i:05d}.npz"),
                 **{k.replace("/", "|"): v for k, v in sh.items()})
    manifest = {
        "step": step,
        "n_shards": len(shards),
        "keys": list(flat.keys()),
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # commit point
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, ref):
    """``arr`` in the template leaf's kind: a DTensor placed as it is, a
    tensor of its dtype on its device, or an array of its dtype."""
    if CO.is_dtensor(ref):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(torch.as_tensor(arr).to(ref.dtype),
                                 ref.device_mesh, ref.placements,
                                 src_data_rank=None)
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
    if hasattr(ref, "dtype"):
        return arr.astype(ref.dtype)
    return arr


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``; returns (tree,
    manifest).  Each leaf takes the template leaf's dtype and, for a
    tensor, its device.

    Raises FileNotFoundError when no committed checkpoint exists.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
            for k in z.files:
                flat[k.replace("|", "/")] = z[k]

    def leaf(key, ref):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        return _restore_leaf(flat[key], ref)

    return map_leaves(leaf, tree_like), manifest


def _host_copy(tree: Any) -> Any:
    """The tree with every tensor copied to the host now."""
    return map_leaves(
        lambda _, x: (x.detach().to("cpu", copy=True)
                      if isinstance(x, torch.Tensor) else x), tree)


class CheckpointManager:
    """Bounded-async writer: one background thread, queue depth 1."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                save_checkpoint(self.directory, step, tree, extra)
                self._gc()
            except BaseException as e:   # surfaced on next save/close
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n
            and os.path.isdir(os.path.join(self.directory, n))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """A tree with DTensor leaves raises ``ValueError``: a process
        mesh's state is saved by ``save_checkpoint`` on every rank."""
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if any(CO.is_dtensor(v) for _, v in walk(tree)):
            raise ValueError("save_async takes no DTensor leaves: save a "
                             "process mesh's state with save_checkpoint")
        host_tree = _host_copy(tree)             # device->host copy now
        self._q.put((step, host_tree, extra))    # blocks if one pending

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
