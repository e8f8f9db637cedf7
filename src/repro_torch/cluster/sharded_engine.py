"""Sharded RangeReach serving over a partitioned forest (the port of
``repro.cluster.sharded_engine``).

:class:`ShardedEngine` is the cluster-scale sibling of the single-device
:class:`~repro_torch.core.engine.QueryEngine`.  The 2DReach forest is
partitioned by tree id (size-balanced bin packing over per-tree entry
counts, :mod:`repro_torch.cluster.partition`), one ``QueryEngine``-style
SoA arena + tile pyramid is put on the card **per shard** (stacked, and
split over the mesh's devices on the shard axis), and the vertex→tree
pointer arrays are copied to every device.  ``query_batch`` serves a
batch on the fused path: every device routes the whole batch, masks it
to the queries whose trees live on each of its shards (every other
query gets the empty slice ``qs = qe = 0``, which the kernels skip), and
launches the fused prune+scan kernel (K1, mode ``reach``) once per
shard over quantized planes on **one grid over the whole forest's
extent**; the per-shard hits OR into one answer, and the largest
candidate count of all shards is read once a batch for the shared
capacity ratchet (an overflowing batch ratchets and re-runs once).  The
two-phase path is retained as ``query_batch_two_phase``, the fused
path's oracle:

1. **route + prune** — per shard, the float32 prune kernel (K2) over its
   own tile pyramid, then the candidate compaction;
2. **masked scan** — after one host read of the largest candidate count
   of all shards (a power-of-two bucket, the same high-water mark), the
   descent scan (K3) per shard over its own arena, the hits OR-ed.

Every query's tree lives on exactly one shard and that shard's arena
holds exactly the tree's entries (same boxes, same slice contents), so
answers are **bit-identical** to ``query_host``.

More shards than devices is legal: each device then holds ``n_shards /
n_devices`` stacked shards and launches once per shard.  On one card
(and on the CPU, where every kernel runs its plain version) all shards
stack on that device; with more visible cards shard ``s`` lives on card
``s // L`` and the hits are gathered onto the first.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.engine import DevicePadder, PointerSide, _bucket, check_vertex_ids
from ..core.two_d_reach import TwoDReachIndex
from ..device import DeviceLike, resolve_device, same_device
from ..kernels.range_query.descent import (
    descent_scan,
    prune_tiles,
    take_candidates,
)
from ..kernels.range_query.fused import (
    QuantGrid,
    compact_ascending,
    fused_serve,
    make_quant_grid,
    quantize_coarse,
    quantize_fine,
    quantize_rects,
)
from ..kernels.range_query.layout import TB
from ..launch.mesh import (
    AXIS,
    ShardMesh,
    devices_for,
    make_shard_mesh,
    visible_devices,
)
from ..obs import REGISTRY, span
from ..obs.tracer import TRACER as _TRACER
from ..resilience.faults import fault_point
from .partition import partition_forest, shard_arenas


def _unsupported_msg(index, what: str) -> str:
    name = type(index).__name__
    method = getattr(index, "method", None) or getattr(index, "variant", None)
    via = f" (method {method!r})" if isinstance(method, str) else ""
    return (
        f"no {what} for {name}{via}: device/cluster serving supports the "
        f"2DReach variants only (2dreach, 2dreach-comp, 2dreach-pointer)"
    )


@dataclasses.dataclass
class _ShardGroup:
    """The shards of one device: their stacked planes (each shard a
    contiguous slice of the stack) and a copy of the routing side."""

    device: torch.device
    first: int                 # global id of its first shard
    entries: torch.Tensor      # (L, 2*dim, Pp) float32
    fine: torch.Tensor         # (L, 2*dim, NTp) float32
    coarse: torch.Tensor       # (L, 2*dim, NCp) float32
    qfine: torch.Tensor        # (L, 2*dim, NTp) int16
    qcoarse: torch.Tensor      # (L, 2*dim, NCp) int32
    ids_row: torch.Tensor      # (1, Pp) int32, unread in reach mode
    side: PointerSide
    tree_shard: torch.Tensor   # (max(T,1),) int32
    tree_qs: torch.Tensor
    tree_qe: torch.Tensor
    grid: QuantGrid
    padder: DevicePadder

    @property
    def n_local(self) -> int:
        return int(self.entries.shape[0])


class ShardedEngine:
    """Sharded engine over a built ``TwoDReachIndex``.

    Parameters
    ----------
    index:    any 2DReach variant (``base`` / ``comp`` / ``pointer``).
    n_shards: forest partitions; defaults to the mesh's (or the visible)
              device count.  May exceed it — shards then stack per
              device.
    device:   ``None`` (the GPU; raises where CUDA is absent) or an
              explicit device; the mesh is built over the visible
              devices of its type.  On ``"cpu"`` every kernel runs its
              plain PyTorch version.
    mesh:     a :class:`~repro_torch.launch.mesh.ShardMesh`; ``None``
              builds one over the largest visible device count that
              divides ``n_shards``.
    """

    def __init__(self, index: TwoDReachIndex,
                 n_shards: Optional[int] = None,
                 device: DeviceLike = None,
                 mesh: Optional[ShardMesh] = None):
        if not isinstance(index, TwoDReachIndex):
            raise ValueError(_unsupported_msg(index, "cluster ShardedEngine"))
        self.variant = index.variant
        self.dim = index.forest.dim
        n_avail = len(visible_devices(device if mesh is None
                                      else mesh.devices[0]))
        if n_shards is None:
            n_shards = mesh.shape[AXIS] if mesh is not None else n_avail
        n_shards = int(n_shards)
        if mesh is None:
            mesh = make_shard_mesh(devices_for(n_shards, n_avail), device)
        n_dev = mesh.shape[AXIS]
        if n_shards % n_dev:
            raise ValueError(
                f"n_shards={n_shards} must be a multiple of the mesh's "
                f"{AXIS} axis size {n_dev}")
        self.mesh = mesh
        self.device = mesh.devices[0]      # where the hits are gathered
        self.n_shards = n_shards
        self._shards_per_dev = n_shards // n_dev

        # ---- partition + one-time placement ----------------------------
        self.partition = partition_forest(index.forest, n_shards)
        entries, fine, coarse, nt = shard_arenas(index.forest, self.partition)
        self.n_tiles = nt                       # per shard, uniform
        self.width = int(entries.shape[-1])     # Pp
        # one quantization grid over the whole forest extent: every
        # shard's planes and every rect are coded on it
        ent = index.forest.entries
        extent = (np.concatenate([ent[:, : self.dim].min(0),
                                  ent[:, self.dim:].max(0)]).astype(
                                      np.float64) if len(ent) else None)
        L = self._shards_per_dev
        self._groups: List[_ShardGroup] = [
            self._place(index, d, i * L, entries, fine, coarse, extent)
            for i, d in enumerate(mesh.devices)]

        self.stats: Dict[str, float] = {
            "uploads": 1, "batches": 0, "queries": 0,
            "adopted": int(getattr(index.forest, "device", None) is not None),
            "tiles_scanned": 0, "tiles_grid": 0, "tiles_full_scan": 0,
            "fused_reruns": 0,
        }
        self.shard_queries = np.zeros(n_shards, dtype=np.int64)
        # per-shard hit counters ride next to the query routing counts:
        # the load signal of a query-log-driven repartitioner
        self.shard_hits = np.zeros(n_shards, dtype=np.int64)
        # host-side mirrors for query-log classification and routing
        self._excluded_host = index.excluded
        self._lookup_tree_host = index.lookup_tree
        # candidate-capacity high-water mark shared by both paths: only
        # ratchets up, so a smaller batch never serves a new capacity
        self._kb_hwm = 1
        self._shapes = set()       # the shapes served (``n_compiles``)

    def _place(self, index, dev, first, entries, fine, coarse, extent
               ) -> _ShardGroup:
        """Shards ``[first, first + L)`` on ``dev``: a slice of the stacks
        (the stacks themselves where they already lie there), their
        quantized planes on the shared grid, and the routing side."""
        sl = slice(first, first + self._shards_per_dev)

        def put(x):
            if isinstance(x, np.ndarray):
                return torch.as_tensor(np.ascontiguousarray(x[sl]),
                                       device=dev)
            return x[sl].to(dev).contiguous()

        e, f, c = put(entries), put(fine), put(coarse)
        grid = make_quant_grid(extent, self.dim, dev)
        qf = torch.stack([quantize_fine(grid, p, self.dim) for p in f])
        qc = torch.stack([quantize_coarse(grid, p, self.dim) for p in c])
        # each shard is handed to the kernels as ``stack[l]``: a
        # contiguous view, no copy
        assert all(t.is_contiguous() for t in (e, f, c, qf, qc))
        part = self.partition

        def tree(a):
            return torch.as_tensor(a, device=dev)

        return _ShardGroup(
            device=dev, first=first, entries=e, fine=f, coarse=c,
            qfine=qf, qcoarse=qc,
            ids_row=torch.zeros((1, self.width), dtype=torch.int32,
                                device=dev),
            side=PointerSide(index, dev), tree_shard=tree(part.tree_shard),
            tree_qs=tree(part.tree_qs), tree_qe=tree(part.tree_qe),
            grid=grid, padder=DevicePadder(self.dim, dev))

    # ------------------------------------------------------------------
    # per-device steps
    # ------------------------------------------------------------------

    def _route(self, g: _ShardGroup, us_dev: torch.Tensor,
               rsoa: torch.Tensor):
        """(tree ids clamped to >= 0, owning shard or -1, Alg. 2 forced
        answers) of the whole batch, on ``g``'s device."""
        us = us_dev.long()
        tid = g.side.lookup(us)
        exc = g.side._excluded[us]
        valid = (tid >= 0) & ~exc
        t = tid.clamp(min=0)
        own = torch.where(valid, g.tree_shard[t], -1)
        pts = g.side._coords[us]
        inr = torch.ones(us.shape[0], dtype=torch.bool, device=g.device)
        for a in range(self.dim):
            inr &= pts[:, a] >= rsoa[a]
            inr &= pts[:, a] <= rsoa[self.dim + a]
        return t, own, exc & inr

    def _slices(self, g: _ShardGroup, t, own):
        """Per local shard, the arena slices of the queries it owns; all
        other queries get the empty slice ``qs = qe = 0``."""
        out = []
        for l in range(g.n_local):
            mine = own == g.first + l
            out.append((torch.where(mine, g.tree_qs[t], 0),
                        torch.where(mine, g.tree_qe[t], 0)))
        return out

    def _pad(self, us: np.ndarray, rects: np.ndarray):
        check_vertex_ids(us, len(self._excluded_host))
        padded = [g.padder.pad(us, rects) for g in self._groups]
        return padded[0][0], [p[1:] for p in padded]

    def _home(self, x: torch.Tensor) -> torch.Tensor:
        return x if same_device(x.device, self.device) else x.to(self.device)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    @property
    def n_compiles(self) -> int:
        """Distinct shapes served so far: (path, batch bucket, candidate
        capacity); flat in steady state.  The analogue of the
        reference's jit cache sizes."""
        return len(self._shapes)

    @property
    def nbytes_planes(self) -> int:
        """Bytes of every shard stack on the devices (entries, float32
        pyramid, quantized pyramid)."""
        return int(sum(t.numel() * t.element_size()
                       for g in self._groups
                       for t in (g.entries, g.fine, g.coarse, g.qfine,
                                 g.qcoarse)))

    def shard_of(self, us: np.ndarray) -> np.ndarray:
        """Host-side vertex -> owning shard (-1: excluded / no tree) —
        the routing key the structured query log records."""
        t = np.asarray(self._lookup_tree_host(np.asarray(us, np.int64)))
        out = np.full(len(t), -1, dtype=np.int64)
        ok = t >= 0
        out[ok] = self.partition.tree_shard[t[ok]]
        return out

    def _finish_batch(self, B, Bb, kb, forced, own, hit, tot, t0):
        """Shared batch epilogue (fused + two-phase): stats, sync,
        per-shard routing/hit counters, gated registry recording."""
        S = self.n_shards
        self.stats["batches"] += 1
        self.stats["queries"] += B
        self.stats["tiles_scanned"] += tot
        self.stats["tiles_grid"] += (Bb // TB) * kb * S
        self.stats["tiles_full_scan"] += (Bb // TB) * self.n_tiles * S
        with span("cluster.sync", cat="cluster"):
            # routing stats over the *real* lanes only (padding reuses
            # vertex 0, which routes to a real shard but answers nothing)
            own_b = own[:B].cpu().numpy()
            out = ((hit > 0) | forced)[:B].cpu().numpy()
        routed = own_b >= 0
        self.shard_queries += np.bincount(
            own_b[routed], minlength=S).astype(np.int64)
        self.shard_hits += np.bincount(
            own_b[routed & out], minlength=S).astype(np.int64)
        if _TRACER.enabled:
            dt_us = (time.perf_counter() - t0) * 1e6
            REGISTRY.histogram("cluster.batch_us").record(dt_us)
            REGISTRY.gauge("cluster.n_compiles").set(self.n_compiles)
            for s in np.nonzero(np.bincount(own_b[routed],
                                            minlength=S))[0]:
                REGISTRY.counter(f"cluster.shard{s}.queries").inc(
                    int((own_b == s).sum()))
                REGISTRY.counter(f"cluster.shard{s}.hits").inc(
                    int((routed & out & (own_b == s)).sum()))
        return out

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Batched RangeReach, bit-identical to the host path: one K1
        launch per shard a batch (per capacity bucket)."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        fault_point("cluster.query_batch", n=B)
        t0 = time.perf_counter()
        with span("cluster.query_batch", cat="cluster", n=B):
            with span("cluster.pad_batch", cat="cluster"):
                Bb, ins = self._pad(us, rects)
            with span("cluster.fused", cat="cluster", batch=B):
                work = []
                for g, (us_dev, rsoa) in zip(self._groups, ins):
                    t, own, forced = self._route(g, us_dev, rsoa)
                    r16, r32 = quantize_rects(g.grid, rsoa, self.dim)
                    work.append((g, rsoa, r16, r32, own, forced,
                                 self._slices(g, t, own)))
                while True:
                    kcap = min(self._kb_hwm, self.n_tiles)
                    self._shapes.add(("fused", Bb, kcap))
                    hit = torch.zeros(Bb, dtype=torch.int32,
                                      device=self.device)
                    cnts = []
                    for g, rsoa, r16, r32, _, _, slices in work:
                        for l, (qs, qe) in enumerate(slices):
                            out, cnt = fused_serve(
                                g.qfine[l], g.qcoarse[l], g.entries[l],
                                g.ids_row, r16, r32, rsoa, qs, qe,
                                mode="reach", kcap=kcap, nt=self.n_tiles,
                                dim=self.dim, device=g.device)
                            hit |= self._home(out)
                            cnts.append(self._home(cnt))
                    cnt = torch.stack(cnts)
                    # one read of the largest count of every shard waits
                    # for all of the batch's launches
                    mx, tot = torch.stack([cnt.max(), cnt.sum()]).tolist()
                    if mx <= kcap or kcap >= self.n_tiles:
                        break
                    self._kb_hwm = min(_bucket(mx, 1), self.n_tiles)
                    self.stats["fused_reruns"] += 1
            own, forced = work[0][4], work[0][5]
            return self._finish_batch(B, Bb, kcap, forced, own, hit, tot,
                                      t0)

    def query_batch_two_phase(self, us: np.ndarray,
                              rects: np.ndarray) -> np.ndarray:
        """The retained two-phase path (per-shard prune → one host read
        of the largest candidate count → per-shard scan, OR-ed) — the
        fused path's oracle."""
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if B == 0:
            return np.zeros(0, dtype=bool)
        fault_point("cluster.query_batch", n=B)
        t0 = time.perf_counter()
        with span("cluster.query_batch", cat="cluster", n=B):
            with span("cluster.pad_batch", cat="cluster"):
                Bb, ins = self._pad(us, rects)
            with span("cluster.route_prune", cat="cluster"):
                work, cnts = [], []
                for g, (us_dev, rsoa) in zip(self._groups, ins):
                    t, own, forced = self._route(g, us_dev, rsoa)
                    shards = []
                    for l, (qs, qe) in enumerate(self._slices(g, t, own)):
                        mask = prune_tiles(g.fine[l], g.coarse[l], rsoa,
                                           qs, qe, dim=self.dim,
                                           device=g.device)
                        cand, cnt = compact_ascending(mask, self.n_tiles)
                        shards.append((cand, qs, qe))
                        cnts.append(self._home(cnt))
                    work.append((g, rsoa, own, forced, shards))
                cnt = torch.stack(cnts)
                # the read of the largest count of every shard waits for
                # the prunes and compactions
                mx, tot = torch.stack([cnt.max(), cnt.sum()]).tolist()
                self._kb_hwm = max(
                    self._kb_hwm,
                    min(_bucket(max(mx, 1), 1), self.n_tiles))
            kb = self._kb_hwm
            self._shapes.add(("two_phase", Bb, kb))
            with span("cluster.scan", cat="cluster"):
                hit = torch.zeros(Bb, dtype=torch.int32, device=self.device)
                for g, rsoa, _, _, shards in work:
                    for l, (cand, qs, qe) in enumerate(shards):
                        hit |= self._home(descent_scan(
                            take_candidates(cand, kb), g.entries[l], rsoa,
                            qs, qe, dim=self.dim, device=g.device))
            own, forced = work[0][2], work[0][3]
            return self._finish_batch(B, Bb, kb, forced, own, hit, tot, t0)

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])


def sharded_engine_for(index, n_shards: Optional[int] = None,
                       device: DeviceLike = None) -> ShardedEngine:
    """Memoised ``ShardedEngine`` for a built 2DReach index.

    One engine is cached per index instance: an explicit ``n_shards``
    that disagrees with the cached engine, or a ``device`` (``None``: the
    GPU) other than its mesh's first, rebuilds and *replaces* it (two
    shard layouts of the same index are never resident at once), while
    ``n_shards=None`` accepts whatever layout is cached.  Unlike
    ``engine_for`` there is no silent fallback: cluster serving is an
    explicit opt-in, so an unsupported index type raises a
    ``ValueError`` naming it."""
    if not isinstance(index, TwoDReachIndex):
        raise ValueError(_unsupported_msg(index, "cluster ShardedEngine"))
    dev = resolve_device(device)
    eng = getattr(index, "_cluster_engine", None)
    if eng is None or (
        n_shards is not None and eng.n_shards != int(n_shards)
    ) or not same_device(eng.device, dev):
        index._cluster_engine = eng = None   # free the old layout first
        eng = ShardedEngine(index, n_shards=n_shards, device=dev)
        index._cluster_engine = eng
    return eng
