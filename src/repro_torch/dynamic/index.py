"""`DynamicIndex` — incremental RangeReach over any static index (the
port of ``repro.dynamic.index``).

The static indexes behind ``core.api.build_index`` are built offline over
a frozen graph.  ``DynamicIndex`` wraps one and absorbs online mutations
(``add_edge`` / ``add_vertex`` / ``add_spatial``) into a
:class:`~repro_torch.dynamic.overlay.DeltaOverlay`, answering every query over
the *mutated* graph without a rebuild.  Mutations are monotone (nothing
is ever deleted), which makes the composition exact:

A RangeReach(u, R) answer over base ∪ overlay decomposes as

1. **base probe** — the static index answers for the base graph's
   reachability and base spatial vertices (sound because base paths and
   base venues survive every mutation);
2. **overlay expansion** — a fixpoint over the delta edge buffer at
   condensation-component granularity computes which components become
   reachable *through* delta edges; every such "entry component" pays
   one extra base probe from a representative vertex (its base-graph
   reach is new to u), and reached components are collected for step 3;
3. **staging probe** — the staging R-tree yields the staged spatial
   vertices inside R; any of them whose component (or pseudo-component,
   for post-snapshot vertices) was reached answers the query.

Step 2 runs on the DynamicIndex's *own* full condensation of the base
graph (independent of the wrapped method's internals — 2DReach-Comp
excludes spatial sinks from its decomposition, the dynamic layer must
not).  DAGGER-style maintenance keeps a union-find over components:
delta edges that close a cycle collapse the endpoint components into one
group, and expansion treats a reached group as all-members-reached.
Expansion results are memoised per union-find representative; a new
delta edge (s, t) invalidates exactly the memos that cover ``s`` — the
only reachable sets the edge can grow.

Compaction (see :mod:`repro_torch.dynamic.compaction`) materialises the
mutated graph, rebuilds the static index — inline or on a background
thread — and swaps it in atomically, replaying any mutations that
arrived mid-build into the fresh overlay.

The base probes run where ``engine`` says: the host index, the device
:class:`~repro_torch.core.engine.QueryEngine` on ``device``, or the
:class:`~repro_torch.cluster.ShardedEngine` there.  A swap's fresh base
is built with ``backend="device"`` on ``device`` for the two device
engines, so its engine adopts the fresh planes without an upload; the
swapped-out index lets go of its memoised engine, so that the old
arena's memory is freed by reference counting, as is a failed swap's.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.condensation import condense
from ..core.graph import GeosocialGraph, build_csr, make_graph
from ..core.scc import scc_np
from ..device import DeviceLike
from ..obs import span
from ..resilience.faults import fault_point
from .compaction import CompactionPolicy, Compactor
from .overlay import DeltaOverlay

_REACH_CACHE_CAP = 512

# an expansion result: (sorted reached base comps, reached new vertices,
# entry vertices — one representative per comp whose base reach is only
# available through delta edges)
_Expansion = Tuple[np.ndarray, frozenset, Tuple[int, ...]]


class DynamicIndex:
    """Updatable RangeReach index: static base + delta overlay.

    Parameters
    ----------
    graph:   initial (base) geosocial graph.
    method:  any ``core.api.METHODS`` entry; the same method is used for
             every compaction rebuild.
    policy:  compaction thresholds; ``None`` -> defaults
             (see :class:`CompactionPolicy`).
    engine:  ``"host"`` (default) answers base probes through the static
             index's NumPy path; ``"device"`` serves the static base with
             a :class:`~repro_torch.core.engine.QueryEngine` on
             ``device`` (rebuilt on every compaction swap) while the
             overlay — small, mutable, pointer-rich — stays host-side;
             ``"cluster"`` shards the static base through a
             :class:`~repro_torch.cluster.ShardedEngine` (repartitioned
             on every compaction swap) with the same host-side overlay
             on top.
    n_shards: forest partitions for ``engine="cluster"`` (default: the
             visible device count); ignored otherwise.
    device:  where the two device engines and the device build run
             (``None``: the GPU; raises where CUDA is absent); unused
             by ``engine="host"`` unless ``build_kw`` asks for
             ``backend="device"``.
    build_kw: forwarded to ``build_index`` (fanout, dedup, ...).  When a
             device serving engine is selected (``"device"`` /
             ``"cluster"``) and no explicit ``backend`` is given, the
             static base — including every compaction rebuild — is
             built with ``backend="device"``, so each swap's fresh index
             is adopted by the new engine zero-copy instead of being
             re-transposed and re-uploaded from host.
    """

    def __init__(self, graph: GeosocialGraph, method: str,
                 policy: Optional[CompactionPolicy] = None,
                 engine: str = "host", n_shards: Optional[int] = None,
                 device: DeviceLike = None, **build_kw):
        from ..core.api import build_index  # deferred: api imports us lazily

        if engine not in ("host", "device", "cluster"):
            raise ValueError(
                f"unknown engine {engine!r}; expected host|device|cluster")
        if engine != "host" and not method.lower().startswith("2dreach"):
            # fail at construction, naming the method — not deep inside
            # the first compaction's engine rebuild
            raise ValueError(
                f"engine={engine!r} serves the 2DReach variants only, "
                f"not method {method!r}")
        self.method = method.lower()
        self.engine = engine
        self.n_shards = n_shards
        self.device = device
        self._build_kw = dict(build_kw)
        if engine != "host":
            # device serving gets the device builder by default: the
            # compaction swap then hands the freshly built arrays to the
            # new engine without a host→device re-upload
            self._build_kw.setdefault("backend", "device")
        if self._build_kw.get("backend") == "device":
            self._build_kw.setdefault("device", device)
        self.policy = policy or CompactionPolicy()
        self._lock = threading.RLock()
        self._compactor = Compactor(self)
        self._oplog: List[tuple] = []
        self._replaying = False
        self.stats: Dict[str, float] = {
            "n_queries": 0, "n_updates": 0, "n_edges_added": 0,
            "n_vertices_added": 0, "n_spatial_added": 0,
            "n_compactions": 0, "t_compaction_total": 0.0,
            "t_last_compaction": 0.0, "n_scc_merges": 0,
            "cache_hits": 0, "cache_misses": 0, "n_cache_invalidations": 0,
            "updates_since_compaction": 0,
        }
        t0 = time.perf_counter()
        index = build_index(graph, self.method, **self._build_kw)
        built = self._build_reach_substrate(graph)
        self._install_base(graph, index, built)
        self.stats["t_initial_build"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # base installation / condensation substrate
    # ------------------------------------------------------------------

    @staticmethod
    def _build_reach_substrate(graph: GeosocialGraph):
        """Full condensation of the base graph (no vertex excluded) +
        DAG CSR + one representative vertex per component."""
        n = graph.n_nodes
        labels = scc_np(n, graph.edges)
        cond = condense(n, graph.edges, labels)
        d = cond.n_comps
        csr = build_csr(d, cond.dag_edges)
        rep = np.zeros(d, dtype=np.int64)
        rep[cond.comp] = np.arange(n, dtype=np.int64)
        return cond.comp.copy(), d, csr.indptr, csr.indices, rep

    def _install_base(self, graph, index, substrate) -> None:
        comp, d, indptr, adj, rep = substrate
        self._graph = graph
        self._index = index
        self._comp = comp
        self._d = d
        self._dag_indptr = indptr
        self._dag_adj = adj
        self._comp_rep = rep
        self._overlay = DeltaOverlay(graph.n_nodes, d)
        self._stamp_arr = np.zeros(d, dtype=np.int64)
        self._stamp = 0
        self._cache: Dict[int, _Expansion] = {}
        self._base_engine = None
        if self.engine == "device":
            from ..core.engine import engine_for  # deferred: core is heavy

            # required=True: asking for device serving on a method the
            # engine cannot serve is a configuration error, not a
            # silent host fallback
            self._base_engine = engine_for(index, device=self.device,
                                           required=True)
        elif self.engine == "cluster":
            from ..cluster import sharded_engine_for  # deferred: heavy

            self._base_engine = sharded_engine_for(
                index, n_shards=self.n_shards, device=self.device)

    @staticmethod
    def _release_engines(index) -> None:
        """Drop ``index``'s memoised serving engines.  An engine holds
        its index and the index its engine, so without this a swapped-out
        base (or a failed swap's fresh one) and its device arena would
        wait for the cycle collector."""
        for attr in ("_device_engine", "_cluster_engine"):
            index.__dict__.pop(attr, None)

    def _base_probe(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Static-base probe — the device engine when enabled (and the
        wrapped method has one), the host path otherwise."""
        with span("dynamic.base_probe", cat="dynamic", n=len(us)):
            if self._base_engine is not None:
                return self._base_engine.query_batch(us, rects)
            return self._index.query_batch(us, rects)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self._overlay.n_nodes

    @property
    def n_base(self) -> int:
        return self._overlay.n_base

    @property
    def base_index(self):
        return self._index

    @property
    def base_engine(self):
        """The device engine serving the static base (None on host)."""
        return self._base_engine

    @property
    def overlay_size(self) -> int:
        o = self._overlay
        return o.n_edges + o.n_staged + o.n_new_vertices

    def snapshot_graph(self) -> GeosocialGraph:
        """Materialise the current mutated graph (base + overlay)."""
        with self._lock:
            return self._materialise()

    # -- mutations ------------------------------------------------------

    def add_vertex(self, coords=None) -> int:
        """Append a vertex; with ``coords`` it is spatial from birth."""
        with self._lock:
            v = self._overlay.add_vertex()
            if coords is not None:
                x, y = (float(coords[0]), float(coords[1]))
                self._overlay.staging.add(v, x, y)
                self._oplog.append(("vertex", (x, y)))
            else:
                self._oplog.append(("vertex", None))
            self._count_update("n_vertices_added")
            return v

    def add_spatial(self, v: int, coords) -> None:
        """Check-in: an existing non-spatial vertex acquires delta(v)."""
        with self._lock:
            v = int(v)
            if not (0 <= v < self._overlay.n_nodes):
                raise IndexError(f"vertex {v} out of range")
            already = (
                v < self._overlay.n_base and bool(self._graph.spatial_mask[v])
            ) or v in self._overlay.staging
            if already:
                raise ValueError(f"vertex {v} is already spatial")
            x, y = float(coords[0]), float(coords[1])
            self._overlay.staging.add(v, x, y)
            self._oplog.append(("spatial", v, x, y))
            self._count_update("n_spatial_added")

    def add_edge(self, s: int, t: int) -> None:
        """Append a directed edge; maintains the overlay condensation
        (union-find merge when the edge closes a cycle) and invalidates
        exactly the memoised reach sets that can now grow."""
        with self._lock:
            s, t = int(s), int(t)
            n = self._overlay.n_nodes
            if not (0 <= s < n and 0 <= t < n):
                raise IndexError(f"edge ({s}, {t}) out of range [0, {n})")
            if s != t:
                # DAGGER maintenance: does t already reach s?  Then s->t
                # closes a cycle and the endpoint components collapse.
                exp = self._expand_from(t)
                if self._exp_covers(exp, s):
                    ea = self._overlay.elem_of_vertex(s, self._comp)
                    eb = self._overlay.elem_of_vertex(t, self._comp)
                    if self._overlay.uf.union(ea, eb):
                        self._overlay.n_scc_merges += 1
                        self.stats["n_scc_merges"] += 1
            self._overlay.add_edge(s, t)
            self._invalidate_covering(s)
            self._oplog.append(("edge", s, t))
            self._count_update("n_edges_added")

    # -- queries --------------------------------------------------------

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
        with self._lock, span("dynamic.query_batch", cat="dynamic", n=B):
            self.stats["n_queries"] += B
            overlay = self._overlay
            self._check_query_range(us)
            ans = np.zeros(B, dtype=bool)
            base_mask = us < overlay.n_base
            if base_mask.any():
                ans[base_mask] = self._base_probe(
                    us[base_mask], rects[base_mask]
                )
            if overlay.is_empty():
                return ans
            extra_qi: List[int] = []
            extra_u: List[int] = []
            with span("dynamic.overlay", cat="dynamic", n=B):
                for i in range(B):
                    if ans[i]:
                        continue
                    reached, new_reached, entries = self._expand_from(
                        int(us[i]))
                    # staging probe: any staged venue in R whose
                    # component (or post-snapshot vertex) was reached?
                    cand = overlay.staging.candidates_in(rects[i])
                    if cand.size:
                        cb = cand[cand < overlay.n_base]
                        if cb.size and np.isin(
                                self._comp[cb], reached).any():
                            ans[i] = True
                            continue
                        if any(int(w) in new_reached
                               for w in cand[cand >= overlay.n_base]):
                            ans[i] = True
                            continue
                    # entry components: base reach opened by delta edges.
                    # comp(u)'s own probe already ran in step 1 — skip it.
                    cu = int(self._comp[us[i]]) if base_mask[i] else -1
                    for t in entries:
                        if int(self._comp[t]) == cu:
                            continue
                        extra_qi.append(i)
                        extra_u.append(t)
            if extra_u:
                got = self._base_probe(
                    np.asarray(extra_u, dtype=np.int64),
                    rects[np.asarray(extra_qi, dtype=np.int64)],
                )
                np.logical_or.at(ans, np.asarray(extra_qi), got)
            return ans

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])

    # -- analytics query classes (queries over base ∪ overlay) -----------
    #
    # Each class decomposes like the boolean query: a base probe through
    # the static index (device engine when configured), an overlay
    # expansion yielding the extra entry components whose base reach only
    # delta edges open, and the staged-venue side.  Staged venues are
    # disjoint from base venues (staging holds only vertices that were
    # not spatial in the base snapshot), so *counts add* across the two
    # sides; multiple base probes can overlap, so whenever entry probes
    # exist the base side switches to an uncapped *collect union*
    # (exact dedup) instead of adding counts.  kNN heap-merges the base
    # candidates against the staged side.

    def _require_2dreach(self, what: str) -> None:
        if not self.method.startswith("2dreach"):
            raise ValueError(
                f"no {what!r} query class for DynamicIndex over method "
                f"{self.method!r}: the analytics classes serve the "
                f"2DReach variants only")

    def _check_query_range(self, us: np.ndarray) -> None:
        if us.size and (us.min() < 0
                        or us.max() >= self._overlay.n_nodes):
            raise IndexError("query vertex out of range")

    def _staged_arrays(self):
        st = self._overlay.staging
        return (np.asarray(st.ids, dtype=np.int64), st.coords_of())

    def _staged_reached_mask(self, sid: np.ndarray, reached, new_reached
                             ) -> np.ndarray:
        n_base = self._overlay.n_base
        keep = np.zeros(len(sid), dtype=bool)
        base = sid < n_base
        if base.any():
            keep[base] = np.isin(self._comp[sid[base]], reached)
        for j in np.nonzero(~base)[0]:
            keep[j] = int(sid[j]) in new_reached
        return keep

    def _merge_probes(self, u: int, is_base: bool):
        """(expansion, extra entry probes) for one query vertex — the
        entry list minus the component the step-1 base probe covers."""
        reached, new_reached, entries = self._expand_from(int(u))
        cu = int(self._comp[u]) if is_base else -1
        extra = [int(t) for t in entries if int(self._comp[t]) != cu]
        return reached, new_reached, extra

    def _base_analytics(self, method: str):
        """Bound base-probe callable: the device engine's batched class
        when the engine exposes it, the host descent otherwise (the
        cluster ShardedEngine serves boolean only)."""
        from ..queries import host as qhost

        eng = self._base_engine
        if eng is not None and hasattr(eng, method):
            return getattr(eng, method)
        return {
            "count_batch": lambda us, rects: qhost.range_count_host(
                self._index, us, rects),
            "collect_batch": lambda us, rects, k: qhost.range_collect_host(
                self._index, us, rects, k),
            "polygon_batch": lambda us, polys: qhost.polygon_reach_host(
                self._index, us, polys),
        }[method]

    def count_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Exact RangeCount over the mutated graph: (B,) int64."""
        self._require_2dreach("count")
        from ..queries.host import _point_in_rect, collect_csr_host

        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
        with self._lock:
            self.stats["n_queries"] += B
            overlay = self._overlay
            self._check_query_range(us)
            ans = np.zeros(B, dtype=np.int64)
            base_mask = us < overlay.n_base
            if base_mask.any():
                ans[base_mask] = self._base_analytics("count_batch")(
                    us[base_mask], rects[base_mask])
            if overlay.is_empty():
                return ans
            sid, scoord = self._staged_arrays()
            for i in range(B):
                reached, new_reached, extra = self._merge_probes(
                    int(us[i]), bool(base_mask[i]))
                st = np.zeros(0, dtype=np.int64)
                if len(sid):
                    inr = _point_in_rect(scoord, rects[i][None])
                    st = sid[inr & self._staged_reached_mask(
                        sid, reached, new_reached)]
                if not extra:
                    ans[i] += len(st)     # staged ∩ base venues = ∅
                    continue
                probes = ([int(us[i])] if base_mask[i] else []) + extra
                _, ids = collect_csr_host(
                    self._index, np.asarray(probes, dtype=np.int64),
                    np.tile(rects[i], (len(probes), 1)))
                ans[i] = len(np.unique(ids)) + len(st)
            return ans

    def collect_batch(self, us: np.ndarray, rects: np.ndarray, k: int):
        """Exact RangeCollect over the mutated graph (K smallest ids,
        exact totals, overflow flags)."""
        self._require_2dreach("collect")
        from ..queries.host import _point_in_rect, collect_csr_host
        from ..queries.program import CollectResult

        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        k = int(k)
        if k < 1:
            raise ValueError(f"collect needs k >= 1, got {k}")
        rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
        with self._lock:
            self.stats["n_queries"] += B
            overlay = self._overlay
            self._check_query_range(us)
            ids = np.full((B, k), -1, dtype=np.int32)
            counts = np.zeros(B, dtype=np.int64)
            base_mask = us < overlay.n_base
            if base_mask.any():
                br = self._base_analytics("collect_batch")(
                    us[base_mask], rects[base_mask], k)
                ids[base_mask] = br.ids
                counts[base_mask] = br.counts
            if overlay.is_empty():
                return CollectResult(ids=ids, counts=counts,
                                     overflow=counts > k)
            sid, scoord = self._staged_arrays()
            for i in range(B):
                reached, new_reached, extra = self._merge_probes(
                    int(us[i]), bool(base_mask[i]))
                st = np.zeros(0, dtype=np.int64)
                if len(sid):
                    inr = _point_in_rect(scoord, rects[i][None])
                    st = sid[inr & self._staged_reached_mask(
                        sid, reached, new_reached)]
                if not extra and len(st) == 0:
                    continue
                if not extra:
                    # K smallest of (base K-smallest ∪ staged) = the
                    # union's K smallest; totals add (disjoint sides)
                    row = np.sort(np.concatenate(
                        [ids[i][ids[i] >= 0].astype(np.int64), st]))[:k]
                    counts[i] += len(st)
                else:
                    probes = ([int(us[i])] if base_mask[i] else []) + extra
                    _, base_ids = collect_csr_host(
                        self._index, np.asarray(probes, dtype=np.int64),
                        np.tile(rects[i], (len(probes), 1)))
                    merged = np.unique(np.concatenate(
                        [base_ids.astype(np.int64), st]))
                    counts[i] = len(merged)
                    row = merged[:k]
                ids[i] = -1
                ids[i, : len(row)] = row
            return CollectResult(ids=ids, counts=counts, overflow=counts > k)

    def knn_batch(self, us: np.ndarray, points: np.ndarray, k: int):
        """Exact KNNReach over the mutated graph: the k nearest
        reachable venues by (dist², id), heap-merging base-probe
        candidates with the staged-venue side."""
        self._require_2dreach("knn")
        from ..queries.knn import _pt_d2, knn_reach_host
        from ..queries.program import KNNResult

        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        k = int(k)
        if k < 1:
            raise ValueError(f"knn needs k >= 1, got {k}")
        points = np.asarray(points, dtype=np.float32).reshape(B, 2)
        with self._lock:
            self.stats["n_queries"] += B
            overlay = self._overlay
            self._check_query_range(us)
            res = KNNResult(
                ids=np.full((B, k), -1, dtype=np.int32),
                dist2=np.full((B, k), np.inf, dtype=np.float64),
            )
            base_mask = us < overlay.n_base
            eng = self._base_engine
            use_eng = eng is not None and hasattr(eng, "knn_batch")

            def base_knn(pu, pp):
                if use_eng:
                    return eng.knn_batch(pu, pp, k)
                return knn_reach_host(self._index, pu, pp, k)

            if base_mask.any() and overlay.is_empty():
                br = base_knn(us[base_mask], points[base_mask])
                res.ids[base_mask] = br.ids
                res.dist2[base_mask] = br.dist2
                return res
            sid, scoord = self._staged_arrays()
            # one batched base probe covering every (query, entry) pair
            probe_qi, probe_us = [], []
            probe_rows: List[List[int]] = [[] for _ in range(B)]
            ctxs = []
            for i in range(B):
                reached, new_reached, extra = self._merge_probes(
                    int(us[i]), bool(base_mask[i]))
                ctxs.append((reached, new_reached, extra))
                mine = ([int(us[i])] if base_mask[i] else []) + extra
                for t in mine:
                    probe_rows[i].append(len(probe_us))
                    probe_qi.append(i)
                    probe_us.append(t)
            if probe_us:
                br = base_knn(np.asarray(probe_us, dtype=np.int64),
                              points[np.asarray(probe_qi)])
            for i in range(B):
                cand_ids, cand_d2 = [], []
                for j in probe_rows[i]:
                    keep = br.ids[j] >= 0
                    cand_ids.append(br.ids[j][keep].astype(np.int64))
                    cand_d2.append(br.dist2[j][keep])
                reached, new_reached, _ = ctxs[i]
                if len(sid):
                    keep = self._staged_reached_mask(
                        sid, reached, new_reached)
                    if keep.any():
                        cand_ids.append(sid[keep])
                        cand_d2.append(_pt_d2(scoord[keep], points[i]))
                if not cand_ids:
                    continue
                ci = np.concatenate(cand_ids)
                cd = np.concatenate(cand_d2)
                ci, first = np.unique(ci, return_index=True)  # dedup probes
                cd = cd[first]
                order = np.lexsort((ci, cd))[:k]
                res.ids[i, : len(order)] = ci[order]
                res.dist2[i, : len(order)] = cd[order]
            return res

    def polygon_batch(self, us: np.ndarray, polygons) -> np.ndarray:
        """Exact convex-polygon RangeReach over the mutated graph."""
        self._require_2dreach("polygon")
        from ..core.polygon import (
            convex_halfplanes,
            points_in_polygon_region,
            polygon_bbox,
        )

        us = np.asarray(us, dtype=np.int64)
        B = len(us)
        if len(polygons) != B:
            raise ValueError(f"{len(polygons)} polygons for {B} queries")
        with self._lock:
            self.stats["n_queries"] += B
            overlay = self._overlay
            self._check_query_range(us)
            ans = np.zeros(B, dtype=bool)
            base_mask = us < overlay.n_base
            base_poly = self._base_analytics("polygon_batch")
            if base_mask.any():
                ans[base_mask] = base_poly(
                    us[base_mask], [polygons[i]
                                    for i in np.nonzero(base_mask)[0]])
            if overlay.is_empty():
                return ans
            sid, scoord = self._staged_arrays()
            # one batched base probe for every (query, entry) pair, as
            # the boolean path does with extra_qi/extra_u
            extra_qi, extra_us, extra_polys = [], [], []
            for i in range(B):
                if ans[i]:
                    continue
                reached, new_reached, extra = self._merge_probes(
                    int(us[i]), bool(base_mask[i]))
                if len(sid):
                    keep = self._staged_reached_mask(
                        sid, reached, new_reached)
                    if keep.any() and points_in_polygon_region(
                            scoord[keep], polygon_bbox(polygons[i]),
                            convex_halfplanes(polygons[i])).any():
                        ans[i] = True
                        continue
                for t in extra:
                    extra_qi.append(i)
                    extra_us.append(t)
                    extra_polys.append(polygons[i])
            if extra_us:
                got = base_poly(
                    np.asarray(extra_us, dtype=np.int64), extra_polys)
                np.logical_or.at(ans, np.asarray(extra_qi), got)
            return ans

    # -- compaction -----------------------------------------------------

    def compact(self, background: Optional[bool] = None) -> bool:
        """Force a compaction now; returns False if a background build is
        already in flight."""
        bg = self.policy.background if background is None else background
        return self._compactor.trigger(bg)

    def join_compaction(self, timeout: Optional[float] = None) -> None:
        self._compactor.join(timeout)

    @property
    def compacting(self) -> bool:
        return self._compactor.running

    @property
    def compaction_error(self):
        """Exception latched by a failed background build (None when
        healthy); an explicit ``compact()`` clears it and retries."""
        return self._compactor.last_error

    def maybe_compact(self) -> bool:
        """Apply the policy; called automatically after each mutation.
        Suppressed while a build runs or after one failed (the error
        stays latched until an explicit ``compact()`` retries)."""
        if self._compactor.running or self._compactor.last_error is not None:
            return False
        o = self._overlay
        if self.policy.should_compact(
            o.n_edges, o.n_staged,
            int(self.stats["updates_since_compaction"]),
        ):
            return self.compact()
        return False

    def nbytes(self) -> dict:
        from ..core.api import index_nbytes

        base = index_nbytes(self._index)
        ov = self._overlay.nbytes()
        return {**base, "overlay": ov,
                "total": int(base["total"]) + int(ov)}

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _count_update(self, kind: str) -> None:
        # replayed ops were already counted when first applied; they only
        # contribute to the new overlay's staleness
        self.stats["updates_since_compaction"] += 1
        if not self._replaying:
            self.stats["n_updates"] += 1
            self.stats[kind] += 1
            self.maybe_compact()

    def _covered_now(self, v: int, cur: int, new_reached: set) -> bool:
        if v < self._overlay.n_base:
            return self._stamp_arr[self._comp[v]] == cur
        return v in new_reached

    def _exp_covers(self, exp: _Expansion, v: int) -> bool:
        reached, new_reached, _ = exp
        if v < self._overlay.n_base:
            c = int(self._comp[v])
            j = int(np.searchsorted(reached, c))
            return j < len(reached) and reached[j] == c
        return v in new_reached

    def _expand_from(self, u: int) -> _Expansion:
        """Reach of u over base ∪ overlay at component granularity.

        Memoised per union-find representative of u's element; the cache
        entry stays valid until a delta edge grows a set that covers its
        source (see ``_invalidate_covering``).
        """
        overlay = self._overlay
        uf = overlay.uf
        elem = overlay.elem_of_vertex(u, self._comp)
        key = uf.find(elem)
        hit = self._cache.get(key)
        if hit is not None:
            self.stats["cache_hits"] += 1
            return hit
        self.stats["cache_misses"] += 1

        self._stamp += 1
        cur = self._stamp
        starr = self._stamp_arr
        d = self._d
        n_base = overlay.n_base
        indptr, adj = self._dag_indptr, self._dag_adj
        reached_list: List[int] = []
        new_reached: set = set()
        entries: List[int] = []
        stack: List[int] = []

        def cover(e: int, covered_primary: int = -1) -> None:
            # mark every member of e's group reached; base-comp members
            # other than ``covered_primary`` (whose base reach an already
            # issued probe covers) become entry components
            for m in uf.group(e):
                if m < d:
                    if starr[m] != cur:
                        starr[m] = cur
                        reached_list.append(m)
                        stack.append(m)
                        if m != covered_primary:
                            entries.append(int(self._comp_rep[m]))
                else:
                    new_reached.add(n_base + (m - d))

        # the start component gets an entry probe too: the memo is shared
        # across every vertex of the group, so it must be covering on its
        # own (consumers skip the probe redundant with their step-1 one)
        cover(elem)

        delta_edges = overlay.edges
        while True:
            while stack:
                c = stack.pop()
                for nb in adj[indptr[c]:indptr[c + 1]]:
                    nb = int(nb)
                    if starr[nb] != cur:
                        # base-DAG successor: reach subset of c's, which
                        # is already covered -> nb needs no entry probe,
                        # but group co-members do
                        cover(nb, covered_primary=nb)
            progressed = False
            for (s, t) in delta_edges:
                if self._covered_now(s, cur, new_reached) \
                        and not self._covered_now(t, cur, new_reached):
                    cover(overlay.elem_of_vertex(t, self._comp))
                    progressed = True
            if not progressed and not stack:
                break

        exp: _Expansion = (
            np.sort(np.asarray(reached_list, dtype=np.int64)),
            frozenset(new_reached),
            tuple(entries),
        )
        if len(self._cache) >= _REACH_CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = exp
        return exp

    def _invalidate_covering(self, s: int) -> None:
        """Drop memoised expansions that cover s — the only ones a new
        edge out of s can grow — plus entries whose key is no longer a
        union-find representative."""
        uf = self._overlay.uf
        dead = [k for k, exp in self._cache.items()
                if self._exp_covers(exp, s) or uf.find(k) != k]
        for k in dead:
            del self._cache[k]
        self.stats["n_cache_invalidations"] += len(dead)

    # -- compaction internals ------------------------------------------

    def _materialise(self) -> GeosocialGraph:
        o = self._overlay
        g = self._graph
        n = o.n_nodes
        if o.edges:
            edges = np.concatenate(
                [g.edges, np.asarray(o.edges, dtype=np.int64).reshape(-1, 2)]
            )
        else:
            edges = g.edges
        coords = np.zeros((n, 2), dtype=np.float32)
        coords[: o.n_base] = g.coords
        sm = np.zeros(n, dtype=bool)
        sm[: o.n_base] = g.spatial_mask
        if len(o.staging):
            ids = np.asarray(o.staging.ids, dtype=np.int64)
            coords[ids] = o.staging.coords_of()
            sm[ids] = True
        return make_graph(n, edges, coords, sm)

    def _begin_compaction(self):
        with self._lock:
            return self._materialise(), len(self._oplog)

    def _build_static(self, snapshot: GeosocialGraph):
        from ..core.api import build_index

        with span("dynamic.compaction_build", cat="dynamic",
                  n=snapshot.n_nodes):
            fault_point("dynamic.compaction.build", n=snapshot.n_nodes)
            index = build_index(snapshot, self.method, **self._build_kw)
            fault_point("dynamic.compaction.mid_build")
            substrate = self._build_reach_substrate(snapshot)
        return index, substrate

    #: everything the swap rebinds — a crash anywhere inside the swap
    #: restores exactly these (plus a stats copy), so a failed
    #: compaction leaves the index serving the pre-swap state
    _SWAP_ATTRS = (
        "_graph", "_index", "_comp", "_d", "_dag_indptr", "_dag_adj",
        "_comp_rep", "_overlay", "_stamp_arr", "_stamp", "_cache",
        "_base_engine", "_oplog",
    )

    def _finish_compaction(self, snapshot, built, cut: int,
                           t_build: float) -> None:
        index, substrate = built
        with self._lock, span("dynamic.compaction_swap", cat="dynamic"):
            fault_point("dynamic.compaction.pre_swap")
            saved = {a: getattr(self, a) for a in self._SWAP_ATTRS}
            saved_stats = dict(self.stats)
            tail = self._oplog[cut:]
            try:
                self._install_base(snapshot, index, substrate)
                self._oplog = []
                self.stats["n_compactions"] += 1
                self.stats["t_compaction_total"] += t_build
                self.stats["t_last_compaction"] = t_build
                self.stats["updates_since_compaction"] = 0
                fault_point("dynamic.compaction.mid_swap")
                # replay mutations that raced the (background) build
                self._replaying = True
                try:
                    fault_point("dynamic.compaction.replay", n=len(tail))
                    for op in tail:
                        if op[0] == "edge":
                            self.add_edge(op[1], op[2])
                        elif op[0] == "vertex":
                            self.add_vertex(op[1])
                        else:  # spatial
                            self.add_spatial(op[1], (op[2], op[3]))
                finally:
                    self._replaying = False
            except BaseException:
                # atomic swap: every rebound attribute points back at
                # the untouched pre-swap objects (the old overlay still
                # holds the tail ops, the old op log still records
                # them), so queries keep answering exactly
                for a in self._SWAP_ATTRS:
                    setattr(self, a, saved[a])
                self.stats.clear()
                self.stats.update(saved_stats)
                if index is not saved["_index"]:
                    self._release_engines(index)
                raise
            if index is not saved["_index"]:
                self._release_engines(saved["_index"])

    def _compact_sync(self) -> None:
        snapshot, cut = self._begin_compaction()
        t0 = time.perf_counter()
        built = self._build_static(snapshot)
        self._finish_compaction(snapshot, built, cut,
                                time.perf_counter() - t0)

    # -- reporting ------------------------------------------------------

    def report(self) -> dict:
        """Stats + derived amortisation numbers."""
        s = dict(self.stats)
        o = self._overlay
        s.update(
            overlay_edges=o.n_edges,
            overlay_staged=o.n_staged,
            overlay_new_vertices=o.n_new_vertices,
            overlay_size=self.overlay_size,
            reach_cache_entries=len(self._cache),
        )
        if s["n_updates"]:
            s["amortized_compaction_us_per_update"] = (
                s["t_compaction_total"] / s["n_updates"] * 1e6
            )
        return s
