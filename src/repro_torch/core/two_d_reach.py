"""2DReach — the paper's contribution (Section 4), host build.

A port of ``repro.core.two_d_reach``.  Three variants, exactly as
evaluated in the paper's Section 5:

* ``base``     2DREACH          — SCC decomposition of the *full* graph,
  one 2-D R-tree per component over its reachable spatial set (no
  sharing), a per-vertex pointer to the component's tree.
* ``comp``     2DREACH-COMP     — spatial sinks excluded from the
  decomposition (Alg. 1 line 4 includes spatial out-neighbours instead);
  components with empty reachable sets are dropped; a parent whose
  reachable set equals one of its children's shares the child's R-tree.
  Queries special-case spatial query vertices (Alg. 2).
* ``pointer``  2DREACH-POINTER  — like ``comp`` but pointers are stored
  only per component-with-a-tree, located through a bit vector + rank
  (popcount) structure rather than a per-vertex array.

Beyond-paper option ``dedup="global"`` shares trees between *any* two
components with identical reachable sets (not only parent/child).

The build runs on the host in NumPy (the index build is offline, exactly
as in the paper), or with ``backend="device"`` runs its two expensive
stages — the closure and the forest bulk load — in torch on a device;
serving runs on the GPU through :class:`repro_torch.core.engine.QueryEngine`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import span
from .condensation import Condensation, condense
from .graph import GeosocialGraph
from .reachability import (
    ClosureResult,
    _ragged_arange,
    closure_bitset_mm,
    closure_np,
    popcount32 as _popcount32,
    unpack_rows,
)
from .rtree import (
    DEFAULT_FANOUT,
    RTreeForest,
    build_forest,
    build_forest_device,
    query_host,
)
from .scc import scc_np

BUILD_BACKENDS = ("host", "device")


# --------------------------------------------------------------------------
# Bit-vector + rank (the Pointer variant's lookup structure)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BitRank:
    """Succinct membership + rank over [0, d): ``rank(i)`` = number of set
    bits strictly below i.  One uint32 word per 32 ids plus one int32
    exclusive-prefix popcount per word."""

    bits: np.ndarray   # (ceil(d/32),) uint32
    rank: np.ndarray   # (ceil(d/32),) int32 — popcount of all lower words

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "BitRank":
        d = len(mask)
        W = (d + 31) // 32
        pad = np.zeros(W * 32, dtype=bool)
        pad[:d] = mask
        by = np.packbits(pad.reshape(W, 4, 8)[..., ::-1], axis=-1)
        bits = np.ascontiguousarray(by.reshape(W, 4)).view(np.uint32).ravel()
        pc = _popcount32(bits)
        rank = np.zeros(W, dtype=np.int64)
        np.cumsum(pc[:-1], out=rank[1:])
        return cls(bits=bits, rank=rank.astype(np.int32))

    def test_rank(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(member?, rank) for each id — vectorised popcount lookup, the
        faithful reproduction of the Pointer variant's extra query work."""
        ids = np.asarray(ids, dtype=np.int64)
        w, b = ids // 32, (ids % 32).astype(np.uint32)
        word = self.bits[w]
        member = (word >> b) & np.uint32(1) > 0
        below = word & ((np.uint32(1) << b) - np.uint32(1))
        return member, self.rank[w].astype(np.int64) + _popcount32(below)

    def nbytes(self) -> int:
        return int(self.bits.nbytes + self.rank.nbytes)


# --------------------------------------------------------------------------
# Index container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TwoDReachIndex:
    variant: str                    # base | comp | pointer
    n: int
    coords: np.ndarray              # (n, 2)
    excluded: np.ndarray            # (n,) bool — spatial sinks (comp/pointer)
    vertex_comp: np.ndarray         # (n,) int32; -1 for excluded vertices
    cond: Optional[Condensation]  # None for an index carried across
    forest: RTreeForest
    comp_tree: np.ndarray           # (d,) int32 tree id or -1
    vertex_tree: Optional[np.ndarray]  # (n,) int64 per-vertex pointer
    bitrank: Optional[BitRank]      # pointer variant lookup
    tree_ptrs: Optional[np.ndarray]  # compacted (n_with_tree,) int32
    stats: Dict[str, Any]
    backend: str = "host"           # build backend that produced this index

    # -- sizes (Table 4 decomposition) ------------------------------------
    def nbytes_rtree(self) -> int:
        return self.forest.nbytes_total()

    def nbytes_pointers(self) -> int:
        if self.variant == "pointer":
            return int(self.bitrank.nbytes() + self.tree_ptrs.nbytes)
        return int(self.vertex_tree.nbytes)

    def nbytes_total(self) -> int:
        return self.nbytes_rtree() + self.nbytes_pointers()

    # -- queries -----------------------------------------------------------
    def lookup_tree(self, u: np.ndarray) -> np.ndarray:
        """(B,) vertex ids -> (B,) tree ids (-1: no tree / excluded)."""
        u = np.asarray(u, dtype=np.int64)
        if self.variant == "pointer":
            c = self.vertex_comp[u]
            ok = c >= 0
            out = np.full(len(u), -1, dtype=np.int64)
            if ok.any():
                member, rank = self.bitrank.test_rank(np.maximum(c[ok], 0))
                t = np.where(member, self.tree_ptrs[np.minimum(
                    rank, len(self.tree_ptrs) - 1)], -1)
                out[ok] = t
            return out
        return self.vertex_tree[u]

    def query_batch(self, us: np.ndarray, rects: np.ndarray) -> np.ndarray:
        """Host batched RangeReach (Alg. 2). us (B,), rects (B, 4)."""
        us = np.asarray(us, dtype=np.int64)
        rects = np.asarray(rects, dtype=np.float32).reshape(len(us), 4)
        ans = np.zeros(len(us), dtype=bool)
        exc = self.excluded[us]
        if exc.any():
            pts = self.coords[us[exc]]
            r = rects[exc]
            ans[exc] = (
                (pts[:, 0] >= r[:, 0]) & (pts[:, 0] <= r[:, 2])
                & (pts[:, 1] >= r[:, 1]) & (pts[:, 1] <= r[:, 3])
            )
        rest = ~exc
        if rest.any():
            tid = self.lookup_tree(us[rest])
            ans[rest] = query_host(self.forest, tid, rects[rest])
        return ans

    def query(self, u: int, rect) -> bool:
        return bool(self.query_batch(np.array([u]), np.array([rect]))[0])


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def build_2dreach(
    graph: GeosocialGraph,
    variant: str = "comp",
    fanout: int = DEFAULT_FANOUT,
    dedup: str = "paper",
    backend: str = "host",
    device: DeviceLike = None,
    device_kernel: Optional[str] = None,
) -> TwoDReachIndex:
    """Construct the 2DReach index (paper Alg. 1 + §4.1 compression).
    Produces the same arrays as ``repro.core.build_2dreach``, bit for
    bit, with either backend.

    backend: ``"host"`` builds everything in NumPy.  ``"device"`` runs
             the closure as a level-scheduled packed OR-AND fixpoint
             (``closure_bitset_mm``, K7) and the forest bulk load as a
             sort plus segmented-MBR reduction (``build_forest_device``,
             K8) on ``device``, and leaves the serving arrays there, so
             a ``QueryEngine`` on that device adopts them without an
             upload.
    device:  where ``backend="device"`` runs (``None``: the GPU; raises
             where CUDA is absent); ignored for ``backend="host"``.
    device_kernel: the device closure's arm, ``"bitset_mm"`` (K7; also
             for ``None``) or ``"gather"`` (the reference's ``"xla"``);
             recorded as ``stats["closure_kernel"]``.  The forest's bulk
             load is K8 either way; ignored for ``backend="host"``.
    """
    assert variant in ("base", "comp", "pointer")
    assert dedup in ("paper", "global", "none")
    if backend not in BUILD_BACKENDS:
        raise ValueError(
            f"unknown build backend {backend!r}; expected one of "
            f"{BUILD_BACKENDS}")
    dev = resolve_device(device) if backend == "device" else None
    t_start = time.perf_counter()
    n = graph.n_nodes
    stats: Dict[str, Any] = {}
    if backend == "device":
        stats["closure_kernel"] = device_kernel or "bitset_mm"

    # ---- decomposition ---------------------------------------------------
    t0 = time.perf_counter()
    with span("build.scc", cat="build", n=n, variant=variant):
        if variant == "base":
            excluded = np.zeros(n, dtype=bool)
            dec_edges = graph.edges
            include = None
        else:
            excluded = graph.spatial_sink_mask()
            e = graph.edges
            keep = ~(excluded[e[:, 0]] | excluded[e[:, 1]])
            dec_edges = e[keep]
            include = ~excluded
        labels = scc_np(n, dec_edges)
        cond = condense(n, dec_edges, labels, include_mask=include)
    stats["t_scc"] = time.perf_counter() - t0

    # ---- reachable-set closure (Alg. 1) ----------------------------------
    t0 = time.perf_counter()
    spatial_ids = graph.spatial_ids
    extra = None
    if variant != "base":
        # Alg. 1 line 4 (modified): excluded spatial out-neighbours join
        # the component's own set
        e = graph.edges
        m = excluded[e[:, 1]] & ~excluded[e[:, 0]]
        if m.any():
            src_c = cond.comp[e[m, 0]]
            ok = src_c >= 0
            extra = (e[m, 1][ok], src_c[ok])
    with span("build.closure", cat="build", backend=backend):
        if backend == "device":
            clo = closure_bitset_mm(cond, n, spatial_ids,
                                    extra_vertex_comp=extra,
                                    kernel=stats["closure_kernel"],
                                    device=dev)
        else:
            clo = closure_np(cond, n, spatial_ids, extra_vertex_comp=extra)
    stats["t_closure"] = time.perf_counter() - t0

    # ---- tree assignment (+ sharing) --------------------------------------
    t0 = time.perf_counter()
    d = cond.n_comps
    with span("build.assign", cat="build", dedup=dedup):
        comp_tree, tree_indptr, cols_flat, n_shared = _assign_trees(
            cond, clo, variant=variant, dedup=dedup
        )
    n_tree = len(tree_indptr) - 1
    stats["t_assign"] = time.perf_counter() - t0

    # ---- forest bulk load --------------------------------------------------
    t0 = time.perf_counter()
    lens = np.diff(tree_indptr)
    vid = clo.spatial_vertex[cols_flat.astype(np.int64)]
    pts = graph.coords[vid]
    boxes = np.concatenate([pts, pts], axis=1)
    tree_of_entry = np.repeat(np.arange(n_tree), lens)
    ext = graph.spatial_extent()
    extent = np.array([ext[0], ext[1], ext[2], ext[3]], dtype=np.float32)
    with span("build.forest", cat="build", backend=backend,
              trees=int(n_tree), entries=int(len(vid))):
        if backend == "device":
            forest = build_forest_device(
                boxes, vid.astype(np.int32), tree_of_entry, n_tree,
                fanout=fanout, extent=extent, device=dev)
            if dev.type == "cuda":  # the pyramid's kernels have finished
                torch.cuda.synchronize(dev)
        else:
            forest = build_forest(
                boxes, vid.astype(np.int32), tree_of_entry, n_tree,
                fanout=fanout, extent=extent,
            )
    stats["t_forest"] = time.perf_counter() - t0

    # ---- pointers ----------------------------------------------------------
    t0 = time.perf_counter()
    vertex_tree: Optional[np.ndarray] = None
    bitrank: Optional[BitRank] = None
    tree_ptrs: Optional[np.ndarray] = None
    with span("build.pointers", cat="build", variant=variant):
        if variant in ("base", "comp"):
            vertex_tree = np.full(n, -1, dtype=np.int64)
            inc = cond.comp >= 0
            vertex_tree[inc] = comp_tree[cond.comp[inc]]
        else:
            has = comp_tree >= 0
            bitrank = BitRank.from_mask(has)
            tree_ptrs = comp_tree[has].astype(np.int32)
            if len(tree_ptrs) == 0:
                tree_ptrs = np.zeros(1, dtype=np.int32)  # rank-lookup safety
    stats["t_pointers"] = time.perf_counter() - t0
    stats["t_total"] = time.perf_counter() - t_start

    # Table 2 statistics
    nonspatial_comp = np.ones(d, dtype=bool)
    sc = cond.comp[spatial_ids]
    nonspatial_comp[sc[sc >= 0]] = False
    stats["n_comps"] = float(d)
    stats["user_comps"] = float(nonspatial_comp.sum())
    stats["distinct_rtrees"] = float(n_tree)
    stats["shared_trees"] = float(n_shared)

    return TwoDReachIndex(
        variant=variant,
        n=n,
        coords=graph.coords,
        excluded=excluded,
        vertex_comp=cond.comp,
        cond=cond,
        forest=forest,
        comp_tree=comp_tree,
        vertex_tree=vertex_tree,
        bitrank=bitrank,
        tree_ptrs=tree_ptrs,
        stats=stats,
        backend=backend,
    )


def _comp_cols_csr(clo: ClosureResult) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, cols) of reachable spatial columns for *every*
    component — the vectorised equivalent of calling ``comp_set_cols``
    per component (interior rows unpacked chunk-wise, one ``nonzero``
    per chunk instead of one per component)."""
    d = len(clo.interior_row)
    counts = np.diff(clo.own_indptr).astype(np.int64)
    n_int = clo.bits.shape[0]
    irow = icol = None
    int_cnt = None
    row_comp = None
    if n_int:
        ii = np.nonzero(clo.interior_row >= 0)[0]
        row_comp = np.empty(n_int, dtype=np.int64)
        row_comp[clo.interior_row[ii]] = ii
        chunk = max(1, (1 << 25) // max(1, clo.p))
        rows_l, cols_l = [], []
        for s in range(0, n_int, chunk):
            r, c = np.nonzero(unpack_rows(clo.bits[s:s + chunk], clo.p))
            rows_l.append(r.astype(np.int64) + s)
            cols_l.append(c.astype(np.int32))
        irow = np.concatenate(rows_l)
        icol = np.concatenate(cols_l)
        int_cnt = np.bincount(irow, minlength=n_int).astype(np.int64)
        counts[row_comp] = int_cnt
    indptr = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = np.empty(int(indptr[-1]), dtype=np.int32)
    if n_int and len(irow):
        grp = np.zeros(n_int + 1, dtype=np.int64)
        np.cumsum(int_cnt, out=grp[1:])
        within = np.arange(len(irow), dtype=np.int64) - grp[irow]
        cols[indptr[row_comp[irow]] + within] = icol
    leaf = clo.interior_row < 0
    own_cnt = np.diff(clo.own_indptr)
    lcomp = np.nonzero(leaf & (own_cnt > 0))[0]
    if lcomp.size:
        cnt = own_cnt[lcomp].astype(np.int64)
        within = _ragged_arange(cnt)
        dest = np.repeat(indptr[lcomp], cnt) + within
        src = np.repeat(clo.own_indptr[lcomp], cnt) + within
        cols[dest] = clo.own_cols[src]
    return indptr, cols


def _hash_sets(indptr: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """(d,) order-independent 64-bit hash of each CSR column set —
    mixed per element, combined by modular sum + xor + cardinality.
    Equal sets always hash equal; callers byte-compare on collision."""

    def mix(x: np.ndarray) -> np.ndarray:
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xFF51AFD7ED558CCD)
        x ^= x >> np.uint64(33)
        x *= np.uint64(0xC4CEB9FE1A85EC53)
        x ^= x >> np.uint64(33)
        return x

    h = mix(cols.astype(np.uint64))
    csum = np.zeros(len(h) + 1, dtype=np.uint64)
    np.cumsum(h, out=csum[1:])
    cxor = np.zeros(len(h) + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(h, out=cxor[1:])
    s = csum[indptr[1:]] - csum[indptr[:-1]]
    x = cxor[indptr[1:]] ^ cxor[indptr[:-1]]
    n = (indptr[1:] - indptr[:-1]).astype(np.uint64)
    return mix(s * np.uint64(3) ^ x ^ mix(n))


def _assign_trees(
    cond: Condensation,
    clo: ClosureResult,
    variant: str,
    dedup: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Map each component to a tree id; returns ``(comp_tree,
    tree_indptr, tree_cols, n_shared)`` with the per-tree column lists
    in CSR form.

    Fully vectorised: sharing candidates come from hash + cardinality
    equality (``_hash_sets``), are verified by an exact ragged
    element-wise compare (``np.logical_and.reduceat`` over the flattened
    candidate pairs), and share *chains* resolve by pointer doubling —
    no per-component Python loop anywhere.  Produces the same output as
    ``repro.core.two_d_reach._assign_trees``, including tree id
    numbering and the shared-tree count.
    """
    d = cond.n_comps
    comp_tree = np.full(d, -1, dtype=np.int32)
    nonempty = clo.comp_nonempty()
    share = (variant != "base") and (dedup != "none")

    indptr, cols_all = _comp_cols_csr(clo)
    sizes = np.diff(indptr)

    if not share:
        # one tree per nonempty comp, in comp id order
        creators = np.nonzero(nonempty)[0]
        root = np.arange(d, dtype=np.int64)
    elif dedup == "paper":
        hashes = _hash_sets(indptr, cols_all)
        child = _paper_share_children(
            cond, nonempty, indptr, cols_all, sizes, hashes)
        root = _resolve_share_roots(child)
        # tree ids are assigned in host processing order: descending
        # level, stable — children strictly before parents
        order = np.argsort(-cond.level, kind="stable")
        creators_mask = nonempty & (child < 0)
        creators = order[creators_mask[order]]
    else:  # dedup == "global": one tree per distinct set anywhere
        hashes = _hash_sets(indptr, cols_all)
        root = _global_share_reps(nonempty, indptr, cols_all, sizes, hashes)
        creators = np.nonzero(nonempty & (root == np.arange(d)))[0]

    tid = np.full(d, -1, dtype=np.int32)
    tid[creators] = np.arange(len(creators), dtype=np.int32)
    ne = np.nonzero(nonempty)[0]
    comp_tree[ne] = tid[root[ne]]
    n_shared = int(nonempty.sum()) - len(creators)

    cnt = sizes[creators].astype(np.int64)
    tree_indptr = np.zeros(len(creators) + 1, dtype=np.int64)
    np.cumsum(cnt, out=tree_indptr[1:])
    slot = np.repeat(indptr[creators], cnt) + _ragged_arange(cnt)
    tree_cols = cols_all[slot]
    return comp_tree, tree_indptr, tree_cols, n_shared


def _verify_equal_sets(
    a: np.ndarray, b: np.ndarray,
    indptr: np.ndarray, cols_all: np.ndarray, sizes: np.ndarray,
) -> np.ndarray:
    """(k,) bool — exact element-wise equality of the column sets of
    comp pairs (a[i], b[i]); the pairs must have equal sizes > 0."""
    cnt = sizes[a].astype(np.int64)
    ar = _ragged_arange(cnt)
    ia = np.repeat(indptr[a], cnt) + ar
    ib = np.repeat(indptr[b], cnt) + ar
    eq = cols_all[ia] == cols_all[ib]
    starts = np.zeros(len(a), dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    return np.logical_and.reduceat(eq, starts)


def _paper_share_children(
    cond: Condensation, nonempty: np.ndarray,
    indptr: np.ndarray, cols_all: np.ndarray, sizes: np.ndarray,
    hashes: np.ndarray,
) -> np.ndarray:
    """(d,) chosen share child per comp (-1: own tree) — for each parent
    the first child (in DAG adjacency order) with an identical set."""
    d = cond.n_comps
    child = np.full(d, -1, dtype=np.int64)
    e = cond.dag_edges
    if e.size == 0:
        return child
    src, dst = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
    cand = (
        nonempty[src] & nonempty[dst]
        & (hashes[src] == hashes[dst]) & (sizes[src] == sizes[dst])
    )
    src, dst = src[cand], dst[cand]
    if not len(src):
        return child
    ok = _verify_equal_sets(src, dst, indptr, cols_all, sizes)
    src, dst = src[ok], dst[ok]
    if not len(src):
        return child
    # dag_edges are (src, dst)-sorted, so the first row of each src run
    # is the first matching child the reference walk would pick
    first = np.r_[True, src[1:] != src[:-1]]
    child[src[first]] = dst[first]
    return child


def _resolve_share_roots(child: np.ndarray) -> np.ndarray:
    """Resolve share chains (parent -> equal child -> ...) to their
    terminal tree-creating comp by pointer doubling.  Chains follow DAG
    edges, so they are acyclic and converge in O(log depth) rounds."""
    f = np.where(child >= 0, child, np.arange(len(child), dtype=np.int64))
    while True:
        f2 = f[f]
        if np.array_equal(f2, f):
            return f
        f = f2


def _global_share_reps(
    nonempty: np.ndarray, indptr: np.ndarray, cols_all: np.ndarray,
    sizes: np.ndarray, hashes: np.ndarray,
) -> np.ndarray:
    """(d,) representative comp per comp (itself: creates a tree).

    Groups nonempty comps by (hash, cardinality); every group member
    byte-compares against the group's lowest comp id.  Hash collisions
    (unequal sets in one group) regroup among themselves and repeat —
    each round retires at least its representatives, so the loop
    terminates; in practice one round resolves everything."""
    d = len(sizes)
    rep = np.arange(d, dtype=np.int64)
    pending = np.nonzero(nonempty)[0]
    while len(pending) > 1:
        order = np.lexsort((pending, sizes[pending], hashes[pending]))
        ps = pending[order]
        new_grp = np.r_[
            True,
            (hashes[ps][1:] != hashes[ps][:-1])
            | (sizes[ps][1:] != sizes[ps][:-1]),
        ]
        reps = ps[new_grp]                       # lowest id per group
        my = reps[np.cumsum(new_grp) - 1]
        member = ps != my
        mm, rr = ps[member], my[member]
        if not len(mm):
            break
        ok = _verify_equal_sets(mm, rr, indptr, cols_all, sizes)
        rep[mm[ok]] = rr[ok]
        pending = mm[~ok]
    return rep
