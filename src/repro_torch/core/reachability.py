"""Reachable-spatial-set closure over the SCC condensation (paper Alg. 1).

A copy of the host half of ``repro.core.reachability`` (the packed
uint32 bitset helpers, :class:`ClosureResult`, ``closure_np`` and the
GeoReach baseline's ``closure_mbr_np``) and a torch port of its device
half: ``closure_bitset_mm``, the same fixpoint with each level's merges
as one packed OR-AND product (K7 on the card) or as a gather and a
halving OR (``kernel="gather"``), and ``closure_torch``, the boolean
sweep closure of ``closure_jax``.

Every component's reachable spatial set is a row of a packed **uint32
bitset matrix** ``(rows, W)`` with ``W = ceil(p / 32)`` and one column
per spatial vertex.  "Merging a child's set" is a bitwise OR of rows,
and one *level* of the DAG (all components at equal longest-path depth)
is merged in a single vectorised segment-OR sweep, levels descending
(the reverse-topological order of Alg. 1).  *Leaf* components (no DAG
out-edges) never get a row: their reachable set is their own member
list.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.bitset_mm import bitset_mm
from .condensation import Condensation

CLOSURE_KERNELS = ("bitset_mm", "gather")

# --------------------------------------------------------------------------
# Bit packing helpers
# --------------------------------------------------------------------------

def n_words(p: int) -> int:
    return (p + 31) // 32


def pack_rows(rows_bool: np.ndarray) -> np.ndarray:
    """(r, p) bool -> (r, W) uint32, bit j of word w = column 32*w + j."""
    rows_bool = np.asarray(rows_bool, dtype=bool)
    r, p = rows_bool.shape
    W = n_words(p)
    padded = np.zeros((r, W * 32), dtype=bool)
    padded[:, :p] = rows_bool
    b = padded.reshape(r, W, 4, 8)
    # np.packbits packs MSB-first per byte; flip for LSB-first bit order
    by = np.packbits(b[..., ::-1], axis=-1).reshape(r, W, 4)
    return by.view(np.uint32).reshape(r, W) if by.flags.c_contiguous else (
        np.ascontiguousarray(by).view(np.uint32).reshape(r, W))


def unpack_rows(bits: np.ndarray, p: int) -> np.ndarray:
    """(r, W) uint32 -> (r, p) bool."""
    bits = np.asarray(bits, dtype=np.uint32)
    r, W = bits.shape
    by = np.ascontiguousarray(bits).view(np.uint8).reshape(r, W, 4)
    bl = np.unpackbits(by, axis=-1).reshape(r, W, 4, 8)[..., ::-1]
    return bl.reshape(r, W * 32)[:, :p].astype(bool)


def set_bits(bits: np.ndarray, row: np.ndarray, col: np.ndarray) -> None:
    """In-place bits[row] |= (1 << col)."""
    np.bitwise_or.at(
        bits, (row, col // 32), (np.uint32(1) << (col % 32).astype(np.uint32))
    )


def popcount32(x: np.ndarray) -> np.ndarray:
    """Element-wise SWAR popcount of uint32 words -> int64."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def row_popcount(bits: np.ndarray) -> np.ndarray:
    """(r, W) uint32 -> (r,) int64 number of set bits.

    SWAR per word — no 32x bool expansion like ``np.unpackbits``."""
    return popcount32(bits).sum(axis=1)


def nonzero_cols(bits_row: np.ndarray, p: int) -> np.ndarray:
    """Columns set in a single (W,) uint32 row."""
    return np.nonzero(unpack_rows(bits_row[None, :], p)[0])[0].astype(np.int32)


# --------------------------------------------------------------------------
# Closure input: which components get bitset rows
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClosureResult:
    """Per-component reachable spatial sets in split representation.

    Components with DAG out-edges ("interior") have a packed bitset row;
    leaf components (the overwhelming majority in LBSNs — every venue sink)
    are represented implicitly by their own member column lists.
    """

    p: int                       # number of spatial columns
    spatial_vertex: np.ndarray   # (p,) vertex id of each column
    col_of_vertex: np.ndarray    # (n,) column id or -1
    interior_row: np.ndarray     # (d,) row idx into ``bits`` or -1 (leaf)
    bits: np.ndarray             # (n_interior, W) uint32 closure rows
    own_indptr: np.ndarray       # (d+1,) CSR of own spatial columns per comp
    own_cols: np.ndarray         # (sum,) int32 columns

    def comp_set_cols(self, c: int) -> np.ndarray:
        """Reachable spatial columns of component ``c`` (exact)."""
        r = self.interior_row[c]
        if r >= 0:
            return nonzero_cols(self.bits[r], self.p)
        return self.own_cols[self.own_indptr[c]:self.own_indptr[c + 1]]

    def comp_nonempty(self) -> np.ndarray:
        """(d,) bool — component has at least one reachable spatial vertex."""
        d = len(self.interior_row)
        out = np.zeros(d, dtype=bool)
        leaf = self.interior_row < 0
        own_cnt = np.diff(self.own_indptr)
        out[leaf] = own_cnt[leaf] > 0
        inter = ~leaf
        if inter.any():
            pc = row_popcount(self.bits)
            out[inter] = pc[self.interior_row[inter]] > 0
        return out


def _own_columns(
    cond: Condensation,
    n: int,
    spatial_vertex: np.ndarray,
    col_of_vertex: np.ndarray,
    extra_vertex_comp: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, cols) of own spatial columns per component.

    ``extra_vertex_comp`` optionally adds (vertex_ids, comp_ids) pairs — the
    compressed variant's "spatial neighbours of n" (Alg. 1 line 4 modified).
    """
    comp_ids: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    in_dec = cond.comp[spatial_vertex] >= 0
    sv = spatial_vertex[in_dec]
    if sv.size:
        comp_ids.append(cond.comp[sv].astype(np.int64))
        cols.append(col_of_vertex[sv].astype(np.int64))
    if extra_vertex_comp is not None:
        ev, ec = extra_vertex_comp
        if len(ev):
            comp_ids.append(np.asarray(ec, dtype=np.int64))
            cols.append(col_of_vertex[np.asarray(ev)].astype(np.int64))
    if comp_ids:
        comp_all = np.concatenate(comp_ids)
        col_all = np.concatenate(cols)
        # dedup (comp, col) pairs
        key = comp_all * np.int64(len(spatial_vertex) + 1) + col_all
        _, idx = np.unique(key, return_index=True)
        comp_all, col_all = comp_all[idx], col_all[idx]
        order = np.argsort(comp_all, kind="stable")
        comp_all, col_all = comp_all[order], col_all[order]
    else:
        comp_all = np.zeros(0, dtype=np.int64)
        col_all = np.zeros(0, dtype=np.int64)
    indptr = np.zeros(cond.n_comps + 1, dtype=np.int64)
    np.cumsum(np.bincount(comp_all, minlength=cond.n_comps), out=indptr[1:])
    return indptr, col_all.astype(np.int32)


def _segment_or_rows(bits: np.ndarray, targets: np.ndarray,
                     sources: np.ndarray, presorted: bool = False) -> None:
    """``bits[targets[i]] |= bits[sources[i]]`` without an unbuffered
    scatter: contributions group by target row, OR-reduce per run with
    ``np.bitwise_or.reduceat``, and write once per unique row.

    ``presorted=True`` skips the grouping sort — the closure's per-level
    edge schedule is already source-sorted."""
    if len(targets) == 0:
        return
    if not presorted:
        order = np.argsort(targets, kind="stable")
        targets, sources = targets[order], sources[order]
    starts = np.nonzero(np.r_[True, targets[1:] != targets[:-1]])[0]
    lens = np.diff(np.r_[starts, len(targets)])
    single = lens == 1
    ss = starts[single]
    if len(ss):
        # a length-1 segment's OR degenerates to one buffered row OR
        bits[targets[ss]] |= bits[sources[ss]]
    if not single.all():
        multi = np.repeat(~single, lens)
        g = bits[sources[multi]]
        tm = targets[multi]
        st = np.nonzero(np.r_[True, tm[1:] != tm[:-1]])[0]
        bits[tm[st]] |= np.bitwise_or.reduceat(g, st, axis=0)


def _segment_or_bits(bits: np.ndarray, rows: np.ndarray,
                     cols: np.ndarray, presorted: bool = False) -> None:
    """``bits[rows] |= (1 << cols)`` via the same group + reduceat
    segment-OR (duplicate (row, word) destinations collapse before the
    single indexed write).  ``presorted`` asserts (row, col) pairs
    already arrive in lexicographic order."""
    if len(rows) == 0:
        return
    W = bits.shape[1]
    cols = cols.astype(np.int64)
    key = rows.astype(np.int64) * W + cols // 32
    vals = np.uint32(1) << (cols % 32).astype(np.uint32)
    if not presorted:
        order = np.argsort(key, kind="stable")
        key, vals = key[order], vals[order]
    starts = np.nonzero(np.r_[True, key[1:] != key[:-1]])[0]
    bits.reshape(-1)[key[starts]] |= np.bitwise_or.reduceat(vals, starts)


def _closure_prologue(
    cond: Condensation,
    n: int,
    spatial_vertex: np.ndarray,
    extra_vertex_comp: Optional[Tuple[np.ndarray, np.ndarray]],
):
    """Shared host prologue of every closure implementation: column
    mapping, own-column CSR, and the interior-row numbering (components
    with at least one DAG out-edge get a packed bitset row)."""
    p = len(spatial_vertex)
    d = cond.n_comps
    col_of_vertex = np.full(n, -1, dtype=np.int64)
    col_of_vertex[spatial_vertex] = np.arange(p, dtype=np.int64)
    own_indptr, own_cols = _own_columns(
        cond, n, spatial_vertex, col_of_vertex, extra_vertex_comp
    )
    interior = np.zeros(d, dtype=bool)
    if cond.dag_edges.size:
        interior[cond.dag_edges[:, 0]] = True
    interior_ids = np.nonzero(interior)[0]
    interior_row = np.full(d, -1, dtype=np.int32)
    interior_row[interior_ids] = np.arange(len(interior_ids), dtype=np.int32)
    return p, col_of_vertex, own_indptr, own_cols, interior_row, interior_ids


def _seed_pairs(own_indptr: np.ndarray, own_cols: np.ndarray,
                interior_row: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of every interior component's own columns — the
    fixpoint seed."""
    d = len(interior_row)
    if not own_cols.size:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    own_comp = np.repeat(np.arange(d, dtype=np.int64), np.diff(own_indptr))
    m0 = interior_row[own_comp] >= 0
    return (interior_row[own_comp[m0]].astype(np.int64),
            own_cols[m0].astype(np.int64))


def closure_np(
    cond: Condensation,
    n: int,
    spatial_vertex: np.ndarray,
    extra_vertex_comp: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    chunk_edges: int = 1 << 22,
    segment_or: bool = True,
) -> ClosureResult:
    """Host reverse-topological closure (paper Alg. 1 lines 6-9).

    Parameters
    ----------
    cond:            SCC condensation (possibly of the social subgraph only).
    spatial_vertex:  (p,) vertex ids that define bitset columns.
    extra_vertex_comp: compressed-variant extra own-members, see
                     ``_own_columns``.
    segment_or:      per-level merge strategy.  ``True`` (default) sorts
                     each level's contributions and OR-reduces runs with
                     ``np.bitwise_or.reduceat`` — one buffered write per
                     unique target instead of ``np.bitwise_or.at``'s
                     element-at-a-time unbuffered scatter.  ``False``
                     keeps the legacy scatter (identical result; kept
                     for the before/after in ``benchmarks/perf_build``).
    """
    p, col_of_vertex, own_indptr, own_cols, interior_row, interior_ids = (
        _closure_prologue(cond, n, spatial_vertex, extra_vertex_comp))
    W = n_words(p)
    bits = np.zeros((len(interior_ids), W), dtype=np.uint32)

    # seed interior rows with own columns (vectorised over all comps)
    rr, cc = _seed_pairs(own_indptr, own_cols, interior_row)
    if len(rr):
        if segment_or:
            # own CSR is (comp, col)-sorted, so the keys arrive in order
            _segment_or_bits(bits, rr, cc, presorted=True)
        else:
            np.bitwise_or.at(
                bits, (rr, cc // 32), np.uint32(1) << (cc % 32).astype(np.uint32)
            )

    if cond.dag_edges.size:
        edges = cond.edges_by_level_desc()
        src_lv = cond.level[edges[:, 0]]
        # process one level at a time (descending); within a level the
        # merge is order-independent because no edge joins two comps of
        # the same level
        boundaries = np.nonzero(np.diff(-src_lv))[0] + 1
        seg_starts = np.concatenate([[0], boundaries, [len(edges)]])
        interior = interior_row >= 0
        leaf = ~interior
        own_cnt = np.diff(own_indptr)
        for s, e in zip(seg_starts[:-1], seg_starts[1:]):
            for cs in range(s, e, chunk_edges):
                ce = min(cs + chunk_edges, e)
                src = edges[cs:ce, 0]
                dst = edges[cs:ce, 1]
                rs = interior_row[src]
                # contribution of interior children: OR their rows
                di = interior_row[dst]
                m = di >= 0
                if m.any():
                    if segment_or:
                        # the level schedule is source-sorted already
                        _segment_or_rows(bits, rs[m], di[m], presorted=True)
                    else:
                        np.bitwise_or.at(bits, (rs[m],), bits[di[m]])
                # contribution of leaf children: OR their own columns
                lm = leaf[dst] & (own_cnt[dst] > 0)
                if lm.any():
                    ls, ld = src[lm], dst[lm]
                    cnt = own_cnt[ld]
                    rep_row = np.repeat(interior_row[ls], cnt)
                    starts = own_indptr[ld]
                    slot = np.repeat(starts, cnt) + _ragged_arange(cnt)
                    cc = own_cols[slot]
                    if segment_or:
                        _segment_or_bits(bits, rep_row, cc)
                    else:
                        np.bitwise_or.at(
                            bits,
                            (rep_row, cc // 32),
                            np.uint32(1) << (cc % 32).astype(np.uint32),
                        )

    return ClosureResult(
        p=p,
        spatial_vertex=np.asarray(spatial_vertex, dtype=np.int32),
        col_of_vertex=col_of_vertex,
        interior_row=interior_row,
        bits=bits,
        own_indptr=own_indptr,
        own_cols=own_cols,
    )


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


# --------------------------------------------------------------------------
# MBR closure (GeoReach baseline substrate)
# --------------------------------------------------------------------------

def closure_mbr_np(
    cond: Condensation,
    coords: np.ndarray,
    spatial_mask: np.ndarray,
) -> np.ndarray:
    """(d, 4) reachability MBR [xmin, ymin, xmax, ymax] per component;
    components with empty reachable sets get an empty box (min > max)."""
    d = cond.n_comps
    mbr = np.empty((d, 4), dtype=np.float32)
    mbr[:, :2] = np.inf
    mbr[:, 2:] = -np.inf
    sv = np.nonzero(spatial_mask)[0]
    if sv.size:
        c = cond.comp[sv]
        keep = c >= 0
        c, pts = c[keep], coords[sv[keep]]
        np.minimum.at(mbr[:, 0], c, pts[:, 0])
        np.minimum.at(mbr[:, 1], c, pts[:, 1])
        np.maximum.at(mbr[:, 2], c, pts[:, 0])
        np.maximum.at(mbr[:, 3], c, pts[:, 1])
    if cond.dag_edges.size:
        # one level at a time: np.minimum.at gathers dst values at call
        # time, so multi-hop propagation needs the same per-level
        # segmentation as the bitset closure
        edges = cond.edges_by_level_desc()
        src_lv = cond.level[edges[:, 0]]
        boundaries = np.nonzero(np.diff(src_lv))[0] + 1
        seg_starts = np.concatenate([[0], boundaries, [len(edges)]])
        for s, e in zip(seg_starts[:-1], seg_starts[1:]):
            src, dst = edges[s:e, 0], edges[s:e, 1]
            np.minimum.at(mbr[:, 0], src, mbr[dst, 0])
            np.minimum.at(mbr[:, 1], src, mbr[dst, 1])
            np.maximum.at(mbr[:, 2], src, mbr[dst, 2])
            np.maximum.at(mbr[:, 3], src, mbr[dst, 3])
    return mbr


# --------------------------------------------------------------------------
# Boolean sweep closure (the reference's jit closure)
# --------------------------------------------------------------------------

def closure_torch(
    n_comps: int,
    dag_edges: np.ndarray,
    own_bool: np.ndarray,
    n_sweeps: int,
    device: DeviceLike = None,
) -> np.ndarray:
    """Boolean closure on ``device`` (``None``: the GPU): rows ``(d, p)``;
    ``n_sweeps`` scatter-max sweeps, each gathering every edge's child
    row before any parent row changes (>= DAG depth sweeps converge; one
    sweep propagates at least one DAG hop).  The port of
    ``repro.core.reachability.closure_jax``: the max of 0/1 values is
    taken as an int32 ``index_add`` clamped at 1, which cannot wrap
    (fan-in < 2^31)."""
    dev = resolve_device(device)
    if dag_edges.size == 0:
        return np.asarray(own_bool, dtype=bool)
    edges = torch.as_tensor(np.asarray(dag_edges, dtype=np.int64),
                            device=dev)
    src, dst = edges[:, 0], edges[:, 1]
    bits = torch.as_tensor(np.asarray(own_bool, dtype=np.int32), device=dev)
    for _ in range(int(n_sweeps)):
        bits = bits.index_add(0, src, bits[dst]).clamp_(max=1)
    return bits.bool().cpu().numpy()


# --------------------------------------------------------------------------
# Device (packed) closure — the backend="device" build path
# --------------------------------------------------------------------------
#
# Packed words live in int32 tensors holding the uint32 bits (torch has no
# usable uint32).  Scatter-adds build rows whose (row, word, bit) triples
# are distinct, so each add is an OR, bit 31 included: no carry can occur.

def _bit_words(cols: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns -> (word index, int32 one-bit mask) tensors."""
    cols = cols.astype(np.int64)
    masks = (np.uint32(1) << (cols % 32).astype(np.uint32)).view(np.int32)
    return (torch.as_tensor(cols // 32, device=device),
            torch.as_tensor(masks, device=device))


def _leaf_row_scatter(
    rows: torch.Tensor, local: np.ndarray, dst: np.ndarray,
    own_indptr: np.ndarray, own_cols: np.ndarray,
) -> torch.Tensor:
    """OR the own columns of leaf components ``dst`` into the zero packed
    ``rows`` at row indices ``local`` (in place; returns ``rows``)."""
    cnt = np.diff(own_indptr)[dst]
    rep = np.repeat(local, cnt)
    slot = np.repeat(own_indptr[dst], cnt) + _ragged_arange(cnt)
    words, masks = _bit_words(own_cols[slot], rows.device)
    rows.index_put_((torch.as_tensor(rep, device=rows.device), words), masks,
                    accumulate=True)
    return rows


def closure_bitset_mm(
    cond: Condensation,
    n: int,
    spatial_vertex: np.ndarray,
    extra_vertex_comp: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    kernel: str = "bitset_mm",
    device: DeviceLike = None,
    chunk_edges: int = 1 << 22,
) -> ClosureResult:
    """Device closure: level-scheduled packed fixpoint R <- own | A.R on
    ``device`` (``None``: the GPU).

    Produces a :class:`ClosureResult` with the same bits as
    ``closure_np`` (set union is order-independent).  Level L touches
    only its source rows and their destinations' rows, so rows that
    converged at deeper levels pay nothing; wide levels are cut into
    ``chunk_edges`` chunks, as ``closure_np`` cuts them.

    kernel: ``"bitset_mm"`` — per level, pack the frontier adjacency
            and run the OR-AND product K7 (:func:`_level_step_mm`, the
            reference's ``kernel="pallas"``); ``"gather"`` — per level,
            gather each edge's destination row and OR-reduce runs of
            equal source by halving (:func:`_level_step_gather`, the
            reference's ``kernel="xla"``)."""
    if kernel not in CLOSURE_KERNELS:
        raise ValueError(f"unknown closure kernel {kernel!r}; expected "
                         f"one of {CLOSURE_KERNELS}")
    step = _level_step_mm if kernel == "bitset_mm" else _level_step_gather
    dev = resolve_device(device)
    p, col_of_vertex, own_indptr, own_cols, interior_row, interior_ids = (
        _closure_prologue(cond, n, spatial_vertex, extra_vertex_comp))
    W = n_words(p)
    n_int = len(interior_ids)
    own_cnt = np.diff(own_indptr)

    # seed: every interior row starts as its own packed columns
    R = torch.zeros((n_int, max(W, 1)), dtype=torch.int32, device=dev)
    rr, cc = _seed_pairs(own_indptr, own_cols, interior_row)
    if len(rr):
        words, masks = _bit_words(cc, dev)
        R.index_put_((torch.as_tensor(rr, device=dev), words), masks,
                     accumulate=True)

    if cond.dag_edges.size:
        edges = cond.edges_by_level_desc()
        src_lv = cond.level[edges[:, 0]]
        boundaries = np.nonzero(np.diff(-src_lv))[0] + 1
        seg_starts = np.concatenate([[0], boundaries, [len(edges)]])
        for s, e in zip(seg_starts[:-1], seg_starts[1:]):
            # a source run split across chunks ORs into its row twice
            for cs in range(s, e, chunk_edges):
                ce = min(cs + chunk_edges, e)
                R = step(
                    R, edges[cs:ce, 0].astype(np.int64),
                    edges[cs:ce, 1].astype(np.int64), interior_row,
                    own_indptr, own_cols, own_cnt, dev)

    bits = R[:, :W].cpu().numpy().view(np.uint32)
    return ClosureResult(
        p=p,
        spatial_vertex=np.asarray(spatial_vertex, dtype=np.int32),
        col_of_vertex=col_of_vertex,
        interior_row=interior_row,
        bits=np.ascontiguousarray(bits).reshape(n_int, W),
        own_indptr=own_indptr,
        own_cols=own_cols,
    )


def _component_rows(
    R: torch.Tensor, comps: np.ndarray, interior_row: np.ndarray,
    own_indptr: np.ndarray, own_cols: np.ndarray, own_cnt: np.ndarray,
    device: torch.device, pad: int = 0,
) -> torch.Tensor:
    """The packed rows of components ``comps`` (an interior component's
    current row of ``R``, a leaf's own columns), then ``pad`` zero rows."""
    rows = torch.zeros((len(comps) + pad, R.shape[1]), dtype=torch.int32,
                       device=device)
    di = interior_row[comps]
    im = di >= 0
    if im.any():
        rows[torch.as_tensor(np.nonzero(im)[0], device=device)] = R[
            torch.as_tensor(di[im].astype(np.int64), device=device)]
    lm = ~im & (own_cnt[comps] > 0)
    if lm.any():
        _leaf_row_scatter(rows, np.nonzero(lm)[0], comps[lm], own_indptr,
                          own_cols)
    return rows


def _level_step_gather(
    R: torch.Tensor, src: np.ndarray, dst: np.ndarray,
    interior_row: np.ndarray, own_indptr: np.ndarray,
    own_cols: np.ndarray, own_cnt: np.ndarray, device: torch.device,
) -> torch.Tensor:
    """One level as gather + bucketed halving-OR (the reference's
    ``_level_step_xla``).

    Contributions (one packed row per edge of the level: an interior
    destination's current row, or a leaf destination's own columns) land
    in a frontier matrix C with one zero row of padding; runs of equal
    source (contiguous: the level schedule keeps the source-sorted edge
    order) are gathered into power-of-two buckets, padded with C's zero
    row, and OR-reduced by halving; then each bucket's source rows are
    updated.  ``usrc`` is unique within a call, so plain indexing writes
    each row once (``accumulate`` would add, and a sum is not an OR)."""
    E = len(src)
    C = _component_rows(R, dst, interior_row, own_indptr, own_cols,
                        own_cnt, device, pad=1)
    run_start = np.nonzero(np.r_[True, src[1:] != src[:-1]])[0]
    usrc = src[run_start]
    run_len = np.diff(np.r_[run_start, E])
    lb = np.ones(len(usrc), dtype=np.int64)
    big = run_len > 1
    lb[big] = 1 << np.ceil(np.log2(run_len[big])).astype(np.int64)
    for L in np.unique(lb):
        rid = np.nonzero(lb == L)[0]
        k = np.arange(L)
        gi = np.where(k[None, :] < run_len[rid][:, None],
                      run_start[rid][:, None] + k[None, :], E)
        M = C[torch.as_tensor(gi, device=device)]          # (runs, L, W)
        Lh = int(L)
        while Lh > 1:
            Lh //= 2
            M = M[:, :Lh] | M[:, Lh:2 * Lh]
        tr = torch.as_tensor(interior_row[usrc[rid]].astype(np.int64),
                             device=device)
        R[tr] = R[tr] | M[:, 0]
    return R


def _level_step_mm(
    R: torch.Tensor, src: np.ndarray, dst: np.ndarray,
    interior_row: np.ndarray, own_indptr: np.ndarray,
    own_cols: np.ndarray, own_cnt: np.ndarray, device: torch.device,
) -> torch.Tensor:
    """One level as a frontier-compacted OR-AND product (the reference's
    ``_level_step_pallas``).

    The level's unique destinations become the contraction axis: their
    packed rows (gathered for interior components, built from own
    columns for leaves) stack into R_L, the level's edges scatter into a
    packed frontier adjacency A_L, and one :func:`bitset_mm` computes all
    of the level's merges.  ``src`` runs are contiguous (the level
    schedule keeps the source-sorted edge order)."""
    udst, dst_inv = np.unique(dst, return_inverse=True)
    Wm = (len(udst) + 31) // 32
    R_L = _component_rows(R, udst, interior_row, own_indptr, own_cols,
                          own_cnt, device)

    run_start = np.nonzero(np.r_[True, src[1:] != src[:-1]])[0]
    usrc = src[run_start]
    f = len(usrc)
    src_local = np.searchsorted(usrc, src)
    A = torch.zeros((f, Wm), dtype=torch.int32, device=device)
    words, masks = _bit_words(dst_inv.reshape(-1), device)
    A.index_put_((torch.as_tensor(src_local, device=device), words), masks,
                 accumulate=True)

    out = bitset_mm(A, R_L, device=device)
    tr = torch.as_tensor(interior_row[usrc].astype(np.int64), device=device)
    R[tr] = R[tr] | out
    return R
