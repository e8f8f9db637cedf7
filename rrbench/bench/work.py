"""The least work a batch of RangeReach or RangeCount queries needs from
the leaf scan, and the least time an H100 could do it in.

This is the yardstick of ``k1_roofline``.  It is counted from the index's
forest (its entries in tree order and each tree's slice of them) and the
batch's queries, never from a kernel's own counters, so it reads the same
work whatever implements the scan.

* Tiles.  A tile is one leaf node of the forest: each tree's slice of
  the entry arena cut into consecutive groups of the forest's fanout (16)
  entries from the tree's own start, with the MBR of its entries, which
  is the leaf's own MBR.  So the count is the R-tree's leaf scan, and
  does not change when a tree moves in the arena.
* Operations.  Count: for each query, one exact box test (4 float32
  compares) against every entry of its tree's tiles whose MBR meets its
  region.  Reach: those tests up to the first hit, in the tree's order.
  A query with no tree, or answered by its own point, needs none.
* Bytes.  Each tile those tests touch, once per batch (16 bytes an
  entry), plus the queries (a 4-byte vertex and a 16-byte region) and the
  answers (4 bytes each).

The peaks are the published ones of one NVIDIA H100 SXM at its 700 W
limit (NVIDIA's data sheet), with the comparison-rate convention of the
port's kernel timing: 67 TFLOP/s of float32 counts a fused multiply-add
as two operations on 128 lanes per SM, and a compare is one instruction,
so float32 compares run at half that rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_CMP_PER_S = 67e12 / 2     # H100 SXM float32 compares
CMPS_PER_TEST = 4
ENTRY_BYTES = 16
QUERY_BYTES = 4 + 16
ANSWER_BYTES = 4
PAIRS_PER_PASS = 1 << 24      # (query, tile) pairs tested at a time
SCAN_PAIRS_PER_PASS = 1 << 21  # (query, tile) pairs scanned entry by entry


class Tiles:
    """The forest's tiles: per tree the range ``[first[t], first[t+1])``
    of tile ids, and per tile its first entry, its length and its MBR."""

    def __init__(self, entries: np.ndarray, entry_off: np.ndarray,
                 fanout: int, device) -> None:
        dev = torch.device(device)
        self.grain = grain = int(fanout)
        off = np.asarray(entry_off, np.int64)
        a, b = off[:-1], off[1:]
        n_tiles = -(-(b - a) // grain)
        self.first = np.concatenate([[0], np.cumsum(n_tiles)])
        tree = np.repeat(np.arange(len(a)), n_tiles)
        k = np.arange(len(tree)) - self.first[tree]
        start = a[tree] + k * grain
        end = np.minimum(start + grain, b[tree])
        self.start = torch.as_tensor(start, device=dev)
        self.length = torch.as_tensor(end - start, device=dev)
        self.entries = torch.as_tensor(np.asarray(entries, np.float32),
                                       device=dev)
        tile_of = torch.repeat_interleave(
            torch.arange(len(start), device=dev), self.length)
        ent = self.entries[: int(end[-1]) if len(end) else 0]
        mbr = torch.empty((len(start), 4), dtype=torch.float32, device=dev)
        for c, red in ((0, "amin"), (1, "amin"), (2, "amax"), (3, "amax")):
            mbr[:, c] = torch.zeros(len(start), device=dev).scatter_reduce(
                0, tile_of, ent[:, c], red, include_self=False)
        self.mbr = mbr
        self.device = dev


def _pairs(tiles: Tiles, trees: np.ndarray, rects: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (query, tile) pairs of these queries whose tile MBR meets the
    query's region, in query order and then tree order."""
    dev = tiles.device
    lo = tiles.first[np.maximum(trees, 0)]
    n = np.where(trees >= 0, tiles.first[np.maximum(trees, 0) + 1] - lo, 0)
    q = torch.repeat_interleave(torch.arange(len(trees), device=dev),
                                torch.as_tensor(n, device=dev))
    base = torch.as_tensor(np.concatenate([[0], np.cumsum(n)[:-1]]),
                           device=dev)
    tile = (torch.arange(q.shape[0], device=dev) - base[q]
            + torch.as_tensor(lo, device=dev)[q])
    m, r = tiles.mbr[tile], rects[q]
    meet = ((m[:, 0] <= r[:, 2]) & (m[:, 2] >= r[:, 0])
            & (m[:, 1] <= r[:, 3]) & (m[:, 3] >= r[:, 1]))
    return q[meet], tile[meet]


def _first_hits(tiles: Tiles, q: torch.Tensor, tile: torch.Tensor,
                rects: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per pair, whether its tile holds an entry in its query's region,
    and the offset in the tile of the first one (its length if none)."""
    has, off = [], []
    lane = torch.arange(tiles.grain, device=tiles.device)[None, :]
    last = tiles.entries.shape[0] - 1
    for s in range(0, q.shape[0], SCAN_PAIRS_PER_PASS):
        qq, tt = q[s:s + SCAN_PAIRS_PER_PASS], tile[s:s + SCAN_PAIRS_PER_PASS]
        length = tiles.length[tt][:, None]
        e = tiles.entries[(tiles.start[tt][:, None] + lane).clamp(max=last)]
        r = rects[qq][:, None, :]
        hit = ((e[..., 0] <= r[..., 2]) & (e[..., 2] >= r[..., 0])
               & (e[..., 1] <= r[..., 3]) & (e[..., 3] >= r[..., 1])
               & (lane < length))
        h = hit.any(dim=1)
        has.append(h)
        off.append(torch.where(h, hit.to(torch.int8).argmax(dim=1),
                               length[:, 0]))
    if not has:
        z = torch.zeros(0, dtype=torch.int64, device=tiles.device)
        return z.bool(), z
    return torch.cat(has), torch.cat(off)


def batch_work(tiles: Tiles, trees: np.ndarray, rects: np.ndarray,
               mode: str) -> Dict[str, float]:
    """``tests`` (box tests) and ``bytes`` of one batch, the seconds they
    take at the peaks (``op_s``, ``byte_s``) and the larger (``bound_s``).
    ``trees[i]`` is the tree query ``i`` scans, -1 where it scans none."""
    if mode not in ("count", "reach"):
        raise ValueError(f"no work count for mode {mode!r}")
    dev = tiles.device
    trees = np.asarray(trees, np.int64)
    B = len(trees)
    rects_t = torch.as_tensor(np.asarray(rects, np.float32).reshape(B, 4),
                              device=dev)
    per_query = int(max(1, PAIRS_PER_PASS // max(
        1, int(np.diff(tiles.first).max(initial=1)))))
    tests = 0
    touched = torch.zeros(tiles.start.shape[0], dtype=torch.bool, device=dev)
    for s in range(0, B, per_query):
        q, tile = _pairs(tiles, trees[s:s + per_query],
                         rects_t[s:s + per_query])
        q = q + s
        length = tiles.length[tile]
        if mode == "reach" and q.shape[0]:
            has, off = _first_hits(tiles, q, tile, rects_t)
            pos = torch.arange(q.shape[0], device=dev)
            never = q.shape[0]
            first = torch.full((B,), never, dtype=torch.int64, device=dev)
            first.scatter_reduce_(0, q, torch.where(has, pos, never), "amin")
            fq = first[q]
            need = pos <= fq         # the pairs up to the first hit
            length = torch.where(pos == fq, off + 1, length) * need
            tile = tile[need]
        tests += int(length.sum())
        touched[tile] = True
    nbytes = (int(tiles.length[touched].sum()) * ENTRY_BYTES
              + B * (QUERY_BYTES + ANSWER_BYTES))
    op_s = tests * CMPS_PER_TEST / F32_CMP_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    return {"tests": float(tests), "bytes": float(nbytes),
            "op_s": op_s, "byte_s": byte_s, "bound_s": max(op_s, byte_s)}
