"""Layered neighbour sampler for sampled GNN training (the port of
``repro.data.sampler``, host NumPy over ``core.graph.CSR``).

GraphSAGE-style fanout sampling over CSR adjacency: given seed nodes,
draw up to ``fanout[l]`` neighbours per node per layer, emitting a
per-layer edge list in *local* (block) indexing plus the global id map.
``pad_block`` pads a block to static shapes (self-loops on the last
node).  From the same ``rng`` and CSR, blocks equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import CSR


@dataclasses.dataclass
class SampledBlock:
    """One mini-batch: layered bipartite blocks, innermost first.

    node_ids:  (N,) global ids; the first ``n_seeds`` are the seeds.
    layers:    per layer (src_local, dst_local) edge arrays, where dst are
               positions < layer_n_dst[l] and src index into node_ids.
    """

    node_ids: np.ndarray
    n_seeds: int
    layers: List[Tuple[np.ndarray, np.ndarray]]

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)


def sample_blocks(
    csr: CSR,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
    pad_to: Optional[int] = None,
) -> SampledBlock:
    """Sample a layered block; ``fanouts`` outermost-last (e.g. (15,
    10))."""
    seeds = np.asarray(seeds, dtype=np.int64)
    frontier = seeds
    all_nodes = [seeds]
    layers: List[Tuple[np.ndarray, np.ndarray]] = []
    # map global -> local, built incrementally
    local = {int(v): i for i, v in enumerate(seeds)}

    for f in fanouts:
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        new_nodes: List[int] = []
        for v in frontier:
            nb = csr.neighbors(int(v))
            if len(nb) == 0:
                continue
            take = nb if len(nb) <= f else rng.choice(nb, size=f,
                                                      replace=False)
            ls = np.empty(len(take), dtype=np.int64)
            for k, u in enumerate(take.tolist()):
                li = local.get(u)
                if li is None:
                    li = len(local)
                    local[u] = li
                    new_nodes.append(u)
                ls[k] = li
            srcs.append(ls)
            dsts.append(np.full(len(take), local[int(v)], dtype=np.int64))
        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        layers.append((src, dst))
        frontier = np.asarray(new_nodes, dtype=np.int64)
        if new_nodes:
            all_nodes.append(frontier)

    node_ids = np.concatenate(all_nodes)
    blk = SampledBlock(node_ids=node_ids, n_seeds=len(seeds), layers=layers)
    if pad_to is not None:
        blk = pad_block(blk, pad_to)
    return blk


def pad_block(blk: SampledBlock, n_nodes: int) -> SampledBlock:
    """Pad to static shapes: nodes to ``n_nodes`` (id 0 for the padding),
    edges of each layer to the next power-of-two bucket of at least 16
    (self-loops on the last node, a sacrificial one, keep segment sums
    exact)."""
    if blk.n_nodes > n_nodes:
        raise ValueError(f"block of {blk.n_nodes} nodes does not pad to "
                         f"{n_nodes}")
    ids = np.zeros(n_nodes, dtype=np.int64)
    ids[: blk.n_nodes] = blk.node_ids
    layers = []
    for src, dst in blk.layers:
        m = len(src)
        cap = max(16, 1 << int(np.ceil(np.log2(max(m, 1)))))
        s = np.full(cap, n_nodes - 1, dtype=np.int64)
        d = np.full(cap, n_nodes - 1, dtype=np.int64)
        s[:m], d[:m] = src, dst
        layers.append((s, d))
    return SampledBlock(node_ids=ids, n_seeds=blk.n_seeds, layers=layers)
