"""Host-side input pipelines (the port of ``repro.data.pipeline``: LM
tokens, DIN batches, batched molecules), shardable across data-parallel hosts.

Deterministic, step-keyed synthetic data: after a restart at step k,
host h regenerates exactly the batch it would have seen, so no
data-loader state goes into checkpoints.  The pipelines yield NumPy
(host) arrays shaped for the local shard: ``global_batch // n_hosts``
rows per host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    host_id: int = 0
    n_hosts: int = 1

    def slice_of(self, global_batch: int) -> int:
        if global_batch % self.n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.n_hosts} hosts")
        return global_batch // self.n_hosts


def _rng(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, host])
    )


def lm_batches(
    vocab_size: int,
    seq_len: int,
    global_batch: int,
    seed: int = 0,
    shard: ShardInfo = ShardInfo(),
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic LM stream: Zipf-distributed tokens with local structure
    (bigram coupling) so the loss has signal to descend."""
    b = shard.slice_of(global_batch)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    step = start_step
    while True:
        rng = _rng(seed, step, shard.host_id)
        toks = rng.choice(vocab_size, size=(b, seq_len + 1), p=probs)
        # bigram coupling: with p=0.5, next token = (prev*31 + 7) % vocab
        mask = rng.random((b, seq_len)) < 0.5
        nxt = (toks[:, :-1] * 31 + 7) % vocab_size
        toks[:, 1:][mask] = nxt[mask]
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        step += 1


def din_batches(
    n_items: int,
    n_cates: int,
    hist_len: int,
    global_batch: int,
    seed: int = 0,
    shard: ShardInfo = ShardInfo(),
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """User-behaviour sequences + target item + click label.  Labels are
    planted: click iff the target's category appears in the recent half
    of the history (gives DIN's target-attention something real)."""
    b = shard.slice_of(global_batch)
    step = start_step
    cate_of = np.arange(n_items) % n_cates
    while True:
        rng = _rng(seed, step, shard.host_id)
        hist = rng.integers(0, n_items, size=(b, hist_len))
        hist_len_real = rng.integers(hist_len // 4, hist_len + 1, size=b)
        mask = np.arange(hist_len)[None, :] < hist_len_real[:, None]
        target = rng.integers(0, n_items, size=b)
        tc = cate_of[target]
        recent = hist[:, hist_len // 2:]
        match = (cate_of[recent] == tc[:, None]) & mask[:, hist_len // 2:]
        label = (match.sum(1) >= 1).astype(np.float32)
        yield {
            "hist_items": hist.astype(np.int32),
            "hist_mask": mask,
            "target_item": target.astype(np.int32),
            "label": label,
        }
        step += 1


def molecule_batches(
    n_nodes: int,
    n_edges: int,
    batch: int,
    n_species: int = 10,
    seed: int = 0,
    shard: ShardInfo = ShardInfo(),
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Random 3-D point-cloud molecules with radius-graph edges, padded to
    (n_nodes, n_edges) per molecule with masked edges 0 -> 0; regression
    target = a smooth function of pairwise distances (so message passing
    must use geometry)."""
    b = shard.slice_of(batch) if batch >= shard.n_hosts else batch
    step = start_step
    while True:
        rng = _rng(seed, step, shard.host_id)
        pos = rng.standard_normal((b, n_nodes, 3)).astype(np.float32) * 2.0
        species = rng.integers(0, n_species, size=(b, n_nodes))
        src = np.zeros((b, n_edges), dtype=np.int32)
        dst = np.zeros((b, n_edges), dtype=np.int32)
        for i in range(b):
            d = np.linalg.norm(pos[i][:, None] - pos[i][None], axis=-1)
            np.fill_diagonal(d, np.inf)
            cand = np.argwhere(d < 3.0)
            if len(cand) == 0:
                cand = np.array([[0, 1]])
            if len(cand) > n_edges:
                cand = cand[rng.choice(len(cand), n_edges, replace=False)]
            src[i, : len(cand)] = cand[:, 0]
            dst[i, : len(cand)] = cand[:, 1]
        edge_mask = ~((src == 0) & (dst == 0))
        edge_mask[:, 0] = True
        dvec = np.take_along_axis(pos, dst[..., None], 1) - np.take_along_axis(
            pos, src[..., None], 1
        )
        dist = np.linalg.norm(dvec, axis=-1)
        energy = (np.exp(-dist) * edge_mask).sum(1) + 0.1 * species.sum(1)
        yield {
            "pos": pos,
            "species": species.astype(np.int32),
            "edge_src": src,
            "edge_dst": dst,
            "edge_mask": edge_mask,
            "energy": energy.astype(np.float32),
        }
        step += 1
