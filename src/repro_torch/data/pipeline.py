"""Host-side input pipelines (the port of ``repro.data.pipeline``, the
LM and recsys parts), shardable across data-parallel hosts.

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
