"""The plain reference for RangeReach and RangeCount.

RangeCount(u, R) is the number of distinct spatial vertices v that u
reaches (u reaches itself) whose point lies in the closed rectangle R;
RangeReach(u, R) is whether that number is above 0.  The reference works
both out from the raw edges alone: a breadth-first search from every
distinct query vertex, many sources at a time as columns of a 0/1 matrix
pushed along the transposed adjacency (one sparse product a level), then
the region test against every venue the search reached.

It imports only NumPy and PyTorch.  ``dtype`` is the precision of the
region test: float32, as the configurations state it, or a lower one for
the control that the benchmark's limits are set against.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def _adjacency(n: int, edges: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(n, n) sparse CSR float32 with a non-zero at [t, s] per edge s -> t."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=dev)
    vals = torch.ones(e.shape[0], dtype=torch.float32, device=dev)
    with warnings.catch_warnings():    # sparse CSR is marked beta
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([e[:, 1], e[:, 0]]), vals,
                                      (n, n))
        return coo.coalesce().to_sparse_csr()


def _reached(adj: torch.Tensor, sources: torch.Tensor) -> torch.Tensor:
    """(n, k) bool: column j marks what ``sources[j]`` reaches."""
    n, k = adj.shape[0], sources.shape[0]
    dev = sources.device
    seen = torch.zeros((n, k), dtype=torch.bool, device=dev)
    seen[sources, torch.arange(k, device=dev)] = True
    frontier = seen
    while True:
        nxt = (adj @ frontier.to(torch.float32)) > 0
        nxt &= ~seen
        if not bool(nxt.any()):
            return seen
        seen |= nxt
        frontier = nxt


class Reference:
    """The reference over one graph: its adjacency and venues, made once,
    then ``counts`` for any queries."""

    def __init__(self, n_nodes: int, edges: np.ndarray, coords: np.ndarray,
                 spatial_mask: np.ndarray, *, device="cpu",
                 sources_per_pass: int = 256, queries_per_pass: int = 64):
        self.dev = torch.device(device)
        spatial = torch.as_tensor(np.asarray(spatial_mask, bool),
                                  device=self.dev)
        self.venues = torch.nonzero(spatial).squeeze(1)
        self.pts = torch.as_tensor(np.asarray(coords, np.float32),
                                   device=self.dev)[self.venues]
        self.adj = _adjacency(n_nodes, edges, self.dev)
        self.sources_per_pass = sources_per_pass
        self.queries_per_pass = queries_per_pass

    def counts(self, us: np.ndarray, rects: np.ndarray,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
        """(len(us),) int64 RangeCount of each query ``(us[i], rects[i])``;
        ``rects`` are [xmin, ymin, xmax, ymax]; the region test in
        ``dtype``."""
        dev = self.dev
        us = np.asarray(us, dtype=np.int64)
        rects_t = torch.as_tensor(
            np.asarray(rects, np.float32).reshape(-1, 4), device=dev
        ).to(dtype)
        pts = self.pts.to(dtype)
        uniq, inv = np.unique(us, return_inverse=True)
        out = np.zeros(len(us), dtype=np.int64)
        for c0 in range(0, len(uniq), self.sources_per_pass):
            src = torch.as_tensor(uniq[c0:c0 + self.sources_per_pass],
                                  device=dev)
            hit_venue = _reached(self.adj, src)[self.venues]      # (V, k)
            qs = np.nonzero((inv >= c0) & (inv < c0 + len(src)))[0]
            for q0 in range(0, len(qs), self.queries_per_pass):
                q = qs[q0:q0 + self.queries_per_pass]
                r = rects_t[torch.as_tensor(q, device=dev)]        # (Q, 4)
                inside = ((pts[:, :1] >= r[:, 0]) & (pts[:, :1] <= r[:, 2])
                          & (pts[:, 1:] >= r[:, 1])
                          & (pts[:, 1:] <= r[:, 3]))
                cols = torch.as_tensor(inv[q] - c0, device=dev)
                out[q] = (hit_venue[:, cols] & inside).sum(0).cpu().numpy()
        return out

