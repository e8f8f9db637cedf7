"""Result containers of the analytics query classes (a copy of
``repro.queries.program.CollectResult``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CollectResult:
    """RangeCollect answers: per query the K smallest reachable venue
    ids in the region (ascending, -1 padded), the exact total count,
    and whether the region held more than K."""

    ids: np.ndarray       # (B, K) int32, -1 padded
    counts: np.ndarray    # (B,) int64 exact totals
    overflow: np.ndarray  # (B,) bool — counts > K

    def row(self, b: int) -> np.ndarray:
        r = self.ids[b]
        return r[r >= 0]
