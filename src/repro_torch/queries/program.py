"""Typed query programs + result containers for the analytics classes
(a copy of ``repro.queries.program``).

A :class:`QueryProgram` is a validated, batched description of one
query-class invocation — the unit ``core.api.run_queries`` executes on
any engine.  Five kinds:

=========  ===========================================  ================
kind       parameters                                   result
=========  ===========================================  ================
reach      us (B,), rects (B, 4)                        (B,) bool
count      us (B,), rects (B, 4)                        (B,) int64
collect    us (B,), rects (B, 4), k                     CollectResult
knn        us (B,), points (B, 2), k                    KNNResult
polygon    us (B,), polygons (B sequences of (Ei, 2))   (B,) bool
=========  ===========================================  ================

Construct via the classmethods (``QueryProgram.count(us, rects)``, ...)
so the shapes are checked once up front instead of deep inside an
engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

QUERY_KINDS = ("reach", "count", "collect", "knn", "polygon")


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


@dataclasses.dataclass
class KNNResult:
    """KNNReach answers: per query the k nearest reachable venues by
    (dist², id) ascending (-1 / +inf padded when fewer exist)."""

    ids: np.ndarray    # (B, k) int32, -1 padded
    dist2: np.ndarray  # (B, k) float64 squared distances, +inf padded

    def row(self, b: int) -> np.ndarray:
        r = self.ids[b]
        return r[r >= 0]


@dataclasses.dataclass(frozen=True)
class QueryProgram:
    """One batched query-class invocation (see module docstring)."""

    kind: str
    us: np.ndarray
    rects: Optional[np.ndarray] = None
    points: Optional[np.ndarray] = None
    polygons: Optional[Tuple[np.ndarray, ...]] = None
    k: Optional[int] = None

    @property
    def n_queries(self) -> int:
        return len(self.us)

    # -- constructors ---------------------------------------------------

    @staticmethod
    def _us(us) -> np.ndarray:
        us = np.asarray(us, dtype=np.int64).reshape(-1)
        return us

    @staticmethod
    def _rects(rects, B: int) -> np.ndarray:
        rects = np.asarray(rects, dtype=np.float32).reshape(B, 4)
        return rects

    @classmethod
    def reach(cls, us, rects) -> "QueryProgram":
        us = cls._us(us)
        return cls(kind="reach", us=us, rects=cls._rects(rects, len(us)))

    @classmethod
    def count(cls, us, rects) -> "QueryProgram":
        us = cls._us(us)
        return cls(kind="count", us=us, rects=cls._rects(rects, len(us)))

    @classmethod
    def collect(cls, us, rects, k: int) -> "QueryProgram":
        us = cls._us(us)
        k = int(k)
        if k < 1:
            raise ValueError(f"collect needs k >= 1, got {k}")
        return cls(kind="collect", us=us, rects=cls._rects(rects, len(us)),
                   k=k)

    @classmethod
    def knn(cls, us, points, k: int) -> "QueryProgram":
        us = cls._us(us)
        k = int(k)
        if k < 1:
            raise ValueError(f"knn needs k >= 1, got {k}")
        points = np.asarray(points, dtype=np.float32).reshape(len(us), 2)
        return cls(kind="knn", us=us, points=points, k=k)

    @classmethod
    def polygon(cls, us, polygons: Sequence) -> "QueryProgram":
        us = cls._us(us)
        if len(polygons) != len(us):
            raise ValueError(
                f"{len(polygons)} polygons for {len(us)} queries")
        polys = tuple(
            np.asarray(p, dtype=np.float32).reshape(-1, 2) for p in polygons
        )
        for p in polys:
            if len(p) < 3:
                raise ValueError("polygons need >= 3 vertices")
        return cls(kind="polygon", us=us, polygons=polys)
