"""Front door: ``build_index`` (offline), ``batch_query`` and
``run_queries`` (online).

    index = build_index(graph, "2dreach-comp")
    ans   = batch_query(index, us, rects, engine="device")
    top   = run_queries(index, QueryProgram.knn(us, points, 8),
                        engine="device")

The port of ``repro.core.api`` for the 2DReach methods.  The other
methods of ``METHODS`` (3DReach, GeoReach) and cluster serving are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..device import DeviceLike
from .graph import GeosocialGraph
from .two_d_reach import TwoDReachIndex, build_2dreach

METHODS = (
    "2dreach",
    "2dreach-comp",
    "2dreach-pointer",
    "3dreach",
    "3dreach-rev",
    "georeach",
)
_VARIANT = {"2dreach": "base", "2dreach-comp": "comp",
            "2dreach-pointer": "pointer"}


def build_index(graph: GeosocialGraph, method: str, **kw) -> TwoDReachIndex:
    """Build the offline index for ``method``.  Keyword arguments go to
    ``build_2dreach`` (``fanout``, ``dedup``, ``backend``, ``device``):
    ``backend="device"`` runs the closure and the forest bulk load on
    ``device`` (``None``: the GPU)."""
    method = method.lower()
    if method not in METHODS:
        raise ValueError(
            f"unknown method {method!r}; expected one of {METHODS}")
    if method not in _VARIANT:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: the port serves the "
            f"2DReach variants (2dreach, 2dreach-comp, 2dreach-pointer); "
            f"the baselines come in a later slice (ROADMAP Queue 1)")
    return build_2dreach(graph, variant=_VARIANT[method], **kw)


def batch_query(index: TwoDReachIndex, us: np.ndarray, rects: np.ndarray,
                engine: str = "host", device: DeviceLike = None
                ) -> np.ndarray:
    """Batched RangeReach through ``index``.

    ``engine="host"`` is the NumPy descent.  ``engine="device"`` serves
    through the memoised :class:`~repro_torch.core.engine.QueryEngine`
    on ``device`` (``None``: the GPU; raises where CUDA is absent).
    """
    if engine == "device":
        from .engine import engine_for  # deferred: engine imports kernels

        return engine_for(index, device=device).query_batch(
            np.asarray(us), np.asarray(rects))
    if engine == "cluster":
        raise NotImplementedError(
            "engine='cluster' is not ported yet (ROADMAP Queue 1, item 8)")
    if engine != "host":
        raise ValueError(
            f"unknown engine {engine!r}; expected host|device|cluster")
    return index.query_batch(np.asarray(us), np.asarray(rects))


def run_queries(index: TwoDReachIndex, program, engine: str = "host",
                device: DeviceLike = None):
    """Execute a :class:`~repro_torch.queries.QueryProgram` through
    ``index``: ``reach`` delegates to :func:`batch_query`; ``count`` /
    ``collect`` / ``knn`` / ``polygon`` run the host descents
    (``engine="host"``) or the memoised device ``QueryEngine`` on
    ``device`` (``"device"``; ``None`` is the GPU), which answer exactly
    alike."""
    from ..queries import host as qhost  # deferred: queries imports core
    from ..queries.knn import knn_reach_host

    if engine not in ("host", "device"):
        raise ValueError(
            f"unknown engine {engine!r}; expected host|device "
            f"(run_queries serves single-index engines)")
    kind = program.kind
    if kind == "reach":
        return batch_query(index, program.us, program.rects, engine=engine,
                           device=device)
    try:
        args = {
            "count": (program.us, program.rects),
            "collect": (program.us, program.rects, program.k),
            "knn": (program.us, program.points, program.k),
            "polygon": (program.us, program.polygons),
        }[kind]
    except KeyError:
        raise ValueError(
            f"unknown query kind {kind!r}; expected one of "
            f"('reach', 'count', 'collect', 'knn', 'polygon')") from None
    if not isinstance(index, TwoDReachIndex):
        raise ValueError(
            f"no {kind!r} query class for {type(index).__name__}: the "
            f"analytics classes are implemented for the 2DReach variants")
    if engine == "device":
        from .engine import engine_for

        return getattr(engine_for(index, device=device), f"{kind}_batch")(
            *args)
    host_fns = {
        "count": qhost.range_count_host,
        "collect": qhost.range_collect_host,
        "knn": knn_reach_host,
        "polygon": qhost.polygon_reach_host,
    }
    return host_fns[kind](index, *args)
