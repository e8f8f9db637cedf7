"""Front door: ``build_index`` (offline), ``batch_query`` and
``run_queries`` (online).

    index = build_index(graph, "2dreach-comp")
    ans   = batch_query(index, us, rects, engine="device")
    top   = run_queries(index, QueryProgram.knn(us, points, 8),
                        engine="device")

The port of ``repro.core.api``: every method of ``METHODS`` (the five
the paper evaluates plus the GeoReach baseline) builds, and
``index_nbytes`` decomposes each index's size.  Cluster serving is not
ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import warnings
from typing import Union

import numpy as np

from ..device import DeviceLike
from .georeach import GeoReachIndex, build_georeach
from .graph import GeosocialGraph
from .three_d_reach import ThreeDReachIndex, build_3dreach
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

AnyIndex = Union[TwoDReachIndex, ThreeDReachIndex, GeoReachIndex]


def build_index(graph: GeosocialGraph, method: str, **kw) -> AnyIndex:
    """Build the offline index for ``method`` (one of ``METHODS``).

    Keyword arguments go to the method's builder (``fanout``, ``dedup``,
    ...).  ``backend`` and ``device`` select the 2DReach build pipeline:
    ``backend="device"`` runs the closure and the forest bulk load on
    ``device`` (``None``: the GPU) and leaves the serving arrays there
    for the engine to adopt.  Asking for ``backend="device"`` with a
    method that has no device builder raises a ``ValueError`` naming the
    method; it never falls back."""
    method = method.lower()
    if method not in METHODS:
        raise ValueError(
            f"unknown method {method!r}; expected one of {METHODS}")
    if method in _VARIANT:
        return build_2dreach(graph, variant=_VARIANT[method], **kw)
    backend = kw.pop("backend", "host")     # host build == the default
    if backend != "host":
        raise ValueError(
            f"no {backend!r} build backend for method {method!r}: "
            f"backend='device' is implemented for the 2DReach variants "
            f"only (2dreach, 2dreach-comp, 2dreach-pointer); build "
            f"{method!r} with backend='host' (the default)")
    if method == "georeach":
        return build_georeach(graph, **kw)
    return build_3dreach(
        graph, variant="3d" if method == "3dreach" else "3drev", **kw)


# (reason, index type) pairs batch_query has already warned about falling
# back to the host path for: one warning per distinct cause, not one per
# batch and not one globally
_FALLBACK_WARNED = set()


def _warn_host_fallback(index, reason: str) -> None:
    name = type(index).__name__
    key = (reason, name)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"batch_query(engine='device') [{reason}]: no device QueryEngine "
        f"for {name}; falling back to the host path (pass required=True "
        f"to make this an error)", RuntimeWarning, stacklevel=3)


def batch_query(index: AnyIndex, us: np.ndarray, rects: np.ndarray,
                engine: str = "host", required: bool = False,
                device: DeviceLike = None) -> np.ndarray:
    """Batched RangeReach through ``index``.

    ``engine="host"`` is the NumPy path every index supports.
    ``engine="device"`` serves a 2DReach index through the memoised
    :class:`~repro_torch.core.engine.QueryEngine` on ``device``
    (``None``: the GPU; raises where CUDA is absent).  An index type
    without a device engine (3DReach, GeoReach) answers from its own
    host ``query_batch``, with one ``RuntimeWarning`` per (reason, index
    type), or, with ``required=True``, raises a ``ValueError`` naming
    the index.
    """
    if engine == "device":
        from .engine import engine_for  # deferred: engine imports kernels

        eng = engine_for(index, device=device, required=required)
        if eng is not None:
            return eng.query_batch(np.asarray(us), np.asarray(rects))
        _warn_host_fallback(index, "unsupported-index")
    elif engine == "cluster":
        raise NotImplementedError(
            "engine='cluster' is not ported yet (ROADMAP Queue 1, item 8)")
    elif engine != "host":
        raise ValueError(
            f"unknown engine {engine!r}; expected host|device|cluster")
    return index.query_batch(np.asarray(us), np.asarray(rects))


def run_queries(index: AnyIndex, program, engine: str = "host",
                device: DeviceLike = None):
    """Execute a :class:`~repro_torch.queries.QueryProgram` through
    ``index``: ``reach`` delegates to :func:`batch_query` (on every
    method; ``engine="device"`` is required to find a device engine);
    ``count`` / ``collect`` / ``knn`` / ``polygon`` run on the 2DReach
    variants, through the host descents (``engine="host"``) or the
    memoised device ``QueryEngine`` on ``device`` (``"device"``;
    ``None`` is the GPU), which answer exactly alike."""
    from ..queries import host as qhost  # deferred: queries imports core
    from ..queries.knn import knn_reach_host

    if engine not in ("host", "device"):
        raise ValueError(
            f"unknown engine {engine!r}; expected host|device "
            f"(run_queries serves single-index engines)")
    kind = program.kind
    if kind == "reach":
        return batch_query(index, program.us, program.rects, engine=engine,
                           required=(engine == "device"), device=device)
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

        return getattr(engine_for(index, device=device, required=True),
                       f"{kind}_batch")(*args)
    host_fns = {
        "count": qhost.range_count_host,
        "collect": qhost.range_collect_host,
        "knn": knn_reach_host,
        "polygon": qhost.polygon_reach_host,
    }
    return host_fns[kind](index, *args)


def index_nbytes(index: AnyIndex) -> dict:
    """Size decomposition mirroring the paper's Table 4 parentheses.

    The ``rtree`` entry is the spatial structure (GeoReach has no R-tree;
    its MBR summaries + per-component venue lists play that role) and
    ``aux`` the social/lookup side, so sizes compare across methods.
    """
    if isinstance(index, TwoDReachIndex):
        return {"rtree": index.nbytes_rtree(),
                "aux": index.nbytes_pointers(),
                "total": index.nbytes_total()}
    if isinstance(index, ThreeDReachIndex):
        return {"rtree": index.nbytes_rtree(),
                "aux": index.nbytes_labels(),
                "total": index.nbytes_total()}
    if isinstance(index, GeoReachIndex):
        return {"rtree": index.nbytes_spatial(),
                "aux": index.nbytes_social(),
                "total": index.nbytes_total()}
    raise ValueError(f"no size decomposition for {type(index).__name__}")
