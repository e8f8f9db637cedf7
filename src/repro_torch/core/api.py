"""Front door: ``build_index`` / ``build_dynamic_index`` (offline),
``batch_query`` and ``run_queries`` (online).

    index = build_index(graph, "2dreach-comp")
    ans   = batch_query(index, us, rects, engine="device")
    top   = run_queries(index, QueryProgram.knn(us, points, 8),
                        engine="device")
    dyn   = build_dynamic_index(graph, "2dreach-comp", engine="device")

The port of ``repro.core.api``: every method of ``METHODS`` (the five
the paper evaluates plus the GeoReach baseline) builds, static or
wrapped in a :class:`~repro_torch.dynamic.DynamicIndex`; ``batch_query``
serves the host path, the device ``QueryEngine`` or the sharded
``ShardedEngine`` (``engine="cluster"``); and ``index_nbytes``
decomposes each index's size.
"""

from __future__ import annotations

import warnings
from typing import Union

import numpy as np

from ..device import DeviceLike
from ..obs import REGISTRY
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


def build_dynamic_index(graph: GeosocialGraph, method: str, policy=None,
                        **kw):
    """Wrap ``method`` in a :class:`repro_torch.dynamic.DynamicIndex`: the
    same offline build plus online ``add_edge``/``add_vertex``/
    ``add_spatial`` and policy-driven compaction.  Method-agnostic —
    every METHODS entry works as the static base.  ``engine``,
    ``n_shards`` and ``device`` go to the wrapper, the rest to
    ``build_index``."""
    from ..dynamic import DynamicIndex  # deferred: dynamic imports core

    return DynamicIndex(graph, method, policy=policy, **kw)


# (reason, index type) pairs batch_query has already warned about falling
# back to the host path for: one warning per distinct cause, not one per
# batch and not one globally — an unsupported index type and a wrapper
# that was *constructed* for host serving are different operator
# mistakes.  Every fallback, warned or not, increments the
# ``api.host_fallback.<reason>`` metric.
_FALLBACK_WARNED = set()
FALLBACK_REASONS = ("unsupported-index", "wrapper-host-engine")


def _warn_host_fallback(index, reason: str) -> None:
    name = type(index).__name__
    REGISTRY.counter(f"api.host_fallback.{reason}").inc()
    key = (reason, name)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    if reason == "wrapper-host-engine":
        detail = (f"{name} was constructed with engine='host', so its "
                  f"query_batch serves the host path; construct it with "
                  f"engine='device' for device base probes")
    else:
        detail = (f"no device QueryEngine for {name}; falling back to "
                  f"the host path")
    warnings.warn(
        f"batch_query(engine='device') [{reason}]: {detail} (pass "
        f"required=True to make this an error)",
        RuntimeWarning, stacklevel=3)


def batch_query(index: AnyIndex, us: np.ndarray, rects: np.ndarray,
                engine: str = "host", required: bool = False,
                device: DeviceLike = None) -> np.ndarray:
    """Batched RangeReach through ``index``.

    ``engine="host"`` is the NumPy path every index supports.
    ``engine="device"`` serves a 2DReach index through the memoised
    :class:`~repro_torch.core.engine.QueryEngine` on ``device``
    (``None``: the GPU; raises where CUDA is absent).  A wrapper
    (``DynamicIndex``) built for device or cluster base probes answers
    through its own ``query_batch``.  Any other index (3DReach, GeoReach,
    a host-engine wrapper) answers from its own host ``query_batch``,
    with one ``RuntimeWarning`` per (reason, index type), or, with
    ``required=True``, raises a ``ValueError`` naming the index.
    ``engine="cluster"`` serves through the memoised sharded
    :class:`~repro_torch.cluster.ShardedEngine` on ``device``; cluster
    serving is an explicit opt-in, so an unsupported index type raises.
    """
    if engine == "device":
        from .engine import engine_for  # deferred: engine imports kernels

        eng = engine_for(index, device=device)
        if eng is not None:
            return eng.query_batch(np.asarray(us), np.asarray(rects))
        wrapped = getattr(index, "engine", None)
        if wrapped is not None and wrapped != "host":
            # a wrapper (DynamicIndex) already configured for device or
            # cluster base serving: its own query_batch IS the device
            # path, not a fallback
            return index.query_batch(np.asarray(us), np.asarray(rects))
        if required:
            engine_for(index, device=device, required=True)  # raises
        _warn_host_fallback(
            index, "wrapper-host-engine" if wrapped == "host"
            else "unsupported-index")
    elif engine == "cluster":
        from ..cluster import sharded_engine_for  # deferred: imports core

        eng = sharded_engine_for(index, device=device)
        return eng.query_batch(np.asarray(us), np.asarray(rects))
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
    ``None`` is the GPU), which answer exactly alike.  A
    :class:`~repro_torch.dynamic.DynamicIndex` answers every class over
    the mutated graph with the engine it was constructed with; asking
    for ``engine="device"`` on a wrapper whose base probes for the class
    would run on the host raises a ``ValueError``."""
    from ..queries import host as qhost  # deferred: queries imports core
    from ..queries.knn import knn_reach_host

    if engine not in ("host", "device"):
        raise ValueError(
            f"unknown engine {engine!r}; expected host|device "
            f"(run_queries serves single-index engines; use batch_query "
            f"for cluster boolean serving)")
    kind = program.kind
    is_static = isinstance(index, (TwoDReachIndex, ThreeDReachIndex,
                                   GeoReachIndex))
    if not is_static and engine == "device":
        # wrappers pick their serving engine at construction; reach is
        # served by device and cluster wrappers, the analytics classes
        # need the single-device QueryEngine (a cluster wrapper's
        # analytics base probes fall back to the host descents)
        wrapped = getattr(index, "engine", "host")
        ok = ("device", "cluster") if kind == "reach" else ("device",)
        if wrapped not in ok:
            raise ValueError(
                f"run_queries(engine='device', kind={kind!r}) on a "
                f"{type(index).__name__} configured with "
                f"engine={wrapped!r}: its base probes for this class "
                f"would run on the host path — construct it with "
                f"engine='device', or pass engine='host' here")
    if kind == "reach":
        if is_static:
            return batch_query(index, program.us, program.rects,
                               engine=engine,
                               required=(engine == "device"), device=device)
        # the wrapper's query_batch is the full mutated-graph answer,
        # routed through whatever base engine it was built with
        return index.query_batch(program.us, program.rects)
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
    method = f"{kind}_batch"
    if isinstance(index, TwoDReachIndex):
        if engine == "device":
            from .engine import engine_for

            return getattr(engine_for(index, device=device, required=True),
                           method)(*args)
        host_fns = {
            "count": qhost.range_count_host,
            "collect": qhost.range_collect_host,
            "knn": knn_reach_host,
            "polygon": qhost.polygon_reach_host,
        }
        return host_fns[kind](index, *args)
    # DynamicIndex (or anything exposing the analytics surface)
    if hasattr(index, method):
        return getattr(index, method)(*args)
    raise ValueError(
        f"no {kind!r} query class for {type(index).__name__}: the "
        f"analytics classes are implemented for the 2DReach variants "
        f"(and DynamicIndex over them); use kind='reach' for boolean "
        f"RangeReach on every method")


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
    # DynamicIndex (or anything else wrapping a base index)
    if hasattr(index, "nbytes"):
        return index.nbytes()
    raise ValueError(f"no size decomposition for {type(index).__name__}")
