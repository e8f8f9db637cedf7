"""Front door: ``build_index`` (offline) and ``batch_query`` (online).

    index = build_index(graph, "2dreach-comp")
    ans   = batch_query(index, us, rects, engine="device")

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
    """Build the offline index for ``method`` on the host.  Keyword
    arguments go to ``build_2dreach`` (``fanout``, ``dedup``,
    ``backend``)."""
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
