"""Dataset registry: named graphs with in-process caching.

``get_dataset("yelp")`` etc. return the scaled synthetic LBSN shaped to
that dataset's Table-2 statistics; ``get_dataset("yelp", scale=0.2)``
re-generates at a different size.  Tiny fixed graphs for tests are
registered under ``tiny*``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core.graph import GeosocialGraph, make_graph
from .lbsn import SPECS, generate_lbsn

_CACHE: Dict[str, GeosocialGraph] = {}


def dataset_names():
    return tuple(SPECS) + ("tiny", "tiny_cyclic")


def get_dataset(name: str, scale: float = 1.0, seed: Optional[int] = None
                ) -> GeosocialGraph:
    key = f"{name}:{scale}:{seed}"
    if key in _CACHE:
        return _CACHE[key]
    if name == "tiny":
        g = _tiny()
    elif name == "tiny_cyclic":
        g = _tiny_cyclic()
    else:
        spec = SPECS[name]
        if scale != 1.0 or seed is not None:
            spec = dataclasses.replace(
                spec,
                n_nodes=max(64, int(spec.n_nodes * scale)),
                seed=spec.seed if seed is None else seed,
            )
        g = generate_lbsn(spec)
    _CACHE[key] = g
    return g


def _tiny() -> GeosocialGraph:
    """The paper's Figure 1 running example: SCCs C1={a,b,c}, C2={d,e},
    spatial sinks f,g (from C1) and h,i (from C2)."""
    a, b, c, d, e, f, g_, h, i = range(9)
    edges = [
        (a, b), (b, c), (c, a),          # C1 cycle
        (d, e), (e, d),                  # C2 cycle
        (c, d),                          # C1 -> C2
        (a, f), (b, g_),                 # C1's own venues
        (d, h), (e, i),                  # C2's venues
    ]
    coords = np.zeros((9, 2), dtype=np.float32)
    coords[f] = (1.0, 1.0)
    coords[g_] = (2.0, 4.0)
    coords[h] = (6.0, 2.0)
    coords[i] = (7.0, 5.0)
    sm = np.zeros(9, dtype=bool)
    sm[[f, g_, h, i]] = True
    return make_graph(9, np.array(edges), coords, sm)


def _tiny_cyclic() -> GeosocialGraph:
    """Spatial vertices with outgoing edges + cycles through venues —
    exercises the general (non-LBSN) data model paths."""
    rng = np.random.default_rng(7)
    n = 40
    edges = rng.integers(0, n, size=(120, 2))
    sm = rng.random(n) < 0.5
    coords = (rng.random((n, 2)) * 10).astype(np.float32)
    return make_graph(n, edges, coords, sm)
