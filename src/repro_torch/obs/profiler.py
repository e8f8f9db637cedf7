"""Device-stage profiling: opt-in ``torch.profiler`` capture + a kernel
cost model so a measured latency always ships with the work it bought.

The span tracer attributes *host wall time* per stage; this module adds
the device side: :func:`device_trace` wraps a serving pass in a
``torch.profiler`` capture (a Chrome trace under ``logdir`` with the
card's kernel events beside the host's operators), and
:func:`engine_cost_model` turns an engine's tile counters into
first-order cost terms — bytes the leaf scan touched, candidate tiles
that survived the hierarchical prune, the fraction of a full arena scan
actually paid — so a kernel-latency regression is explainable (did the
prune get worse, or the kernel?).

``torch`` is imported inside the functions, so importing the package
loads neither ``torch`` nor CUDA.
"""

from __future__ import annotations

import contextlib
import os

#: the Chrome trace :func:`device_trace` writes under its ``logdir``
TRACE_FILE = "device_trace.json"


@contextlib.contextmanager
def device_trace(logdir: str, enabled: bool = True, device=None):
    """Opt-in ``torch.profiler`` capture around a serving pass, written
    as a Chrome trace to ``logdir/device_trace.json``.

    The trace holds every ``obs.span`` the pass crosses as a range of
    its name, on the profiler's clock, and ``TRACER`` records them too.

    ``device=None`` records CPU and CUDA activity (the card's kernels);
    ``device="cpu"`` (or any non-CUDA device) records CPU activity only.
    No-op when ``enabled`` is False, and degrades to a no-op (rather
    than failing the serve) when the profiler cannot start a capture —
    e.g. a second concurrent capture, or a build without CUDA tracing —
    or cannot write its trace.
    """
    if not enabled:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if ((device is None or torch.device(device).type == "cuda")
                and torch.cuda.is_available()):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:        # capture unavailable: never fail the serve
        yield
        return
    try:
        yield
    finally:
        try:
            if ProfilerActivity.CUDA in acts:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        except Exception:
            pass


def annotate(name: str):
    """Named region visible inside a ``device_trace`` capture
    (``torch.profiler.record_function``); falls back to a null context
    where it cannot be made."""
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


def engine_cost_model(engine) -> dict:
    """First-order per-batch cost terms from an engine's tile counters.

    Works for :class:`~repro_torch.core.engine.QueryEngine` and any
    object whose ``stats`` share its tile-counter schema (the
    reference's ``ShardedEngine`` does).  All ``*_per_batch`` terms are
    lifetime means.

    Terms
    -----
    candidate_tiles_per_batch:  leaf tiles that survived the prune —
        the work an ideal scan does.
    grid_tiles_per_batch:       scan slots incl. K-bucket padding.
    scan_bytes_per_batch:       entry-plane bytes the scan slots touch
        (TP entries x 2*dim float32 planes per tile).
    prune_bytes_per_batch:      tile-MBR pyramid bytes the prune reads
        per query tile (fine + coarse planes).
    scan_fraction:              candidate tiles / full-arena scan — the
        prune's effectiveness; 1.0 means pruning bought nothing.
    """
    from ..kernels.range_query.layout import COARSE_GROUP, TB, TP

    stats = engine.stats
    batches = max(int(stats.get("batches", 0)), 1)
    dim = int(getattr(engine, "dim", 2))
    n_tiles = int(getattr(engine, "n_tiles", 0))
    n_shards = int(getattr(engine, "n_shards", 1))
    planes = 2 * dim
    tile_bytes = TP * planes * 4
    cand = stats.get("tiles_scanned", 0) / batches
    grid = stats.get("tiles_grid", 0) / batches
    full = stats.get("tiles_full_scan", 0) / batches
    # the prune reads every fine tile MBR + every coarse group MBR once
    # per query tile; query tiles per batch = grid steps / K columns
    pyramid_tiles = n_tiles * n_shards * (1 + 1 / max(COARSE_GROUP, 1))
    qtiles = (stats.get("queries", 0) / batches) / TB
    return {
        "batches": int(stats.get("batches", 0)),
        "queries_per_batch": stats.get("queries", 0) / batches,
        "candidate_tiles_per_batch": cand,
        "grid_tiles_per_batch": grid,
        "full_scan_tiles_per_batch": full,
        "scan_fraction": cand / full if full else None,
        "scan_bytes_per_batch": grid * tile_bytes,
        "prune_bytes_per_batch": qtiles * pyramid_tiles * planes * 4,
        "tile_shape": {"TB": TB, "TP": TP, "planes": planes},
    }
