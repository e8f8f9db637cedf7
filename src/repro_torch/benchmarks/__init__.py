"""The paper's benchmark harness on the port (the port of the reference's
``benchmarks/`` scripts, all but ``roofline.py`` and ``hlo_stats.py``,
which read the LM/GNN dry runs).

* :mod:`~repro_torch.benchmarks.paper_tables` — Tables 2-4 (graph
  statistics, build time, index size) and the paper's claims on them;
* :mod:`~repro_torch.benchmarks.paper_fig3` — Figure 3's query-time
  sweeps over extent, degree and selectivity for the six methods;
* :mod:`~repro_torch.benchmarks.perf_build` — host against device build,
  stage by stage, with the zero-copy handoff gate;
* :mod:`~repro_torch.benchmarks.perf_queries` — host, fused and
  two-phase serving per query class;
* :mod:`~repro_torch.benchmarks.perf_rangereach` — the RangeReach
  engines (host, wavefront, K9 leaf scan, device, cluster) per query,
  the degraded arm, and the closure by scatter-OR, MXU product and K7;
* :mod:`~repro_torch.benchmarks.chaos_flight` — the gate that a
  chaos-driven SLO burn freezes a replayable flight bundle;
* :mod:`~repro_torch.benchmarks.regress` — the ``BENCH_*.json`` runs
  against a history of the port's own, with the ratio gates;
* :mod:`~repro_torch.benchmarks.perf_dynamic` — the dynamic index's
  latency against its overlay size and its compaction's cost;
* :mod:`~repro_torch.benchmarks.obs_overhead` — the analytic gate on the
  disabled obs and fault hooks' cost;
* :mod:`~repro_torch.benchmarks.run` — the tables, Figure 3 and the
  kernel microbenches in one report.

Run one with ``PYTHONPATH=src python -m repro_torch.benchmarks.<name>``.
Each writes only under ``results/torch/`` of the checkout.  The device
work runs on the GPU unless ``--device cpu`` is given; the CUDA kernels
are built before anything is timed (:func:`build_kernels`), so no time
includes ``nvcc``.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import DeviceLike, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS = os.path.join(ROOT, "results", "torch")


def result_path(name: str) -> str:
    """``results/torch/<name>`` of the checkout, its directory made."""
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, name)


def build_kernels(device: DeviceLike = None) -> float:
    """Build every kernel source on a CUDA ``device`` (one ``nvcc`` each,
    all started together; a source built already loads at once) and
    return the seconds taken; 0.0 on the CPU, where the plain versions
    run."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0.0
    from ..kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:
        for f in [ex.submit(_build.build, n) for n in _build.SOURCES]:
            f.result()
    return time.perf_counter() - t0


def device_name(device: torch.device) -> str:
    """What a result ran on: the card's name, or ``cpu``."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
