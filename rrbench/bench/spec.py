"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
and the files it names, found by name.

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration is the JSON file its ``configs`` entry names;
* a traffic mix is ``rrbench/traffic/<traffic>.json``;
* a per-layer metric is read by ``rrbench/metrics/<name>.py``, a module
  with ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "rrbench"


def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def cell_spec(cell: str, bench: Optional[Dict] = None) -> Dict:
    """Everything one run of ``cell`` needs: its entry, its configuration
    and traffic (loaded), and the metrics it reports."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[cell]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)

    def reported(metrics):
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    return {"cell": w, "config": config, "traffic": traffic,
            "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``rrbench/metrics/<name>.py``."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"rrbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
