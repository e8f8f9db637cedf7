"""OpenMetrics / Prometheus text exposition of the metrics registry.

``serve.py --obs`` writes ``metrics.prom`` next to the trace artifacts
so a run's final state is scrapeable by anything that speaks the
Prometheus text format (promtool, VictoriaMetrics import, Grafana agent
one-shot).  Zero dependencies: the format is lines.

Mapping (names sanitised to ``[a-zA-Z0-9_:]``, dots become
underscores, everything prefixed ``repro_``):

* :class:`~repro_torch.obs.metrics.Counter`  -> ``counter``
  (``repro_<name>_total``);
* :class:`~repro_torch.obs.metrics.Gauge`    -> ``gauge`` plus a sibling
  ``..._hwm`` gauge for the high-water mark;
* :class:`~repro_torch.obs.metrics.Histogram`-> ``summary``: ``quantile``
  labelled samples from the one Histogram implementation, plus
  ``_sum`` / ``_count``.

Histograms carrying (trace id, value) exemplar reservoirs annotate each
quantile sample with one exemplar from the bucket the quantile falls in
(OpenMetrics exemplar syntax — `` # {trace_id="..."} value``), so "show
me an actual p99 request" survives the exposition round-trip: scrape
the quantile, read the trace id, resolve it in the flight bundle.

The output ends with the OpenMetrics ``# EOF`` terminator and is
parse-checked line-by-line in ``tests/test_workload.py``.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

from . import metrics as _metrics

PREFIX = "repro_"
_SANITISE = re.compile(r"[^a-zA-Z0-9_:]")
QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


def metric_name(name: str, prefix: str = PREFIX) -> str:
    """Sanitised exposition-format metric family name."""
    out = prefix + _SANITISE.sub("_", name)
    if out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_openmetrics(registry: Optional[_metrics.Registry] = None,
                   prefix: str = PREFIX) -> str:
    """The registry's current state in OpenMetrics text format."""
    reg = registry if registry is not None else _metrics.REGISTRY
    lines = []
    for name, m in reg.items():
        n = metric_name(name, prefix)
        if isinstance(m, _metrics.Counter):
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n}_total {_fmt(m.value)}")
        elif isinstance(m, _metrics.Gauge):
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_fmt(m.value)}")
            lines.append(f"# TYPE {n}_hwm gauge")
            lines.append(f"{n}_hwm {_fmt(m.max)}")
        elif isinstance(m, _metrics.Histogram):
            lines.append(f"# TYPE {n} summary")
            if m.count:
                for q in QUANTILES:
                    v = m.percentile(q * 100.0)
                    ln = f'{n}{{quantile="{q:g}"}} {_fmt(v)}'
                    ex = m.exemplars_near(v)
                    if ex:
                        tid, ev = ex[-1]
                        ln += f' # {{trace_id="{tid}"}} {_fmt(ev)}'
                    lines.append(ln)
            lines.append(f"{n}_sum {_fmt(m.sum)}")
            lines.append(f"{n}_count {_fmt(m.count)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_prom(path: str,
               registry: Optional[_metrics.Registry] = None) -> str:
    """Write :func:`to_openmetrics` to ``path``; returns the path."""
    with open(path, "w") as f:
        f.write(to_openmetrics(registry))
    return path
