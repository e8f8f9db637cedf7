"""What the profiler saw in a traced window, reduced to the numbers the
per-layer metrics read: the device's busy seconds, device time by
operation, and the device's idle gaps named by what the host was doing.

``summarize`` takes plain intervals, so it is tested without a card;
``from_profiler`` turns a finished ``torch.profiler.profile`` into them.
Only the aggregates are kept, never a trace of the whole window.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW_SPAN = "rrbench.batch"   # the harness's span around each batch
TOP = 10

Interval = Tuple[str, float, float]   # (name, start µs, end µs)


def _merge(spans: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host: Sequence[Interval], points: Sequence[float]
               ) -> List[str]:
    """For each time in ``points`` (ascending), the name of the latest-
    starting host interval that covers it ("python" where none does).
    Host intervals of one thread nest, so a stack sweep finds it."""
    order = sorted(host, key=lambda h: (h[1], -h[2]))
    names, stack, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else "python")
    return names


def summarize(device: Sequence[Interval], host: Sequence[Interval],
              window: Tuple[float, float]) -> Dict:
    """``busy_s`` and ``window_s`` of the window ``(start, end)`` in µs,
    ``device_s`` by operation name, and ``idle_s`` by the innermost host
    operation running at the middle of each idle gap, after the
    harness's batch span around it ("between batches" outside one).
    Only time inside the window counts."""
    w0, w1 = window
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    by_op: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in clipped:
        by_op[n] += (e - s) / 1e6
    busy = _merge([(s, e) for _, s, e in clipped])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    inner = _innermost(host, mids)
    outer = _innermost([h for h in host if h[0] == WINDOW_SPAN], mids)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), i, o in zip(gaps, inner, outer):
        o = o if o == WINDOW_SPAN else "between batches"
        name = i if i == o else f"{o} > {i}"
        idle[name] += (b - a) / 1e6
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_s": dict(by_op),
        "idle_s": dict(idle),
        "idle_gaps": len(gaps),
    }


def top(d: Dict[str, float], k: int = TOP, width: int = 160) -> List[List]:
    """The ``k`` largest entries as ``[name, seconds]``, largest first,
    each name cut to ``width`` characters (a kernel's full template name
    runs to a thousand)."""
    return [[n[:width], v]
            for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def from_profiler(prof) -> Optional[Dict]:
    """``summarize`` over a finished profile, its window the span from the
    first ``WINDOW_SPAN`` to the end of the last; ``None`` where the
    profile has no such span.  Device intervals are the kernels, copies
    and sets the card ran; host intervals are the operations of the
    thread that ran the window.  Reads the profiler's raw events, which
    is several times faster than building its ``FunctionEvent`` list."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns() / 1e3
        iv = (e.name(), t0, t0 + e.duration_ns() / 1e3, e.start_thread_id())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() != WINDOW_SPAN:
                device.append(iv[:3])
        elif e.name() == WINDOW_SPAN:
            spans.append(iv)
        else:
            host.append(iv)
    if not spans:
        return None
    thread = spans[0][3]
    window = (min(s[1] for s in spans), max(s[2] for s in spans))
    host = [h[:3] for h in host if h[3] == thread] + [s[:3] for s in spans]
    out = summarize(device, host, window)
    out["batches"] = len(spans)
    return out


def kernel_seconds(summary: Optional[Dict], needle: str) -> float:
    """Device seconds of the operations whose name holds ``needle``."""
    if not summary:
        return 0.0
    return sum(v for n, v in summary["device_s"].items() if needle in n)

