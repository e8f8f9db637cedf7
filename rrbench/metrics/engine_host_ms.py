"""engine_host_ms: the engine's host time a batch outside its wait for the
fused kernel, over the traced window: the summed durations of the
top-level batch spans (``engine.count_batch``, ``engine.query_batch``)
less the waits their ``engine.fused`` / ``engine.route_prune`` spans
record (``wait_us``), over the number of batch spans.  Pad, route,
quantize, launch and the read back: time in which the card idles.

The spans are those ``repro_torch.obs.TRACER`` recorded while the
window's ``torch.profiler`` capture ran.  A program whose spans stay off
under a capture records none, and the metric is then not reported."""

BATCH_SPANS = ("engine.count_batch", "engine.query_batch")


def from_events(events):
    """The metric from span tuples ``(name, cat, tid, t0_ns, dur_ns,
    args)``; ``None`` where there is no batch span."""
    n, busy_ns, wait_us = 0, 0, 0.0
    for name, _cat, _tid, _t0, dur, args in events:
        if name in BATCH_SPANS:
            n += 1
            busy_ns += dur
        elif args and "wait_us" in args:
            wait_us += args["wait_us"]
    if n == 0:
        return None
    return (busy_ns / 1e6 - wait_us / 1e3) / n


def read(ctx):
    from repro_torch.obs.tracer import TRACER

    return from_events(TRACER.events())
