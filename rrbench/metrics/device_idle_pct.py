"""device_idle_pct: the share of the traced window in which the card ran
no kernel, copy or set (``torch.profiler``'s CUDA activity)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
