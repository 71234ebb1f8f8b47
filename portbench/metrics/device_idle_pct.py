"""device_idle_pct: the device: the share of the traced sub-window in which
no operation ran on the card (torch.profiler)."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0 or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
