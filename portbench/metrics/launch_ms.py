"""launch_ms: the engine (engine.py ``_device_search``): the mean of its
``device_search_s`` (host clock around the model call, ending in the copy
to the host) over the window before the traced sub-window."""

from portbench import readings


def read(ctx):
    mean = readings.counter_mean(ctx, ("engine", ctx["index_id"], "device_search_s"))
    return None if mean is None else mean * 1e3
