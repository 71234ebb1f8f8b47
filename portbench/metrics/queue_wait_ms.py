"""queue_wait_ms: the scheduler (serving/scheduler.py): the mean of its
``queue_wait_s`` over the window before the traced sub-window."""

from portbench import readings


def read(ctx):
    mean = readings.counter_mean(ctx, ("scheduler", "queues", "queue_wait_s"))
    return None if mean is None else mean * 1e3
