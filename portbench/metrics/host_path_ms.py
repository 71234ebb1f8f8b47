"""host_path_ms: the client and the wire (parallel/client.py, rpc.py,
wire.py, the server's connection loop): the mean request time on the
benchmark's clock less the rank's mean queue wait and mean device search,
over the window before the traced sub-window."""

import numpy as np

from portbench import readings


def read(ctx):
    done = readings.requests_done(ctx, ctx["w0"], ctx["tp"])
    wait = readings.counter_mean(ctx, ("scheduler", "queues", "queue_wait_s"))
    dev = readings.counter_mean(ctx, ("engine", ctx["index_id"], "device_search_s"))
    if not done or wait is None or dev is None:
        return None
    return (float(np.mean([r.latency for r in done])) - wait - dev) * 1e3
