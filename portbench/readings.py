"""What the per-layer metric readers share: the rank's counters diffed over
the counted part of the window (from its open to the traced sub-window),
the requests of a span of it, and a kernel's roofline share over the
traced sub-window.

A reader is ``metrics/<metric>.py`` with ``read(ctx) -> float | None``;
``ctx`` is the dict ``harness.run_cell`` builds after a traced run:
``cell``, ``requests``, ``w0``/``tp``/``w1`` (the window's open, the
sub-window's start, its close, on the host clock), ``snaps`` (the rank's
``get_perf_stats()`` with the kernel wrappers' launches, at ``w0`` and
``tp``), ``trace`` (``devtrace.summarize`` of the sub-window), ``programs``
(``program_stats()`` after the window), ``snapshot`` (the served index's
centroids and live rows a list), ``pool`` (the ``traffic.Pool``), ``device``, ``index_id``,
``seed``. A reader that finds nothing to read returns None.
"""

import numpy as np

from portbench import devtrace, roofline

# requests of the sub-window whose probed lists are counted
ROOFLINE_REQUESTS = 16


def counter_diff(ctx, path: tuple):
    """(count, total) of one latency counter of the rank over [w0, tp], or
    None where the rank does not keep it or it did not move."""
    vals = []
    for key in ("w0", "tp"):
        node = ctx["snaps"].get(key)
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
        if not isinstance(node, dict) or "count" not in node:
            return None
        vals.append((node["count"], node["total_s"]))
    n, total = vals[1][0] - vals[0][0], vals[1][1] - vals[0][1]
    return (n, total) if n > 0 else None


def counter_mean(ctx, path: tuple):
    d = counter_diff(ctx, path)
    return None if d is None else d[1] / d[0]


def requests_done(ctx, lo: float, hi: float) -> list:
    return [r for r in ctx["requests"]
            if r.error is None and r.done is not None and lo <= r.done < hi]


def launches_diff(ctx, wrapper: str):
    a = ctx["snaps"].get("w0", {}).get("kernels", {}).get(wrapper)
    b = ctx["snaps"].get("tp", {}).get("kernels", {}).get(wrapper)
    return None if a is None or b is None else b - a


def roofline_pct(ctx, kernel: str, symbol: str, wrapper: str):
    """The least time of the work ``kernel`` did in the traced sub-window
    over its summed device time there, in %. The work is counted in query
    rows: the rows a launch of ``wrapper`` served before the sub-window
    (the engine's rows over the wrapper's launches), times the launches the
    trace holds; each row's least time is the mean over up to
    ROOFLINE_REQUESTS requests sent in the sub-window."""
    trace, snap = ctx["trace"], ctx["snapshot"]
    layout = ctx["cell"].config.get("kernels", {}).get(kernel)
    if not trace or snap is None or layout is None:
        return None
    launches, seconds = devtrace.kernel_time(trace, symbol)
    rows = counter_diff(ctx, ("engine", ctx["index_id"], "device_search_rows"))
    calls = launches_diff(ctx, wrapper)
    if launches == 0 or seconds <= 0 or rows is None or not calls:
        return None
    rows_per_launch = rows[1] / calls
    sent = [r for r in ctx["requests"] if ctx["tp"] <= r.sent < ctx["w1"]]
    if not sent:
        return None
    rng = np.random.default_rng([int(ctx["seed"]) & (2**64 - 1), 11])
    pick = rng.choice(len(sent), size=min(ROOFLINE_REQUESTS, len(sent)), replace=False)
    nrows = ctx["cell"].mix["rows_per_request"]
    qs = [ctx["pool"].batch(sent[i].offset) for i in sorted(pick)]
    per_request = roofline.mean_request_least_s(
        kernel, snap["centroids"], snap["sizes"], qs, int(ctx["cell"].point["nprobe"]),
        layout, ctx["device"])
    least = launches * rows_per_launch / nrows * per_request
    return 100.0 * least / seconds
