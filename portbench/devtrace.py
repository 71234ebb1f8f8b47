"""Read a ``torch.profiler`` trace of the rank's sub-window: the device's
busy seconds, each device operation's summed time and count, and the
longest idle gaps with what the host was doing in each (the pattern of
``chip_smoke.py``'s ``profile_window``).
"""

from collections import defaultdict

TOP = 10


def _union_us(spans):
    """Total length of the union of (start, end) intervals."""
    busy, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def _gaps(spans, lo, hi):
    """Idle (start, end) intervals in [lo, hi] between device spans."""
    out, t = [], lo
    for s, e in sorted(spans):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def _host_label(cpu, gap):
    """The host operation that overlaps ``gap`` the most, by name."""
    best, name = 0.0, "host: no profiled operation (python: rpc, wire, scheduler, join)"
    for s, e, n in cpu:
        if s >= gap[1]:
            break
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > best:
            best, name = ov, f"host: {n}"
    return name


def profile_spans(prof) -> list:
    """(on the device, start us, end us, name) of every event of a stopped
    ``torch.profiler.profile``, timed from its start, read from the raw
    kineto events: ``prof.events()`` builds an object tree over them,
    which added about 50 s to a traced run of a busy window on the card."""
    kr = prof.profiler.kineto_results
    t0 = kr.trace_start_ns()
    return [(e.device_type().name == "CUDA", (e.start_ns() - t0) * 1e-3,
             (e.start_ns() - t0 + e.duration_ns()) * 1e-3, e.name()) for e in kr.events()]


def summarize(spans, window_s: float) -> dict:
    """{busy_s, window_s, ops: {name: [count, seconds]}, device_ops,
    idle_gaps} from ``profile_spans``. Device events are kernels, copies
    and sets on the card, clipped to the ``window_s`` the host clock
    measured from the profiler's start."""
    hi = window_s * 1e6
    dev, cpu = [], []
    for on_device, s, t, name in spans:
        s, t = max(0.0, s), min(hi, t)
        if t > s:
            (dev if on_device else cpu).append((s, t, name))
    ops = defaultdict(lambda: [0, 0.0])
    for s, e, n in dev:
        ops[n][0] += 1
        ops[n][1] += (e - s) * 1e-6
    busy_us = _union_us([(s, e) for s, e, _ in dev])
    out = {"busy_s": busy_us * 1e-6, "window_s": float(window_s),
           "ops": {n: [c, t] for n, (c, t) in ops.items()}}
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    out["device_ops"] = [[n[:120], t] for n, (_c, t) in top]
    if dev:
        cpu.sort()
        gaps = sorted(_gaps([(s, e) for s, e, _ in dev], 0.0, hi),
                      key=lambda g: g[0] - g[1])[:TOP]
        out["idle_gaps"] = [[_host_label(cpu, g)[:120], (g[1] - g[0]) * 1e-6] for g in gaps]
    else:
        out["idle_gaps"] = []
    return out


def kernel_time(trace: dict, symbol: str) -> tuple:
    """(launches, seconds) of the traced device operations whose name holds
    ``symbol``."""
    n, t = 0, 0.0
    for name, (c, s) in trace.get("ops", {}).items():
        if symbol in name:
            n, t = n + c, t + s
    return n, t
