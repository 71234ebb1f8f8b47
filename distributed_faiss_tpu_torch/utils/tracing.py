"""Latency statistics, trace exemplars and profiler hooks (counterpart of
distributed_faiss_tpu/utils/tracing.py).

- ``LatencyStats``: lock-protected per-operation counters with streaming
  percentiles over fixed log-spaced histogram buckets (1 µs .. 1000 s, 5
  buckets per decade), so ``record`` is O(log n_buckets) with O(1) memory
  per op name and the serving hot path can afford per-request recording.
  ``record(exemplar=)`` keeps the most recent sampled ``trace_id`` per
  bucket (aged out after ``EXEMPLAR_TTL_S``), so a p99 row names a
  fetchable trace (observability/spans.py); ``summary(raw=True)`` adds the
  bucket counts and exemplars (the Prometheus exporter's ``_bucket``
  series, observability/export.py); ``delta`` diffs two summaries (dfstat's
  rates).
- ``traced``: a ``torch.profiler.record_function`` range around a block
  (visible in a profiler trace) that also records its wall time.
- ``profile_trace``: a ``torch.profiler.profile`` around a block that
  writes a Chrome trace into ``log_dir``.
"""

import bisect
import contextlib
import os
import time
from typing import Dict, Optional

from distributed_faiss_tpu_torch.utils import lockdep

# bucket upper bounds: 1 µs .. 10^3 s, ratio 10^(1/5) ≈ 1.58x (the worst
# relative error of a reported percentile)
_BUCKET_BOUNDS = tuple(1e-6 * 10 ** (i / 5) for i in range(46))
_PERCENTILES = ((0.50, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s"))

# a bucket's exemplar stops being advertised this long after it was
# recorded: by then the span rings have evicted its trace
EXEMPLAR_TTL_S = 900.0


def bucket_bounds() -> tuple:
    """The bucket upper bounds every histogram shares (the ``le`` labels of
    the exporter's cumulative ``_bucket`` series)."""
    return _BUCKET_BOUNDS


class LatencyStats:
    def __init__(self):
        self._lock = lockdep.lock("LatencyStats._lock")
        self._stats: Dict[str, Dict[str, float]] = {}
        self._hist: Dict[str, list] = {}
        # op -> {bucket: (trace_id, time.monotonic() when recorded)}; only
        # sampled requests fill it, so without tracing summaries are
        # unchanged
        self._exemplars: Dict[str, Dict[int, tuple]] = {}

    def record(self, name: str, seconds: float, exemplar=None) -> None:
        with self._lock:
            s = self._stats.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += seconds
            s["max_s"] = max(s["max_s"], seconds)
            hist = self._hist.setdefault(name, [0] * len(_BUCKET_BOUNDS))
            # bucket i holds values <= bounds[i]; out-of-range clamps to the
            # last bucket
            bucket = min(bisect.bisect_left(_BUCKET_BOUNDS, seconds),
                         len(_BUCKET_BOUNDS) - 1)
            hist[bucket] += 1
            if exemplar is not None:
                self._exemplars.setdefault(name, {})[bucket] = (exemplar, time.monotonic())

    @staticmethod
    def _percentiles(hist, count, max_s) -> Dict[str, float]:
        """Upper edge of the bucket holding each quantile rank (<= 10^(1/5)x
        above the true value), capped at the exact max."""
        out = {}
        targets = [(q * count, key) for q, key in _PERCENTILES]
        cum = 0
        ti = 0
        last = len(hist) - 1
        for i, n in enumerate(hist):
            cum += n
            while ti < len(targets) and cum >= targets[ti][0]:
                # the last bucket is unbounded above: only the max is honest
                est = max_s if i == last else min(_BUCKET_BOUNDS[i], max_s)
                out[targets[ti][1]] = est
                ti += 1
            if ti == len(targets):
                break
        return out

    def summary(self, raw: bool = False) -> Dict[str, Dict[str, float]]:
        """Per-op {count, total_s, max_s, mean_s, p50_s, p95_s, p99_s}, plus
        ``p99_exemplar`` where a fresh exemplar sits at or past the p99
        bucket. ``raw=True`` adds ``hist`` (bucket counts aligned with
        ``bucket_bounds()``) and ``exemplars`` ({bucket: trace_id}, fresh
        ones only)."""
        fresh_after = time.monotonic() - EXEMPLAR_TTL_S
        with self._lock:
            out = {}
            for name, s in self._stats.items():
                hist = self._hist[name]
                out[name] = dict(s)
                out[name]["mean_s"] = s["total_s"] / max(s["count"], 1)
                out[name].update(self._percentiles(hist, s["count"], s["max_s"]))
                ex = {b: tid for b, (tid, t) in (self._exemplars.get(name) or {}).items()
                      if t >= fresh_after}
                if ex:
                    tail = self._p99_exemplar(hist, s["count"], ex)
                    if tail is not None:
                        out[name]["p99_exemplar"] = tail
                if raw:
                    out[name]["hist"] = list(hist)
                    out[name]["exemplars"] = ex
            return out

    @staticmethod
    def _p99_exemplar(hist, count, exemplars):
        """The exemplar of the lowest bucket at or above the p99 rank that
        has one, else None."""
        target = 0.99 * count
        cum = 0
        p99_bucket = len(hist) - 1
        for i, n in enumerate(hist):
            cum += n
            if cum >= target:
                p99_bucket = i
                break
        at_or_above = [b for b in exemplars if b >= p99_bucket]
        return exemplars[min(at_or_above)] if at_or_above else None

    @staticmethod
    def delta(prev: Optional[Dict], cur: Dict) -> Dict[str, Dict]:
        """The interval between two ``summary()`` snapshots: per op of
        ``cur``, ``count`` and ``total_s`` deltas (a missing baseline counts
        as zero), ``interval_mean_s``, ``max_s`` and, when both are raw,
        the interval's ``hist``. A counter that went backward (the rank
        restarted) is reported from zero, never as a negative rate."""
        prev = prev or {}
        out = {}
        for name, c in cur.items():
            if not isinstance(c, dict) or "count" not in c:
                continue
            p = prev.get(name) or {}
            base = {} if p.get("count", 0) > c["count"] else p
            d_count = c["count"] - base.get("count", 0)
            d_total = c["total_s"] - base.get("total_s", 0.0)
            row = {
                "count": d_count,
                "total_s": d_total,
                "interval_mean_s": d_total / d_count if d_count else 0.0,
                "max_s": c.get("max_s", 0.0),
            }
            if "hist" in c:
                ph = base.get("hist")
                row["hist"] = [n - (ph[i] if ph and i < len(ph) else 0)
                               for i, n in enumerate(c["hist"])]
            out[name] = row
        return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._hist.clear()
            self._exemplars.clear()


@contextlib.contextmanager
def traced(name: str, stats: Optional[LatencyStats] = None):
    """A profiler range named ``name`` and, given ``stats``, its wall time
    recorded under the same name."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(name):
        yield
    if stats is not None:
        stats.record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block (host ops, and the card's kernels where CUDA is
    available) and write a Chrome trace (chrome://tracing, Perfetto) into
    ``log_dir``. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
