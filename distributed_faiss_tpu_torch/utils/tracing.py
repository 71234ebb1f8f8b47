"""Latency statistics (the ``LatencyStats`` part of
distributed_faiss_tpu/utils/tracing.py).

Lock-protected per-operation counters with streaming percentiles over fixed
log-spaced histogram buckets (1 µs .. 1000 s, 5 buckets per decade), so
``record`` is O(log n_buckets) with O(1) memory per op name and the
serving hot path can afford per-request recording. The trace exemplars,
the ``delta`` rate helper and the jax profiler hooks of the JAX module
belong to the observability subsystem, which this slice does not port.
"""

import bisect
import threading
from typing import Dict

_BUCKET_BOUNDS = tuple(1e-6 * 10 ** (i / 5) for i in range(46))
_PERCENTILES = ((0.50, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s"))


class LatencyStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = {}
        self._hist: Dict[str, list] = {}

    def record(self, name: str, seconds: float) -> None:
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
                est = max_s if i == last else min(_BUCKET_BOUNDS[i], max_s)
                out[targets[ti][1]] = est
                ti += 1
            if ti == len(targets):
                break
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-op {count, total_s, max_s, mean_s, p50_s, p95_s, p99_s}."""
        with self._lock:
            out = {}
            for name, s in self._stats.items():
                out[name] = dict(s)
                out[name]["mean_s"] = s["total_s"] / max(s["count"], 1)
                out[name].update(self._percentiles(
                    self._hist[name], s["count"], s["max_s"]))
            return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._hist.clear()
