"""Cross-process request tracing: trace ids, sampling, the span ring
(counterpart of distributed_faiss_tpu/observability/spans.py).

A sampled request gets one ``trace_id`` minted on the client
(``maybe_sample``); it rides the CALL frame's meta beside
``req_id``/``deadline_s`` (parallel/rpc.py). Each stage that touches the
request (client pack and round trip, server queue wait, device launch,
failover hop, response write) records a span into its own process's
bounded ``SpanBuffer``; nothing is pushed anywhere. The buffers are pulled
over the ordinary ``get_trace_spans`` RPC op and merged on the client
(``IndexClient.get_trace_spans``, dfstat ``--trace``).

- Off costs nothing on the wire: ``DFT_TRACE_SAMPLE`` defaults to 0,
  ``maybe_sample`` then returns None, no trace key enters a frame and every
  recording site is gated on ``trace_id is not None``.
- Spans are plain dicts of scalars, so they cross the wire through the
  frame skeleton and into JSON unchanged.
- ``start_s`` is wall clock (``time.time()``), so the spans of several
  processes share one timeline; ``dur_s`` is measured on a monotonic clock.
"""

import os
import random
import threading
from collections import deque
from typing import Optional

from distributed_faiss_tpu_torch.utils import envutil, lockdep

# the CALL-frame meta key a trace rides under
TRACE_META_KEY = "trace_id"

DEFAULT_BUFFER = 2048

# private generator: sampling never perturbs the process's global RNG
_sample_rng = random.Random()


def sample_rate() -> float:
    """DFT_TRACE_SAMPLE: the share of requests that mint a trace (0 = off,
    1 = every request), read per call so a live process can be flipped."""
    return envutil.env_float("DFT_TRACE_SAMPLE", 0.0)


def mint_trace_id() -> str:
    """16 hex characters of OS entropy: unique across processes without
    coordination."""
    return os.urandom(8).hex()


def maybe_sample() -> Optional[str]:
    """A fresh trace_id when this request is sampled, else None."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    if rate >= 1.0 or _sample_rng.random() < rate:
        return mint_trace_id()
    return None


class SpanBuffer:
    """Bounded per-process ring of spans: past ``capacity``
    (``DFT_TRACE_BUFFER``) the oldest is evicted. ``snapshot`` is the read
    side (the ``get_trace_spans`` op)."""

    def __init__(self, capacity: Optional[int] = None, rank=None):
        if capacity is None:
            capacity = envutil.env_int("DFT_TRACE_BUFFER", DEFAULT_BUFFER)
        self.capacity = max(int(capacity), 1)
        self.rank = rank
        self._lock = lockdep.lock("SpanBuffer._lock")
        self._spans = deque(maxlen=self.capacity)
        self._counters = {"recorded": 0, "evicted": 0}

    def record(self, trace_id: str, name: str, start_s: float, dur_s: float,
               **extra) -> None:
        """Append one span: ``start_s`` wall clock, ``dur_s`` a monotonic
        duration; ``extra`` must hold scalars and containers only (it
        crosses the wire)."""
        span = {"trace_id": trace_id, "name": name, "start_s": float(start_s),
                "dur_s": float(dur_s)}
        if self.rank is not None:
            span["rank"] = self.rank
        if extra:
            span["extra"] = extra
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._counters["evicted"] += 1
            self._spans.append(span)
            self._counters["recorded"] += 1

    def snapshot(self, trace_id: Optional[str] = None) -> list:
        """Spans in recording order; ``trace_id`` filters to one trace."""
        with self._lock:
            spans = list(self._spans)
        if trace_id is None:
            return spans
        return [s for s in spans if s["trace_id"] == trace_id]

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "size": len(self._spans), **self._counters}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


# the client's spans (stub round trips, fan-out and failover hops) have no
# server to own a buffer: they land in one process-local ring, created on
# first use; a server rank owns its own (``IndexServer.spans``)
_local_mu = lockdep.lock("spans._local_mu")
_local: Optional[SpanBuffer] = None


def local_buffer() -> SpanBuffer:
    global _local
    with _local_mu:
        if _local is None:
            _local = SpanBuffer()
        return _local


# the scheduler's batcher thread calls the engine through a fixed
# search_fn signature: a thread-local carries the sampled traces of the
# window being launched, so the engine can record its launch span in each
_TLS = threading.local()


def set_current_trace(trace_id: Optional[str], window=()) -> None:
    """Hand the launch on this thread its representative trace (the
    exemplar of its latency) and ``window``, every sampled trace it serves
    (default: the representative alone)."""
    _TLS.trace_id = trace_id
    _TLS.window = tuple(window) or ((trace_id,) if trace_id is not None else ())


def current_trace() -> Optional[str]:
    return getattr(_TLS, "trace_id", None)


def current_window_traces() -> tuple:
    """Every sampled trace of the launch on this thread (empty when none)."""
    return getattr(_TLS, "window", ())


def merge_timelines(*span_lists) -> list:
    """One timeline from per-process span lists: exact duplicates dropped
    (a loopback process sees its own spans locally and over the RPC),
    sorted by start, longer spans first on a tie so an enclosing span
    precedes its children."""
    seen = set()
    merged = []
    for spans in span_lists:
        for s in spans or ():
            key = (s.get("trace_id"), s.get("name"), s.get("rank"), s.get("start_s"),
                   s.get("dur_s"))
            if key in seen:
                continue
            seen.add(key)
            merged.append(s)
    merged.sort(key=lambda s: (s.get("start_s", 0.0), -s.get("dur_s", 0.0)))
    return merged
