"""Deadline-aware micro-batching scheduler for the serving path (counterpart
of distributed_faiss_tpu/serving/scheduler.py).

One ``SearchScheduler`` per server rank. Connection threads call ``submit``
(blocking) or ``submit_async`` with a completion callback (the multiplexed
RPC path, whose reader must keep pulling frames); one batcher thread
drains the queue, coalesces compatible requests — same ``(index_id, top_k,
return_embeddings, dim)`` — into one concatenated batch, runs the engine's
batched search once, and hands every caller its row slice. Flush triggers:
the pending compatible rows reach ``max_batch_rows``, or the oldest queued
request has waited ``max_wait_ms``.

Admission control: a request past its deadline is rejected with
``DeadlineExpired`` (at admission, or shed at flush time without touching
the device); a request arriving while ``max_queue`` are pending is rejected
with ``SchedulerBusy``, which the RPC layer answers with a structured BUSY
frame that clients retry with backoff.

Query rows are independent in every index's search, so a caller's slice of
the merged launch equals the result of serving its request alone; rows are
routed back purely positionally.

Tracing: a request submitted with a ``trace_id`` gets a ``server.queue``
span (its wait, its window and the window's occupancy) and a
``server.device`` span (the host-clock window around ``search_fn``) in the
owner's span ring, and its id is the exemplar of ``queue_wait_s`` and
``e2e_s``. The window's sampled ids are handed to the engine through
``observability.spans.set_current_trace`` (the first as its latency's
exemplar), which records its ``engine.launch`` span in each.
"""

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.utils import lockdep, xfercheck
from distributed_faiss_tpu_torch.utils.atomics import AtomicCounters
from distributed_faiss_tpu_torch.utils.config import SchedulerCfg
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

logger = logging.getLogger()


class SchedulerBusy(RuntimeError):
    """The request queue is full. Retryable."""

    def __init__(self, queue_depth: int, max_queue: int):
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        super().__init__(f"scheduler queue full ({queue_depth}/{max_queue} requests)")


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before it reached the device."""


class SchedulerStopped(RuntimeError):
    """The scheduler was stopped while this request was queued."""


class _Request:
    __slots__ = ("index_id", "q", "k", "return_embeddings", "deadline", "eager",
                 "enqueue_t", "event", "result", "error", "callback", "trace_id")

    def __init__(self, index_id: str, q: np.ndarray, k: int, return_embeddings: bool,
                 deadline: Optional[float], eager: bool = False,
                 callback: Optional[Callable] = None, trace_id: Optional[str] = None):
        self.index_id = index_id
        self.q = q
        self.k = k
        self.return_embeddings = return_embeddings
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.eager = eager  # head of queue flushes without the wait window
        self.enqueue_t = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.callback = callback  # fired once with (result, error)
        self.trace_id = trace_id  # a sampled request's trace, else None

    @property
    def key(self) -> Tuple:
        return (self.index_id, self.k, self.return_embeddings, self.q.shape[1])

    @property
    def rows(self) -> int:
        return self.q.shape[0]


def _split_rows(value, offsets: List[Tuple[int, int]]):
    """Split one element of a batched result back per caller: arrays and
    lists along the row axis, None and scalars broadcast."""
    if value is None:
        return [None] * len(offsets)
    if isinstance(value, (np.ndarray, list)):
        return [value[lo:hi] for lo, hi in offsets]
    return [value] * len(offsets)


class SearchScheduler:
    """Bounded queue + batcher thread coalescing concurrent searches.

    ``search_fn(index_id, query_batch, top_k, return_embeddings)`` is the
    engine's batched entry (``engine.Index.search_batched`` on a server).
    ``span_buffer`` (the owning server's ring) receives the spans of
    sampled requests; None records none."""

    def __init__(self, search_fn: Callable, cfg: Optional[SchedulerCfg] = None,
                 name: str = "search-batcher", span_buffer=None):
        self._search_fn = search_fn
        self.cfg = cfg if cfg is not None else SchedulerCfg()
        self.spans = span_buffer
        self._cond = lockdep.condition("SearchScheduler._cond")
        self._queue: List[_Request] = []
        self._stopping = False
        self.stats = LatencyStats()
        self._counters = AtomicCounters(("submitted", "batches", "shed_deadline",
                                         "rejected_busy"))
        self._thread = threading.Thread(target=self._batcher_loop, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ client side

    def submit(self, index_id: str, query_batch: np.ndarray, top_k: int,
               return_embeddings: bool = False, deadline: Optional[float] = None,
               eager: bool = False, trace_id: Optional[str] = None):
        """Enqueue one search and block until its slice of a merged launch
        is ready. ``eager`` flushes without the wait window when this
        request heads the queue (a one-in-flight caller, whose followers
        cannot arrive)."""
        req = self.submit_async(index_id, query_batch, top_k, return_embeddings,
                                deadline=deadline, eager=eager, trace_id=trace_id)
        # timed waits: the escape hatch for a batcher thread that died
        while not req.event.wait(timeout=5.0):
            if not self._thread.is_alive() and not req.event.is_set():
                raise SchedulerStopped("scheduler batcher thread died with this "
                                       "request in flight")
        if req.error is not None:
            raise req.error
        self.stats.record("e2e_s", time.monotonic() - req.enqueue_t, exemplar=req.trace_id)
        return req.result

    def submit_async(self, index_id: str, query_batch: np.ndarray, top_k: int,
                     return_embeddings: bool = False, deadline: Optional[float] = None,
                     eager: bool = False, callback: Optional[Callable] = None,
                     trace_id: Optional[str] = None) -> _Request:
        """Admission-checked enqueue that returns at once. ``callback(result,
        error)`` fires exactly once on the batcher thread. Admission failures
        raise here and the callback never fires."""
        q = np.asarray(query_batch, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query batch must be 2-D, got shape {q.shape}")
        req = _Request(index_id, q, int(top_k), bool(return_embeddings), deadline,
                       eager=eager, callback=callback, trace_id=trace_id)
        with self._cond:
            if self._stopping:
                raise SchedulerStopped("scheduler is stopped")
            if deadline is not None and time.monotonic() >= deadline:
                self._counters.inc("shed_deadline")
                raise DeadlineExpired("deadline expired before the request was admitted")
            if len(self._queue) >= self.cfg.max_queue:
                self._counters.inc("rejected_busy")
                raise SchedulerBusy(len(self._queue), self.cfg.max_queue)
            self._counters.inc("submitted")
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def _finish(self, req: _Request) -> None:
        """Publish a request's outcome exactly once."""
        if req.event.is_set():
            return
        if req.error is None and req.result is None:
            req.error = RuntimeError("scheduled search aborted")
        req.event.set()
        if req.callback is not None:
            if req.error is None:
                self.stats.record("e2e_s", time.monotonic() - req.enqueue_t,
                                  exemplar=req.trace_id)
            try:
                req.callback(req.result, req.error)
            except Exception:
                logger.exception("scheduler completion callback failed")

    # ----------------------------------------------------------- batcher side

    def _batcher_loop(self) -> None:
        while True:
            try:
                batch = self._next_batch()
            except Exception:
                # the thread must survive: fail what is queued, keep serving
                logger.exception("scheduler flush-wait failed")
                with self._cond:
                    stranded, self._queue = self._queue, []
                for r in stranded:
                    r.error = RuntimeError("scheduler internal error")
                    self._finish(r)
                time.sleep(0.05)
                continue
            if batch is None:
                return
            try:
                self._serve(batch)
            except Exception:
                logger.exception("scheduler batch failed")
                for r in batch:
                    self._finish(r)

    def _next_batch(self) -> Optional[List[_Request]]:
        max_wait_s = self.cfg.max_wait_ms / 1000.0
        with self._cond:
            while True:
                if self._stopping:
                    return None
                if not self._queue:
                    self._cond.wait(timeout=1.0)
                    continue
                head = self._queue[0]
                rows = sum(r.rows for r in self._queue if r.key == head.key)
                flush_at = head.enqueue_t + max_wait_s
                now = time.monotonic()
                if not head.eager and rows < self.cfg.max_batch_rows and now < flush_at:
                    self._cond.wait(flush_at - now)
                    continue
                # whole compatible requests until the row budget is reached;
                # a single over-budget request still goes alone
                taken, taken_rows, rest = [], 0, []
                for r in self._queue:
                    if r.key == head.key and taken_rows < self.cfg.max_batch_rows:
                        taken.append(r)
                        taken_rows += r.rows
                    else:
                        rest.append(r)
                self._queue = rest
                self.stats.record("queue_depth", float(len(rest)))
                return taken

    def _serve(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                self._counters.inc("shed_deadline")
                r.error = DeadlineExpired(
                    f"deadline expired while queued (waited {now - r.enqueue_t:.3f}s)")
                self._finish(r)
                continue
            self.stats.record("queue_wait_s", now - r.enqueue_t, exemplar=r.trace_id)
            live.append(r)
        if not live:
            return
        window = self._counters.inc("batches")
        n_rows = sum(r.rows for r in live)
        self.stats.record("batch_requests", float(len(live)))
        self.stats.record("batch_rows", float(n_rows))
        traced = ([r for r in live if r.trace_id is not None]
                  if self.spans is not None else [])
        if traced:
            # one queue span a sampled request: its merge window and that
            # window's occupancy
            now_w = time.time()
            for r in traced:
                waited = now - r.enqueue_t
                self.spans.record(r.trace_id, "server.queue", now_w - waited, waited,
                                  window=window, occupancy_requests=len(live),
                                  occupancy_rows=n_rows)
        head = live[0]
        try:
            qcat = head.q if len(live) == 1 else np.concatenate([r.q for r in live])
            if traced:
                obs_spans.set_current_trace(traced[0].trace_id,
                                            window=[r.trace_id for r in traced])
                launch_w0, launch_p0 = time.time(), time.perf_counter()
            try:
                # DFT_XFERCHECK=1: the merged window's launch is a guarded
                # section; a sync outside an explicit() fetch fails it
                with xfercheck.guarded("scheduler merge-window flush"):
                    result = self._search_fn(head.index_id, qcat, head.k,
                                             head.return_embeddings)
            finally:
                if traced:
                    # the window is one launch: each sampled request shares
                    # its timing
                    launch_dt = time.perf_counter() - launch_p0
                    obs_spans.set_current_trace(None)
                    for r in traced:
                        self.spans.record(r.trace_id, "server.device", launch_w0, launch_dt,
                                          window=window, rows=n_rows)
            if not isinstance(result, tuple):
                result = (result,)
            offsets, ofs = [], 0
            for r in live:
                offsets.append((ofs, ofs + r.rows))
                ofs += r.rows
            per_elem = [_split_rows(v, offsets) for v in result]
            for i, r in enumerate(live):
                r.result = tuple(elem[i] for elem in per_elem)
        except Exception as exc:
            # one application error fails exactly the callers of this launch,
            # each with its own exception object
            for r in live:
                try:
                    err = type(exc)(*exc.args)
                except Exception:
                    err = RuntimeError(f"scheduled search failed: {exc!r}")
                err.__cause__ = exc
                r.error = err
        finally:
            for r in live:
                self._finish(r)

    # ------------------------------------------------------------- lifecycle

    def stop(self) -> None:
        """Stop the batcher and fail everything still queued."""
        with self._cond:
            self._stopping = True
            stranded, self._queue = self._queue, []
            self._cond.notify_all()
        for r in stranded:
            r.error = SchedulerStopped("scheduler stopped with request queued")
            self._finish(r)
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            logger.warning("scheduler batcher thread did not exit in 10s")

    def perf_stats(self, raw: bool = False) -> dict:
        """{"counters": {...}, "queues": {metric: summary}}; ``raw`` adds the
        bucket histograms."""
        with self._cond:
            # AtomicCounters._lock is a leaf: safe under _cond
            counters = self._counters.snapshot()
            counters["queued"] = len(self._queue)
        return {"counters": counters, "queues": self.stats.summary(raw=raw)}
