"""In-process natural batching in front of the engine's device search
(counterpart of distributed_faiss_tpu/utils/batching.py).

``SearchBatcher`` coalesces concurrent ``search(q, k)`` calls into shared
device launches. A launch costs a fixed host-side price (the probe plan, the
kernel launches, the copies back) whatever its row count, so N callers
that each pay their own launch waste N-1 of them.

Leader/follower protocol ("natural batching"):

- The first caller to find no batch in flight becomes the LEADER. It
  optionally sleeps ``window_ms`` (0 by default: no added latency), then
  drains everything queued, groups by (k, dim), runs one launch per
  group, and hands each caller its row slice.
- Callers arriving while a launch is in flight just enqueue; the leader
  keeps draining (load -> bigger batches, idle -> single-request latency,
  no background thread). To bound the leader's own caller latency under
  sustained load, leadership is HANDED OFF after ``max_rounds`` drains:
  the leader wakes one pending caller as the next leader and returns.

There is exactly one leader at a time, so the engine's one in-flight
device search per index is kept.
"""

import threading
from typing import Callable, List, Tuple

import numpy as np

from distributed_faiss_tpu_torch.utils import lockdep


class _Entry:
    __slots__ = ("q", "k", "event", "scores", "ids", "error", "promoted")

    def __init__(self, q: np.ndarray, k: int):
        self.q = q
        self.k = k
        self.event = threading.Event()
        self.scores = None
        self.ids = None
        self.error = None
        self.promoted = False

    @property
    def done(self) -> bool:
        return self.error is not None or self.scores is not None


class SearchBatcher:
    """Coalesce concurrent search calls into shared device launches.

    run: ``(q_concat (n, d) fp32, k) -> (scores (n, k), ids (n, k))`` —
    the underlying (locked) device search. window_ms: how long a leader
    waits for followers before draining; 0 = never wait (natural
    batching only). max_rounds: drain rounds before leadership handoff.
    """

    def __init__(self, run: Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]],
                 window_ms: float = 0.0, max_rounds: int = 4):
        self._run = run
        self._window_s = max(0.0, float(window_ms)) / 1000.0
        self._max_rounds = max(1, int(max_rounds))
        self._lock = lockdep.lock("SearchBatcher._lock")
        self._pending: List[_Entry] = []
        self._leader_active = False

    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q)
        if q.ndim != 2:
            raise ValueError(f"query batch must be 2-D, got shape {q.shape}")
        entry = _Entry(q, int(k))
        with self._lock:
            self._pending.append(entry)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if not lead:
            entry.event.wait()
            if not entry.promoted:
                if entry.error is not None:
                    raise entry.error
                return entry.scores, entry.ids
            # handed leadership: _leader_active is still True for us

        if self._window_s and not entry.done:
            # wait for followers; our own event cannot fire (we lead)
            threading.Event().wait(self._window_s)
        try:
            rounds = 0
            while True:
                with self._lock:
                    batch = self._pending
                    self._pending = []
                    if not batch:
                        self._leader_active = False
                        break
                self._serve(batch)
                rounds += 1
                if rounds >= self._max_rounds and entry.done:
                    # bound our caller's latency under sustained load:
                    # hand leadership to the next queued caller (if any)
                    with self._lock:
                        if not self._pending:
                            self._leader_active = False
                            break
                        successor = self._pending[0]
                    successor.promoted = True
                    successor.event.set()
                    break
        except BaseException:
            # never leave the batcher wedged: fail whatever is queued
            with self._lock:
                stranded = self._pending
                self._pending = []
                self._leader_active = False
            for e in stranded:
                e.error = RuntimeError("search batch leader died")
                e.event.set()
            raise
        if entry.error is not None:
            raise entry.error
        return entry.scores, entry.ids

    def _serve(self, batch: List[_Entry]) -> None:
        # group by (k, dim): a malformed caller can only fail its own group,
        # and only callers whose shapes really merged share a fate
        groups = {}
        for e in batch:
            groups.setdefault((e.k, e.q.shape[1]), []).append(e)
        try:
            for (k, _d), group in groups.items():
                try:
                    qcat = group[0].q if len(group) == 1 else np.concatenate(
                        [e.q for e in group], axis=0)
                    scores, ids = self._run(qcat, k)
                    ofs = 0
                    for e in group:
                        n = e.q.shape[0]
                        e.scores = scores[ofs:ofs + n]
                        e.ids = ids[ofs:ofs + n]
                        ofs += n
                except Exception as exc:  # reaches every caller in the group
                    for e in group:
                        e.error = exc
                finally:
                    for e in group:
                        # a BaseException from the launch (KeyboardInterrupt,
                        # SystemExit) skips both branches above: never wake a
                        # caller with neither result nor error
                        if not e.done:
                            e.error = RuntimeError("search batch aborted")
                        e.event.set()
        finally:
            # a BaseException mid-iteration reaches the per-group finally of
            # the failing group only; the batch was already popped from
            # _pending, so the groups the loop never reached would wait
            # forever: sweep the whole batch
            for e in batch:
                if not e.event.is_set():
                    if not e.done:
                        e.error = RuntimeError("search batch aborted")
                    e.event.set()
