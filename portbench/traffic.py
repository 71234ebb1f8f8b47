"""The one traffic generator: a closed loop, as model workers send their
batches. Each client sends its next request when its last one is answered;
a mix (``traffic/<mix>.json``) sets the clients, the rows a request and k.

Every request takes the next rows of the query pool, so no query is sent
twice in a run. The pool is a list of equal chunks of whole requests: those
drawn in set-up, and after them chunks drawn from the seed's stream in a
thread of its own while the window runs, once fewer than ``AHEAD`` are left,
so no rate runs it dry; a request that finds its chunk not drawn yet waits
for it, and the wait counts in its latency.
"""

import threading
import time

import numpy as np


class PoolExhausted(RuntimeError):
    """The query pool ran out inside the window (a pool with no more chunks
    to draw) or its drawing failed."""


# rows a chunk of the pool holds, at least (rounded up to whole requests)
CHUNK_ROWS = 1 << 16
# chunks kept drawn beyond the one being taken
AHEAD = 2


def chunk_rows(rows_per_request: int) -> int:
    r = int(rows_per_request)
    return -(-CHUNK_ROWS // r) * r


class Pool:
    """``chunks``: the rows drawn in set-up, equal chunks of whole requests;
    ``more(i)``: draws chunk ``i`` (None: the pool ends with ``chunks``)."""

    def __init__(self, chunks: list, rows_per_request: int, more=None):
        self.rows = int(rows_per_request)
        self._chunks = list(chunks)
        self.chunk_rows = int(self._chunks[0].shape[0])
        if self.chunk_rows % self.rows or any(c.shape[0] != self.chunk_rows for c in chunks):
            raise ValueError("pool chunks must be equal and hold whole requests")
        self.first = len(self._chunks)
        self._more = more
        self._next = 0
        self._cv = threading.Condition()
        self._closed = False
        self.failure = None
        self.waits, self.wait_s, self.draw_s = 0, 0.0, 0.0
        self._thread = None
        if more is not None:
            self._thread = threading.Thread(target=self._draw, name="bench-pool", daemon=True)
            self._thread.start()

    @property
    def drawn(self) -> int:
        """Chunks drawn while the loop ran."""
        return len(self._chunks) - self.first

    def _draw(self) -> None:
        while True:
            with self._cv:
                while not self._closed and \
                        len(self._chunks) > self._next // self.chunk_rows + AHEAD:
                    self._cv.wait()
                if self._closed:
                    return
                i = len(self._chunks)
            t = time.perf_counter()
            try:
                chunk = self._more(i)
            except Exception as e:  # reported by the take that needed the chunk
                with self._cv:
                    self.failure = e
                    self._cv.notify_all()
                return
            with self._cv:
                self.draw_s += time.perf_counter() - t
                self._chunks.append(chunk)
                self._cv.notify_all()

    def take(self) -> int:
        """The pool offset of the next request's rows."""
        with self._cv:
            start = self._next
            self._next = start + self.rows
            c = start // self.chunk_rows
            if c + AHEAD >= len(self._chunks):
                self._cv.notify_all()
            if c >= len(self._chunks):
                t = time.perf_counter()
                while (c >= len(self._chunks) and self._more is not None
                       and self.failure is None and not self._closed):
                    self._cv.wait()
                if c >= len(self._chunks):
                    why = f": {self.failure}" if self.failure is not None else ""
                    raise PoolExhausted(
                        f"query pool of {len(self._chunks) * self.chunk_rows} rows ran out{why}")
                self.waits += 1
                self.wait_s += time.perf_counter() - t
            return start

    def batch(self, offset: int) -> np.ndarray:
        """The rows of the request at ``offset``."""
        c, o = divmod(int(offset), self.chunk_rows)
        return self._chunks[c][o:o + self.rows]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()


class Request:
    __slots__ = ("client", "offset", "sent", "done", "error", "dist", "ids")

    def __init__(self, client: int, offset: int, sent: float):
        self.client, self.offset, self.sent = client, offset, sent
        self.done = None
        self.error = None
        self.dist = self.ids = None

    @property
    def latency(self) -> float:
        return self.done - self.sent


def meta_ids(meta) -> np.ndarray:
    """The served ids (the integer metadata each row was added with) as an
    int64 array; -1 where a slot came back empty."""
    try:
        return np.asarray(meta, np.int64)
    except (TypeError, ValueError):
        return np.asarray([[-1 if m is None else int(m) for m in row] for row in meta], np.int64)


class ClosedLoop:
    """``len(searchers)`` client threads; ``searchers[c](queries, k)``
    returns (distances, metadata). ``run`` drives them until ``stop_at``
    (host clock) or until ``stop`` is set, and returns every request, in
    the order they were sent."""

    def __init__(self, searchers: list, pool: Pool, k: int):
        self.searchers = searchers
        self.pool = pool
        self.k = int(k)
        self.requests = []
        self.errors = []
        self.stop = threading.Event()
        self._lock = threading.Lock()

    def _client(self, c: int, start: threading.Event, stop_at: float) -> None:
        search = self.searchers[c]
        start.wait()
        while time.perf_counter() < stop_at and not self.stop.is_set():
            sent = time.perf_counter()
            try:
                off = self.pool.take()
            except PoolExhausted as e:
                with self._lock:
                    self.errors.append(e)
                return
            req = Request(c, off, sent)
            with self._lock:
                self.requests.append(req)
            try:
                dist, meta = search(self.pool.batch(off), self.k)
                req.dist, req.ids = np.asarray(dist, np.float32), meta_ids(meta)
            except Exception as e:  # a failed request; counted, and the loop goes on
                req.error = f"{type(e).__name__}: {e}"
            req.done = time.perf_counter()

    def run(self, stop_at: float, join_timeout: float) -> list:
        """Run the clients; wait for the requests in flight at the close
        until ``join_timeout`` past ``stop_at`` (or past ``stop``)."""
        start = threading.Event()
        threads = [threading.Thread(target=self._client, args=(c, start, stop_at),
                                    name=f"bench-client-{c}", daemon=True)
                   for c in range(len(self.searchers))]
        for t in threads:
            t.start()
        start.set()
        while time.perf_counter() < stop_at and not self.stop.wait(0.05):
            pass
        deadline = min(stop_at, time.perf_counter()) + join_timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        self.stragglers = sum(t.is_alive() for t in threads)
        if self.errors:
            raise self.errors[0]
        return list(self.requests)


def window_stats(requests: list, w0: float, w1: float) -> dict:
    """The end-to-end numbers of the window [w0, w1]: query rows answered
    in it over its seconds, and the 95th percentile of the latency of every
    request that completed in it (a failed one counts as missing: +inf)."""
    done = [r for r in requests if r.done is not None and w0 <= r.done <= w1]
    ok = [r for r in done if r.error is None]
    rows = sum(r.ids.shape[0] for r in ok)
    lat = np.array([r.latency if r.error is None else np.inf for r in done])
    return {"qps": rows / (w1 - w0), "requests": len(done), "failed": len(done) - len(ok),
            "p95_ms": float(np.percentile(lat, 95)) * 1e3 if len(lat) else float("inf"),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3 if len(lat) else float("inf")}
