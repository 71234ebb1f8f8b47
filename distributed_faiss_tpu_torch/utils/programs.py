"""The program cache: each model's search programs captured as CUDA graphs
and replayed (the port's counterpart of the JAX package's jitted search
programs; the JAX package needs no module for it, ``jax.jit`` is its cache).

The JAX package runs the whole search of a query block (coarse
top-nprobe, the probe groups, the scan kernel, the merges, the exact
refine) as one ``jax.jit`` program, and a window of several blocks as one
program over the stacked blocks (``lax.map``); the query buckets
(``ops.distance.bucket_size``) keep the set of programs bounded. PyTorch
runs op by op, so the port issues each of those ops from Python. Here a
model's search function is captured once as a CUDA graph
(``torch.cuda.graph``) and replayed: one launch for the block or for the
window, as the JAX program is one. One graph a key is the counterpart of
one XLA executable a jit signature.

``ProgramCache`` (one a model: ``TorchIndex.programs``) keys a program on
its name (the model's search function, per block or over the window), its
static arguments (k, nprobe, probe group, metric, codec, refine, LUT
dtype, chunk), the input's bucketed shape, and the state it reads: the
``data_ptr``, shape, stride and dtype of every device tensor the program
reads (lists, ids, sizes, norms, codebooks, refine store, live mask) and
the host ints it was captured with (fill counts). A graph reads those
addresses at every replay, so
- a mutation that reallocates a tensor (an add that grows the lists or
  rewrites the sizes) changes the key, and a stale graph is never
  replayed; the programs read from the superseded state are evicted, and
  their graphs freed (the pool too, with its last graph);
- a mutation written in place (the tombstone masks, ``mask_rows`` /
  ``mask_cells``) is read by the next replay, which the engine runs under
  ``index_lock`` as it runs every search.
At most ``MAX_PROGRAMS`` programs a model are kept, the least recently
used evicted first.

Capture: the function first runs eagerly on a side stream (the warm-up,
where the nvcc build, the library load and cuBLAS's set-up happen), then
is captured on that stream between a static input and a static output
buffer, in ``capture_error_mode="thread_local"`` under one process-wide
capture lock, so other threads may serve other indexes meanwhile. A
model's programs share one memory pool. That is safe only because one
model's replays are serialized (the cache's lock is held from the upload
to the fetch) and each replay's output is copied to the host before the
next replay runs: two programs of one pool may reuse each other's
intermediate memory, never at the same time. A capture or a replay that
fails raises; nothing falls back to op by op.

A replay is one upload of the padded queries into the static input, the
graph's replay, and one fetch of its output, the scores' bits packed
beside the ids. A program may take host ints beside the queries (the
mesh's routed programs take the block's real row count) and return a
third output, a count (the routed pairs dropped): the ints ride in the
same upload as the queries, the count in the same fetch as the scores
and ids, so a routed block is one upload, one replay and one fetch where
the JAX package reads its drop count and its results in two readbacks.
The kernel wrappers count their launches through
``count_launches``: during a capture the counts are recorded into the
program, and each replay adds them to the wrappers' ``launches``, so the
counts stay true under replay. ``count`` does the same for any other
counter of launches (the mesh's per-shard counts), and ``tally`` counts
the launches a section of code makes, captured or not.

Each capture is a ``utils/compilecheck.py`` record ``capture:<name>``, the
counterpart of the JAX witness's compile tally: a steady-state window
asserts that nothing was captured. Counters on the cache: ``captures``,
``capture_s``, ``replays``, ``evictions``; ``pool_bytes()`` reads the
pool's size from the allocator.

The same functions run op by op (one upload, the ops, one fetch):
- for inputs on the CPU, unless a capture backend was injected (the tests
  drive the cache on the CPU with a recording stand-in);
- inside ``eager()``, the counterpart of ``jax.disable_jit()``, which the
  tests and ``chip_smoke.py`` enter for the A/B. It holds for the whole
  process while entered (the serving threads run the searches);
- under GRAFT_SANITIZE=1, whose checks read the operands on the host
  before each launch (``utils/sanitize.py``);
- where the model asks for no programs: a mesh over several devices
  (a graph is one device's).

``utils/jitreg.py`` declares every program name and its bucket budget.
"""

import collections
import contextlib
import functools
import threading
import time

import numpy as np
import torch

from distributed_faiss_tpu_torch.utils import compilecheck, lockdep, sanitize, xfercheck

__all__ = [
    "MAX_PROGRAMS", "ProgramCache", "CudaGraphs", "RecordingGraphs", "eager", "is_eager",
    "count", "count_launches", "tally", "recording", "signature", "run_eager",
]

MAX_PROGRAMS = 32

_TLS = threading.local()  # .recording: counter updates of the capture; .tallies
# one capture at a time in the process; taken inside a cache's lock
_capture_lock = lockdep.lock("programs._capture_lock")
# guards _eager_depth; a strict leaf
_eager_lock = lockdep.lock("programs._eager_lock")
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every program op by op while this is entered, in every thread
    of the process (the counterpart of ``jax.disable_jit()``)."""
    global _eager_depth
    with _eager_lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _eager_lock:
            _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0


# ------------------------------------------------------------- launch counts


@contextlib.contextmanager
def recording(updates: list):
    """Record this thread's counter updates into ``updates`` instead of
    applying them (the capture of a program)."""
    prev = getattr(_TLS, "recording", None)
    _TLS.recording = updates
    try:
        yield updates
    finally:
        _TLS.recording = prev


def count(update) -> None:
    """Apply ``update()``, a counter update for launches made now; while
    this thread captures a program it is recorded instead, and each replay
    of the program applies it."""
    rec = getattr(_TLS, "recording", None)
    if rec is not None:
        rec.append(update)
    else:
        update()


def _add_launches(lock, wrappers) -> None:
    with lock:
        for wrapper in wrappers:
            wrapper.launches += 1


def count_launches(lock, *wrappers) -> None:
    """One launch of each wrapper's kernel (their ``launches`` guarded by
    ``lock``), counted now or at each replay (``count``)."""
    for t in getattr(_TLS, "tallies", ()):
        t.update(wrappers)
    count(functools.partial(_add_launches, lock, wrappers))


@contextlib.contextmanager
def tally():
    """A Counter of the launches this thread's wrappers make inside the
    block, by wrapper, whether they run now or are captured."""
    tallies = getattr(_TLS, "tallies", None)
    if tallies is None:
        tallies = _TLS.tallies = []
    t = collections.Counter()
    tallies.append(t)
    try:
        yield t
    finally:
        tallies.pop()


# ------------------------------------------------------------- one program


def signature(reads) -> tuple:
    """The key of the state a program reads: each tensor's address, shape,
    stride, dtype and device; a host value as itself; lists nested."""
    out = []
    for r in reads:
        if isinstance(r, torch.Tensor):
            out.append((r.data_ptr(), tuple(r.shape), r.stride(), str(r.dtype), str(r.device)))
        elif isinstance(r, (list, tuple)):
            out.append(signature(r))
        else:
            out.append(r)
    return tuple(out)


def _pack(outs) -> torch.Tensor:
    """(..., k) scores and ids -> one (..., 2k) int32 tensor, the scores'
    bits beside the ids, so that one copy fetches both; a third output (a
    count) rides after them in a flat tensor."""
    packed = torch.cat([outs[0].float().view(torch.int32), outs[1].to(torch.int32)], dim=-1)
    if len(outs) == 2:
        return packed
    return torch.cat([packed.reshape(-1), outs[2].reshape(1).to(torch.int32)])


def _inputs(x) -> tuple:
    """A program's host inputs: the queries, or a tuple of the queries and
    other arrays of 4-byte items (host ints), uploaded as one buffer."""
    return x if isinstance(x, tuple) else (x,)


def _static_input(xs: tuple, device):
    """One flat 4-byte buffer for the inputs ``xs`` and a view of it shaped
    and typed as each."""
    flat = torch.empty(sum(a.size for a in xs), dtype=torch.float32, device=device)
    views, o = [], 0
    for a in xs:
        dtype = torch.float32 if a.dtype == np.float32 else torch.int32
        views.append(flat[o:o + a.size].view(dtype).view(a.shape))
        o += a.size
    return flat, views


def _upload(xs: tuple, dst: torch.Tensor) -> None:
    host = xs[0].reshape(-1) if len(xs) == 1 else np.concatenate(
        [np.ascontiguousarray(a).reshape(-1).view(np.float32) for a in xs])
    with xfercheck.explicit("program query upload"):
        dst.copy_(torch.from_numpy(host))


def _fetch(packed: torch.Tensor, rows: tuple):
    """Host (scores float32, ids int32) of a packed output whose leading
    dims are ``rows``, and its count when it has one."""
    with xfercheck.explicit("program result fetch"):
        host = packed.to("cpu", copy=True).numpy()
    extra = ()
    if host.ndim == 1:
        host, extra = host[:-1].reshape(rows + (-1,)), (int(host[-1]),)
    k = host.shape[-1] // 2
    return (host[..., :k].view(np.float32), host[..., k:]) + extra


def run_eager(fn, x, device):
    """``fn`` op by op over the host batch ``x`` (``_inputs``): one upload,
    the ops, one fetch. Returns host (scores float32, ids int32) and the
    count where ``fn`` returns one."""
    xs = _inputs(x)
    flat, views = _static_input(xs, device)
    _upload(xs, flat)
    return _fetch(_pack(fn(*views)), xs[0].shape[:-1])


class CudaGraphs:
    """The capture backend on a card: ``torch.cuda.graph``."""

    def pool(self, device):
        return torch.cuda.graph_pool_handle()

    def capture(self, run, traced, device, pool):
        """Run ``run()`` on a side stream (the warm-up), then capture
        ``traced()`` (the same, its counter updates recorded) on it into a
        graph of ``pool``. Returns (graph, traced's output)."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = traced()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()

    def release(self, graph) -> None:
        graph.reset()

    def pool_bytes(self, pool) -> int:
        pid = tuple(pool)
        return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pid)


_CUDA = CudaGraphs()


class RecordingGraphs:
    """A stand-in capture backend that drives the cache on the CPU (the
    tests): a "capture" runs the warm-up and the traced function eagerly,
    a "replay" runs the function again into the static output, its counter
    updates dropped since the cache applies the recorded ones. Counts its
    captures and replays."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def pool(self, device):
        return ("recording", id(self))

    def capture(self, run, traced, device, pool):
        run()
        out = traced()
        self.captures += 1
        return (run, out), out

    def replay(self, graph) -> None:
        run, out = graph
        with recording([]):
            out[...] = run()
        self.replays += 1

    def release(self, graph) -> None:
        pass

    def pool_bytes(self, pool) -> int:
        return 0


class _Program:
    __slots__ = ("static_in", "static_out", "graph", "updates", "rows")

    def __init__(self, static_in, static_out, graph, updates, rows):
        self.static_in = static_in
        self.static_out = static_out
        self.graph = graph
        self.updates = updates
        self.rows = rows


class _Bound:
    """A cache bound to one search's static arguments and read state:
    ``run(name, fn, x, device)``, what ``models.base.blocked_search``
    calls for each block or window."""

    def __init__(self, cache, prefix: str, static: tuple, reads: tuple):
        self.cache = cache
        self.prefix = prefix
        self.static = static
        self.state = signature(reads)

    def run(self, name: str, fn, x, device, static: tuple = ()):
        """``static``: more static arguments of this program (the routed
        programs' pair bucket)."""
        return self.cache.run(f"{self.prefix}.{name}", fn, x, device, self.static + static,
                              self.state)


class ProgramCache:
    """One model's captured programs (module docstring)."""

    def __init__(self):
        # None: CUDA graphs for inputs on a card, op by op for the CPU; the
        # tests set a stand-in
        self.backend = None
        self.max_programs = MAX_PROGRAMS
        self._lock = lockdep.lock("ProgramCache.lock")
        self._programs = collections.OrderedDict()  # key -> _Program, LRU order
        self._pool = None  # (backend, pool handle) shared by the programs
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.evictions = 0

    def bind(self, prefix: str, static=(), reads=()) -> _Bound:
        return _Bound(self, prefix, tuple(static), tuple(reads))

    def _backend(self, device: torch.device):
        if is_eager() or sanitize.enabled():
            return None
        if self.backend is not None:
            return self.backend
        return _CUDA if device.type == "cuda" else None

    def run(self, name: str, fn, x, device, static: tuple, state: tuple):
        """``fn`` (a (rows, d) or (nblocks, block, d) device batch, and the
        other inputs of ``x`` (``_inputs``) -> (scores, ids) or (scores,
        ids, count)) over the host batch ``x`` as the program of ``name``
        for these static arguments and read state (``signature``):
        replayed, captured first when there is none. Returns host (scores
        float32, ids int32), and the count where ``fn`` returns one."""
        device = torch.device(device)
        backend = self._backend(device)
        if backend is None:
            return run_eager(fn, x, device)
        xs = _inputs(x)
        key = (name, static, tuple(a.shape for a in xs), state)
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                self._evict(state)
                prog = self._capture(backend, name, fn, xs, device)
                self._programs[key] = prog
            else:
                self._programs.move_to_end(key)
            _upload(xs, prog.static_in)
            backend.replay(prog.graph)
            for update in prog.updates:
                update()
            self.replays += 1
            return _fetch(prog.static_out, prog.rows)

    def _capture(self, backend, name, fn, xs, device) -> _Program:
        if self._pool is None:
            self._pool = (backend, backend.pool(device))
        static_in, views = _static_input(xs, device)
        static_in.zero_()
        updates = []

        def run():
            return _pack(fn(*views))

        def traced():
            with recording(updates):
                return run()

        compilecheck.record(f"capture:{name}")
        t0 = time.perf_counter()
        # the capture synchronizes the device first (torch.cuda.graph)
        with xfercheck.explicit("program capture"):
            graph, static_out = backend.capture(run, traced, device, self._pool[1])
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return _Program(static_in, static_out, graph, updates, xs[0].shape[:-1])

    def _drop(self, key) -> None:
        prog = self._programs.pop(key)
        self._pool[0].release(prog.graph)
        self.evictions += 1

    def _evict(self, state: tuple) -> None:
        """Before a capture: evict the programs read from another state
        (superseded by a mutation), then the least recently used past the
        bound; a pool left without programs goes with them."""
        for key in [k for k in self._programs if k[3] != state]:
            self._drop(key)
        while len(self._programs) >= self.max_programs:
            self._drop(next(iter(self._programs)))
        if not self._programs:
            self._pool = None

    def clear(self) -> None:
        """Free every program and the pool (the model was swapped out)."""
        with self._lock:
            for key in list(self._programs):
                self._drop(key)
            self._pool = None

    def __len__(self) -> int:
        return len(self._programs)

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in this cache's graph pool (0 without
        one)."""
        with self._lock:
            if self._pool is None:
                return 0
            return self._pool[0].pool_bytes(self._pool[1])

    def stats(self) -> dict:
        return {"programs": len(self._programs), "captures": self.captures,
                "capture_s": self.capture_s, "replays": self.replays,
                "evictions": self.evictions, "pool_bytes": self.pool_bytes()}
