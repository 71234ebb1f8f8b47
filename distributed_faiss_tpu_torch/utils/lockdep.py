"""Runtime lock-order witness (DFT_LOCKDEP=1) over the port's pinned locks
(counterpart of distributed_faiss_tpu/utils/lockdep.py, same semantics).

Every pinned lock of the port is created through the ``lock()`` /
``rlock()`` / ``condition()`` factories below, under the JAX package's key
where the JAX package has the lock (``"Index.buffer_lock"``) and a key of
its own otherwise (``"flat_scan._counter_lock"``). With ``DFT_LOCKDEP=1``
each returned primitive records

- per thread, the ordered list of held lockdep keys, and
- globally, every acquisition edge ``held-key -> acquired-key`` ever
  observed (with the thread and call site that first produced it).

An acquisition whose new edge would close a cycle in that graph raises
``LockOrderError`` *before blocking*: a would-be ABBA deadlock becomes a
loud failure naming both chains instead of a hung rank. Re-acquiring a
non-reentrant key the thread already holds raises at once
(self-deadlock). ``Condition.wait`` drops the key for the wait.

Keys are lock *classes*, not instances: an edge observed between the
locks of two Index instances still orders the classes, which catches an
ABBA hazard on the interleaving that did not happen to deadlock. The
knob is read when a lock is created, so a module-level lock (the kernel
wrappers' launch counters, the build locks) follows the environment the
module was imported under.

Disabled (the default), the factories return plain ``threading``
primitives: nothing is wrapped. ``DFT_RACECHECK=1`` turns the factories
on too (utils/racecheck.py intersects locksets with ``held()``).
"""

import os
import threading
import traceback

from distributed_faiss_tpu_torch.utils import envutil

__all__ = [
    "LockOrderError", "enabled", "lock", "rlock", "condition",
    "reset", "edges", "held",
]


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the observed lock-order
    graph (or re-acquire a held non-reentrant lock): a deadlock waiting
    for the right interleaving."""


def enabled() -> bool:
    """DFT_LOCKDEP master switch, read at lock-creation time (so tests
    can flip it per-fixture and subprocess ranks inherit it).
    DFT_RACECHECK=1 also turns the factories on: the shared-state race
    witness (utils/racecheck.py) intersects CANDIDATE locksets against
    ``held()``, which only tracks instrumented locks — an uninstrumented
    lock under racecheck would read as 'no locks held' and false-flag
    every guarded access."""
    return (envutil.env_flag("DFT_LOCKDEP", False)
            or envutil.env_flag("DFT_RACECHECK", False))


# ---------------------------------------------------------------- graph state
#
# _MU guards _EDGES; it is a plain lock, never itself instrumented (the
# witness must not observe its own bookkeeping). Held-lists are
# per-thread, so they need no lock at all.

_MU = threading.Lock()
_EDGES = {}  # (held_key, acquired_key) -> "thread @ file:line" provenance
_TLS = threading.local()


def _held_list():
    lst = getattr(_TLS, "held", None)
    if lst is None:
        lst = _TLS.held = []
    return lst


def held() -> tuple:
    """Ordered keys the CURRENT thread holds (oldest first)."""
    return tuple(_held_list())


def edges() -> dict:
    """Snapshot of the global acquisition-edge set."""
    with _MU:
        return dict(_EDGES)


def reset() -> None:
    """Clear the global edge graph and the current thread's held list
    (test isolation; production code never calls this)."""
    with _MU:
        _EDGES.clear()
    _TLS.held = []


def _site() -> str:
    """'thread-name @ file:line' of the acquiring frame outside this
    module — the provenance stored per edge."""
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        if not frame.filename.endswith("lockdep.py"):
            return (f"{threading.current_thread().name} @ "
                    f"{os.path.basename(frame.filename)}:{frame.lineno}")
    return threading.current_thread().name  # pragma: no cover


def _chain(start, target):
    """Edge path start -> ... -> target in _EDGES (caller holds _MU), as
    a list of keys, or None."""
    parents = {start: None}
    frontier = [start]
    while frontier:
        nxt = []
        for a in frontier:
            for (x, y) in _EDGES:
                if x != a or y in parents:
                    continue
                parents[y] = a
                if y == target:
                    path = [y]
                    while parents[path[-1]] is not None:
                        path.append(parents[path[-1]])
                    return list(reversed(path))
                nxt.append(y)
        frontier = nxt
    return None


def _before_acquire(key: str, reentrant_held: bool = False) -> None:
    """Record edges held->key and raise if one closes a cycle. Runs
    BEFORE the real acquire, so a would-be deadlock raises instead of
    blocking."""
    if reentrant_held:
        return  # re-acquiring an owned RLock can never deadlock
    held_now = _held_list()
    if key in held_now:
        raise LockOrderError(
            f"lockdep: thread {threading.current_thread().name!r} "
            f"re-acquires non-reentrant lock {key!r} while already "
            f"holding it (held: {held_now}) — self-deadlock, or two "
            "instances of the same lock class nested without a declared "
            "order"
        )
    if not held_now:
        return
    site = None  # stack extraction only when a NEW edge is recorded —
    # the steady state (every edge already known) pays a dict lookup
    with _MU:
        for h in held_now:
            if (h, key) in _EDGES:
                continue
            if site is None:
                site = _site()
            back = _chain(key, h)
            if back is not None:
                hops = " -> ".join(back)
                provenance = "; ".join(
                    f"{a}->{b} first seen at {_EDGES[(a, b)]}"
                    for a, b in zip(back, back[1:]))
                raise LockOrderError(
                    f"lockdep: acquiring {key!r} while holding {h!r} "
                    f"(at {site}) closes a lock-order cycle: the reverse "
                    f"chain {hops} was already observed ({provenance}). "
                    "One thread taking this path and another taking the "
                    "recorded one deadlock."
                )
            _EDGES[(h, key)] = site


def _after_acquire(key: str) -> None:
    _held_list().append(key)


def _after_release(key: str) -> None:
    lst = _held_list()
    # remove the newest occurrence (LIFO is the common case; out-of-order
    # release of a different occurrence is handled by scanning)
    for i in range(len(lst) - 1, -1, -1):
        if lst[i] == key:
            del lst[i]
            return


class _DepLock:
    """threading.Lock wrapper with lockdep bookkeeping."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _before_acquire(self.name, self._owned_reentrant())
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self):
        self._inner.release()
        self._note_released()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"

    # reentrancy hooks (RLock overrides)
    def _owned_reentrant(self) -> bool:
        return False

    def _note_acquired(self):
        _after_acquire(self.name)

    def _note_released(self):
        _after_release(self.name)


class _DepRLock(_DepLock):
    """threading.RLock wrapper: nested acquires by the owning thread are
    legal and recorded once (no self-edge, one held entry)."""

    def _make_inner(self):
        return threading.RLock()

    def __init__(self, name: str):
        super().__init__(name)
        self._owner = None
        self._count = 0

    def _owned_reentrant(self) -> bool:
        return self._owner == threading.get_ident()

    def _note_acquired(self):
        me = threading.get_ident()
        if self._owner == me:
            self._count += 1
            return
        self._owner = me
        self._count = 1
        _after_acquire(self.name)

    def _note_released(self):
        self._count -= 1
        if self._count == 0:
            self._owner = None
            _after_release(self.name)


class _DepCondition:
    """threading.Condition wrapper. ``wait`` releases the underlying
    lock, so the held-list drops the key for the duration and re-adds it
    on wakeup (the re-acquire happens inside ``Condition.wait``; its
    edges were recorded at the original acquire)."""

    def __init__(self, name: str):
        self.name = name
        self._cond = threading.Condition()

    def acquire(self, *args, **kwargs):
        _before_acquire(self.name)
        got = self._cond.acquire(*args, **kwargs)
        if got:
            _after_acquire(self.name)
        return got

    def release(self):
        self._cond.release()
        _after_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def wait(self, timeout=None):
        owned = getattr(self._cond, "_is_owned", lambda: True)()
        if not owned:
            # let threading raise its own "cannot wait on un-acquired
            # lock" RuntimeError without corrupting the held list (the
            # key was never pushed, so nothing must be popped/re-added)
            return self._cond.wait(timeout)
        _after_release(self.name)
        try:
            # Condition.wait re-acquires the lock before propagating
            # wakeup-path exceptions, so the finally's re-add is correct
            # on every path that reaches the real wait
            return self._cond.wait(timeout)
        finally:
            _after_acquire(self.name)

    def wait_for(self, predicate, timeout=None):
        # reimplemented over self.wait so the held-list tracking applies
        import time as _time
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f"<_DepCondition {self.name!r}>"


# ------------------------------------------------------------------ factories

def lock(name: str):
    """A ``threading.Lock`` — instrumented under DFT_LOCKDEP=1. ``name``
    is the lockdep key; use the pinned-map spelling ``Class.attr``."""
    return _DepLock(name) if enabled() else threading.Lock()


def rlock(name: str):
    """A ``threading.RLock`` — instrumented under DFT_LOCKDEP=1."""
    return _DepRLock(name) if enabled() else threading.RLock()


def condition(name: str):
    """A ``threading.Condition`` — instrumented under DFT_LOCKDEP=1."""
    return _DepCondition(name) if enabled() else threading.Condition()
