"""Runtime thread-leak witness (DFT_THREADCHECK=1): a non-daemon thread
that outlives the scope that started it is a leak (counterpart of
distributed_faiss_tpu/utils/threadcheck.py, same semantics).

- ``install()`` wraps ``threading.Thread.start`` to record each started
  thread's creation site ("file:line"), so a leak report names where the
  thread came from, not just its name;
- ``snapshot()`` before a scope and ``check(before)`` after it: any
  NON-DAEMON thread that appeared and is still alive after a bounded
  grace join (DFT_THREADCHECK_GRACE_S, default 5 s) raises
  ``ThreadLeakError``. The port's pytest plugin
  (testing/pytest_witness.py) wraps every test this way.

Daemon threads are exempt by design: they cannot block interpreter exit,
and the port's event- or connection-bound workers (save and compaction
watchers, connection readers, the batcher) are daemon for that reason.
Non-daemon threads (ThreadPoolExecutor workers are) must be joined or
shut down by whoever created them.

Disabled (the default), nothing is wrapped.
"""

import os
import threading
import time
import traceback
import weakref
from typing import Optional

from distributed_faiss_tpu_torch.utils import envutil

__all__ = [
    "ThreadLeakError", "enabled", "install", "uninstall",
    "snapshot", "leaked", "check", "provenance",
]


class ThreadLeakError(AssertionError):
    """A non-daemon thread created during the witnessed scope outlived
    it: the join path the lifecycle discipline promises never ran."""


def enabled() -> bool:
    """DFT_THREADCHECK master switch, read per call (tests flip it
    per-fixture; subprocess tiers inherit it)."""
    return envutil.env_flag("DFT_THREADCHECK", False)


# ------------------------------------------------------------- provenance
#
# Thread -> "file:line" of the start() caller. Weak keys: the registry
# must not keep dead Thread objects (and their targets' closures) alive.

_SITES = weakref.WeakKeyDictionary()
_ORIG_START = None


def _site() -> str:
    """'file:line' of the first frame outside this module and threading
    itself — the creation provenance stored per thread."""
    for frame in reversed(traceback.extract_stack(limit=12)[:-1]):
        base = os.path.basename(frame.filename)
        if base not in ("threadcheck.py", "threading.py"):
            return f"{base}:{frame.lineno}"
    return "<unknown>"  # pragma: no cover


def install() -> None:
    """Wrap ``threading.Thread.start`` to record creation provenance.
    Idempotent; wraps the CLASS, so subclass and executor threads are
    covered too."""
    global _ORIG_START
    if _ORIG_START is not None:
        return
    _ORIG_START = threading.Thread.start

    def start(self):
        _SITES[self] = _site()
        return _ORIG_START(self)

    threading.Thread.start = start


def uninstall() -> None:
    """Restore the unwrapped ``Thread.start`` (test isolation)."""
    global _ORIG_START
    if _ORIG_START is not None:
        threading.Thread.start = _ORIG_START
        _ORIG_START = None


def provenance(thread: threading.Thread) -> str:
    return _SITES.get(thread, "<unwitnessed start>")


# ------------------------------------------------------------ leak check

def snapshot() -> frozenset:
    """The live-thread set to diff against (take BEFORE the scope)."""
    return frozenset(threading.enumerate())


def _candidates(before: frozenset):
    me = threading.current_thread()
    return [
        t for t in threading.enumerate()
        if t not in before and t is not me and not t.daemon and t.is_alive()
    ]


def _default_grace() -> float:
    """DFT_THREADCHECK_GRACE_S: how long a just-stopped worker gets to
    finish winding down before it counts as leaked (tests drop it to
    fractions of a second to keep doctored-leak cases fast)."""
    return envutil.env_float("DFT_THREADCHECK_GRACE_S", 5.0)


def leaked(before: frozenset, grace_s: Optional[float] = None):
    """Non-daemon threads created since ``before`` that are still alive
    after a bounded grace join (a just-stopped worker gets ``grace_s``,
    default DFT_THREADCHECK_GRACE_S, to finish winding down before it
    counts as leaked)."""
    if grace_s is None:
        grace_s = _default_grace()
    cand = _candidates(before)
    deadline = time.monotonic() + grace_s
    while cand:
        budget = deadline - time.monotonic()
        if budget <= 0:
            break
        for t in cand:
            t.join(timeout=max(0.05, budget / max(len(cand), 1)))
        cand = _candidates(before)
    return cand


def check(before: frozenset, grace_s: Optional[float] = None) -> None:
    """Raise ``ThreadLeakError`` naming every leaked non-daemon thread
    (name + creation site): the witness fixture's teardown call."""
    leaks = leaked(before, grace_s=grace_s)
    if not leaks:
        return
    lines = [
        f"  {t.name!r} (daemon={t.daemon}) started at {provenance(t)}"
        for t in leaks
    ]
    raise ThreadLeakError(
        "threadcheck: %d non-daemon thread(s) leaked past the test that "
        "created them (no join path ran):\n%s" % (len(leaks), "\n".join(lines))
    )
