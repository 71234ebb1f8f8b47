"""Runtime implicit-sync witness (DFT_XFERCHECK=1) around the serving hot
path (counterpart of distributed_faiss_tpu/utils/xfercheck.py).

- ``guarded(label)`` (a no-op unless DFT_XFERCHECK=1) arms the witness
  for the calling thread around a serving section: the scheduler's window
  flush and the engine's launch-to-fetch span wear it. A synchronizing
  CUDA call inside it (``.item()``, ``.cpu()``, ``torch.nonzero``, a
  pageable copy either way) raises ``ImplicitTransferError`` naming the
  label, the thread, the scope and the file:line that made the call, and
  is recorded for ``drain``/``check``.
- ``explicit(reason)`` marks a DESIGNED host fetch or feed: syncs inside
  it pass, and are counted per site (``syncs()``: "reason (file:line)" ->
  syncs), the list of designed syncs on the served path. No-op when no
  guard is armed on this thread.
- the pytest plugin (testing/pytest_witness.py) drains the recorded
  violations after every test, so a raise swallowed by the scheduler's
  per-request error routing still fails the test that provoked it.

Mechanism. jax's transfer guard is per thread; torch's sync debug mode
(``torch.cuda.set_sync_debug_mode``) is one setting for the process, and
"error" would also fail a designed fetch on another thread. So while any
guard is armed the mode is held at "warn" (a count of armed sections;
the last one out restores the previous mode), an "always" filter keeps
the warnings filter from swallowing repeats, and a hook on
``warnings._showwarnmsg`` (which pytest's per-test warning capture leaves
in place) turns the warning into a violation only on a thread that is
inside ``guarded`` and not inside ``explicit``. On other threads the
warning is dropped when the mode was off before arming. torch emits the
warning on the thread that made the call, so the thread test is exact.
Without CUDA (the CPU tests) the mode is not set and only the bookkeeping
runs: a warning with torch's text, raised by hand, stands in for the
card. A card whose torch has no sync debug mode raises when a guard arms.

``DFT_XFERCHECK_SCOPE``: torch reports a sync without its direction, and
every sync is the host waiting on the device, so ``all`` (default) and
``d2h`` guard every synchronizing call; ``h2d`` guards nothing, since
torch refuses an implicit upload by itself (a CPU tensor in a CUDA op
raises) and a sync is out of that scope.

Disabled (the default), ``guarded``/``explicit`` never touch the sync
debug mode or the warnings machinery.
"""

import contextlib
import os
import sys
import threading
import traceback
import warnings

import torch

from distributed_faiss_tpu_torch.utils import envutil

__all__ = [
    "ImplicitTransferError", "SYNC_WARNING", "enabled", "scope", "guarded",
    "explicit", "drain", "check", "reset", "armed", "syncs",
]

# the text torch's sync debug mode warns with (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"


class ImplicitTransferError(AssertionError):
    """A synchronizing CUDA call happened inside a guarded serving section,
    outside any explicit() fetch: the hot path silently waited on the
    device."""


def enabled() -> bool:
    """DFT_XFERCHECK master switch, read per call."""
    return envutil.env_flag("DFT_XFERCHECK", False)


def scope() -> str:
    """DFT_XFERCHECK_SCOPE: "all" (default), "d2h" or "h2d" (module
    docstring)."""
    val = envutil.env_str("DFT_XFERCHECK_SCOPE", "all")
    return val if val in ("all", "d2h", "h2d") else "all"


# _MU is a strict leaf guarding _VIOLATIONS, _SYNCS and the arming state
_MU = threading.Lock()
_VIOLATIONS = []  # formatted messages, drained by the witness fixture
_SYNCS = {}  # "reason (file:line)" -> designed syncs seen inside explicit()
_TLS = threading.local()
_ARMED = 0  # guarded sections active in the process
_PREV_MODE = None  # the sync debug mode before the first arm, on a card
_ORIG_SHOWWARNMSG = None
_FILTER = None
_SKIP_FILES = (os.path.dirname(torch.__file__), __file__, contextlib.__file__)


def armed() -> bool:
    """True when a guarded() section is active on THIS thread."""
    return bool(getattr(_TLS, "labels", None))


def _site() -> str:
    """'file:line' of the innermost frame outside torch, this module and
    contextlib: the line that made the call."""
    for fr in reversed(traceback.extract_stack()):
        if not fr.filename.startswith(_SKIP_FILES):
            return f"{os.path.basename(fr.filename)}:{fr.lineno}"
    return "<unknown>"  # pragma: no cover


def _on_sync(msg) -> None:
    labels = getattr(_TLS, "labels", None)
    if labels and labels[-1][1] != "h2d":
        stack = _TLS.explicit
        if stack:
            with _MU:
                _SYNCS[stack[-1]] = _SYNCS.get(stack[-1], 0) + 1
            return
        label, scope_ = labels[-1]
        text = (
            f"xfercheck: synchronizing CUDA call inside guarded section "
            f"{label!r} (thread {threading.current_thread().name!r}, scope "
            f"{scope_!r}) at {_site()}: {msg.message}. The serving hot path "
            "may wait on the device only inside an explicit(reason) fetch "
            "or feed."
        )
        with _MU:
            _VIOLATIONS.append(text)
        raise ImplicitTransferError(text)
    if _PREV_MODE:
        _ORIG_SHOWWARNMSG(msg)  # the mode was on before arming: show it


def _showwarnmsg(msg):
    if _ARMED and SYNC_WARNING in str(msg.message):
        return _on_sync(msg)
    return _ORIG_SHOWWARNMSG(msg)


def _arm(scope_: str) -> None:
    global _ARMED, _PREV_MODE, _ORIG_SHOWWARNMSG, _FILTER
    with _MU:
        if _ARMED == 0:
            if scope_ != "h2d" and torch.cuda.is_available():
                _PREV_MODE = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            _ORIG_SHOWWARNMSG = warnings._showwarnmsg
            warnings._showwarnmsg = _showwarnmsg
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
            _FILTER = warnings.filters[0]
        _ARMED += 1


def _disarm() -> None:
    global _ARMED, _PREV_MODE
    with _MU:
        _ARMED -= 1
        if _ARMED:
            return
        if _PREV_MODE is not None:
            torch.cuda.set_sync_debug_mode(_PREV_MODE)
            _PREV_MODE = None
        warnings._showwarnmsg = _ORIG_SHOWWARNMSG
        if _FILTER in warnings.filters:
            warnings.filters.remove(_FILTER)
            warnings._filters_mutated()


@contextlib.contextmanager
def guarded(label: str):
    """Arm the witness around a serving hot-path section on this thread.
    Nests (the scheduler's flush wraps the engine's launch); the innermost
    section's label names a violation."""
    if not enabled():
        yield
        return
    scope_ = scope()
    _arm(scope_)
    labels = getattr(_TLS, "labels", None)
    if labels is None:
        labels = _TLS.labels = []
        _TLS.explicit = []
    labels.append((label, scope_))
    try:
        yield
    finally:
        labels.pop()
        _disarm()


def _caller() -> str:
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.startswith(_SKIP_FILES):
        f = f.f_back
    return "<unknown>" if f is None else f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


@contextlib.contextmanager
def explicit(reason: str):
    """A designed host fetch or feed: syncs inside are allowed, and counted
    under "reason (file:line of this call)". No-op when no guard is armed
    on this thread."""
    if not armed():
        yield
        return
    stack = _TLS.explicit
    stack.append(f"{reason} ({_caller()})")
    try:
        yield
    finally:
        stack.pop()


def syncs() -> dict:
    """Designed syncs seen inside explicit() since the last reset, by site."""
    with _MU:
        return dict(_SYNCS)


def drain():
    """Return-and-clear the recorded violations (the witness fixture's
    per-test read side)."""
    with _MU:
        out = list(_VIOLATIONS)
        _VIOLATIONS.clear()
    return out


def check() -> None:
    """Raise if any violation was recorded since the last drain."""
    leaks = drain()
    if leaks:
        raise ImplicitTransferError(
            "%d implicit sync(s) witnessed:\n%s" % (len(leaks), "\n".join(leaks)))


def reset() -> None:
    """Clear recorded violations and the designed-sync counts."""
    drain()
    with _MU:
        _SYNCS.clear()
