"""Runtime shared-state race witness (DFT_RACECHECK=1): an Eraser-style
lockset check over the port's lockdep-factory-locked classes (counterpart
of distributed_faiss_tpu/utils/racecheck.py, same semantics).

- ``install()`` instruments the registered classes' ``__setattr__`` and
  ``__getattribute__``: every attribute WRITE is witnessed, and reads of
  attributes that have ever been written through the wrapper are
  witnessed too (sampled by DFT_RACECHECK_SAMPLE);
- per (instance, attribute) the witness runs the Eraser state machine:
  the creating thread owns the attribute EXCLUSIVELY (constructor writes
  constrain nothing); the first touch from a second thread moves it to
  SHARED with the CANDIDATE lockset of the locks that thread holds
  (``lockdep.held()``, which is why DFT_RACECHECK implies the lockdep
  factories); every later access INTERSECTS the candidate with the
  accessor's held set. Read-only sharing never reports. Once a write
  happens in the shared phase, a candidate that goes EMPTY means no lock
  consistently orders the accesses: the witness records the violation
  (thread and file:line of this access and of the last write) and raises
  ``SharedStateRaceError`` at the access;
- the pytest plugin (testing/pytest_witness.py) drains the recorded
  violations after every test, so a raise that a serving loop swallowed
  still fails the test that provoked it.

``EXEMPT`` holds the reviewed-benign (class, attribute) pairs: the JAX
package's list, kept wherever the port has the attribute.

Disabled (the default), nothing is wrapped.
"""

import contextlib
import importlib
import os
import random
import sys
import threading

from distributed_faiss_tpu_torch.utils import envutil, lockdep

__all__ = [
    "SharedStateRaceError", "enabled", "install", "uninstall",
    "instrument", "deinstrument", "drain", "check", "reset", "peeking",
    "INSTRUMENTED", "EXEMPT",
]


class SharedStateRaceError(AssertionError):
    """An attribute's candidate lockset went empty across threads with a
    write involved: no lock consistently orders the accesses."""


def enabled() -> bool:
    """DFT_RACECHECK master switch, read per call (tests flip it
    per-fixture; subprocess tiers inherit it). Turning it on also turns
    the lockdep factories on (lockdep.enabled) — held-lockset tracking
    is what the candidate sets intersect."""
    return envutil.env_flag("DFT_RACECHECK", False)


def _sample_rate() -> float:
    """DFT_RACECHECK_SAMPLE: fraction of witnessed READS actually
    recorded (writes are always witnessed). 1.0 (the default) checks
    every read; drop it when a suite's attribute-read volume makes the
    full witness too slow."""
    return envutil.env_float("DFT_RACECHECK_SAMPLE", 1.0)


# the port's classes that match the JAX package's twelve, resolved lazily
# by install() so importing this module stays cheap when the witness is off
INSTRUMENTED = (
    ("distributed_faiss_tpu_torch.engine", "Index"),
    ("distributed_faiss_tpu_torch.parallel.server", "IndexServer"),
    ("distributed_faiss_tpu_torch.parallel.client", "IndexClient"),
    ("distributed_faiss_tpu_torch.parallel.rpc", "Client"),
    ("distributed_faiss_tpu_torch.parallel.replication", "MembershipTable"),
    ("distributed_faiss_tpu_torch.parallel.replication", "RepairQueue"),
    ("distributed_faiss_tpu_torch.parallel.antientropy", "HealthTable"),
    ("distributed_faiss_tpu_torch.parallel.antientropy", "AntiEntropySweeper"),
    ("distributed_faiss_tpu_torch.serving.scheduler", "SearchScheduler"),
    ("distributed_faiss_tpu_torch.mutation.versions", "HLC"),
    ("distributed_faiss_tpu_torch.observability.spans", "SpanBuffer"),
    ("distributed_faiss_tpu_torch.utils.atomics", "AtomicCounters"),
)

# reviewed-benign (class, attr) pairs the witness never tracks: the JAX
# package's list (its static checker's atomic() annotations, then the
# publish-once cross-object wirings such as ``index.span_buffer = ...``)
EXEMPT = frozenset({
    # == atomic publishes ==
    ("Index", "_train_thread"),
    ("Index", "_add_thread"),
    ("Index", "index_save_time"),
    ("Index", "cfg"),
    ("IndexServer", "shard_group"),
    ("IndexServer", "_antientropy"),
    ("IndexServer", "_metrics"),
    ("IndexServer", "socket"),
    # == publish-once cross-object wirings ==
    ("Index", "span_buffer"),
    ("Index", "compaction_gate"),
})

_STATE_KEY = "__racecheck_state__"

# ---------------------------------------------------------------- bookkeeping
#
# _MU guards every state mutation AND the violations list; it is a plain
# lock, never instrumented, and a strict leaf (nothing else is acquired
# while it is held).

_MU = threading.Lock()
_VIOLATIONS = []  # formatted messages, drained by the witness fixture
_READ_RNG = random.Random(0xDF7)
_TLS = threading.local()


@contextlib.contextmanager
def peeking():
    """Suspend witnessing on the CURRENT thread — for white-box TEST
    assertions that peek at internals production code only touches under
    locks (``eng.tombstones.ledger()`` from a test body, say). The peek
    is still subject to the usual caveat that it may observe mid-update
    state; what this context records is that the TEST accepted that. Do
    not use it in production code — guard there, or annotate."""
    prev = getattr(_TLS, "suspended", False)
    _TLS.suspended = True
    try:
        yield
    finally:
        _TLS.suspended = prev


class _AttrState:
    __slots__ = ("first", "wrote", "cand", "modified", "last_write",
                 "emptied_by", "reported")

    def __init__(self, first, wrote, last_write):
        self.first = first          # owning thread ident (exclusive phase)
        self.wrote = wrote          # any write seen so far
        self.cand = None            # candidate lockset; None = exclusive
        self.modified = False       # a write happened in the shared phase
        self.last_write = last_write  # (thread name, site, heldset) | None
        self.emptied_by = None      # (thread, site, kind) that emptied cand
        self.reported = False


def _site(depth: int) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except ValueError:  # pragma: no cover - shallow stack
        return "<unknown>"


def _witness(obj, cls_name: str, attr: str, is_write: bool,
             depth: int = 3) -> None:
    if getattr(_TLS, "suspended", False):
        return
    held = frozenset(lockdep.held())
    me = threading.get_ident()
    d = object.__getattribute__(obj, "__dict__")
    with _MU:
        states = d.get(_STATE_KEY)
        if states is None:
            states = d[_STATE_KEY] = {}
        rec = states.get(attr)
        if rec is None:
            lw = ((threading.current_thread().name, _site(depth), held)
                  if is_write else None)
            states[attr] = _AttrState(me, is_write, lw)
            return
        if rec.cand is None and me == rec.first:
            # exclusive phase: the owner constrains nothing
            rec.wrote |= is_write
            if is_write:
                rec.last_write = (threading.current_thread().name,
                                  _site(depth), held)
            return
        if rec.cand is None:
            # a second thread: enter the shared phase — the candidate
            # lockset starts at what THIS access holds. Construction-time
            # writes by the owner deliberately do NOT arm the modified
            # flag (Eraser's Exclusive -> Shared edge): publish-in-init /
            # read-by-worker is the package's dominant benign pattern,
            # and Thread.start() is its happens-before edge. Only a write
            # at-or-after the transition makes the state Shared-Modified.
            rec.cand = held
            rec.modified = is_write
            if not held:
                rec.emptied_by = (threading.current_thread().name,
                                  _site(depth),
                                  "write" if is_write else "read")
        else:
            refined = rec.cand & held
            if refined != rec.cand and not refined:
                rec.emptied_by = (threading.current_thread().name,
                                  _site(depth),
                                  "write" if is_write else "read")
            rec.cand = refined
            if is_write:
                rec.modified = True
        rec.wrote |= is_write
        if is_write:
            rec.last_write = (threading.current_thread().name,
                              _site(depth), held)
        if not rec.modified or rec.cand or rec.reported:
            return
        rec.reported = True  # one report per attribute, not a cascade
        kind = "write" if is_write else "read"
        lw = rec.last_write
        lw_txt = (f"last write by {lw[0]!r} at {lw[1]} holding "
                  f"{sorted(lw[2]) or 'no locks'}") if lw else "no write seen"
        eb = rec.emptied_by
        eb_txt = (f"; the lock-free access that emptied the candidate was "
                  f"a {eb[2]} by {eb[0]!r} at {eb[1]}") if eb else ""
        msg = (
            f"racecheck: {cls_name}.{attr} candidate lockset went EMPTY "
            f"across threads — this {kind} by "
            f"{threading.current_thread().name!r} at {_site(depth)} holding "
            f"{sorted(held) or 'no locks'}; {lw_txt}{eb_txt}. No lock "
            "consistently orders the accesses: a torn/stale view is one "
            "interleaving away. Guard both sides, or register the "
            "reviewed-benign pair in utils/racecheck.EXEMPT."
        )
        _VIOLATIONS.append(msg)
    raise SharedStateRaceError(msg)


def drain():
    """Return-and-clear the recorded violations (the witness fixture's
    per-test read side: a raise swallowed by a serving loop still fails
    the test that provoked it)."""
    with _MU:
        out = list(_VIOLATIONS)
        _VIOLATIONS.clear()
    return out


def check() -> None:
    """Raise if any violation was recorded since the last drain."""
    leaks = drain()
    if leaks:
        raise SharedStateRaceError(
            "%d shared-state race(s) witnessed:\n%s"
            % (len(leaks), "\n".join(leaks)))


def reset() -> None:
    """Clear recorded violations (test isolation)."""
    drain()


# ------------------------------------------------------------- instrumentation

def instrument(cls):
    """Wrap one class's ``__setattr__``/``__getattribute__`` with the
    witness. Idempotent; returns the class (usable on test doubles)."""
    if cls.__dict__.get("__racecheck_orig__"):
        return cls
    orig_set = cls.__setattr__
    orig_get = cls.__getattribute__
    watched = set()
    cls_name = cls.__name__

    def __setattr__(self, name, value):
        # the store lands FIRST: a witness raise must report the race, not
        # additionally corrupt the program by swallowing the write
        orig_set(self, name, value)
        if name.startswith("__") or (cls_name, name) in EXEMPT:
            return
        if callable(getattr(cls, name, None)):
            # an instance attr shadowing a class-level callable is a
            # monkeypatch (test doctoring / method stubbing), not shared
            # mutable state — witnessing it would fail every test that
            # stubs a method on a live, already-shared object
            return
        watched.add(name)
        _witness(self, cls_name, name, True)

    def __getattribute__(self, name):
        value = orig_get(self, name)
        if name in watched:
            rate = _sample_rate()
            if rate >= 1.0 or _READ_RNG.random() < rate:
                _witness(self, cls_name, name, False)
        return value

    cls.__racecheck_orig__ = (orig_set, orig_get)
    cls.__racecheck_watched__ = watched
    cls.__setattr__ = __setattr__
    cls.__getattribute__ = __getattribute__
    return cls


def deinstrument(cls) -> None:
    """Restore one class's unwrapped attribute protocol."""
    orig = cls.__dict__.get("__racecheck_orig__")
    if not orig:
        return
    cls.__setattr__, cls.__getattribute__ = orig
    del cls.__racecheck_orig__
    del cls.__racecheck_watched__


_installed = []


def install() -> None:
    """Instrument every registered class (idempotent). The pytest plugin
    calls it at configure time under DFT_RACECHECK=1, and a witnessed
    process before it builds anything, so every instance is witnessed
    from birth."""
    if _installed:
        return
    for mod_name, cls_name in INSTRUMENTED:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        instrument(cls)
        _installed.append(cls)


def uninstall() -> None:
    """Restore every installed class (test isolation)."""
    while _installed:
        deinstrument(_installed.pop())
    reset()
