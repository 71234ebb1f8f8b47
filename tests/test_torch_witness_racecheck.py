"""The port's shared-state race witness (utils/racecheck.py), case for case
with tests/test_racecheck.py, plus the same Eraser transitions and the same
violation through both packages' witnesses.

Unit layer: a cross-thread write with an empty candidate lockset raises
SharedStateRaceError with both sides' provenance; a consistently held lock
keeps the candidate non-empty; RLock reentry and Condition.wait are
handled; read-only sharing and construction-time publishes never report;
EXEMPT pairs, peeking() and the read-sampling knob are honored; every
INSTRUMENTED entry resolves to a port class. E2e layer: the plugin fails a
seeded race whose in-thread raise was swallowed, and passes its locked
twin. The slow case re-runs the port's concurrent suites under the knob.
"""

import importlib
import os
import subprocess
import sys
import threading

import pytest

from distributed_faiss_tpu.utils import lockdep as jax_lockdep
from distributed_faiss_tpu.utils import racecheck as jax_racecheck
from distributed_faiss_tpu_torch.utils import lockdep, racecheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGIN = "distributed_faiss_tpu_torch.testing.pytest_witness"
CASES = "tests/test_torch_witness_cases.py"


@pytest.fixture
def witness(monkeypatch):
    """DFT_RACECHECK=1 (which turns the lockdep factories on); recorded
    violations are drained on the way out."""
    monkeypatch.setenv("DFT_RACECHECK", "1")
    monkeypatch.delenv("DFT_RACECHECK_SAMPLE", raising=False)
    yield
    racecheck.reset()


def _fresh(name="Shared", lock_factory=None, lock_name=None, rc=racecheck, ld=lockdep):
    lock_factory = lock_factory or ld.lock

    class Shared:
        def __init__(self):
            self.lock = lock_factory(lock_name or f"{name}.lock")
            self.value = 0

    Shared.__name__ = name
    return rc.instrument(Shared)


def _run_in_thread(fn, name="racer"):
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:  # captured for assertions
            box["exc"] = e

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    t.join(10.0)
    assert not t.is_alive()
    return box.get("exc")


# ------------------------------------------------------------------ switch

def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("DFT_RACECHECK", raising=False)
    assert not racecheck.enabled()


def test_enabled_implies_lockdep(witness, monkeypatch):
    monkeypatch.delenv("DFT_LOCKDEP", raising=False)
    assert racecheck.enabled()
    assert lockdep.enabled()


# ------------------------------------------------------------- the machine

def test_two_thread_empty_lockset_raises_with_provenance(witness):
    obj = _fresh("ProvCls")()
    obj.value = 2

    def locked_write():
        with obj.lock:
            obj.value = 3

    assert _run_in_thread(locked_write) is None
    with pytest.raises(racecheck.SharedStateRaceError) as exc:
        obj.value = 4
    msg = str(exc.value)
    assert "ProvCls.value" in msg
    assert "test_torch_witness_racecheck.py:" in msg
    assert "last write by" in msg and "MainThread" in msg
    racecheck.reset()


def test_lockset_refinement_keeps_common_lock_quiet(witness):
    obj = _fresh("Refined")()
    extra = lockdep.lock("Refined.extra")

    def writer():
        for _ in range(50):
            with obj.lock:
                obj.value += 1
        with extra:
            with obj.lock:
                obj.value += 1

    assert _run_in_thread(writer, "w1") is None
    assert _run_in_thread(writer, "w2") is None
    with obj.lock:
        obj.value += 1
    assert racecheck.drain() == []


def test_rlock_reentry_is_not_a_violation(witness):
    obj = _fresh("Reent", lock_factory=lockdep.rlock)()

    def writer():
        with obj.lock:
            with obj.lock:
                obj.value += 1

    assert _run_in_thread(writer) is None
    with obj.lock:
        obj.value += 1
    assert racecheck.drain() == []


def test_condition_wait_release_is_handled(witness):
    class Queue:
        def __init__(self):
            self.cond = lockdep.condition("Queue.cond")
            self.items = 0

    racecheck.instrument(Queue)
    q = Queue()
    started = threading.Event()

    def consumer():
        with q.cond:
            started.set()
            while q.items == 0:
                q.cond.wait(timeout=5.0)
            q.items -= 1

    t = threading.Thread(target=consumer, name="consumer", daemon=True)
    t.start()
    assert started.wait(5.0)
    with q.cond:
        q.items += 1
        q.cond.notify_all()
    t.join(10.0)
    assert not t.is_alive()
    assert racecheck.drain() == []


def test_read_only_sharing_never_reports(witness):
    obj = _fresh("ReadOnly")()
    obj.value = 7

    def reader():
        for _ in range(20):
            assert obj.value == 7

    assert _run_in_thread(reader, "r1") is None
    assert _run_in_thread(reader, "r2") is None
    assert racecheck.drain() == []


def test_exempt_pairs_are_never_tracked(witness):
    class Index:  # matches the EXEMPT ("Index", "cfg") pair by name
        def __init__(self):
            self.lock = lockdep.lock("ExemptIndex.lock")
            self.cfg = None

    racecheck.instrument(Index)
    obj = Index()

    def racy_cfg_write():
        obj.cfg = object()

    assert ("Index", "cfg") in racecheck.EXEMPT
    assert _run_in_thread(racy_cfg_write) is None
    obj.cfg = object()
    assert racecheck.drain() == []


def test_exempt_mirrors_the_jax_list_where_the_port_has_the_attribute():
    assert racecheck.EXEMPT <= jax_racecheck.EXEMPT
    assert {c for _, c in racecheck.INSTRUMENTED} == {c for _, c in jax_racecheck.INSTRUMENTED}


def test_swallowed_raise_is_still_recorded_for_check(witness):
    obj = _fresh("Swallowed")()
    obj.value = 1

    def racy():
        try:
            obj.value = 2
        except racecheck.SharedStateRaceError:
            pass

    assert _run_in_thread(racy) is None
    with pytest.raises(racecheck.SharedStateRaceError, match="Swallowed"):
        racecheck.check()
    assert racecheck.drain() == []


def test_peeking_suspends_the_witness_on_this_thread(witness):
    obj = _fresh("Peeked")()
    obj.value = 1

    def racy():
        with racecheck.peeking():
            obj.value = 2

    assert _run_in_thread(racy) is None
    assert racecheck.drain() == []


def test_sample_knob_gates_reads_but_never_writes(witness, monkeypatch):
    monkeypatch.setenv("DFT_RACECHECK_SAMPLE", "0")
    calls = []
    real = racecheck._witness

    def counting(obj, cls_name, attr, is_write, depth=3):
        calls.append((attr, is_write))
        return real(obj, cls_name, attr, is_write, depth + 1)

    monkeypatch.setattr(racecheck, "_witness", counting)
    obj = _fresh("Sampled")()
    obj.value = 1
    _ = obj.value
    assert ("value", True) in calls
    assert ("value", False) not in calls
    racecheck.reset()


def test_instrument_is_idempotent_and_deinstrument_restores(witness):
    class C:
        def __init__(self):
            self.lock = lockdep.lock("C.lock")

    orig_set = C.__setattr__
    racecheck.instrument(C)
    wrapped = C.__setattr__
    assert wrapped is not orig_set
    racecheck.instrument(C)
    assert C.__setattr__ is wrapped
    racecheck.deinstrument(C)
    assert C.__setattr__ is orig_set
    racecheck.deinstrument(C)
    assert C.__setattr__ is orig_set


def test_registry_resolves_and_uninstall_restores():
    """Every INSTRUMENTED entry imports and resolves to a port class."""
    for mod_name, cls_name in racecheck.INSTRUMENTED:
        assert mod_name.startswith("distributed_faiss_tpu_torch.")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        assert isinstance(cls, type), (mod_name, cls_name)
    was_empty = not racecheck._installed
    racecheck.install()
    try:
        for cls in racecheck._installed:
            assert cls.__dict__.get("__racecheck_orig__")
    finally:
        if was_empty:
            racecheck.uninstall()
    if was_empty:
        for mod_name, cls_name in racecheck.INSTRUMENTED:
            cls = getattr(importlib.import_module(mod_name), cls_name)
            assert "__racecheck_orig__" not in cls.__dict__


# ------------------------------------------------------------------ parity

def _eraser_trace(rc, ld):
    """One doctored two-thread sequence: (the attribute's state after each
    step, the violation's kind) through one package's witness."""
    obj = _fresh("Parity", rc=rc, ld=ld)()
    states = []

    def state():
        rec = object.__getattribute__(obj, "__dict__")[rc._STATE_KEY]["value"]
        return (rec.cand is None, sorted(rec.cand or ()), rec.modified, rec.wrote)

    obj.value = 1  # the owner: exclusive
    states.append(state())

    def locked_read():
        with obj.lock:
            _ = obj.value  # shared, candidate = {Parity.lock}

    assert _run_in_thread(locked_read) is None
    states.append(state())
    with obj.lock:
        obj.value = 2  # a locked write: shared-modified, candidate kept
    states.append(state())
    err = _run_in_thread(lambda: setattr(obj, "value", 3))  # lock-free: empties it
    states.append(state())
    rc.reset()
    return states, type(err).__name__


def test_same_eraser_transitions_in_both_packages(monkeypatch):
    monkeypatch.setenv("DFT_RACECHECK", "1")
    monkeypatch.delenv("DFT_RACECHECK_SAMPLE", raising=False)
    port = _eraser_trace(racecheck, lockdep)
    jax = _eraser_trace(jax_racecheck, jax_lockdep)
    assert port == jax
    states, err = port
    assert states == [(True, [], False, True), (False, ["Parity.lock"], False, True),
                      (False, ["Parity.lock"], True, True), (False, [], True, True)]
    assert err == "SharedStateRaceError"


# ----------------------------------------------------------------------- e2e

def _run_doctored(case: str):
    env = dict(os.environ, DFT_RACECHECK="1", DFT_RACECHECK_E2E="1", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "pytest", f"{CASES}::{case}", "-q", "-p", "no:cacheprovider",
         "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_e2e_plugin_fixture_fails_seeded_race():
    proc = _run_doctored("test_seeded_race_fails_via_the_fixture")
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "SharedStateRaceError" in proc.stdout
    assert "Shared.value" in proc.stdout
    assert "test_torch_witness_cases.py:" in proc.stdout


def test_e2e_locked_twin_passes():
    proc = _run_doctored("test_locked_twin_is_clean")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]


# ------------------------------------------------------------------ the tier

@pytest.mark.slow
def test_concurrent_suites_under_witness():
    """The port's serving, selector, wire, replication, anti-entropy,
    mutation and versions suites with DFT_RACECHECK=1 through the plugin."""
    env = dict(os.environ, DFT_RACECHECK="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_serving.py",
         "tests/test_torch_selector.py", "tests/test_torch_wire.py",
         "tests/test_torch_replication.py", "tests/test_torch_antientropy.py",
         "tests/test_torch_mutation.py", "tests/test_torch_versions.py",
         "-q", "-m", "not slow", "-p", "no:cacheprovider", "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=2400)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
