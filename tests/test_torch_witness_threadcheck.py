"""The port's thread-leak witness (utils/threadcheck.py), case for case with
tests/test_threadcheck.py, plus the same leak verdicts through both
packages' witnesses.

Unit layer: a leaked non-daemon thread raises ThreadLeakError naming it
and its creation site; daemon threads, joined workers, workers winding
down inside the grace join and threads older than the snapshot are not
leaks; the knob is read per call. E2e layer: a pytest subprocess over the
doctored cases of tests/test_torch_witness_cases.py proves the plugin's
wiring (testing/pytest_witness.py) fails a leaking test and passes the
others. The slow case re-runs the port's threaded suites under the knob.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

from distributed_faiss_tpu.utils import threadcheck as jax_threadcheck
from distributed_faiss_tpu_torch.utils import threadcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGIN = "distributed_faiss_tpu_torch.testing.pytest_witness"
CASES = "tests/test_torch_witness_cases.py"


@pytest.fixture
def witness(monkeypatch):
    """DFT_THREADCHECK=1 with the port's start wrapper installed; the
    unwrapped start is restored afterwards unless an outer run owned the
    installation."""
    monkeypatch.setenv("DFT_THREADCHECK", "1")
    owned = threadcheck._ORIG_START is None
    threadcheck.install()
    yield
    if owned:
        threadcheck.uninstall()


def _hold(name, daemon):
    hold = threading.Event()
    t = threading.Thread(target=hold.wait, name=name, daemon=daemon)
    t.start()
    return hold, t


def _release(hold, t):
    hold.set()
    t.join(5.0)
    assert not t.is_alive()


# ------------------------------------------------------------------ switch

def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("DFT_THREADCHECK", raising=False)
    assert not threadcheck.enabled()


def test_enabled_reads_env(witness):
    assert threadcheck.enabled()


def test_install_is_idempotent_and_uninstall_restores():
    was_installed = threadcheck._ORIG_START is not None
    threadcheck.uninstall()
    orig = threading.Thread.start
    try:
        threadcheck.install()
        wrapped = threading.Thread.start
        assert wrapped is not orig
        threadcheck.install()
        assert threading.Thread.start is wrapped
        threadcheck.uninstall()
        assert threading.Thread.start is orig
        threadcheck.uninstall()
        assert threading.Thread.start is orig
    finally:
        if was_installed:
            threadcheck.install()


# --------------------------------------------------------------- leak check

def test_leak_detected_with_name_and_site(witness):
    before = threadcheck.snapshot()
    hold, t = _hold("leaky-worker", daemon=False)
    with pytest.raises(threadcheck.ThreadLeakError) as exc:
        threadcheck.check(before, grace_s=0.2)
    msg = str(exc.value)
    assert "leaky-worker" in msg and "test_torch_witness_threadcheck.py:" in msg
    _release(hold, t)


def test_daemon_threads_are_exempt(witness):
    before = threadcheck.snapshot()
    hold, t = _hold("daemon-worker", daemon=True)
    threadcheck.check(before, grace_s=0.2)
    _release(hold, t)


def test_tracked_and_joined_is_clean(witness):
    before = threadcheck.snapshot()
    done = threading.Event()
    t = threading.Thread(target=done.set, name="joined-worker", daemon=False)
    t.start()
    assert done.wait(5.0)
    t.join(5.0)
    threadcheck.check(before)
    assert threadcheck.leaked(before, grace_s=0.0) == []


def test_grace_join_absorbs_winding_down_worker(witness):
    before = threadcheck.snapshot()
    t = threading.Thread(target=time.sleep, args=(0.3,), name="winding-down", daemon=False)
    t.start()
    threadcheck.check(before, grace_s=5.0)
    assert not t.is_alive()


def test_preexisting_threads_are_exempt(witness):
    hold, t = _hold("outer-scope", daemon=False)
    before = threadcheck.snapshot()
    assert threadcheck.leaked(before, grace_s=0.1) == []
    _release(hold, t)


def test_grace_default_comes_from_env(witness, monkeypatch):
    monkeypatch.setenv("DFT_THREADCHECK_GRACE_S", "0.25")
    assert threadcheck._default_grace() == 0.25
    before = threadcheck.snapshot()
    hold, t = _hold("env-grace", daemon=False)
    t0 = time.monotonic()
    with pytest.raises(threadcheck.ThreadLeakError):
        threadcheck.check(before)
    assert time.monotonic() - t0 < 3.0
    _release(hold, t)


# ---------------------------------------------------------------- provenance

def test_provenance_recorded_for_wrapped_start(witness):
    t = threading.Thread(target=lambda: None, name="prov", daemon=True)
    t.start()
    t.join(5.0)
    assert threadcheck.provenance(t).startswith("test_torch_witness_threadcheck.py:")


def test_unwitnessed_start_has_placeholder_provenance():
    was_installed = threadcheck._ORIG_START is not None
    threadcheck.uninstall()
    try:
        t = threading.Thread(target=lambda: None, name="bare", daemon=True)
        t.start()
        t.join(5.0)
        assert threadcheck.provenance(t) == "<unwitnessed start>"
    finally:
        if was_installed:
            threadcheck.install()


# ------------------------------------------------------------------ parity

def test_same_leak_verdicts_in_both_packages(monkeypatch):
    """The same threads through both witnesses: the same threads leak (by
    name), the same are clean, each witness naming the same creation
    line. Installed in order and restored in reverse."""
    monkeypatch.setenv("DFT_THREADCHECK", "1")
    owned = [m for m in (jax_threadcheck, threadcheck) if m._ORIG_START is None]
    for m in (jax_threadcheck, threadcheck):
        m.install()
    try:
        before = {m: m.snapshot() for m in (jax_threadcheck, threadcheck)}
        leak_hold, leak = _hold("parity-leak", daemon=False)
        daemon_hold, daemon = _hold("parity-daemon", daemon=True)
        joined = threading.Thread(target=lambda: None, name="parity-joined", daemon=False)
        joined.start()
        joined.join(5.0)
        verdicts = {}
        for m in (jax_threadcheck, threadcheck):
            names = sorted(t.name for t in m.leaked(before[m], grace_s=0.2)
                           if t.name.startswith("parity-"))
            verdicts[m.__name__.split(".")[0]] = (names, m.provenance(leak))
        assert verdicts["distributed_faiss_tpu"] == verdicts["distributed_faiss_tpu_torch"]
        names, site = verdicts["distributed_faiss_tpu_torch"]
        assert names == ["parity-leak"]
        assert site.startswith("test_torch_witness_threadcheck.py:")
        _release(leak_hold, leak)
        _release(daemon_hold, daemon)
    finally:
        for m in reversed((jax_threadcheck, threadcheck)):
            if m in owned:
                m.uninstall()


# ----------------------------------------------------------------------- e2e

def _run_doctored(case: str):
    env = dict(os.environ, DFT_THREADCHECK="1", DFT_THREADCHECK_E2E="1",
               DFT_THREADCHECK_GRACE_S="0.5", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "pytest", f"{CASES}::{case}", "-q", "-p", "no:cacheprovider",
         "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_e2e_plugin_fixture_fails_leaking_test():
    proc = _run_doctored("test_leaks_a_nondaemon_thread")
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "ThreadLeakError" in proc.stdout
    assert "doctored-leak" in proc.stdout
    assert "test_torch_witness_cases.py:" in proc.stdout


@pytest.mark.parametrize("case", ["test_daemon_thread_is_exempt",
                                  "test_tracked_and_joined_is_clean"])
def test_e2e_daemon_and_joined_cases_pass(case):
    proc = _run_doctored(case)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]


def test_e2e_cases_skip_without_their_knob():
    env = {k: v for k, v in os.environ.items() if not k.endswith("_E2E")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", CASES, "-q", "-p", "no:cacheprovider", "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "7 skipped" in proc.stdout


# ------------------------------------------------------------------ the tier

@pytest.mark.slow
def test_threaded_suites_under_witness():
    """The port's serving, replication, anti-entropy, mutation and versions
    suites with DFT_THREADCHECK=1 through the plugin: a test that leaves a
    non-daemon thread running fails with the thread's creation site."""
    env = dict(os.environ, DFT_THREADCHECK="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_serving.py",
         "tests/test_torch_batching.py", "tests/test_torch_replication.py",
         "tests/test_torch_antientropy.py", "tests/test_torch_mutation.py",
         "tests/test_torch_versions.py", "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=2400)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
