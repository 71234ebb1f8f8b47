"""Doctored cases for the witnesses' end-to-end tests, driven through the
port's pytest plugin (``-p distributed_faiss_tpu_torch.testing.pytest_witness``)
in a subprocess by tests/test_torch_witness_{threadcheck,racecheck,xfercheck}.py.

Each case runs only when the test that runs it sets its ``*_E2E`` knob:
the leak, the swallowed race and the swallowed implicit sync must FAIL
under the plugin's fixtures, which proves the real wiring (install at
configure, drain and check around each test); their twins must pass. Without the knobs every
case skips, so a plain run of the suite never trips over them.
"""

import os
import threading
import time
import warnings

import pytest
import torch

from distributed_faiss_tpu_torch.utils import lockdep, racecheck, xfercheck


def _driven_by(knob: str):
    return pytest.mark.skipif(os.environ.get(knob) != "1",
                              reason=f"doctored case: runs only under {knob}=1")


# ------------------------------------------------------------- threadcheck

# outlives the runner's shortened grace join, short enough not to hold the
# subprocess's interpreter for long after pytest finishes
_LINGER_S = 3.0


@_driven_by("DFT_THREADCHECK_E2E")
def test_leaks_a_nondaemon_thread():
    threading.Thread(target=time.sleep, args=(_LINGER_S,), name="doctored-leak",
                     daemon=False).start()


@_driven_by("DFT_THREADCHECK_E2E")
def test_daemon_thread_is_exempt():
    hold = threading.Event()
    threading.Thread(target=hold.wait, name="doctored-daemon", daemon=True).start()


@_driven_by("DFT_THREADCHECK_E2E")
def test_tracked_and_joined_is_clean():
    done = threading.Event()
    t = threading.Thread(target=done.set, name="doctored-joined", daemon=False)
    t.start()
    assert done.wait(5.0)
    t.join(5.0)
    assert not t.is_alive()


# --------------------------------------------------------------- racecheck

def _shared_class():
    class Shared:
        def __init__(self):
            self.lock = lockdep.lock("Shared.lock")
            self.value = 0

    return racecheck.instrument(Shared)


def _run(fn, name):
    t = threading.Thread(target=fn, name=name, daemon=True)
    t.start()
    t.join(5.0)
    assert not t.is_alive()


@_driven_by("DFT_RACECHECK_E2E")
def test_seeded_race_fails_via_the_fixture():
    """The racing write happens on a worker that swallows the raise (as a
    serving loop would): only the plugin's post-test check fails it."""
    obj = _shared_class()()

    def doctored_racy_write():
        try:
            obj.value = 1  # lock-free write from a second thread
        except racecheck.SharedStateRaceError:
            pass

    _run(doctored_racy_write, "doctored-racer")


@_driven_by("DFT_RACECHECK_E2E")
def test_locked_twin_is_clean():
    obj = _shared_class()()

    def locked_write():
        with obj.lock:
            obj.value = 1

    _run(locked_write, "doctored-locked")
    with obj.lock:
        obj.value = 2


# --------------------------------------------------------------- xfercheck

def _sync(x: torch.Tensor) -> float:
    """A host read of ``x``. On a CPU tensor torch's sync debug mode has
    nothing to report, so the warning the card would give is raised by
    hand with torch's own text."""
    value = float(x.sum().item())
    if x.device.type == "cpu":
        warnings.warn(xfercheck.SYNC_WARNING, UserWarning)
    return value


@_driven_by("DFT_XFERCHECK_E2E")
def test_seeded_implicit_sync_fails_via_the_fixture():
    """A host read inside a guarded window flush on a worker that swallows
    the raise: only the plugin's post-test check fails it."""
    x = torch.ones(8)

    def doctored_serve():
        try:
            with xfercheck.guarded("doctored merge-window flush"):
                _sync(x)
        except xfercheck.ImplicitTransferError:
            pass

    _run(doctored_serve, "doctored-server")


@_driven_by("DFT_XFERCHECK_E2E")
def test_explicit_twin_is_clean():
    x = torch.ones(8)

    def clean_serve():
        with xfercheck.guarded("doctored merge-window flush"):
            with xfercheck.explicit("doctored result fetch"):
                _sync(x)

    _run(clean_serve, "doctored-server")
