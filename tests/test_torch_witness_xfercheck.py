"""The port's implicit-sync witness (utils/xfercheck.py), case for case with
tests/test_xfercheck.py where torch has a counterpart.

On the CPU torch's sync debug mode reports nothing, so these tests raise
the warning the card gives (``xfercheck.SYNC_WARNING``) by hand and cover
the bookkeeping: a sync inside guarded() raises ImplicitTransferError with
the label, thread, scope and call site and is recorded; explicit() lets a
designed fetch through and counts it by site; a sync on another, unguarded
thread passes; nested sections record once; other exceptions pass
through; the scope knob; arming and disarming restore the warnings
machinery; with the knob off nothing is touched. The card tests
(tests/test_torch_cuda.py) and chip_smoke.py's phase i drive a real
``.item()`` on the card. The slow case re-runs the port's serving suites
under the knob.
"""

import os
import subprocess
import sys
import threading
import warnings

import pytest
import torch

from distributed_faiss_tpu_torch.utils import xfercheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGIN = "distributed_faiss_tpu_torch.testing.pytest_witness"
CASES = "tests/test_torch_witness_cases.py"


def _sync():
    """What torch's sync debug mode does at a synchronizing call on the card."""
    warnings.warn(xfercheck.SYNC_WARNING, UserWarning)


@pytest.fixture
def witness(monkeypatch):
    monkeypatch.setenv("DFT_XFERCHECK", "1")
    monkeypatch.delenv("DFT_XFERCHECK_SCOPE", raising=False)
    xfercheck.reset()
    yield
    xfercheck.reset()
    assert xfercheck._ARMED == 0


# ------------------------------------------------------------------ switch

def test_disabled_by_default_touches_nothing(monkeypatch):
    monkeypatch.delenv("DFT_XFERCHECK", raising=False)
    assert not xfercheck.enabled()

    def refuse(*a):
        raise AssertionError("the sync debug mode was touched")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    hook, filters = warnings._showwarnmsg, list(warnings.filters)
    with xfercheck.guarded("off"):
        assert not xfercheck.armed()
        assert warnings._showwarnmsg is hook and warnings.filters == filters
        with xfercheck.explicit("cold path"):
            pass
    assert xfercheck.drain() == [] and xfercheck.syncs() == {}


def test_scope_default_and_validation(monkeypatch):
    monkeypatch.delenv("DFT_XFERCHECK_SCOPE", raising=False)
    assert xfercheck.scope() == "all"
    for val in ("d2h", "h2d"):
        monkeypatch.setenv("DFT_XFERCHECK_SCOPE", val)
        assert xfercheck.scope() == val
    monkeypatch.setenv("DFT_XFERCHECK_SCOPE", "bogus")
    assert xfercheck.scope() == "all"


# ------------------------------------------------------------- the witness

def test_implicit_sync_raises_with_label_and_is_recorded(witness):
    with pytest.raises(xfercheck.ImplicitTransferError) as exc:
        with xfercheck.guarded("unit merge-window flush"):
            _sync()
    msg = str(exc.value)
    assert "'unit merge-window flush'" in msg
    assert "MainThread" in msg and "scope 'all'" in msg
    assert "test_torch_witness_xfercheck.py:" in msg
    leaks = xfercheck.drain()
    assert len(leaks) == 1 and "unit merge-window flush" in leaks[0]


def test_section_without_a_sync_is_clean(witness):
    with xfercheck.guarded("unit clean launch"):
        assert xfercheck.armed()
        (torch.ones(8, 4) * 2.0).sum()
    assert not xfercheck.armed()
    assert xfercheck.drain() == []


def test_explicit_scope_allows_and_counts_a_designed_fetch(witness):
    with xfercheck.guarded("unit flush"):
        for _ in range(3):
            with xfercheck.explicit("designed host fetch"):
                _sync()
    assert xfercheck.drain() == []
    (site, count), = xfercheck.syncs().items()
    assert count == 3
    assert site.startswith("designed host fetch (test_torch_witness_xfercheck.py:")


def test_explicit_is_a_noop_when_nothing_is_armed(monkeypatch):
    monkeypatch.delenv("DFT_XFERCHECK", raising=False)
    hook = warnings._showwarnmsg
    with xfercheck.explicit("cold path"):
        assert warnings._showwarnmsg is hook
    assert xfercheck.syncs() == {}


def test_nested_guarded_records_exactly_once(witness):
    with pytest.raises(xfercheck.ImplicitTransferError):
        with xfercheck.guarded("outer scheduler flush"):
            with xfercheck.guarded("inner engine span"):
                _sync()
    leaks = xfercheck.drain()
    assert len(leaks) == 1 and "inner engine span" in leaks[0]
    assert not xfercheck.armed()


def test_non_transfer_exceptions_pass_through(witness):
    with pytest.raises(ValueError, match="unrelated"):
        with xfercheck.guarded("unit flush"):
            raise ValueError("unrelated serving failure")
    assert xfercheck.drain() == []


def test_swallowed_raise_still_fails_check(witness):
    def serve():
        try:
            with xfercheck.guarded("swallowing serve loop"):
                _sync()
        except xfercheck.ImplicitTransferError:
            pass

    t = threading.Thread(target=serve, name="swallower", daemon=True)
    t.start()
    t.join(30.0)
    assert not t.is_alive()
    with pytest.raises(xfercheck.ImplicitTransferError, match="swallowing serve loop"):
        xfercheck.check()
    assert xfercheck.drain() == []


def test_unguarded_thread_syncs_freely_while_another_is_armed(witness):
    """The process-wide mode is armed by one thread; a sync on another
    thread at the same moment is neither raised nor recorded."""
    armed, done = threading.Event(), threading.Event()
    box = {}

    def guarded_worker():
        with xfercheck.guarded("armed elsewhere"):
            armed.set()
            done.wait(10.0)

    def free_worker():
        armed.wait(10.0)
        try:
            _sync()
            box["ok"] = True
        except BaseException as e:  # pragma: no cover - the failure
            box["err"] = e
        done.set()

    ts = [threading.Thread(target=guarded_worker), threading.Thread(target=free_worker)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
        assert not t.is_alive()
    assert box == {"ok": True}
    assert xfercheck.drain() == []


def test_h2d_scope_leaves_syncs_unguarded(witness, monkeypatch):
    """torch cannot upload implicitly, so the h2d scope guards nothing: a
    sync is out of that scope."""
    monkeypatch.setenv("DFT_XFERCHECK_SCOPE", "h2d")
    with xfercheck.guarded("unit h2d-only flush"):
        _sync()
    assert xfercheck.drain() == []


def test_d2h_scope_guards_syncs(witness, monkeypatch):
    monkeypatch.setenv("DFT_XFERCHECK_SCOPE", "d2h")
    with pytest.raises(xfercheck.ImplicitTransferError, match="scope 'd2h'"):
        with xfercheck.guarded("unit d2h flush"):
            _sync()
    assert len(xfercheck.drain()) == 1


def test_arming_restores_the_warnings_machinery(witness):
    """The hook and the "always" filter live only while a section is armed;
    other warnings still reach the original hook meanwhile."""
    hook, filters = warnings._showwarnmsg, list(warnings.filters)
    with xfercheck.guarded("outer"):
        assert warnings._showwarnmsg is not hook
        assert warnings.filters[0][0] == "always"
        with xfercheck.guarded("inner"):
            assert xfercheck._ARMED == 2
        with pytest.warns(UserWarning, match="unrelated"):
            warnings.warn("unrelated", UserWarning)
    assert warnings._showwarnmsg is hook
    assert warnings.filters == filters
    assert xfercheck._ARMED == 0


def test_repeated_syncs_at_one_line_are_each_seen(witness):
    """The default filter shows a warning once per line; the "always"
    filter makes every sync count."""
    with xfercheck.guarded("repeats"):
        with xfercheck.explicit("loop fetch"):
            for _ in range(5):
                _sync()
    assert sum(xfercheck.syncs().values()) == 5


# ----------------------------------------------------------------------- e2e

def _run_doctored(case: str):
    env = dict(os.environ, DFT_XFERCHECK="1", DFT_XFERCHECK_E2E="1", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "pytest", f"{CASES}::{case}", "-q", "-p", "no:cacheprovider",
         "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_e2e_plugin_fixture_fails_seeded_implicit_sync():
    proc = _run_doctored("test_seeded_implicit_sync_fails_via_the_fixture")
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "ImplicitTransferError" in proc.stdout
    assert "doctored merge-window flush" in proc.stdout


def test_e2e_explicit_twin_passes():
    proc = _run_doctored("test_explicit_twin_is_clean")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]


# ------------------------------------------------------------------ the tier

@pytest.mark.slow
def test_serving_suites_under_witness():
    """The port's serving, selector, wire, batching and mesh-serving suites
    with DFT_XFERCHECK=1 and DFT_COMPILECHECK=1 through the plugin."""
    env = dict(os.environ, DFT_XFERCHECK="1", DFT_COMPILECHECK="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_serving.py",
         "tests/test_torch_selector.py", "tests/test_torch_wire.py",
         "tests/test_torch_batching.py", "tests/test_torch_mesh_serving.py",
         "-q", "-m", "not slow", "-p", "no:cacheprovider", "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=2400)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
