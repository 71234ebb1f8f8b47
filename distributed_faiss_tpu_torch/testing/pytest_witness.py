"""pytest plugin: the port's runtime witnesses around every test.

Load it with ``-p distributed_faiss_tpu_torch.testing.pytest_witness``:

    DFT_LOCKDEP=1 python -m pytest tests/test_torch_serving.py \\
        -p distributed_faiss_tpu_torch.testing.pytest_witness

- at ``pytest_configure``: DFT_THREADCHECK=1 wraps ``Thread.start`` (each
  thread's creation site), DFT_RACECHECK=1 instruments the port's
  racecheck classes, DFT_COMPILECHECK=1 turns the build/load tally on;
  ``pytest_unconfigure`` undoes each;
- autouse fixtures, each a no-op with its knob unset: a non-daemon thread
  a test started and left running fails it (threadcheck); races and
  implicit syncs recorded during a test fail it, drained first so blame
  lands on the test that provoked them, and recorded also where a serving
  thread swallowed the raise (racecheck, xfercheck). DFT_LOCKDEP=1 needs
  no fixture: a lock-order inversion raises where it happens.

The JAX package's tests/conftest.py reacts to the same knobs for the JAX
package's witnesses in the same process; this plugin touches only the
port's modules, and its fixtures have names of their own.
"""

import pytest

from distributed_faiss_tpu_torch.utils import compilecheck, racecheck, threadcheck, xfercheck


def pytest_configure(config):
    if threadcheck.enabled():
        threadcheck.install()
    if racecheck.enabled():
        racecheck.install()
    if compilecheck.enabled():
        compilecheck.install()


def pytest_unconfigure(config):
    compilecheck.uninstall()
    racecheck.uninstall()
    threadcheck.uninstall()


@pytest.fixture(autouse=True)
def _port_thread_leak_witness():
    if not threadcheck.enabled():
        yield
        return
    before = threadcheck.snapshot()
    yield
    threadcheck.check(before)


@pytest.fixture(autouse=True)
def _port_race_witness():
    if not racecheck.enabled():
        yield
        return
    racecheck.drain()
    yield
    racecheck.check()


@pytest.fixture(autouse=True)
def _port_sync_witness():
    if not xfercheck.enabled():
        yield
        return
    xfercheck.drain()
    yield
    xfercheck.check()
