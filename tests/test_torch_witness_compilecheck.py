"""The port's compile-count witness (utils/compilecheck.py): the native
builds and loads on the serving path, tallied so a window after warm-up
can show it built nothing.

Counterparts of tests/test_compilecheck.py: the knob, install/uninstall,
a fresh build tallied once and reuse tallied never (a real g++ build of
the hnswsq graph library into a temporary build dir), the
snapshot/new_since window, reset. The nvcc builds and ctypes loads of
``ops/cuda_build.py`` are tallied through the same records, checked here
with a stand-in compiler (this machine has no nvcc).
"""

import types

import pytest

from distributed_faiss_tpu_torch.models import hnsw
from distributed_faiss_tpu_torch.ops import cuda_build
from distributed_faiss_tpu_torch.utils import compilecheck


@pytest.fixture
def tally():
    """A clean installed tally, restored afterwards even when the
    surrounding run (DFT_COMPILECHECK=1) installed one."""
    installed_here = not compilecheck._installed
    compilecheck.install()
    compilecheck.reset()
    yield
    compilecheck.reset()
    if installed_here:
        compilecheck.uninstall()


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("DFT_COMPILECHECK", raising=False)
    assert not compilecheck.enabled()
    monkeypatch.setenv("DFT_COMPILECHECK", "1")
    assert compilecheck.enabled()


def test_install_is_idempotent_and_uninstall_stops_the_tally():
    if compilecheck._installed:
        pytest.skip("compilecheck already installed by the surrounding run")
    compilecheck.reset()
    compilecheck.record("nvcc:x")
    assert compilecheck.counts() == {}
    compilecheck.install()
    compilecheck.install()
    assert len(compilecheck._installed) == 1
    compilecheck.record("nvcc:x")
    assert compilecheck.counts() == {"nvcc:x": 1}
    compilecheck.uninstall()
    compilecheck.record("nvcc:x")
    assert compilecheck.counts() == {"nvcc:x": 1}
    compilecheck.uninstall()
    compilecheck.reset()


def test_real_hnsw_build_is_tallied_once_and_reuse_never(tally, tmp_path, monkeypatch):
    monkeypatch.setattr(hnsw, "BUILD_DIR", tmp_path / "native")
    lib = hnsw.build_library()
    assert lib.exists() and lib.parent == tmp_path / "native"
    assert compilecheck.counts() == {"g++:hnsw": 1}
    snap = compilecheck.snapshot()
    assert hnsw.build_library() == lib
    assert compilecheck.new_since(snap) == {}


def test_nvcc_builds_and_loads_are_tallied(tally, tmp_path, monkeypatch):
    """Each source nvcc compiles is one record, a built library is never
    rebuilt, and each library's ctypes load is one record."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "_libs", {})

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()
            self.returncode = 0

        def communicate(self):
            return "ptxas info: 0 bytes spill", None

    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    cuda_build.build()
    assert compilecheck.counts() == {"nvcc:adc_scan": 1, "nvcc:flat_scan": 1,
                                     "nvcc:topk_select": 1}
    snap = compilecheck.snapshot()
    cuda_build.build()
    assert compilecheck.new_since(snap) == {}
    lib = cuda_build.load("flat_scan")
    assert cuda_build.load("flat_scan") is lib
    assert compilecheck.new_since(snap) == {"load:flat_scan": 1}


def test_snapshot_new_since_window_semantics(tally):
    compilecheck.record("load:flat_scan")
    snap = compilecheck.snapshot()
    assert compilecheck.new_since(snap) == {}
    compilecheck.record("load:flat_scan")
    compilecheck.record("nvcc:adc_scan")
    assert compilecheck.new_since(snap) == {"load:flat_scan": 1, "nvcc:adc_scan": 1}


def test_reset_clears_the_tally(tally):
    compilecheck.record("g++:hnsw")
    assert compilecheck.counts()
    compilecheck.reset()
    assert compilecheck.counts() == {}
