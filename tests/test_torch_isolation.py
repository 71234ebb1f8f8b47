"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never run on the CPU unless asked to."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "distributed_faiss_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import distributed_faiss_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "distributed_faiss_tpu"))
print(len(names), bad, ",".join(names))
"""

# modules the isolation check must reach by name (the walk imports all)
_NAMED = ("distributed_faiss_tpu_torch.parallel.wire",
          "distributed_faiss_tpu_torch.utils.batching",
          "distributed_faiss_tpu_torch.models.hnsw",
          "distributed_faiss_tpu_torch.mutation.tombstones",
          "distributed_faiss_tpu_torch.parallel.replication",
          "distributed_faiss_tpu_torch.parallel.antientropy",
          "distributed_faiss_tpu_torch.parallel.launcher",
          "distributed_faiss_tpu_torch.parallel.mesh",
          "distributed_faiss_tpu_torch.testing.chaos",
          "distributed_faiss_tpu_torch.testing.pytest_witness",
          "distributed_faiss_tpu_torch.utils.envutil",
          "distributed_faiss_tpu_torch.utils.lockdep",
          "distributed_faiss_tpu_torch.utils.atomics",
          "distributed_faiss_tpu_torch.utils.threadcheck",
          "distributed_faiss_tpu_torch.utils.racecheck",
          "distributed_faiss_tpu_torch.utils.xfercheck",
          "distributed_faiss_tpu_torch.utils.sanitize",
          "distributed_faiss_tpu_torch.utils.compilecheck")


def test_port_modules_import_without_jax():
    """Every module of the port, and chip_smoke.py, imports in a fresh
    interpreter without pulling in jax or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad, names = out.stdout.strip().split(" ", 2)
    assert int(count) >= 32
    assert bad == "[]", f"port imported {bad}"
    assert set(_NAMED) <= set(names.split(","))


def test_no_import_statement_names_jax():
    pattern = re.compile(r"^\s*(from|import) (jax|distributed_faiss_tpu)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in files for m in pattern.finditer(p.read_text())]
    assert not hits


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA, so the default device is valid here")


def test_default_device_raises_without_cuda(tmp_path):
    """Models, the engine and the server default to device='cuda' and raise
    on a CUDA-less machine instead of running on the CPU."""
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.models.factory import build_index
    from distributed_faiss_tpu_torch.models.flat import FlatIndex
    from distributed_faiss_tpu_torch.models.hnsw import HNSWSQIndex
    from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
    from distributed_faiss_tpu_torch.parallel.server import IndexServer
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from distributed_faiss_tpu_torch.utils.device import resolve_device

    _no_cuda()
    cfg = IndexCfg(index_builder_type="ivfsq", dim=8, centroids=4)
    pq_cfg = IndexCfg(index_builder_type="knnlm", dim=8, centroids=4, code_size=4)
    hnsw_cfg = IndexCfg(index_builder_type="hnswsq", dim=8, metric="l2")
    for make in (lambda: FlatIndex(8), lambda: IVFFlatIndex(8, 4), lambda: IVFPQIndex(8, 4, m=4),
                 lambda: HNSWSQIndex(8), lambda: build_index(hnsw_cfg),
                 lambda: Index(cfg), lambda: build_index(cfg), lambda: build_index(pq_cfg),
                 lambda: IndexServer(0, str(tmp_path)), resolve_device):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("mps")


def test_explicit_cpu_device_runs():
    from distributed_faiss_tpu_torch.models.flat import FlatIndex

    idx = FlatIndex(8, "l2", device="cpu")
    x = np.eye(8, dtype=np.float32)
    idx.add(x)
    _, ids = idx.search(x[:2], 1)
    assert ids.tolist() == [[0], [1]]


def test_kernel_sources_and_build_dir():
    """Every kernel source is built from the checkout into build/torch_kernels,
    under a name that carries a hash of the source."""
    from distributed_faiss_tpu_torch.ops import cuda_build

    assert cuda_build.sources() == ["adc_scan", "flat_scan"]
    for name in cuda_build.sources():
        path = cuda_build.library_path(name)
        assert path.parent == REPO / "build" / "torch_kernels"
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{12}}\.so", path.name)
    assert "-gencode" in cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    from distributed_faiss_tpu_torch.ops import cuda_build

    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits nonzero and prints no result where CUDA is absent."""
    _no_cuda()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """chip_smoke.py copied alone into a directory exits nonzero and prints
    no result: it needs the port's sources beside it."""
    import shutil

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "not a checkout" in out.stderr
