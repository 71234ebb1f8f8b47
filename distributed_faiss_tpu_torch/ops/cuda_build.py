"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
nvcc for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library under ``build/torch_kernels/`` at the root of the checkout, at first
use, then loaded with ``ctypes``. The library's file name carries a hash of
its source and of the shared headers, so an edited kernel rebuilds and a
stale one is never loaded.
``build`` starts one nvcc per source, all at once, and waits for them
together. Nothing here runs at import time: this module imports on machines
without nvcc (the CPU tests import every module).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else $PATH, else the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of the shared
    headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile every named kernel source that is not built yet, one nvcc
    per source, all started together. Returns {name: library path}.
    Raises with nvcc's output when a build fails."""
    names = sources() if names is None else list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {n: library_path(n) for n in names}
        todo = {n: p for n, p in targets.items() if not p.exists()}
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
        failures = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, lib)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        return targets


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current build of ``name``, or '' when it has not been built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib
