"""Runtime compile-count witness (DFT_COMPILECHECK=1): the builds and loads
of native code on the serving path, tallied so a steady-state window can
assert it compiled NOTHING new after warm-up (counterpart of
distributed_faiss_tpu/utils/compilecheck.py).

The port has no jit. What compiles on its path is native code built at
first use: one nvcc per kernel source (``ops/cuda_build.py`` ``build``),
the ctypes load of each library (``load``), and the g++ build and load of
the ``hnswsq`` graph library (``models/hnsw.py``). Those sites call
``record`` with "nvcc:<source>", "load:<source>", "g++:hnsw" or
"load:hnsw"; ``install()`` turns the tally on and ``uninstall()`` off.

- ``snapshot()`` / ``new_since(snap)`` bound a serving window: warm the
  entries, snapshot, serve, then assert ``new_since(snap) == {}``.
- Counting is passive: nothing raises mid-serve; the assertion lives with
  whoever owns the window.

The JAX package's ``utils/jitreg.py`` (the jitted programs traced for the
IR tier of its lint) has no counterpart: the port traces no programs.
"""

import threading

from distributed_faiss_tpu_torch.utils import envutil

__all__ = [
    "enabled", "install", "uninstall", "record", "snapshot", "new_since",
    "counts", "reset",
]


def enabled() -> bool:
    """DFT_COMPILECHECK master switch, read per call."""
    return envutil.env_flag("DFT_COMPILECHECK", False)


# _MU is a strict leaf guarding _COUNTS and _installed
_MU = threading.Lock()
_COUNTS = {}  # "nvcc:<source>" / "load:<source>" / "g++:hnsw" -> count
_installed = []


def install() -> None:
    """Start tallying builds and loads (idempotent)."""
    with _MU:
        if not _installed:
            _installed.append(True)


def uninstall() -> None:
    """Stop tallying."""
    with _MU:
        _installed.clear()


def record(name: str) -> None:
    """One build or load of ``name``; counted only while installed."""
    with _MU:
        if _installed:
            _COUNTS[name] = _COUNTS.get(name, 0) + 1


def counts() -> dict:
    """Snapshot of the per-name tally."""
    with _MU:
        return dict(_COUNTS)


def snapshot() -> dict:
    """Alias of counts(), named for the warm-up/serve protocol."""
    return counts()


def new_since(snap: dict) -> dict:
    """Names built or loaded since ``snap``: the steady-state assertion is
    ``new_since(snap) == {}`` after warm-up."""
    now = counts()
    return {name: n - snap.get(name, 0) for name, n in now.items() if n > snap.get(name, 0)}


def reset() -> None:
    """Clear the tally (test isolation)."""
    with _MU:
        _COUNTS.clear()
