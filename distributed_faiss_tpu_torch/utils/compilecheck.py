"""Runtime compile-count witness (DFT_COMPILECHECK=1): the builds, loads and
captures on the serving path, tallied so a steady-state window can assert
it compiled NOTHING new after warm-up (counterpart of
distributed_faiss_tpu/utils/compilecheck.py).

The port has no jit. What compiles on its path is native code built at
first use: one nvcc per kernel source (``ops/cuda_build.py`` ``build``),
the ctypes load of each library (``load``), and the g++ build and load of
the ``hnswsq`` graph library (``models/hnsw.py``); and each search program
the program cache captures as a CUDA graph (``utils/programs.py``), the
counterpart of a jit compile. Those sites call ``record`` with
"nvcc:<source>", "load:<source>", "g++:hnsw", "load:hnsw" or
"capture:<program>"; ``install()`` turns the tally on and ``uninstall()``
off.

- ``snapshot()`` / ``new_since(snap)`` bound a serving window: warm the
  entries, snapshot, serve, then assert ``new_since(snap) == {}``.
- ``by_entry()`` tallies the captures under their ``utils/jitreg.py`` row
  (the JAX witness reports its compiles per registered qualname);
  ``unregistered()`` lists captured names no row declares.
- Counting is passive: nothing raises mid-serve; the assertion lives with
  whoever owns the window.
"""

import threading

from distributed_faiss_tpu_torch.utils import envutil

__all__ = [
    "enabled", "install", "uninstall", "record", "snapshot", "new_since",
    "counts", "reset", "by_entry", "unregistered",
]

_CAPTURE = "capture:"


def enabled() -> bool:
    """DFT_COMPILECHECK master switch, read per call."""
    return envutil.env_flag("DFT_COMPILECHECK", False)


# _MU is a strict leaf guarding _COUNTS and _installed
_MU = threading.Lock()
_COUNTS = {}  # "nvcc:<source>" / "load:<source>" / "g++:hnsw" / "capture:<program>" -> count
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


def by_entry(snap: dict = None) -> dict:
    """Captures (since ``snap``, when given) by registered program name;
    names no row declares are left out (``unregistered``)."""
    from distributed_faiss_tpu_torch.utils import jitreg

    names = set(jitreg.registered_qualnames())
    tally = counts() if snap is None else new_since(snap)
    return {n[len(_CAPTURE):]: c for n, c in tally.items()
            if n.startswith(_CAPTURE) and n[len(_CAPTURE):] in names}


def unregistered() -> list:
    """Captured program names that no ``utils/jitreg.py`` row declares."""
    from distributed_faiss_tpu_torch.utils import jitreg

    names = set(jitreg.registered_qualnames())
    return sorted(n[len(_CAPTURE):] for n in counts()
                  if n.startswith(_CAPTURE) and n[len(_CAPTURE):] not in names)


def reset() -> None:
    """Clear the tally (test isolation)."""
    with _MU:
        _COUNTS.clear()
