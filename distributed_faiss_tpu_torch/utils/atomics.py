"""Named monotonic counters behind one leaf lock (counterpart of
distributed_faiss_tpu/utils/atomics.py).

Threads bump them with an atomic ``inc``; ``snapshot`` is a consistent
cut for stats readers. The lock comes from the lockdep factory, so the
DFT_LOCKDEP and DFT_RACECHECK witnesses see it like every other pinned
lock, and it is a LEAF by contract: nothing is acquired while it is held,
so it can be taken while holding anything (the scheduler bumps its
counters under its condition).
"""

from typing import Dict, Iterable, Optional

from distributed_faiss_tpu_torch.utils import lockdep

__all__ = ["AtomicCounters"]


class AtomicCounters:
    """Named monotonic counters behind one leaf lock."""

    def __init__(self, names: Iterable[str] = (),
                 initial: Optional[Dict[str, int]] = None):
        self._lock = lockdep.lock("AtomicCounters._lock")
        self._counts: Dict[str, int] = {n: 0 for n in names}
        if initial:
            self._counts.update({k: int(v) for k, v in initial.items()})

    def inc(self, name: str, n: int = 1) -> int:
        """Atomically add ``n`` (default 1) and return the new value.
        Unknown names start at zero — counters are declarative, not
        pre-registered."""
        with self._lock:
            value = self._counts.get(name, 0) + n
            self._counts[name] = value
            return value

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def __getitem__(self, name: str) -> int:
        return self.get(name)

    def snapshot(self) -> Dict[str, int]:
        """A consistent point-in-time copy of every counter."""
        with self._lock:
            return dict(self._counts)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"AtomicCounters({self.snapshot()!r})"
