"""Per-id mutation versions: hybrid logical clocks and the last-writer-wins
gates (counterpart of distributed_faiss_tpu/mutation/versions.py, the same
functions on the same values).

A version is a 3-tuple ``(wall_ms, counter, writer_id)``:

- ``wall_ms``: the stamping client's wall clock in integer milliseconds,
  advanced to at least the largest version it has observed, so a client
  whose clock is behind still stamps ahead of what it has seen;
- ``counter``: increments when several stamps land in one millisecond;
- ``writer_id``: a per-client tie-break, so versions are totally ordered.

Versions are plain tuples on the wire and lists in the JSON sidecar
(``version_key`` normalizes both); ``None`` means unversioned and compares
below every real version, so the legacy semantics (delete always wins,
re-ingest always restores) are the degenerate case of the gates:

- ``add_loses(v, live, dead)``: a versioned add no-ops when the id is live
  at ``>= v`` (a replay) or was deleted at ``> v``. A tie goes to the add,
  so an upsert that reuses its delete's version still lands its re-add.
- ``delete_loses(v, live, dead)``: a versioned delete no-ops when the id is
  live at ``>= v`` (an upsert outran it) or already deleted at ``>= v``.
"""

import os
import time
from typing import Optional, Tuple

from distributed_faiss_tpu_torch.utils import lockdep

Version = Tuple[int, int, int]


def version_key(v) -> Optional[Version]:
    """A version from any carrier (wire tuple, JSON list) as the canonical
    comparable 3-tuple; ``None`` (unversioned) passes through."""
    if v is None:
        return None
    if isinstance(v, (list, tuple)) and len(v) == 3:
        return (int(v[0]), int(v[1]), int(v[2]))
    raise ValueError(f"not a version: {v!r}")


def compare(a, b) -> int:
    """Total order with ``None`` minimal: -1, 0 or 1."""
    ka, kb = version_key(a), version_key(b)
    if ka is None and kb is None:
        return 0
    if ka is None:
        return -1
    if kb is None:
        return 1
    return (ka > kb) - (ka < kb)


def newest(a, b):
    """The larger of two versions (None minimal)."""
    return a if compare(a, b) >= 0 else b


def add_loses(v, live, dead) -> bool:
    """True when a versioned add of an id must no-op: the id is live at the
    same or a newer version, or a strictly newer delete won."""
    return compare(live, v) >= 0 or compare(dead, v) > 0


def delete_loses(v, live, dead) -> bool:
    """True when a versioned delete must no-op: a same-or-newer live write
    won, or the delete replays one already applied."""
    return compare(live, v) >= 0 or compare(dead, v) >= 0


class HLC:
    """Hybrid logical clock, one per writing client. ``tick()`` returns a
    version strictly greater than every version this clock has ticked or
    observed; ``observe(v)`` merges a remote version in (a client seeds its
    clock from the cluster's watermarks, so a restart on a machine whose
    wall clock went backward still stamps ahead of its earlier writes).
    ``clock_ms`` injects the wall clock (tests). Thread-safe."""

    def __init__(self, writer_id: Optional[int] = None, clock_ms=None):
        if writer_id is None:
            # only needs to tell concurrent writers apart
            writer_id = (os.getpid() << 16) ^ (time.time_ns() & 0xFFFF)
        self.writer_id = int(writer_id) & 0x7FFFFFFF
        self._clock_ms = clock_ms or (lambda: time.time_ns() // 1_000_000)
        self._lock = lockdep.lock("HLC._lock")
        self._last_ms = 0
        self._counter = 0

    def tick(self) -> Version:
        with self._lock:
            now = int(self._clock_ms())
            if now > self._last_ms:
                self._last_ms = now
                self._counter = 0
            else:
                self._counter += 1
            return (self._last_ms, self._counter, self.writer_id)

    def observe(self, v) -> None:
        """Merge a remote version: later ticks compare above it."""
        k = version_key(v)
        if k is None:
            return
        with self._lock:
            if k[0] > self._last_ms:
                self._last_ms = k[0]
                self._counter = k[1]
            elif k[0] == self._last_ms and k[1] > self._counter:
                self._counter = k[1]
