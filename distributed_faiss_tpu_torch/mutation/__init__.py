"""Mutable corpora on one rank (counterpart of
distributed_faiss_tpu/mutation): tombstone deletes by metadata id, upsert,
compaction and per-id versions.

- Device side: every maskable model has ``remove_rows``. A flat corpus
  keeps a boolean ``live`` mask that its scan ANDs with the padding mask;
  an IVF family writes -1 into the deleted cells of its ids plane, which
  every list scan (the K1 and K3 kernels inside, K2's and K4's paths right
  after the kernel) already treats as padding. An index nothing was ever
  deleted from runs the program it ran before this subsystem.
- Engine side (engine.py): ``remove_ids``/``upsert`` map metadata ids onto
  positional rows (rows still in the add buffer are masked when their
  chunk drains), record them in a ``tombstones.TombstoneSet`` and persist
  the set both inside every committed generation and in a standalone
  ``tombstones.json`` rewritten on every mutation, in the JAX package's
  format, so each package loads the other's storage dirs.
- ``compaction.py`` rebuilds the index without the dead rows into a fresh
  MANIFEST generation; ``versions.py`` holds the hybrid logical clock and
  the last-writer-wins gates that versioned writes pass through.
"""

from distributed_faiss_tpu_torch.mutation.compaction import (  # noqa: F401
    CompactionUnsupported,
    compact_state,
    run_watcher,
)
from distributed_faiss_tpu_torch.mutation.tombstones import (  # noqa: F401
    SIDECAR_NAME,
    TombstoneSet,
    load_sidecar,
    write_sidecar,
)
from distributed_faiss_tpu_torch.mutation.versions import (  # noqa: F401
    HLC,
    add_loses,
    delete_loses,
    version_key,
)
