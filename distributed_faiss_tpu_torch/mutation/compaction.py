"""Compaction: rewrite tombstoned rows out of an index (counterpart of
distributed_faiss_tpu/mutation/compaction.py).

``compact_state`` filters a model's ``state_dict`` down to the surviving
rows; the engine rebuilds the model from it with ``index_from_state_dict``
on its own device. Centroids, codebooks and quantizer parameters are kept
as they are, encoded rows are copied verbatim (no decode/re-encode drift),
and the rebuilt inverted lists come back tight: the dead cells are gone
and each list's capacity is sized to what survives.

``run_watcher`` is the body of the per-engine watcher thread: it wakes
every ``DFT_COMPACT_INTERVAL`` seconds and compacts once the tombstoned
fraction of the indexed rows reaches ``DFT_COMPACT_THRESHOLD``. It waits
on the engine's retired event, so retiring the engine ends it at once.
"""

import logging
import os
import time

import numpy as np

logger = logging.getLogger()

# the kinds compact_state can filter, and the per-row arrays (in insertion
# order) a state dict of those kinds carries
_ROW_KEYS = ("rows", "assign", "list_norms", "refine_rows")
SUPPORTED_KINDS = frozenset({"flat", "sharded_flat", "ivf_flat", "sharded_ivf_flat",
                             "ivf_pq", "sharded_ivf_pq"})


class CompactionUnsupported(RuntimeError):
    """This index kind has no row-filterable state dict."""


def compact_state(state: dict, keep: np.ndarray) -> dict:
    """A new state dict of the same kind holding the rows where ``keep`` is
    True (insertion order). Structural entries are shared, per-row arrays
    are filtered."""
    kind = str(state["kind"])
    if kind not in SUPPORTED_KINDS:
        raise CompactionUnsupported(
            f"index kind {kind!r} has no row-filterable state")
    keep = np.asarray(keep, bool)
    out = dict(state)
    if kind == "flat":
        data = np.asarray(state["data"])
        if keep.shape[0] != data.shape[0]:
            raise ValueError(
                f"keep mask covers {keep.shape[0]} rows, state has "
                f"{data.shape[0]}")
        out["data"] = data[keep]
        out["ntotal"] = int(keep.sum())
        return out
    for key in _ROW_KEYS:
        if key in state:
            arr = np.asarray(state[key])
            if arr.shape[0] != keep.shape[0]:
                raise ValueError(
                    f"keep mask covers {keep.shape[0]} rows, state[{key!r}] "
                    f"has {arr.shape[0]}")
            out[key] = arr[keep]
    return out


def run_watcher(engine, cfg) -> None:
    """Body of the compaction watcher thread of ``engine`` (an
    ``engine.Index``) under ``cfg`` (a ``MutationCfg``)."""
    name = os.path.basename(engine.cfg.index_storage_dir or "?")
    while not engine._retired.wait(cfg.interval_s):
        try:
            frac = engine.tombstone_fraction()
            if frac < cfg.threshold:
                continue
            # a replicated deployment installs a lease so the replicas of a
            # group do not compact at once; a standalone engine has none
            gate = engine.compaction_gate
            if gate is not None and not gate():
                logger.debug("compaction watcher (%s): tombstone fraction %.3f but "
                             "another replica holds the compaction lease", name, frac)
                continue
            logger.info("compaction watcher (%s): tombstone fraction %.3f >= %.3f, "
                        "compacting", name, frac, cfg.threshold)
            engine.compact()
        except Exception:
            # one failed pass must not end the watcher: the next interval
            # retries against fresh state
            logger.exception("compaction pass failed (%s)", name)
            time.sleep(min(1.0, cfg.interval_s))
