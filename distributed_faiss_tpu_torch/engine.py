"""Per-(server, index_id) shard engine: buffer, state machine, async
train/add, mutation, persistence (counterpart of
distributed_faiss_tpu/engine.py, one rank).

Behavior kept from the JAX package (and its reference,
distributed_faiss/index.py:111-508): ingest buffer + positional metadata,
NOT_TRAINED -> TRAINING -> TRAINED <-> ADD lifecycle, threshold-triggered
async training on a uniform sample of the whole buffer, chunked async add
(cfg.buffer_bsz), the metadata join, and generation + MANIFEST persistence
that writes the same file set as the JAX engine's ``_commit_generation``
(index npz, meta pkl, buffer pkl, cfg json, tombstones json), so a storage
dir written by either package loads in the other. With
``cfg.save_interval_sec > 0`` a save watcher thread commits a generation
every interval while rows keep arriving, and ``search`` goes through the
in-process natural batcher (utils/batching.py) so concurrent callers share
device launches.

Mutation (mutation/): ``remove_ids`` and ``upsert`` tombstone rows by
metadata id, masked on the device under ``index_lock`` (the lock every
device search holds, so a coalesced window is wholly before or wholly
after a delete) and made durable in the standalone sidecar before the
call returns; rows still in the add buffer are masked when their chunk
drains. ``compact`` rebuilds the index without its dead rows into a fresh
generation, by hand or from the watcher thread (DFT_COMPACT*). Writes may
carry hybrid-logical-clock versions: the last-writer-wins gates make
replays no-ops and let an upsert outrun a delete, the per-writer
watermarks back read-your-writes (``assert_min_version``), and
``search_at_generation`` serves a retained committed generation exactly
as it was committed (DFT_RETAIN_GENERATIONS).

Replication (parallel/antientropy.py): ``replica_digest`` is an
order-independent hash of the live ids and the deletion ledger (the JAX
engine's, byte for byte), ``id_sets`` / ``export_rows_versioned`` /
``reconcile_deletes`` / ``prune_ledger`` are the delta-repair protocol, and
``export_snapshot`` / ``import_snapshot`` carry a whole shard to a rank
that commits it as a generation of its own before serving it.

Persistence also reads the pre-manifest flat layout (``index.npz``,
``meta.pkl``, ``buffer.pkl``, ``cfg.json``; ``get_index_files``) when a
dir holds no committed generation, as the JAX engine does.

Tracing: a server wires its span ring into ``span_buffer``; a launch of a
window the scheduler marked as sampled (``observability.spans``) records an
``engine.launch`` span in every sampled request of the window (the JAX
engine records it in the first one only) and makes the first the exemplar
of ``device_search_s``; the span stays outside the model's captured
program, which a replay runs without Python.

Programs (utils/programs.py): a model serves through its captured search
programs under ``index_lock``, so a tombstone mask written in place is
read by the next replay. A model swapped out (compaction, drop, a
replaced engine's ``retire``) and a replaced generation snapshot free
their programs; the snapshot model of ``search_at_generation`` has a cache
of its own. ``device_launches`` keeps the JAX engine's meaning: the mesh
models' counted launches.
"""

import hashlib
import json
import logging
import os
import pickle
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.models.factory import (
    build_index,
    index_from_state_dict,
    remove_rows_unsupported,
)
from distributed_faiss_tpu_torch.mutation import compaction as _compaction
from distributed_faiss_tpu_torch.mutation import tombstones as _tombstones
from distributed_faiss_tpu_torch.mutation import versions as _versions
from distributed_faiss_tpu_torch.mutation.tombstones import TombstoneSet
from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.utils import envutil, lockdep, serialization, xfercheck
from distributed_faiss_tpu_torch.utils.batching import SearchBatcher
from distributed_faiss_tpu_torch.utils.config import IndexCfg, MutationCfg, VersioningCfg
from distributed_faiss_tpu_torch.utils.device import resolve_device
from distributed_faiss_tpu_torch.utils.serialization import atomic_write, load_state, save_state
from distributed_faiss_tpu_torch.utils.state import (
    NOT_TRAINED_REJECTION_FMT,
    STALE_READ_REJECTION_FMT,
    IndexState,
)
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

logger = logging.getLogger()

_IVF_BUILDERS = ("ivf_simple", "knnlm", "ivfsq", "ivf_tpu")

_id_match_key = _tombstones.id_match_key

# per-id 128-bit hashes summed mod 2^128: the digest does not depend on the
# rows' order, and unlike XOR a duplicated id cannot cancel out
_DIGEST_MASK = (1 << 128) - 1


def _id_hash(key) -> int:
    return int.from_bytes(
        hashlib.sha1(repr(key).encode("utf-8", "backslashreplace")).digest()[:16], "little")


class _MetaStore:
    """Growable object-ndarray metadata store. Append-only: ``snapshot``
    hands out (array, length) that is safe to read outside the lock,
    because slots below the snapshotted length are never rewritten (a
    compaction replaces the whole store)."""

    __slots__ = ("_arr", "_n")

    def __init__(self, items=None):
        items = items if items is not None else []
        n = len(items)
        arr = np.empty(max(8, n), dtype=object)
        if n:
            # fromiter keeps nested sequences as 1-D scalars
            arr[:n] = np.fromiter(items, dtype=object, count=n)
        self._arr, self._n = arr, n

    def __len__(self) -> int:
        return self._n

    def extend(self, items) -> None:
        if not hasattr(items, "__len__"):
            items = list(items)
        m = len(items)
        if m == 0:
            return
        if self._n + m > self._arr.shape[0]:
            new = np.empty(max(self._arr.shape[0] * 2, self._n + m), dtype=object)
            new[: self._n] = self._arr[: self._n]
            self._arr = new
        self._arr[self._n:self._n + m] = np.fromiter(items, dtype=object, count=m)
        self._n += m

    def snapshot(self) -> Tuple[np.ndarray, int]:
        return self._arr, self._n

    def tolist(self) -> list:
        return self._arr[: self._n].tolist()


# what _meta_id returns for a row without an id (None is a legal id)
_NO_ID = object()


def _meta_id(m, id_idx: int):
    """The metadata id of one row, or ``_NO_ID`` for a row that has none
    (empty metadata, or metadata the id index does not reach)."""
    if not m:
        return _NO_ID
    try:
        return m[id_idx]
    except (TypeError, IndexError, KeyError):
        return _NO_ID


def _iter_live_ids(meta_arr, meta_n: int, dead_rows, id_idx: int):
    """``(position, id)`` of every live row that has a metadata id."""
    for p in range(meta_n):
        if p in dead_rows:
            continue
        mid = _meta_id(meta_arr[p], id_idx)
        if mid is not _NO_ID:
            yield p, mid


def _normalize_batch_versions(version, n: int):
    """``add_batch``'s ``version``: None (unversioned), one version for the
    whole batch (a client call ticks once), or a per-row list. Returns
    ``(vlist, per_row)``: None or n normalized versions, and whether they
    were per row, which is also what allows a row to replace an older
    live row of its id (metadata ids need not be unique, so a plain batch
    never does)."""
    if version is None:
        return None, False
    if (isinstance(version, (list, tuple)) and len(version) == 3
            and all(isinstance(c, (int, np.integer)) for c in version)):
        return [_versions.version_key(version)] * n, False
    out = [_versions.version_key(v) for v in version]
    if len(out) != n:
        raise RuntimeError("versions length should match the batch size of the embeddings")
    return out, True


def _apply_sidecar_by_id(tomb: TombstoneSet, side: dict, meta: list, id_idx: int,
                         storage_dir: str) -> None:
    """Re-apply a standalone sidecar whose positions belong to a layout that
    did not survive (a compacted generation torn before a crash) by id:
    its ids are layout-free. Conservative: an id deleted and re-added in
    the lost layout is deleted again (a delete must never resurrect)."""
    ids = {_id_match_key(v) for v in side.get("dead_ids", ()) if v is not None}
    if not ids:
        return
    hits = 0
    for p, m in enumerate(meta):
        mid = _meta_id(m, id_idx)
        if mid is not _NO_ID and _id_match_key(mid) in ids and p not in tomb:
            tomb.add([p], [mid])
            hits += 1
    logger.warning("tombstone sidecar at %s is keyed to layout %s but the generation's "
                   "layout is %s: re-applied %d delete(s) by id", storage_dir,
                   side.get("layout"), tomb.layout, hits)


def get_index_files(index_storage_dir: str) -> Tuple[str, str, str, str]:
    """The pre-manifest flat file names of a shard (reference
    index.py:103-108, .faiss -> .npz). Saves write generation sets under a
    MANIFEST; these names remain so that pre-manifest dirs still load."""
    return tuple(os.path.join(index_storage_dir, name)
                 for name in ("index.npz", "meta.pkl", "buffer.pkl", "cfg.json"))


def infer_n_centroids(total_data_size: int) -> int:
    """Centroid-count tiers (reference index.py:497-508)."""
    if total_data_size < 10e5:
        return int(2 * (total_data_size ** 0.5))
    if total_data_size < 10e6:
        return 65536
    if total_data_size < 10e7:
        return 262144
    return 1048576



def _release_programs(model) -> None:
    """Free a swapped-out model's captured search programs and their pool
    (``utils/programs.py``)."""
    if model is not None:
        model.release_programs()

class Index:
    def __init__(self, cfg: IndexCfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embeddings_buffer: List[np.ndarray] = []
        self.total_data = 0
        self.id_to_metadata = _MetaStore()
        self.buffer_lock = lockdep.lock("Index.buffer_lock")
        self.index_lock = lockdep.lock("Index.index_lock")
        self.state = IndexState.NOT_TRAINED
        self.model = None  # models.base.TorchIndex once trained
        # set when a server replaces this engine (drop_index): no further
        # saves or compactions
        self._retired = threading.Event()
        self._train_thread: Optional[threading.Thread] = None
        self._add_thread: Optional[threading.Thread] = None
        self._save_thread: Optional[threading.Thread] = None
        self._compaction_thread: Optional[threading.Thread] = None
        self.index_save_time = time.time()
        self.index_saved_size = 0
        self.perf = LatencyStats()  # device-search latency, served via get_perf_stats
        # the serving rank's span ring (observability/spans.py); None records
        # no span
        self.span_buffer = None
        self._generation = 0  # newest committed snapshot generation
        # bumped under both locks whenever the positional layout is replaced
        # (compaction, drop_index): a search that launched on the old layout
        # re-joins
        self._meta_epoch = 0

        # ---- mutation (guarded by index_lock unless noted) ----
        self.tombstones = TombstoneSet()
        self._mutation_counters = {
            "compactions": 0, "compactions_aborted": 0, "load_fallbacks": 0,
            # versioned writes that no-op'd (replays, outrun deletes) and
            # adds that replaced an older live row in place
            "version_noop_adds": 0, "version_noop_deletes": 0, "version_replaced": 0,
            # deletion-ledger entries every replica had passed (prune_ledger)
            "ledger_pruned": 0,
        }
        self.versioning = VersioningCfg.from_env()
        # writer id -> (wall_ms, counter) of the newest version incorporated
        self._version_watermark = {}
        # one cached snapshot of a retained generation for pinned reads,
        # under its own lock: a pinned read never contends with serving
        self._pinned_lock = lockdep.lock("Index._pinned_lock")
        self._pinned_cache = None
        # the standalone sidecar is written outside the serving locks, by
        # version: a payload snapshotted later is a superset (the set only
        # shrinks at a compaction swap, which bumps the version), so an
        # older writer skips
        self._tombstone_io_lock = lockdep.lock("Index._tombstone_io_lock")
        self._tombstone_version = 0
        self._tombstone_written = 0  # under _tombstone_io_lock
        # the tombstone version the last committed generation captured: a
        # delete alone (ntotal unchanged) still commits on the next save
        self._saved_tombstone_version = 0
        # a replicated deployment's compaction lease; None compacts freely
        self.compaction_gate = None
        # (cache key, replica_digest) under both locks
        self._digest_cache = None
        self.mutation_cfg = MutationCfg.from_env()
        if self.mutation_cfg.compact and cfg.index_storage_dir:
            self._run_compaction_watcher()

        # concurrent searches coalesce into shared device launches; window 0
        # = natural batching only, no added latency
        self._batcher = SearchBatcher(
            self._device_search, window_ms=float(cfg.extra.get("batch_window_ms", 0.0)))
        if cfg.save_interval_sec > 0:
            self._run_save_watcher()

    # ------------------------------------------------------------------ ingest

    def drop_index(self) -> None:
        with self.buffer_lock:
            self.embeddings_buffer = []
            self.total_data = 0
            self.id_to_metadata = _MetaStore()
            self._meta_epoch += 1
        with self.index_lock:
            _release_programs(self.model)
            self.model = None
            self.state = IndexState.NOT_TRAINED
            self.tombstones = TombstoneSet(layout=self.tombstones.layout)

    def add_batch(self, embeddings: np.ndarray, metadata: Optional[List[object]],
                  train_async_if_triggered: bool = True, version=None) -> None:
        n = embeddings.shape[0]
        if not metadata:
            metadata = [None] * n
        if n != len(metadata):
            raise RuntimeError("metadata length should match the batch size of the embeddings")
        embeddings = np.asarray(embeddings, np.float32)
        vlist, per_row = _normalize_batch_versions(version, n)
        if vlist is not None:
            total_data = self._add_batch_versioned(embeddings, metadata, vlist, per_row)
        else:
            with self.buffer_lock:
                self.embeddings_buffer.append(embeddings)
                self.id_to_metadata.extend(metadata)
                self.total_data += n
                total_data = self.total_data
            # a re-added id is live again: drop its ledger entry, durably
            # like the delete it reverses (only when anything was deleted)
            payload = None
            with self.index_lock:
                if self.tombstones.ledger_size():
                    id_idx = self.cfg.custom_meta_id_idx
                    keys = [k for k in (_meta_id(m, id_idx) for m in metadata)
                            if k is not _NO_ID]
                    if self.tombstones.unledger(keys):
                        payload, sc_version = self._tombstone_payload_locked()
            if payload is not None:
                self._write_tombstone_sidecar(payload, sc_version)

        state = self.get_state()
        if state == IndexState.TRAINED:
            self.add_buffer_to_index()
        elif state == IndexState.NOT_TRAINED and 0 < self.cfg.train_num <= total_data:
            logger.info("buffer reached %d >= train_num, triggering training", total_data)
            if train_async_if_triggered:
                t = threading.Thread(target=self.train, name=f"train:{self._thread_tag()}",
                                     daemon=True)
                self._train_thread = t
                t.start()
            else:
                self.train()

    def _scan_ids(self, meta_arr, lo: int, hi: int, match) -> list:
        """``(position, id)`` of the rows in [lo, hi) whose id ``match``
        accepts."""
        id_idx = self.cfg.custom_meta_id_idx
        found = []
        for p in range(lo, hi):
            mid = _meta_id(meta_arr[p], id_idx)
            if mid is not _NO_ID and match(mid):
                found.append((p, mid))
        return found

    def _add_batch_versioned(self, embeddings: np.ndarray, metadata: list, vlist: list,
                             allow_replace: bool) -> int:
        """Append under the last-writer-wins gate, per id: a row whose
        version loses to the id's live or deleted version no-ops. With
        ``allow_replace`` (per-row versions) a row that wins displaces the
        live rows of its id in place (they are tombstoned in the same lock
        hold); a single-stamp batch never displaces. Decide and apply run
        under both locks; the sidecar write, when the ledger changed, after
        them. Returns the buffered total (the training trigger)."""
        id_idx = self.cfg.custom_meta_id_idx
        keys = []
        for m in metadata:
            mid = _meta_id(m, id_idx)
            keys.append(None if mid is _NO_ID else _id_match_key(mid))
        batch_keys = {k for k in keys if k is not None}

        def in_batch(mid):
            return _id_match_key(mid) in batch_keys

        # the O(rows) candidate scan runs lock-free over the append-only
        # snapshot; the locked section rescans only the tail since
        candidates = []
        if allow_replace and batch_keys:
            with self.buffer_lock:
                epoch0 = self._meta_epoch
                meta_arr0, meta_n0 = self.id_to_metadata.snapshot()
            candidates = self._scan_ids(meta_arr0, 0, meta_n0, in_batch)
        with self.buffer_lock, self.index_lock:
            tomb = self.tombstones
            keep = [True] * len(metadata)
            replace_keys = set()
            noop = 0
            for i, (k, v) in enumerate(zip(keys, vlist)):
                self._observe_version_locked(v)
                if k is None or v is None:
                    continue
                if _versions.add_loses(v, tomb.live_version(k), tomb.ledger_version(k)):
                    keep[i] = False
                    noop += 1
                elif allow_replace:
                    replace_keys.add(k)
            self._mutation_counters["version_noop_adds"] += noop
            replaced_rows = 0
            if replace_keys:
                meta_arr, meta_n = self.id_to_metadata.snapshot()
                if self._meta_epoch != epoch0:
                    candidates = self._scan_ids(meta_arr, 0, meta_n, in_batch)
                else:
                    candidates += self._scan_ids(meta_arr, meta_n0, meta_n, in_batch)
                hit = [(p, mid) for p, mid in candidates
                       if p not in tomb and _id_match_key(mid) in replace_keys]
                if hit:
                    self._check_remove_supported_locked()
                    self._mask_indexed_locked([p for p, _ in hit])
                    tomb.add([p for p, _ in hit], [mid for _, mid in hit])
                    replaced_rows = len(hit)
                    self._mutation_counters["version_replaced"] += replaced_rows
            kept_n = sum(keep)
            unledgered = 0
            if kept_n:
                if kept_n == len(metadata):
                    kept_emb, kept_meta = embeddings, metadata
                else:
                    kept_emb = embeddings[np.asarray(keep, bool)]
                    kept_meta = [m for i, m in enumerate(metadata) if keep[i]]
                self.embeddings_buffer.append(kept_emb)
                self.id_to_metadata.extend(kept_meta)
                self.total_data += kept_n
                for i, (k, v) in enumerate(zip(keys, vlist)):
                    if not keep[i] or k is None:
                        continue
                    if v is not None:
                        tomb.set_live_version(k, _versions.newest(tomb.live_version(k), v))
                    # the landing write outranks any recorded delete
                    unledgered += tomb.unledger([k])
            total_data = self.total_data
            # the sidecar is rewritten only when the deletion state moved;
            # plain appends' live versions become durable at the next commit
            payload = None
            if replaced_rows or unledgered:
                payload, sc_version = self._tombstone_payload_locked()
        if payload is not None:
            self._write_tombstone_sidecar(payload, sc_version)
        return total_data

    def _thread_tag(self) -> str:
        return os.path.basename(self.cfg.index_storage_dir or "") or f"mem-{id(self):x}"

    def get_idx_data_num(self) -> Tuple[int, int]:
        with self.buffer_lock:
            buf_total = self.total_data
        with self.index_lock:
            index_total = self.model.ntotal if self.model is not None else 0
        return buf_total, index_total

    # ---------------------------------------------------------------- mutation

    def remove_ids(self, ids, version=None) -> int:
        """Tombstone every row whose metadata id (``cfg.custom_meta_id_idx``)
        is in ``ids``; returns the rows newly tombstoned.

        ``version`` (one version for the call) makes the delete LWW-gated:
        an id live at a same-or-newer version no-ops, a replay no-ops, and
        every id the delete wins is ledgered at ``version``, rows here or
        not, so a stale add arriving later is gated too. Unversioned calls
        keep the legacy delete-wins semantics.

        Indexed rows are masked on the device at once, under ``index_lock``;
        buffered rows keep their positions and are masked when their chunk
        drains. The O(rows) id scan runs lock-free over the append-only
        metadata snapshot (only the tail appended since is rescanned under
        the locks), and the sidecar is written after the locks are released
        but before this returns: an acknowledged delete survives a crash."""
        id_set = ids if isinstance(ids, (set, frozenset)) else set(ids)
        if not id_set:
            return 0

        def wanted(mid):
            return mid in id_set

        with self.buffer_lock:
            epoch0 = self._meta_epoch
            meta_arr0, meta_n0 = self.id_to_metadata.snapshot()
        candidates = self._scan_ids(meta_arr0, 0, meta_n0, wanted)

        vk = _versions.version_key(version)
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            if self._meta_epoch != epoch0:
                # a compaction or drop replaced the layout since the scan
                candidates = self._scan_ids(meta_arr, 0, meta_n, wanted)
            else:
                candidates += self._scan_ids(meta_arr, meta_n0, meta_n, wanted)
            eligible_keys = None
            if vk is not None:
                # the gate runs per requested id, not per matched row
                self._observe_version_locked(vk)
                eligible_keys, gated = set(), 0
                for raw in id_set:
                    k = _id_match_key(raw)
                    if _versions.delete_loses(vk, self.tombstones.live_version(k),
                                              self.tombstones.ledger_version(k)):
                        gated += 1
                    else:
                        eligible_keys.add(k)
                self._mutation_counters["version_noop_deletes"] += gated
            rows, rids = [], []
            for p, mid in candidates:
                if p in self.tombstones:
                    continue
                if eligible_keys is not None and _id_match_key(mid) not in eligible_keys:
                    continue
                rows.append(p)
                rids.append(mid)
            if not rows and not eligible_keys:
                return 0
            if rows:
                self._check_remove_supported_locked()
                self._mask_indexed_locked(rows)
                self.tombstones.add(rows, rids, version=vk)
                if vk is None:
                    # legacy delete-wins: a live version must not outlive
                    # its rows
                    for mid in rids:
                        self.tombstones.drop_live_version(mid)
            if eligible_keys:
                self.tombstones.ledger_update_versioned((k, vk) for k in eligible_keys)
                for k in eligible_keys:
                    self.tombstones.drop_live_version(k)
            payload, sc_version = self._tombstone_payload_locked()
            removed = len(rows)
        self._write_tombstone_sidecar(payload, sc_version)
        return removed

    def upsert(self, ids, embeddings: np.ndarray, metadata: Optional[List[object]] = None,
               version=None) -> int:
        """Delete + add: tombstone every live row of ``ids``, then ingest
        the replacements through the add path (fresh positions, so the
        ids' positional tombstones do not cover them). The old rows stop
        serving before this returns; the new ones serve once their chunk
        drains; never both. ``metadata`` defaults to ``(id,)`` tuples when
        the id rides at position 0. ``version`` stamps both halves; the tie
        rules make a replayed upsert a no-op."""
        ids = list(ids)
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.shape[0] != len(ids):
            raise RuntimeError("upsert ids length should match the batch size of the embeddings")
        if metadata is None:
            if self.cfg.custom_meta_id_idx != 0:
                raise RuntimeError("upsert needs explicit metadata when custom_meta_id_idx != 0")
            metadata = [(i,) for i in ids]
        removed = self.remove_ids(ids, version=version)
        self.add_batch(embeddings, metadata, version=version)
        return removed

    def _mask_indexed_locked(self, rows: list) -> None:
        """Mask the already-indexed ones of ``rows`` on the device (caller
        holds index_lock; the buffered ones are masked when they drain)."""
        indexed_n = self.model.ntotal if self.model is not None else 0
        device_rows = [p for p in rows if p < indexed_n]
        if device_rows:
            self.model.remove_rows(np.asarray(device_rows, np.int64))

    def _check_remove_supported_locked(self) -> None:
        """Refuse a delete on an index kind without a tombstone mask before
        any tombstone is recorded, also while every row is still buffered:
        a tombstone the drain could not mask would serve the row."""
        if self.model is not None:
            if not self.model.supports_remove_rows():
                raise RuntimeError(
                    f"{type(self.model).__name__} does not support remove/upsert "
                    "(no tombstone mask for this index kind)")
        elif remove_rows_unsupported(self.cfg):
            kind = self.cfg.index_builder_type or self.cfg.faiss_factory
            raise RuntimeError(f"index kind {kind!r} does not support remove/upsert "
                               "(no tombstone mask for this index kind)")

    def _tombstone_payload_locked(self):
        """The sidecar payload and a monotonic version, taken under
        index_lock; the disk write happens outside it."""
        self._tombstone_version += 1
        return self.tombstones.to_payload(), self._tombstone_version

    def _write_tombstone_sidecar(self, payload: dict, version: int) -> None:
        """Rewrite the standalone sidecar unless a newer payload already
        landed. No-op without a storage dir (the set stays in memory)."""
        storage_dir = self.cfg.index_storage_dir
        if not storage_dir:
            return
        with self._tombstone_io_lock:
            if version <= self._tombstone_written:
                return
            os.makedirs(storage_dir, exist_ok=True)
            _tombstones.write_sidecar(storage_dir, payload)
            self._tombstone_written = version

    def tombstone_fraction(self) -> float:
        """Tombstoned share of the indexed rows (the compaction trigger)."""
        with self.index_lock:
            indexed_n = self.model.ntotal if self.model is not None else 0
            if indexed_n == 0:
                return 0.0
            return self.tombstones.count_below(indexed_n) / indexed_n

    def mutation_stats(self) -> dict:
        """The ``mutation`` perf-stats key: tombstone counts, the live
        fraction, the compaction and version counters, the layout epoch,
        ``compaction_s`` once a pass ran, and the version watermark."""
        with self.index_lock:
            indexed_n = self.model.ntotal if self.model is not None else 0
            dead_indexed = self.tombstones.count_below(indexed_n)
            out = {
                "tombstoned_rows": len(self.tombstones),
                "tombstoned_indexed": dead_indexed,
                "live_fraction": 1.0 - dead_indexed / indexed_n if indexed_n else 1.0,
                "layout_generation": self.tombstones.layout,
                **self._mutation_counters,
            }
        comp = self.perf.summary().get("compaction_s")
        if comp:
            out["compaction_s"] = comp
        wm = self.version_watermark()
        out["version_watermark"] = list(wm) if wm is not None else None
        return out

    # ------------------------------------------------------------- versioning

    def _observe_version_locked(self, vk) -> None:
        """Fold a presented version into its writer's watermark, applied or
        gated alike: a gated replay is covered by a same-or-newer write."""
        if vk is None:
            return
        cur = self._version_watermark.get(vk[2])
        pair = (vk[0], vk[1])
        if cur is None or pair > cur:
            self._version_watermark[vk[2]] = pair

    def version_watermark(self):
        """The newest version incorporated here across all writers (None
        before any): what a client's clock seeds from."""
        with self.index_lock:
            items = list(self._version_watermark.items())
        if not items:
            return None
        return max((ms, ctr, w) for w, (ms, ctr) in items)

    def assert_min_version(self, min_version) -> None:
        """Read-your-writes gate: raise the stale-read rejection unless this
        shard has incorporated ``min_version``. Watermarks are per writer,
        so another writer's newer version never satisfies it."""
        vk = _versions.version_key(min_version)
        if vk is None:
            return
        with self.index_lock:
            wm = self._version_watermark.get(vk[2])
        if wm is None or wm < (vk[0], vk[1]):
            raise RuntimeError(STALE_READ_REJECTION_FMT.format(
                version=list(vk), watermark=list(wm) if wm else None))

    def id_sets(self) -> dict:
        """The live ids (buffered ones included) and the deletion ledger,
        normalized; the version planes; and ``watermark``, the newest
        incorporated version, which a client's clock seeds from."""
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            dead_rows = frozenset(self.tombstones.rows())
            ledger_items = self.tombstones.ledger_items()
            live_vmap = dict(self.tombstones.live_versions())
        live = [_id_match_key(mid) for _p, mid in
                _iter_live_ids(meta_arr, meta_n, dead_rows, self.cfg.custom_meta_id_idx)]
        live_keys = set(live)
        wm = self.version_watermark()
        return {
            "live": live,
            "dead": sorted((k for k, _v in ledger_items), key=repr),
            "live_versions": sorted(([k, v] for k, v in live_vmap.items()
                                     if v is not None and k in live_keys), key=repr),
            "dead_versions": sorted(([k, v] for k, v in ledger_items if v is not None),
                                    key=repr),
            "watermark": list(wm) if wm is not None else None,
        }

    # ------------------------------------------------------------ anti-entropy

    def replica_digest(self) -> dict:
        """Order-independent convergence digest: ``live_hash`` sums per-id
        hashes of every live id (buffered rows included), ``live_vhash``
        of every (id, live version), ``dead_hash`` of the deletion ledger.
        Engine-local counters stay out of it (converged replicas compact at
        different times) and form the cache key: the digest is cached until
        a mutation or a new layout moves (layout epoch, tombstone version,
        metadata length). The O(rows) hashing runs outside the locks, over
        the append-only metadata snapshot."""
        with self.buffer_lock, self.index_lock:
            key = (self._meta_epoch, self._tombstone_version, len(self.id_to_metadata))
            if self._digest_cache is not None and self._digest_cache[0] == key:
                return dict(self._digest_cache[1])
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            dead_rows = frozenset(self.tombstones.rows())
            ledger = self.tombstones.ledger()
            live_vmap = dict(self.tombstones.live_versions())
        live_sum, live_vsum, live_n = 0, 0, 0
        for _p, mid in _iter_live_ids(meta_arr, meta_n, dead_rows, self.cfg.custom_meta_id_idx):
            k = _id_match_key(mid)
            live_sum = (live_sum + _id_hash(k)) & _DIGEST_MASK
            live_vsum = (live_vsum + _id_hash((k, live_vmap.get(k)))) & _DIGEST_MASK
            live_n += 1
        dead_sum = 0
        for k in ledger:
            dead_sum = (dead_sum + _id_hash(k)) & _DIGEST_MASK
        digest = {
            "live_n": live_n,
            "live_hash": format(live_sum, "032x"),
            "live_vhash": format(live_vsum, "032x"),
            "dead_n": len(ledger),
            "dead_hash": format(dead_sum, "032x"),
        }
        with self.buffer_lock, self.index_lock:
            if key == (self._meta_epoch, self._tombstone_version, len(self.id_to_metadata)):
                self._digest_cache = (key, dict(digest))
        return digest

    def export_rows(self, ids) -> Tuple[np.ndarray, list]:
        """``(embeddings, metadata)`` of every live row whose id is in
        ``ids``: indexed rows reconstructed by the model (exact for raw
        storage, through the codec otherwise), buffered rows verbatim."""
        emb, metas, _vers = self._export_rows(ids)
        return emb, metas

    def export_rows_versioned(self, ids, with_hash: bool = False):
        """``export_rows`` plus each row's live write version (None where it
        was never written versioned), and with ``with_hash`` a sha256 of the
        chunk (``serialization.row_payload_hash``) that the puller checks
        before it applies any row."""
        emb, metas, vers = self._export_rows(ids)
        if not with_hash:
            return emb, metas, vers
        return emb, metas, vers, serialization.row_payload_hash(emb, metas, vers)

    def _export_rows(self, ids) -> Tuple[np.ndarray, list, list]:
        """One capture under both locks: positions must pair with the
        buffer they index into. A repair path, never a hot one."""
        want = {_id_match_key(i) for i in ids}
        id_idx = self.cfg.custom_meta_id_idx
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            indexed_n = self.model.ntotal if self.model is not None else 0
            dead_rows = frozenset(self.tombstones.rows())
            live_vmap = dict(self.tombstones.live_versions())
            positions, metas, vers = [], [], []
            for p, mid in _iter_live_ids(meta_arr, meta_n, dead_rows, id_idx):
                k = _id_match_key(mid)
                if k in want:
                    positions.append(p)
                    metas.append(meta_arr[p])
                    vers.append(live_vmap.get(k))
            dim = int(self.cfg.dim)
            # the buffer concatenate is paid only when a wanted row is in it
            need_buffer = any(p >= indexed_n for p in positions)
            flat_buf = (np.concatenate(self.embeddings_buffer, axis=0)
                        if need_buffer and self.embeddings_buffer
                        else np.zeros((0, dim), np.float32))
            out = np.zeros((len(positions), dim), np.float32)
            keep = np.ones(len(positions), bool)
            idxed = [(j, p) for j, p in enumerate(positions) if p < indexed_n]
            if idxed:
                rec = np.asarray(self.model.reconstruct_batch(
                    np.asarray([p for _j, p in idxed], np.int64)), np.float32)
                out[[j for j, _p in idxed]] = rec
            for j, p in enumerate(positions):
                if p < indexed_n:
                    continue
                off = p - indexed_n
                if off < flat_buf.shape[0]:
                    out[j] = flat_buf[off]
                else:  # metadata longer than index + buffer: skip the row
                    keep[j] = False
        if not keep.all():
            out = out[keep]
            metas = [m for j, m in enumerate(metas) if keep[j]]
            vers = [v for j, v in enumerate(vers) if keep[j]]
        return out, metas, vers

    def prune_ledger(self, min_watermark, min_age_s: float = 0.0) -> int:
        """Drop the deletion-ledger entries below ``min_watermark`` (the
        group's lowest replica watermark; the sweeper decides when it is
        safe) that are at least ``min_age_s`` old, and persist the smaller
        ledger through the sidecar writer. Returns the entries dropped."""
        cutoff = int(time.time() * 1000.0 - min_age_s * 1000.0) if min_age_s > 0 else None
        with self.buffer_lock, self.index_lock:
            pruned = self.tombstones.prune_ledger(min_watermark, max_wall_ms=cutoff)
            if not pruned:
                return 0
            self._mutation_counters["ledger_pruned"] += pruned
            self._digest_cache = None
            payload, sc_version = self._tombstone_payload_locked()
        self._write_tombstone_sidecar(payload, sc_version)
        return pruned

    def reconcile_deletes(self, dead_keys, dead_versions=None) -> int:
        """Apply a peer's deletion ledger. A versioned peer delete is
        LWW-gated: a local live write at a same-or-newer version wins. An
        unversioned one deletes (delete wins) unless the local row was
        written versioned. Every peer key is max-merged into the local
        ledger, durably, so a stale repair re-send is never pulled back.
        Returns the rows newly tombstoned."""
        keys = {_id_match_key(k) for k in dead_keys}
        if not keys:
            return 0
        vmap = {_id_match_key(k): _versions.version_key(v) for k, v in (dead_versions or ())}
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            dead_rows = frozenset(self.tombstones.rows())
            live_vmap = dict(self.tombstones.live_versions())
        raw_by_version, legacy_raw, gated = {}, [], 0
        for _p, mid in _iter_live_ids(meta_arr, meta_n, dead_rows, self.cfg.custom_meta_id_idx):
            k = _id_match_key(mid)
            if k not in keys:
                continue
            vd = vmap.get(k)
            if vd is None:
                if live_vmap.get(k) is not None:
                    gated += 1
                else:
                    legacy_raw.append(mid)
            else:
                raw_by_version.setdefault(vd, []).append(mid)
        removed = self.remove_ids(legacy_raw) if legacy_raw else 0
        # one versioned call per peer version: remove_ids re-gates under the
        # locks, so an upsert landing since the snapshot keeps its rows
        for vd, raws in sorted(raw_by_version.items()):
            removed += self.remove_ids(raws, version=vd)
        with self.buffer_lock, self.index_lock:
            if gated:
                self._mutation_counters["version_noop_deletes"] += gated
            changed = self.tombstones.ledger_update_versioned(
                (k, vmap.get(k)) for k in keys
                if not (live_vmap.get(k) is not None
                        and _versions.compare(live_vmap.get(k), vmap.get(k)) >= 0))
            for vk in vmap.values():
                self._observe_version_locked(vk)
            payload = None
            if changed:
                self._digest_cache = None
                payload, sc_version = self._tombstone_payload_locked()
        if payload is not None:
            self._write_tombstone_sidecar(payload, sc_version)
        return removed

    # ---------------------------------------------------------------- compaction

    def compact(self) -> bool:
        """Rewrite the tombstoned rows out of the index as a fresh MANIFEST
        generation, swapped in atomically; True when one committed.

        1. Under both locks: snapshot the state dict, row count and dead set.
        2. Without locks, serving on: filter the state to the survivors and
           build the new model on the engine's device.
        3. Under both locks again: abort if an add drained rows since (the
           watcher retries later); carry deletes that arrived meanwhile
           onto the new layout; commit the generation (rows, compacted
           metadata, buffer and the remapped tombstones with the new layout
           epoch); swap model, metadata and tombstones; bump the layout
           epoch so in-flight joins retry.

        A crash in 2 leaves orphan files (quarantined at load; the previous
        generation and its sidecar serve). A crash in 3 after the manifest
        landed loads the new generation, whose own payload has the catch-up
        set; the standalone sidecar, still of the old layout, is then
        re-applied by id."""
        storage_dir = self.cfg.index_storage_dir
        if not storage_dir:
            return False
        t0 = time.perf_counter()
        with self.buffer_lock, self.index_lock:
            if self.model is None or self.state != IndexState.TRAINED:
                return False
            n0 = int(self.model.ntotal)
            dead0 = np.asarray([p for p in self.tombstones.rows() if p < n0], np.int64)
            if dead0.size == 0:
                return False
            state = self.model.state_dict()

        delay = envutil.env_float("DFT_COMPACT_TEST_DELAY_S", 0.0)
        if delay:
            # chaos-test hook: widen the mid-rebuild window so a SIGKILL
            # gate can land inside an uncommitted rebuild, serving live
            time.sleep(delay)
        keep = np.ones(n0, bool)
        keep[dead0] = False
        try:
            new_state = _compaction.compact_state(state, keep)
        except _compaction.CompactionUnsupported as e:
            logger.info("compaction skipped: %s", e)
            return False
        new_model = index_from_state_dict(new_state, device=self.device)
        self._apply_runtime_knobs(new_model)
        new_n = int(keep.sum())
        old2new = np.full(n0, -1, np.int64)
        old2new[keep] = np.arange(new_n)

        with self.buffer_lock, self.index_lock:
            if (self.model is None or self.state != IndexState.TRAINED
                    or int(self.model.ntotal) != n0):
                self._mutation_counters["compactions_aborted"] += 1
                logger.info("compaction aborted: index changed mid-rebuild")
                return False
            meta = self.id_to_metadata.tolist()
            new_meta = [meta[p] for p in range(n0) if keep[p]] + meta[n0:]
            # deletes since the snapshot, remapped (buffered rows shift down)
            shift = new_n - n0
            carried = {}
            for p, mid in self.tombstones.items():
                if p >= n0:
                    carried[p + shift] = mid
                elif keep[p]:
                    carried[int(old2new[p])] = mid
            new_tomb = TombstoneSet(carried)
            # the ledger and both version planes are position-free and
            # survive the swap
            new_tomb.ledger_update_versioned(self.tombstones.ledger_items())
            new_tomb.live_versions_update(self.tombstones.live_versions())
            carried_indexed = [r for r in carried if r < new_n]
            if carried_indexed:
                new_model.remove_rows(np.asarray(carried_indexed, np.int64))
            disk_gens = serialization.list_generations(storage_dir)
            gen = max(self._generation, disk_gens[0][0] if disk_gens else 0) + 1
            new_tomb.layout = gen
            # claim the sidecar version before the commit writes the
            # remapped payload: a writer that snapshotted the old layout
            # skips afterwards
            self._tombstone_version += 1
            with self._tombstone_io_lock:
                self._tombstone_written = max(self._tombstone_written,
                                              self._tombstone_version)
            self._commit_generation(
                storage_dir, gen, new_state, new_meta, self.embeddings_buffer, self.cfg,
                extra={"ntotal": new_n, "layout": gen, "compacted": True},
                tombstones=new_tomb.to_payload(), io_lock=self._tombstone_io_lock,
                keep=self.versioning.retain_generations)
            _release_programs(self.model)
            self.model = new_model
            self.id_to_metadata = _MetaStore(new_meta)
            self.tombstones = new_tomb
            self._generation = gen
            self.index_saved_size = new_n
            self._saved_tombstone_version = self._tombstone_version
            self.index_save_time = time.time()
            self._meta_epoch += 1
            self._mutation_counters["compactions"] += 1
        dt = time.perf_counter() - t0
        self.perf.record("compaction_s", dt)
        logger.info("compacted %d tombstoned rows out (%d -> %d) into generation %d "
                    "in %.3fs", n0 - new_n, n0, new_n, gen, dt)
        return True

    def _run_compaction_watcher(self) -> None:
        t = threading.Thread(target=_compaction.run_watcher, args=(self, self.mutation_cfg),
                             name=f"compaction:{self._thread_tag()}", daemon=True)
        self._compaction_thread = t
        t.start()

    # ------------------------------------------------------------------ train

    def train(self) -> None:
        with self.index_lock:
            if self.state in (IndexState.TRAINING, IndexState.TRAINED, IndexState.ADD):
                return
            self.state = IndexState.TRAINING
        try:
            self._train_impl()
        except BaseException:
            # a failed (possibly async) training run must not wedge the
            # shard in TRAINING: reset so clients see NOT_TRAINED and retry
            with self.index_lock:
                if self.state == IndexState.TRAINING:
                    self.state = IndexState.NOT_TRAINED
            logger.exception("index training failed")
            raise

    def _train_impl(self) -> None:
        cfg = self.cfg
        with self.buffer_lock:
            if cfg.dim == 0 and self.embeddings_buffer:
                cfg.dim = int(self.embeddings_buffer[0].shape[1])
            if cfg.train_num > 0:
                train_num = cfg.train_num
            elif cfg.train_ratio >= 1.0:
                train_num = self.total_data
            else:
                train_num = int(cfg.train_ratio * self.total_data)
            all_data = (np.concatenate(self.embeddings_buffer, axis=0)
                        if self.embeddings_buffer else np.zeros((0, cfg.dim), np.float32))
        total_data_size = all_data.shape[0]
        train_num = min(train_num, total_data_size)
        # uniform sample over the whole buffer (the JAX package's fix of the
        # reference's first-rows slice)
        sel = np.random.default_rng(0).permutation(total_data_size)[:train_num]
        index = self._init_index(total_data_size)
        logger.info("training %s on %s vectors", type(index).__name__, (train_num, cfg.dim))
        index.train(all_data[sel])
        index.set_nprobe(cfg.nprobe)
        with self.index_lock:
            self.model = index
            self.state = IndexState.TRAINED
        self.add_buffer_to_index()

    def sync_train(self) -> None:
        self.train()

    def _init_index(self, total_data_size: int):
        cfg = self.cfg
        needs_centroids = cfg.index_builder_type in _IVF_BUILDERS or (
            cfg.faiss_factory and "IVF" in cfg.faiss_factory)
        if needs_centroids:
            cfg.centroids = int(cfg.centroids)
            if cfg.centroids == 0 or cfg.infer_centroids:
                cfg.centroids = infer_n_centroids(total_data_size)
                logger.info("inferred cfg.centroids=%d", cfg.centroids)
        index = build_index(cfg, self.device)
        self._apply_runtime_knobs(index)
        return index

    def _apply_runtime_knobs(self, index) -> None:
        """cfg.extra['stored_norms'] (default True): False recomputes
        ||x||^2 in the scan instead of reading the stored norms."""
        if index is not None and hasattr(index, "use_stored_norms"):
            index.use_stored_norms = bool(self.cfg.extra.get("stored_norms", True))

    # ------------------------------------------------------------------ add

    def add_buffer_to_index(self) -> None:
        add_to_index = False
        with self.index_lock:
            if self.state == IndexState.TRAINED:
                add_to_index = True
                self.state = IndexState.ADD
            else:
                logger.info("index add already in progress (state=%s)", self.state)
        if add_to_index:
            # async so the serving thread keeps answering while the device
            # runs assign + encode + append
            t = threading.Thread(target=self._add_buffer_to_idx,
                                 name=f"add:{self._thread_tag()}", daemon=True)
            self._add_thread = t
            t.start()

    def _add_buffer_to_idx(self) -> None:
        while True:
            bsz = self.cfg.buffer_bsz
            with self.buffer_lock:
                take, taken_rows = 0, 0
                for e in self.embeddings_buffer:
                    take += 1
                    taken_rows += e.shape[0]
                    if taken_rows >= bsz:
                        break
                chunks = self.embeddings_buffer[:take]
                self.embeddings_buffer = self.embeddings_buffer[take:]
                self.total_data -= taken_rows
            if taken_rows == 0:
                break
            add_data = np.concatenate(chunks, axis=0)
            start_time = time.time()
            with self.index_lock:
                if self.state != IndexState.ADD or self.model is None:
                    logger.info("add worker: index dropped mid-add, exiting")
                    return
                self.model.add(add_data)
                ntotal = self.model.ntotal
                # rows deleted while buffered are masked in the same lock
                # hold that adds them: no search window sees them live
                dead_new = self.tombstones.rows_in_range(ntotal - add_data.shape[0], ntotal)
                if dead_new:
                    # unreachable for kinds without a mask (remove_ids refuses
                    # them up front); a failure must not kill the drain worker
                    try:
                        self.model.remove_rows(np.asarray(dead_new, np.int64))
                    except Exception:
                        logger.exception("drain-time tombstone mask failed for rows %s: "
                                         "rows serve until compaction", dead_new)
            logger.info("added %d vectors in %.3fs (ntotal=%d)",
                        add_data.shape[0], time.time() - start_time, ntotal)
            self._maybe_save(ignore_time=False)
        with self.index_lock:
            if self.state == IndexState.ADD:  # don't stomp a concurrent drop
                self.state = IndexState.TRAINED
        # rows appended between the empty-buffer check and the state flip
        # would be stranded until the next add_batch: re-trigger the drain
        with self.buffer_lock:
            refilled = self.total_data > 0
        if refilled:
            self.add_buffer_to_index()

    # ------------------------------------------------------------------ query

    def _device_search(self, query_batch: np.ndarray, top_k: int):
        """The locked device launch: one in-flight search per index (the
        lock also serializes against add, list growth and the tombstone
        masks). A model with a ``launches`` counter (the mesh-sharded ones,
        parallel/mesh.py) gets it diffed around the call into
        ``device_launches`` (launches this window took: 1.0 on the masked
        mesh, a routed block and each relaunch in routed mode) and
        ``rows_per_launch``."""
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError(NOT_TRAINED_REJECTION_FMT.format(state=self.state))
            # the sampled trace of the scheduler's window, when a ring is wired
            trace_id = obs_spans.current_trace() if self.span_buffer is not None else None
            launches0 = getattr(self.model, "launches", None)
            w0 = time.time() if trace_id is not None else 0.0
            t0 = time.perf_counter()
            out = self.model.search_batched(query_batch, top_k)
            dt = time.perf_counter() - t0
            rows = int(query_batch.shape[0])
            self.perf.record("device_search_s", dt, exemplar=trace_id)
            self.perf.record("device_search_rows", float(rows))
            launches = None
            if launches0 is not None:
                launches = self.model.launches - launches0
                self.perf.record("device_launches", float(launches))
                if launches > 0:
                    self.perf.record("rows_per_launch", rows / launches)
            if trace_id is not None:
                # one launch serves the whole window: each sampled request
                # of it gets the span
                for tid in obs_spans.current_window_traces():
                    self.span_buffer.record(tid, "engine.launch", w0, dt, rows=rows,
                                            launches=launches)
            return out

    @staticmethod
    def _search_and_reconstruct(model, query_batch: np.ndarray, top_k: int):
        """(scores, ids, embeddings) from one model state; missing slots
        reconstruct as zeros."""
        scores, indexes = model.search(query_batch, top_k)
        flat = indexes.reshape(-1)
        if model.ntotal == 0:
            rec = np.zeros((flat.shape[0], query_batch.shape[1]), np.float32)
        else:
            with xfercheck.explicit("reconstruct embeddings fetch"):
                rec = np.array(model.reconstruct_batch(np.where(flat >= 0, flat, 0)))
            rec[flat < 0] = 0.0
        return scores, indexes, rec.reshape(indexes.shape + (query_batch.shape[1],))

    def _search_reconstruct(self, query_batch: np.ndarray, top_k: int):
        """Search + embedding reconstruction from one atomic index state."""
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError(NOT_TRAINED_REJECTION_FMT.format(state=self.state))
            return self._search_and_reconstruct(self.model, query_batch, top_k)

    def _run_and_join(self, run, return_embeddings: bool):
        """Launch + metadata join under the layout-epoch check: a compaction
        or drop between the launch and the join relaunches on the new
        layout instead of pairing old positional ids with new metadata."""
        for _ in range(8):
            with self.buffer_lock:
                epoch0 = self._meta_epoch
            # DFT_XFERCHECK=1: the launch-to-fetch span is a guarded section;
            # the device is read only inside the explicit() fetches below it
            with xfercheck.guarded("engine launch-to-fetch span"):
                scores, indexes, embs_arr = run()
            with self.buffer_lock:
                if self._meta_epoch != epoch0:
                    continue
                meta_arr, meta_n = self.id_to_metadata.snapshot()
            return self._join_results(scores, indexes, embs_arr, return_embeddings,
                                      meta_arr, meta_n)
        raise RuntimeError("metadata layout kept changing during search")

    def search(self, query_batch: np.ndarray, top_k: int = 100,
               return_embeddings: bool = False):
        """Search through the natural batcher: concurrent callers share
        device launches (the state is re-checked under the lock inside
        ``_device_search``)."""
        query_batch = np.asarray(query_batch, np.float32)
        if return_embeddings:
            run = lambda: self._search_reconstruct(query_batch, top_k)  # noqa: E731
        else:
            run = lambda: self._batcher.search(query_batch, top_k) + (None,)  # noqa: E731
        return self._run_and_join(run, return_embeddings)

    def search_batched(self, query_batch: np.ndarray, top_k: int = 100,
                       return_embeddings: bool = False):
        """The already-batched entry the serving scheduler calls with one
        coalesced window: the same locked launch and metadata join as
        ``search``, without the batcher in front (the scheduler has already
        coalesced its callers, from a single thread)."""
        query_batch = np.asarray(query_batch, np.float32)
        if return_embeddings:
            run = lambda: self._search_reconstruct(query_batch, top_k)  # noqa: E731
        else:
            run = lambda: self._device_search(query_batch, top_k) + (None,)  # noqa: E731
        return self._run_and_join(run, return_embeddings)

    # ------------------------------------------------- generation-pinned reads

    def current_generation(self) -> int:
        """Newest committed generation (0 = none): what a client pins."""
        with self.index_lock:
            return self._generation

    def search_at_generation(self, query_batch: np.ndarray, top_k: int = 100,
                             generation: int = 0, return_embeddings: bool = False):
        """Search a retained committed generation as it was committed: its
        indexed rows and its own tombstones, whatever changed since. The
        snapshot loads lazily on the engine's device, one cached at a time
        under its own lock; a pruned or unknown generation raises."""
        query_batch = np.asarray(query_batch, np.float32)
        gen = int(generation)
        with self._pinned_lock:
            cached = self._pinned_cache
            if cached is None or cached[0] != gen:
                if cached is not None:
                    _release_programs(cached[1][0])
                self._pinned_cache = cached = (gen, self._load_generation_snapshot(gen))
            snap, meta_arr, meta_n = cached[1]
            if return_embeddings:
                scores, indexes, embs_arr = self._search_and_reconstruct(
                    snap, query_batch, top_k)
            else:
                (scores, indexes), embs_arr = snap.search(query_batch, top_k), None
        return self._join_results(scores, indexes, embs_arr, return_embeddings,
                                  meta_arr, meta_n)

    def _load_generation_snapshot(self, gen: int):
        """One retained generation, read-only: (model with the generation's
        own tombstones masked, metadata array, length). A second resident
        copy of the shard."""
        storage_dir = self.cfg.index_storage_dir
        if not storage_dir:
            raise RuntimeError("generation-pinned reads need a persistent shard "
                               "(no index_storage_dir configured)")
        manifest = None
        for g, mpath in serialization.list_generations(storage_dir):
            if g == gen:
                manifest = serialization.load_manifest(mpath)
                break
        if manifest is None:
            raise RuntimeError(f"generation {gen} is not retained at {storage_dir} (pruned "
                               "or never committed; raise DFT_RETAIN_GENERATIONS to keep a "
                               "deeper point-in-time window)")

        def gen_path(key):
            return os.path.join(storage_dir, manifest["files"][key]["name"])

        snap = index_from_state_dict(load_state(gen_path("index")), device=self.device)
        with open(gen_path("meta"), "rb") as f:
            meta = pickle.load(f)[: snap.ntotal]
        tomb = TombstoneSet.from_payload(
            _tombstones.load_generation_payload(storage_dir, manifest))
        dead = [p for p in tomb.rows() if p < snap.ntotal]
        if dead:
            snap.remove_rows(np.asarray(dead, np.int64))
        meta_arr, meta_n = _MetaStore(meta).snapshot()
        logger.info("pinned generation %d of %s for point-in-time reads (%d rows, %d "
                    "tombstoned)", gen, storage_dir, snap.ntotal, len(dead))
        return snap, meta_arr, meta_n

    def _join_results(self, scores, indexes, embs_arr, return_embeddings, meta_arr, meta_n):
        valid = indexes != -1
        max_id = np.max(indexes, initial=-1)
        if max_id >= meta_n:
            raise IndexError(f"search returned id {max_id} >= metadata size {meta_n}")
        safe = np.where(valid, indexes, 0)
        joined = meta_arr.take(safe.ravel()).reshape(indexes.shape)
        joined[~valid] = None
        embs = None
        if return_embeddings:
            nq, k = indexes.shape
            embs = [[embs_arr[i, j] for j in range(k)] for i in range(nq)]
        return scores, joined.tolist(), embs

    def perf_stats(self, raw: bool = False) -> dict:
        """Device-launch latencies (``device_search_s``, host clock around
        the model call, which ends in the results' copy to the host) and
        rows a launch; ``raw`` adds the bucket histograms."""
        return self.perf.summary(raw=raw)

    def get_centroids(self):
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError("Server index is not trained")
            return self.model.get_centroids()

    def get_ids(self) -> set:
        """The ``cfg.custom_meta_id_idx`` field of every live indexed or
        buffered row's metadata. The store and the dead rows are
        snapshotted under both locks and the set is built outside them, so
        a long iteration does not stall concurrent adds (slots below the
        snapshotted length are never rewritten)."""
        id_idx = self.cfg.custom_meta_id_idx
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            dead = frozenset(self.tombstones.rows())
        return {meta[id_idx] for p, meta in enumerate(meta_arr[:meta_n].tolist())
                if meta and p not in dead}

    def set_nprobe(self, nprobe: int) -> None:
        self.cfg.nprobe = nprobe
        with self.index_lock:
            if self.model is not None:
                self.model.set_nprobe(nprobe)

    def get_state(self) -> IndexState:
        with self.index_lock:
            return self.state

    def upd_cfg(self, cfg: IndexCfg) -> None:
        self.cfg = cfg
        with self.index_lock:
            if self.model is not None:
                self.model.set_nprobe(cfg.nprobe)
                self._apply_runtime_knobs(self.model)

    # ------------------------------------------------------------------ persistence

    def save(self):
        state = self.get_state()
        if state == IndexState.TRAINED:
            return self._maybe_save(ignore_time=True)
        if state == IndexState.ADD:
            # the JAX engine's rule: save on completion of the in-flight add
            self.index_save_time = 0
            return None
        logger.info("index is not trained, skip saving")
        return False

    def retire(self) -> None:
        """Stop persistence and compaction for this engine (the server
        swapped it out) and join its workers, bounded: the watchers wake on
        the retired event and exit at once; a train or add worker still
        running past the timeout is harmless, since ``_maybe_save`` no-ops
        once retired."""
        self._retired.set()
        for t in (self._save_thread, self._compaction_thread, self._train_thread,
                  self._add_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=1.0)
        # the captured programs hold device memory (a search still in
        # flight on this engine captures anew)
        with self.index_lock:
            _release_programs(self.model)
        with self._pinned_lock:
            if self._pinned_cache is not None:
                _release_programs(self._pinned_cache[1][0])

    def _maybe_save(self, ignore_time: bool = False) -> bool:
        if self._retired.is_set():
            return False
        if not ignore_time:
            if self.cfg.save_interval_sec <= 0:
                return False
            if time.time() - self.index_save_time < self.cfg.save_interval_sec:
                return False
        with self.buffer_lock, self.index_lock:
            if self.model is None or (
                    self.model.ntotal == self.index_saved_size
                    and self._tombstone_version == self._saved_tombstone_version):
                return False
            storage_dir = self.cfg.index_storage_dir
            # never recycle a generation number already on disk
            disk_gens = serialization.list_generations(storage_dir)
            gen = max(self._generation, disk_gens[0][0] if disk_gens else 0) + 1
            self._commit_generation(
                storage_dir, gen, self.model.state_dict(), self.id_to_metadata.tolist(),
                self.embeddings_buffer, self.cfg,
                extra={"ntotal": int(self.model.ntotal), "layout": self.tombstones.layout},
                tombstones=self.tombstones.to_payload(), io_lock=self._tombstone_io_lock,
                keep=self.versioning.retain_generations)
            self._generation = gen
            self.index_saved_size = self.model.ntotal
            self._saved_tombstone_version = self._tombstone_version
            self.index_save_time = time.time()
            logger.info("saved index (%d vectors) to %s as generation %d",
                        self.index_saved_size, storage_dir, gen)
            return True

    def _run_save_watcher(self) -> None:
        def watch(idx: "Index"):
            # the retired event doubles as the sleep: retire() wakes the
            # watcher at once instead of leaking it one last interval
            while not idx._retired.wait(idx.cfg.save_interval_sec):
                idx._maybe_save(ignore_time=False)

        t = threading.Thread(target=watch, args=(self,), name=f"save:{self._thread_tag()}",
                             daemon=True)
        self._save_thread = t
        t.start()

    @staticmethod
    def _commit_generation(storage_dir: str, gen: int, state: dict, meta: list,
                           buffer: list, cfg: IndexCfg, extra: Optional[dict] = None,
                           tombstones: Optional[dict] = None, io_lock=None,
                           keep: int = 2) -> None:
        """The torn-snapshot commit protocol (the JAX engine's file set):
        every file of generation ``gen`` is written tmp+fsync+rename, and
        the generation becomes loadable only when its MANIFEST, with each
        file's sha256, lands last. ``tombstones`` is the payload committed
        with the generation (valid for its positions); after the manifest
        the standalone sidecar is rewritten from it, under ``io_lock`` (the
        per-mutation writer's lock), then the cfg.json convenience copy,
        and the dir is pruned to the newest ``keep`` (>= 2) generations."""
        os.makedirs(storage_dir, exist_ok=True)
        ts_payload = tombstones if tombstones is not None else TombstoneSet().to_payload()
        ts_text = _tombstones.dump_payload(ts_payload) + "\n"
        plan = {
            "index": ("npz", "wb", lambda f: save_state(f, state)),
            "meta": ("pkl", "wb", lambda f: pickle.dump(meta, f)),
            "buffer": ("pkl", "wb", lambda f: pickle.dump(buffer, f)),
            "cfg": ("json", "w", lambda f: f.write(cfg.to_json_string() + "\n")),
            "tombstones": ("json", "w", lambda f: f.write(ts_text)),
        }
        entries = {}
        for key, (ext, mode, write_fn) in plan.items():
            name = serialization.generation_filename(key, gen, ext)
            digest = atomic_write(os.path.join(storage_dir, name), write_fn, mode)
            entries[key] = {"name": name, "sha256": digest}
        serialization.write_manifest(storage_dir, gen, entries, extra=extra)
        if io_lock is not None:
            with io_lock:
                _tombstones.write_sidecar(storage_dir, ts_payload)
        else:
            _tombstones.write_sidecar(storage_dir, ts_payload)
        atomic_write(os.path.join(storage_dir, "cfg.json"),
                     lambda f: f.write(cfg.to_json_string() + "\n"), "w")
        serialization.prune_generations(storage_dir, keep=max(2, int(keep)))

    # ------------------------------------------------------------ shard transfer

    def export_snapshot(self) -> dict:
        """The shard-transfer unit: the model's state_dict, all metadata, the
        not-yet-indexed buffer, the cfg and the tombstone payload, captured
        under both locks at one point (what a committed save writes). It
        stalls this engine's serving for the capture, as a save does."""
        with self.buffer_lock, self.index_lock:
            state = self.model.state_dict() if self.model is not None else None
            return {
                "format": 1,
                "generation": self._generation,
                "state": state,
                "state_name": self.state.name,
                "ntotal": int(self.model.ntotal) if self.model is not None else 0,
                "meta": self.id_to_metadata.tolist(),
                "buffer": list(self.embeddings_buffer),
                "cfg_json": self.cfg.to_json_string(),
                # a replica joined from the snapshot must not resurrect a delete
                "tombstones": self.tombstones.to_payload(),
            }

    @classmethod
    def import_snapshot(cls, snapshot: dict, storage_dir: str, cfg: IndexCfg = None,
                        device="cuda") -> "Index":
        """Install a transferred shard (either package's ``export_snapshot``)
        on this rank. A trained snapshot is first committed to
        ``storage_dir`` as a generation of its own (the MANIFEST protocol),
        so a crash right after the transfer restarts from it; then the
        engine restores from it on ``device`` and replays the buffer through
        the add path. An untrained snapshot only replays its buffer."""
        if cfg is None:
            kwargs = json.loads(snapshot["cfg_json"])
            kwargs.update(kwargs.pop("extra", {}))
            cfg = IndexCfg(**kwargs)
        cfg.index_storage_dir = storage_dir
        meta = list(snapshot.get("meta") or [])
        buffer = [np.asarray(b, np.float32) for b in (snapshot.get("buffer") or [])]
        tomb = TombstoneSet.from_payload(snapshot.get("tombstones"))
        state = snapshot.get("state")
        if state is None:
            result = cls(cfg, device)
            result.tombstones = tomb
            # the rows are replayed next: their live versions are not stale
            result._seed_version_state(prune=False)
            offset = 0
            for chunk in buffer:
                n = chunk.shape[0]
                result.add_batch(chunk, meta[offset:offset + n])
                offset += n
            return result
        model = index_from_state_dict(state, device=device)
        disk_gens = serialization.list_generations(storage_dir)
        gen = max(int(snapshot.get("generation", 0)), disk_gens[0][0] if disk_gens else 0) + 1
        cls._commit_generation(
            storage_dir, gen, state, meta, buffer, cfg,
            extra={"ntotal": int(model.ntotal), "transferred": True, "layout": tomb.layout},
            tombstones=tomb.to_payload(), keep=VersioningCfg.from_env().retain_generations)
        logger.info("imported a transferred shard (%d vectors, %d buffered) into %s as "
                    "generation %d", model.ntotal, sum(b.shape[0] for b in buffer),
                    storage_dir, gen)
        result = cls._restore(cfg, model, meta, buffer, device, tombstones=tomb)
        result._generation = gen
        result.index_saved_size = model.ntotal
        return result

    @classmethod
    def from_storage_dir(cls, index_storage_dir: str, cfg: IndexCfg = None,
                         ignore_buffer: bool = True, device="cuda") -> Optional["Index"]:
        """Restore a shard from its newest complete generation. A generation
        whose files fail the sha256 check is quarantined and the previous
        one loads instead. The generation's own tombstones apply, and the
        standalone sidecar merges in positionally when its layout matches,
        by id otherwise. Without a committed generation the pre-manifest
        flat layout loads (``_from_legacy_layout``); None when neither
        exists."""
        stale = serialization.quarantine_stale_tmps(index_storage_dir)
        if stale:
            logger.warning("quarantined %d abandoned .tmp file(s): %s", len(stale), stale)
        chosen = None
        fallbacks = 0
        for gen, mpath in serialization.list_generations(index_storage_dir):
            try:
                manifest = serialization.load_manifest(mpath)
                errors = serialization.verify_manifest(index_storage_dir, manifest)
            except (OSError, ValueError) as e:
                errors = [f"unreadable manifest: {e}"]
            if not errors:
                chosen = (gen, manifest)
                break
            reason = "; ".join(errors)
            logger.warning("generation %d at %s is torn (%s): quarantining and "
                           "falling back", gen, index_storage_dir, reason)
            serialization.quarantine_generation(index_storage_dir, gen, reason)
            fallbacks += 1
        if chosen is None:
            return cls._from_legacy_layout(index_storage_dir, cfg, ignore_buffer, device)
        gen, manifest = chosen
        orphans = serialization.quarantine_orphans(index_storage_dir, newer_than=gen)
        if orphans:
            logger.warning("quarantined %d uncommitted newer file(s): %s", len(orphans), orphans)

        def gen_path(key):
            return os.path.join(index_storage_dir, manifest["files"][key]["name"])

        model = index_from_state_dict(load_state(gen_path("index")), device=device)
        with open(gen_path("meta"), "rb") as f:
            meta = pickle.load(f)
        if len(meta) < model.ntotal:
            raise RuntimeError(f"metadata ({len(meta)}) shorter than the index "
                               f"({model.ntotal}) in generation {gen}")
        buffer = []
        if not ignore_buffer:
            with open(gen_path("buffer"), "rb") as f:
                buffer = pickle.load(f)
        if cfg is None:
            cfg = IndexCfg.from_json(gen_path("cfg"))
        committed = _tombstones.load_generation_payload(index_storage_dir, manifest)
        tomb = TombstoneSet.from_payload(committed)
        side = _tombstones.load_sidecar(index_storage_dir)
        if side is not None:
            if int(side.get("layout", 0)) == tomb.layout:
                tomb.merge_payload(side)
            else:
                _apply_sidecar_by_id(tomb, side, meta, cfg.custom_meta_id_idx,
                                     index_storage_dir)
        result = cls._restore(cfg, model, meta, buffer, device, tombstones=tomb)
        result._generation = gen
        result.index_saved_size = model.ntotal
        if side is not None and side != committed:
            # mutations acknowledged after the commit: the next save commits them
            result._tombstone_version = 1
        result._mutation_counters["load_fallbacks"] = fallbacks
        return result

    @classmethod
    def _from_legacy_layout(cls, index_storage_dir: str, cfg: Optional[IndexCfg],
                            ignore_buffer: bool, device) -> Optional["Index"]:
        """A pre-manifest shard: flat index.npz / meta.pkl / buffer.pkl /
        cfg.json. Such a dir never compacted, so its layout epoch is 0 and a
        standalone tombstone sidecar at layout 0 applies as it is."""
        index_file, meta_file, buffer_file, cfg_file = get_index_files(index_storage_dir)
        if not os.path.exists(index_file):
            logger.info("no index found at %s", index_storage_dir)
            return None
        model = index_from_state_dict(load_state(index_file), device=device)
        if not os.path.exists(meta_file):
            raise RuntimeError(f"no meta file at {meta_file}: cannot use the index")
        with open(meta_file, "rb") as f:
            meta = pickle.load(f)
        if len(meta) < model.ntotal:
            raise RuntimeError(f"metadata ({len(meta)}) shorter than the index "
                               f"({model.ntotal}) at {index_storage_dir}")
        buffer = []
        if not ignore_buffer and os.path.exists(buffer_file):
            with open(buffer_file, "rb") as f:
                buffer = pickle.load(f)
        if cfg is None:
            cfg = IndexCfg.from_json(cfg_file) if os.path.isfile(cfg_file) else IndexCfg()
        tomb = None
        side = _tombstones.load_sidecar(index_storage_dir)
        if side is not None and int(side.get("layout", 0)) == 0:
            tomb = TombstoneSet.from_payload(side)
        return cls._restore(cfg, model, meta, buffer, device, tombstones=tomb)

    @classmethod
    def _restore(cls, cfg: IndexCfg, model, meta: list, buffer: list, device,
                 tombstones: Optional[TombstoneSet] = None) -> "Index":
        """Wire a loaded (model, meta, buffer) triple into a TRAINED engine,
        re-adding a consistent leftover buffer and truncating metadata
        otherwise. The recovered tombstones are masked on the device before
        the buffer replay starts, so a dead buffered row is masked when its
        chunk lands."""
        result = cls(cfg, device)
        result.model = model
        result.state = IndexState.TRAINED
        result.upd_cfg(cfg)
        if tombstones is not None:
            result.tombstones = tombstones
            dead_indexed = [p for p in tombstones.rows() if p < model.ntotal]
            if dead_indexed:
                model.remove_rows(np.asarray(dead_indexed, np.int64))
        buffer_size = sum(v.shape[0] for v in buffer)
        if len(meta) == model.ntotal + buffer_size:
            result.id_to_metadata = _MetaStore(meta)
            result.embeddings_buffer = buffer
            result.total_data = buffer_size
            if buffer_size > 0:
                result.add_buffer_to_index()
        else:
            if buffer_size:
                logger.warning("metadata size %d != index+buffer %d: ignoring buffer, "
                               "truncating meta", len(meta), model.ntotal + buffer_size)
            result.id_to_metadata = _MetaStore(meta[: model.ntotal])
        result._seed_version_state()
        return result

    def _seed_version_state(self, prune: bool = True) -> None:
        """After a restore: re-seed the per-writer watermarks from the
        recovered version planes, and (``prune``) drop live versions whose
        rows did not survive (a truncated buffer)."""
        with self.buffer_lock, self.index_lock:
            pairs = self.tombstones.ledger_items() + self.tombstones.live_versions()
            if not pairs:
                return
            for _k, v in pairs:
                self._observe_version_locked(_versions.version_key(v))
            live_pairs = self.tombstones.live_versions()
            if not prune or not live_pairs:
                return
            meta_arr, meta_n = self.id_to_metadata.snapshot()
            dead_rows = frozenset(self.tombstones.rows())
            live_keys = {_id_match_key(mid) for _p, mid in
                         _iter_live_ids(meta_arr, meta_n, dead_rows, self.cfg.custom_meta_id_idx)}
            for k, _v in live_pairs:
                if k not in live_keys:
                    self.tombstones.drop_live_version(k)
