"""Per-(server, index_id) shard engine: buffer, state machine, async
train/add, persistence (counterpart of distributed_faiss_tpu/engine.py,
core only).

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

Not ported yet: mutation (remove/upsert, tombstones, compaction), per-id
versions, replica digests, shard transfer and generation-pinned reads. A
storage dir whose tombstone set is not empty is refused with a clear
error, because serving it without the deletes would resurrect deleted
rows.
"""

import json
import logging
import os
import pickle
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.models.factory import build_index, index_from_state_dict
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.batching import SearchBatcher
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.device import resolve_device
from distributed_faiss_tpu_torch.utils.serialization import atomic_write, load_state, save_state
from distributed_faiss_tpu_torch.utils.state import NOT_TRAINED_REJECTION_FMT, IndexState
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

logger = logging.getLogger()

_IVF_BUILDERS = ("ivf_simple", "knnlm", "ivfsq", "ivf_tpu")

# the standalone tombstone sidecar and the empty payload a generation
# commits with it (the JAX package's mutation/tombstones.py format 2)
TOMBSTONE_SIDECAR = "tombstones.json"
EMPTY_TOMBSTONES = {"format": 2, "layout": 0, "dead_rows": [], "dead_ids": [],
                    "dead_ledger": [], "dead_versions": [], "live_versions": []}


def _dump_tombstones(payload: dict) -> str:
    return json.dumps(payload, default=str, sort_keys=True)


def _refuse_tombstones(payload: Optional[dict], where: str) -> None:
    if payload and (payload.get("dead_rows") or payload.get("dead_ledger")):
        raise RuntimeError(
            f"{where} holds a nonempty tombstone set "
            f"({len(payload.get('dead_rows') or [])} dead rows): deletes are "
            "not yet ported to distributed_faiss_tpu_torch, and serving this "
            "shard without them would resurrect deleted rows")


class _MetaStore:
    """Growable object-ndarray metadata store. Append-only: ``snapshot``
    hands out (array, length) that is safe to read outside the lock,
    because slots below the snapshotted length are never rewritten."""

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


def infer_n_centroids(total_data_size: int) -> int:
    """Centroid-count tiers (reference index.py:497-508)."""
    if total_data_size < 10e5:
        return int(2 * (total_data_size ** 0.5))
    if total_data_size < 10e6:
        return 65536
    if total_data_size < 10e7:
        return 262144
    return 1048576


class Index:
    def __init__(self, cfg: IndexCfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embeddings_buffer: List[np.ndarray] = []
        self.total_data = 0
        self.id_to_metadata = _MetaStore()
        self.buffer_lock = threading.Lock()
        self.index_lock = threading.Lock()
        self.state = IndexState.NOT_TRAINED
        self.model = None  # models.base.TorchIndex once trained
        # set when a server replaces this engine (drop_index): no further saves
        self._retired = threading.Event()
        self._train_thread: Optional[threading.Thread] = None
        self._add_thread: Optional[threading.Thread] = None
        self._save_thread: Optional[threading.Thread] = None
        self.index_save_time = time.time()
        self.index_saved_size = 0
        self.perf = LatencyStats()  # device-search latency, served via get_perf_stats
        self._generation = 0  # newest committed snapshot generation
        # bumped under both locks whenever the positional layout is replaced
        # (drop_index): a search that launched on the old layout re-joins
        self._meta_epoch = 0
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
            self.model = None
            self.state = IndexState.NOT_TRAINED

    def add_batch(self, embeddings: np.ndarray, metadata: Optional[List[object]],
                  train_async_if_triggered: bool = True, version=None) -> None:
        if version is not None:
            raise RuntimeError("versioned writes are not yet ported to "
                               "distributed_faiss_tpu_torch")
        n = embeddings.shape[0]
        if not metadata:
            metadata = [None] * n
        if n != len(metadata):
            raise RuntimeError("metadata length should match the batch size of the embeddings")
        embeddings = np.asarray(embeddings, np.float32)
        with self.buffer_lock:
            self.embeddings_buffer.append(embeddings)
            self.id_to_metadata.extend(metadata)
            self.total_data += n
            total_data = self.total_data

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

    def _thread_tag(self) -> str:
        return os.path.basename(self.cfg.index_storage_dir or "") or f"mem-{id(self):x}"

    def get_idx_data_num(self) -> Tuple[int, int]:
        with self.buffer_lock:
            buf_total = self.total_data
        with self.index_lock:
            index_total = self.model.ntotal if self.model is not None else 0
        return buf_total, index_total

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
        lock also serializes against add and list growth)."""
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError(NOT_TRAINED_REJECTION_FMT.format(state=self.state))
            t0 = time.perf_counter()
            out = self.model.search_batched(query_batch, top_k)
            self.perf.record("device_search_s", time.perf_counter() - t0)
            self.perf.record("device_search_rows", float(query_batch.shape[0]))
            return out

    def _search_reconstruct(self, query_batch: np.ndarray, top_k: int):
        """Search + embedding reconstruction from one atomic index state."""
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError(NOT_TRAINED_REJECTION_FMT.format(state=self.state))
            scores, indexes = self.model.search(query_batch, top_k)
            flat = indexes.reshape(-1)
            if self.model.ntotal == 0:
                rec = np.zeros((flat.shape[0], query_batch.shape[1]), np.float32)
            else:
                rec = np.array(self.model.reconstruct_batch(np.where(flat >= 0, flat, 0)))
                rec[flat < 0] = 0.0
        return scores, indexes, rec.reshape(indexes.shape + (query_batch.shape[1],))

    def _run_and_join(self, run, return_embeddings: bool):
        """Launch + metadata join under the layout-epoch check: a drop
        between the launch and the join relaunches on the new layout instead
        of pairing old positional ids with new metadata."""
        for _ in range(8):
            with self.buffer_lock:
                epoch0 = self._meta_epoch
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

    def perf_stats(self) -> dict:
        return self.perf.summary()

    def get_centroids(self):
        with self.index_lock:
            if self.state != IndexState.TRAINED:
                raise RuntimeError("Server index is not trained")
            return self.model.get_centroids()

    def get_ids(self) -> set:
        """The ``cfg.custom_meta_id_idx`` field of every indexed or buffered
        row's metadata. The store is snapshotted under both locks and the
        set is built outside them, so a long iteration does not stall
        concurrent adds (slots below the snapshotted length are never
        rewritten). Deletes are not ported, so no row is dead."""
        id_idx = self.cfg.custom_meta_id_idx
        with self.buffer_lock, self.index_lock:
            meta_arr, meta_n = self.id_to_metadata.snapshot()
        return {meta[id_idx] for meta in meta_arr[:meta_n].tolist() if meta}

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
        """Stop persistence for this engine (the server swapped it out) and
        join its workers, bounded: the save watcher wakes on the retired
        event and exits at once; a train or add worker still running past
        the timeout is harmless, since ``_maybe_save`` no-ops once
        retired."""
        self._retired.set()
        for t in (self._save_thread, self._train_thread, self._add_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=1.0)

    def _maybe_save(self, ignore_time: bool = False) -> bool:
        if self._retired.is_set():
            return False
        if not ignore_time:
            if self.cfg.save_interval_sec <= 0:
                return False
            if time.time() - self.index_save_time < self.cfg.save_interval_sec:
                return False
        with self.buffer_lock, self.index_lock:
            if self.model is None or self.model.ntotal == self.index_saved_size:
                return False
            storage_dir = self.cfg.index_storage_dir
            # never recycle a generation number already on disk
            disk_gens = serialization.list_generations(storage_dir)
            gen = max(self._generation, disk_gens[0][0] if disk_gens else 0) + 1
            self._commit_generation(
                storage_dir, gen, self.model.state_dict(), self.id_to_metadata.tolist(),
                self.embeddings_buffer, self.cfg,
                extra={"ntotal": int(self.model.ntotal), "layout": 0})
            self._generation = gen
            self.index_saved_size = self.model.ntotal
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
                           keep: int = 2) -> None:
        """The torn-snapshot commit protocol (the JAX engine's file set):
        every file of generation ``gen`` is written tmp+fsync+rename, and
        the generation becomes loadable only when its MANIFEST — with each
        file's sha256 — lands last. Then the standalone tombstone sidecar
        and the cfg.json convenience copy are refreshed and the dir is
        pruned to the newest ``keep`` (>= 2) generations."""
        os.makedirs(storage_dir, exist_ok=True)
        plan = {
            "index": ("npz", "wb", lambda f: save_state(f, state)),
            "meta": ("pkl", "wb", lambda f: pickle.dump(meta, f)),
            "buffer": ("pkl", "wb", lambda f: pickle.dump(buffer, f)),
            "cfg": ("json", "w", lambda f: f.write(cfg.to_json_string() + "\n")),
            "tombstones": ("json", "w",
                           lambda f: f.write(_dump_tombstones(EMPTY_TOMBSTONES) + "\n")),
        }
        entries = {}
        for key, (ext, mode, write_fn) in plan.items():
            name = serialization.generation_filename(key, gen, ext)
            digest = atomic_write(os.path.join(storage_dir, name), write_fn, mode)
            entries[key] = {"name": name, "sha256": digest}
        serialization.write_manifest(storage_dir, gen, entries, extra=extra)
        atomic_write(os.path.join(storage_dir, TOMBSTONE_SIDECAR),
                     lambda f: f.write(_dump_tombstones(EMPTY_TOMBSTONES) + "\n"), "w")
        atomic_write(os.path.join(storage_dir, "cfg.json"),
                     lambda f: f.write(cfg.to_json_string() + "\n"), "w")
        serialization.prune_generations(storage_dir, keep=max(2, int(keep)))

    @classmethod
    def from_storage_dir(cls, index_storage_dir: str, cfg: IndexCfg = None,
                         ignore_buffer: bool = True, device="cuda") -> Optional["Index"]:
        """Restore a shard from its newest complete generation. A generation
        whose files fail the sha256 check is quarantined and the previous
        one loads instead. Returns None when no committed generation exists
        (the JAX package's pre-manifest flat layout is not ported)."""
        stale = serialization.quarantine_stale_tmps(index_storage_dir)
        if stale:
            logger.warning("quarantined %d abandoned .tmp file(s): %s", len(stale), stale)
        chosen = None
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
        if chosen is None:
            logger.info("no committed generation at %s", index_storage_dir)
            return None
        gen, manifest = chosen
        orphans = serialization.quarantine_orphans(index_storage_dir, newer_than=gen)
        if orphans:
            logger.warning("quarantined %d uncommitted newer file(s): %s", len(orphans), orphans)

        def gen_path(key):
            return os.path.join(index_storage_dir, manifest["files"][key]["name"])

        if "tombstones" in manifest["files"]:
            with open(gen_path("tombstones")) as f:
                _refuse_tombstones(json.load(f), f"generation {gen} at {index_storage_dir}")
        sidecar = os.path.join(index_storage_dir, TOMBSTONE_SIDECAR)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                _refuse_tombstones(json.load(f), sidecar)
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
        result = cls._restore(cfg, model, meta, buffer, device)
        result._generation = gen
        result.index_saved_size = model.ntotal
        return result

    @classmethod
    def _restore(cls, cfg: IndexCfg, model, meta: list, buffer: list, device) -> "Index":
        """Wire a loaded (model, meta, buffer) triple into a TRAINED engine,
        re-adding a consistent leftover buffer and truncating metadata
        otherwise."""
        result = cls(cfg, device)
        result.model = model
        result.state = IndexState.TRAINED
        result.upd_cfg(cfg)
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
        return result
