"""Index server runtime: one process = one shard rank, many named indexes
(counterpart of distributed_faiss_tpu/parallel/server.py).

Multi-index registry guarded by a lock, storage path convention
``{storage_dir}/{index_id}/{rank}/``, and the single-rank RPC surface:
create/add/search/sync_train/async_train/add_buffer_to_index/get_state/
get_ntotal/get_aggregated_ntotal/get_ids/get_centroids/index_loaded/
set_nprobe/set_omp_num_threads/save/load/drop/ping (plus get_rank and
get_config_path, which the client's construction and load path use), and
the mutation ops: remove_ids/upsert/compact_index, ``version=`` on
add_index_data, a search's ``min_version`` (read-your-writes, checked
before the scheduler sees the request), get_generation/
search_at_generation (pinned reads, never through the scheduler) and
get_id_sets. Searches go through the ``SearchScheduler``; with
DFT_SCHEDULER=0 they are served through ``engine.Index.search`` and its
natural batcher.

Replication: the rank's shard group (``DFT_SHARD_GROUP``, or the
``set_shard_group`` op a client pushes), ``sync_shard_from`` (stream a live
replica's shard over a dedicated ``KIND_SHARD_FETCH`` connection, commit it
as a generation here and serve it), the delta-repair ops
(``export_rows``, ``export_rows_versioned``), ``get_health``, the
``KIND_DIGEST`` answer, and, given a discovery file, the anti-entropy
sweeper (parallel/antientropy.py), which also holds the group's compaction
lease that gates every engine's compaction watcher.

Two serving loops: thread-per-connection (``start_blocking``) and one
selector thread for every connection (``start``). Calls whose frame meta
carries a ``req_id`` are dispatched without blocking the reader — searches
to the scheduler's async completion path, everything else to a small worker
pool — and answered with tagged frames under a per-connection write lock;
frames without ``req_id`` (the serial client) are served in order on the
reader, and on the selector loop their searches flush at once
(``eager``: a one-in-flight peer sends no followers to wait for). A
connection whose client advertised binary skeletons (the ``wire`` CALL-meta
key, or a binary frame itself) gets its search responses in binary
(parallel/wire.py) unless DFT_RPC_WIRE=pickle; every other response stays
pickle.

Tracing (observability/): the rank's span ring (``spans``, bounded by
``TracingCfg.buffer``) receives the scheduler's ``server.queue`` and
``server.device`` spans, the engines' ``engine.launch`` spans and a
``server.write`` span after each traced response is sent; the
``get_trace_spans`` op reads it. ``get_perf_stats(raw=True)`` adds the
bucket histograms and exemplars, and with ``TracingCfg.metrics_port`` > 0
(DFT_METRICS_PORT) rank r serves it as Prometheus text on base + r.
"""

import logging
import os
import pathlib
import resource
import selectors
import socket
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.observability import export as obs_export
from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan, topk
from distributed_faiss_tpu_torch.parallel import antientropy, rpc, wire
from distributed_faiss_tpu_torch.serving.scheduler import (
    DeadlineExpired,
    SchedulerBusy,
    SchedulerStopped,
    SearchScheduler,
)
from distributed_faiss_tpu_torch.utils import envutil, lockdep
from distributed_faiss_tpu_torch.utils.config import (
    AntiEntropyCfg,
    IndexCfg,
    SchedulerCfg,
    TracingCfg,
    WireCfg,
)
from distributed_faiss_tpu_torch.utils.device import resolve_device
from distributed_faiss_tpu_torch.utils.state import IndexState
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

logger = logging.getLogger()

_SEARCH_ARGS = ("index_id", "query_batch", "top_k", "return_embeddings", "min_version")


def _search_args(args, kwargs) -> dict:
    """A search call's arguments by name; an unknown keyword is refused,
    not dropped."""
    vals = dict(zip(_SEARCH_ARGS, args))
    vals.update(kwargs or {})
    unknown = sorted(set(vals) - set(_SEARCH_ARGS))
    if unknown:
        raise TypeError(f"search() got an unexpected keyword argument {unknown[0]!r}")
    return vals


def rpc_worker_count() -> int:
    """Worker pool size for mux-dispatched non-search ops and response
    writes (DFT_RPC_WORKERS overrides)."""
    workers = envutil.env_int("DFT_RPC_WORKERS")
    if workers:
        return max(1, workers)
    return min(8, max(2, os.cpu_count() or 4))


def setup_server_logging(level=logging.INFO) -> None:
    """The server's root-logger format: '[thread] time [level] message'."""
    logging.basicConfig(level=level,
                        format="[%(threadName)s] %(asctime)s [%(levelname)s] %(message)s",
                        force=True)


class _ConnState:
    """One connection's serving state, shared by both loops: its peer's
    address, the response write lock, whether its client decodes binary
    skeletons (dies with the connection, like the client's half), and its
    buffered frame reader."""

    __slots__ = ("addr", "wlock", "peer_wire", "reader")

    def __init__(self, addr, reader: rpc.FrameReader):
        self.addr = addr
        self.wlock = lockdep.lock("IndexServer.conn_wlock")
        self.peer_wire = False
        self.reader = reader


class IndexServer:
    def __init__(self, rank: int, index_storage_dir: str,
                 scheduler_cfg: Optional[SchedulerCfg] = None, device="cuda",
                 wire_cfg: Optional[WireCfg] = None, discovery_path: Optional[str] = None,
                 antientropy_cfg: Optional[AntiEntropyCfg] = None,
                 tracing_cfg: Optional[TracingCfg] = None):
        self.device = resolve_device(device)
        self.indexes: Dict[str, Index] = {}
        self.indexes_lock = lockdep.lock("IndexServer.indexes_lock")
        # ids this rank dropped, so the sweeper never pulls one back from a
        # peer that missed the drop; a re-create, load or resync clears it
        self._dropped: set = set()
        # the replica group this rank serves: None until registered
        self.shard_group: Optional[int] = envutil.env_int("DFT_SHARD_GROUP")
        # the sweeper resolves its peers from the discovery file; without
        # one (or with DFT_ANTIENTROPY=0) the rank has none. It starts once
        # the socket is bound, so it can tell its own discovery entry.
        self.discovery_path = discovery_path
        self._antientropy_cfg = (antientropy_cfg if antientropy_cfg is not None
                                 else AntiEntropyCfg.from_env())
        self._antientropy: Optional[antientropy.AntiEntropySweeper] = None
        # the last shard this rank joined by transfer (sync_shard_from)
        self.last_transfer: Optional[dict] = None
        self.rank = rank
        self.index_storage_dir = index_storage_dir
        self.socket: Optional[socket.socket] = None
        self._stopping = threading.Event()
        self.perf = LatencyStats()  # per-RPC latency
        self._threads_lock = lockdep.lock("IndexServer._threads_lock")
        self._train_threads: List[threading.Thread] = []
        self._conns = set()  # live client connections, under _threads_lock
        # DFT_RPC_WIRE=pickle keeps every response byte-identical to the
        # pickle-only protocol
        wire_cfg = wire_cfg if wire_cfg is not None else WireCfg.from_env()
        self._wire_enabled = wire_cfg.encoding == "binary"
        # the span ring every serving stage of a sampled request records
        # into, and the optional metrics listener (started by bind())
        self.tracing_cfg = tracing_cfg if tracing_cfg is not None else TracingCfg.from_env()
        self.spans = obs_spans.SpanBuffer(capacity=self.tracing_cfg.buffer, rank=rank)
        self._metrics: Optional[obs_export.MetricsExporter] = None
        cfg = scheduler_cfg if scheduler_cfg is not None else SchedulerCfg.from_env()
        self.scheduler: Optional[SearchScheduler] = None
        if cfg.enabled:
            self.scheduler = SearchScheduler(self._engine_search_batched, cfg,
                                             name=f"search-batcher:r{rank}",
                                             span_buffer=self.spans)
        self._rpc_worker_count = rpc_worker_count()
        self._rpc_workers = ThreadPoolExecutor(max_workers=self._rpc_worker_count,
                                               thread_name_prefix=f"rpc-worker:r{rank}")
        # mux calls dispatched and not yet answered, and calls served by
        # dialect
        self._mux_lock = lockdep.lock("IndexServer._mux_lock")
        self._mux_inflight = 0
        self._mux_counters = {"mux_calls": 0, "legacy_calls": 0}

    # ------------------------------------------------------------ RPC surface

    def create_index(self, index_id: str, cfg: IndexCfg) -> bool:
        with self.indexes_lock:
            if index_id in self.indexes:
                return False
        storage = self._get_storage_dir(index_id, cfg)
        cfg.index_storage_dir = storage
        pathlib.Path(storage).mkdir(parents=True, exist_ok=True)
        index = Index(cfg, self.device)
        self._wire_engine(index)
        with self.indexes_lock:
            if index_id not in self.indexes:
                self.indexes[index_id] = index
                self._dropped.discard(index_id)
                logger.info("created index %s (storage %s)", index_id, storage)
                return True
        index.retire()
        return False

    def add_index_data(self, index_id: str, embeddings: np.ndarray, metadata=None,
                       train_async_if_triggered: bool = True, version=None) -> None:
        self._get_index(index_id).add_batch(embeddings, metadata, train_async_if_triggered,
                                            version=version)

    def search(self, index_id: str, query_batch: np.ndarray, top_k: int,
               return_embeddings: bool = False, min_version=None):
        index = self._get_index(index_id)
        if min_version is not None:
            # read-your-writes: refused before the device when this shard
            # has not incorporated the demanded version
            index.assert_min_version(min_version)
        return index.search(query_batch, top_k=top_k, return_embeddings=return_embeddings)

    def _checked_search_args(self, args, kwargs) -> dict:
        """A scheduled search's arguments, its ``min_version`` checked and
        taken off: the check needs no device and must not hold a window."""
        vals = _search_args(args, kwargs)
        min_version = vals.pop("min_version", None)
        if min_version is not None:
            self._get_index(vals["index_id"]).assert_min_version(min_version)
        return vals

    def _engine_search_batched(self, index_id: str, query_batch: np.ndarray, top_k: int,
                               return_embeddings: bool):
        """The scheduler's launch target (one coalesced window)."""
        return self._get_index(index_id).search_batched(
            query_batch, top_k=top_k, return_embeddings=return_embeddings)

    # ------------------------------------------------------------ mutation

    def remove_ids(self, index_id: str, ids, version=None) -> int:
        """Tombstone rows by metadata id: masked on the device at once and
        in the sidecar before the ack; ``version`` makes the delete
        LWW-gated (engine.remove_ids)."""
        return self._get_index(index_id).remove_ids(ids, version=version)

    def upsert(self, index_id: str, ids, embeddings, metadata=None, version=None) -> int:
        """Delete + add: the ids' old rows stop serving before the ack, the
        replacements serve once their chunk drains."""
        return self._get_index(index_id).upsert(ids, embeddings, metadata, version=version)

    def compact_index(self, index_id: str) -> bool:
        """A compaction pass now (the watcher runs one past
        DFT_COMPACT_THRESHOLD)."""
        return self._get_index(index_id).compact()

    def get_id_sets(self, index_id: str) -> dict:
        """Live ids, deletion ledger, version planes and the watermark a
        client's clock seeds from (engine.id_sets)."""
        return self._get_index(index_id).id_sets()

    def get_generation(self, index_id: str) -> int:
        """Newest committed generation of this rank's shard (0 = none)."""
        return self._get_index(index_id).current_generation()

    def search_at_generation(self, index_id: str, query_batch: np.ndarray, top_k: int,
                             generation: int, return_embeddings: bool = False):
        """Search a retained committed generation as it was committed
        (engine.search_at_generation). Not through the scheduler: pinned
        reads never share a window with live traffic."""
        return self._get_index(index_id).search_at_generation(
            query_batch, top_k=top_k, generation=generation,
            return_embeddings=return_embeddings)

    def sync_train(self, index_id: str) -> None:
        self._get_index(index_id).train()

    def async_train(self, index_id: str) -> None:
        index = self._get_index(index_id)
        t = threading.Thread(target=index.train, name=f"train:{index_id}:r{self.rank}",
                             daemon=True)
        with self._threads_lock:
            self._train_threads = [x for x in self._train_threads
                                   if x.ident is None or x.is_alive()]
            self._train_threads.append(t)
            t.start()  # inside the lock: stop() never joins an unstarted thread

    def add_buffer_to_index(self, index_id: str) -> None:
        return self._get_index(index_id).add_buffer_to_index()

    def get_state(self, index_id: str) -> IndexState:
        return self._get_index(index_id).get_state()

    def get_ids(self, index_id: str = "default") -> set:
        return self._get_index(index_id).get_ids()

    def get_centroids(self, index_id: str):
        return self._get_index(index_id).get_centroids()

    def index_loaded(self, index_id: str) -> bool:
        with self.indexes_lock:
            return (index_id in self.indexes
                    and self.indexes[index_id].get_state() == IndexState.TRAINED)

    def get_ntotal(self, index_id: str) -> int:
        with self.indexes_lock:
            index = self.indexes.get(index_id)
        return 0 if index is None else index.get_idx_data_num()[1]

    def get_aggregated_ntotal(self, index_id: str) -> int:
        """Buffered, not-yet-indexed rows (the reference's name for it)."""
        with self.indexes_lock:
            index = self.indexes.get(index_id)
        return 0 if index is None else index.get_idx_data_num()[0]

    def save_index(self, index_id: str) -> None:
        self._get_index(index_id).save()

    def load_index(self, index_id: str = "default", cfg: IndexCfg = None) -> bool:
        index_dir = self._get_storage_dir(index_id, cfg)
        if cfg:
            cfg.index_storage_dir = index_dir
        with self.indexes_lock:
            if index_id in self.indexes:
                if cfg:
                    self.indexes[index_id].upd_cfg(cfg)
                return True
        index = Index.from_storage_dir(index_dir, cfg, ignore_buffer=False, device=self.device)
        if index is None:
            return False
        self._wire_engine(index)
        with self.indexes_lock:
            self.indexes[index_id] = index
            self._dropped.discard(index_id)
        return True

    def drop_index(self, index_id: str) -> None:
        with self.indexes_lock:
            old = self.indexes.pop(index_id, None)
            # marked also when this rank never held the index: the drop may
            # arrive before a sync would have brought it
            self._dropped.add(index_id)
        if old is not None:
            old.retire()

    def set_nprobe(self, index_id: str, nprobe: int) -> None:
        return self._get_index(index_id).set_nprobe(nprobe)

    def get_rank(self) -> int:
        return self.rank

    # ------------------------------------------------------------ replicas

    def get_shard_group(self) -> Optional[int]:
        """The replica group this rank serves (None: unregistered)."""
        return self.shard_group

    def set_shard_group(self, group: Optional[int]) -> Optional[int]:
        """The registration op: a client (or an operator) assigns this
        rank's group. One reference write; readers tolerate a stale one."""
        self.shard_group = None if group is None else int(group)
        logger.info("rank %d registered shard_group=%s", self.rank, self.shard_group)
        return self.shard_group

    def sync_shard_from(self, index_id: str, host: str, port: int,
                        shard_group: Optional[int] = None) -> dict:
        """Online join: fetch a live replica's shard over a dedicated
        connection, commit it here as a generation, restore it on this
        rank's device, swap it into the registry (retiring any stale local
        engine, so it never autosaves over the new state) and register the
        group. Other calls are served throughout."""
        t0 = time.perf_counter()
        snapshot = rpc.fetch_shard(host, port, index_id)
        t_fetch = time.perf_counter() - t0
        array_bytes = _array_bytes(snapshot)
        index = Index.import_snapshot(snapshot, self._get_storage_dir(index_id, None),
                                      device=self.device)
        self._wire_engine(index)
        with self.indexes_lock:
            old = self.indexes.get(index_id)
            self.indexes[index_id] = index
            self._dropped.discard(index_id)
        if old is not None:
            old.retire()
        if shard_group is not None:
            self.set_shard_group(shard_group)
        buffered, ntotal = index.get_idx_data_num()
        dt = time.perf_counter() - t0
        self.perf.record("sync_shard_from", dt)
        logger.info("rank %d joined %s via shard transfer from %s:%d: %d rows, %d buffered, "
                    "%.1f MB of arrays, %.3f s (fetch %.3f s)", self.rank, index_id, host, port,
                    ntotal, buffered, array_bytes / 1e6, dt, t_fetch)
        out = {"rank": self.rank, "index_id": index_id, "ntotal": ntotal,
               "buffered": buffered, "generation": index.current_generation(),
               "shard_group": self.shard_group, "seconds": dt, "fetch_seconds": t_fetch,
               "array_bytes": array_bytes, "source": f"{host}:{port}"}
        self.last_transfer = out
        return out

    def export_rows(self, index_id: str, ids):
        """Delta repair's pull side: (embeddings, metadata) of live ids."""
        return self._get_index(index_id).export_rows(ids)

    def export_rows_versioned(self, index_id: str, ids, with_hash: bool = False):
        """(embeddings, metadata, versions), and the chunk's sha256 with
        ``with_hash``: the puller applies the rows through the LWW gates."""
        return self._get_index(index_id).export_rows_versioned(ids, with_hash=with_hash)

    def get_health(self) -> dict:
        """This rank's failure-detector view: suspect peers, per-peer
        failures and whether it holds its group's compaction lease. A
        suspect is tried last by a client's read walk, never removed."""
        if self._antientropy is None:
            return {"enabled": False, "rank": self.rank, "shard_group": self.shard_group,
                    "peers": {}, "suspects": [], "compaction": {"held": True}}
        return self._antientropy.health_snapshot()

    def _wire_engine(self, index: Index) -> None:
        """Give an engine this rank's span ring, and gate its compaction
        watcher on the group's lease (the sweeper re-asserts this each
        sweep)."""
        index.span_buffer = self.spans
        if self._antientropy is not None:
            index.compaction_gate = self._antientropy.may_compact

    def _start_antientropy(self) -> None:
        if (self._antientropy is not None or self.discovery_path is None
                or not self._antientropy_cfg.enabled):
            return
        # published before the accept loop admits a connection
        self._antientropy = antientropy.AntiEntropySweeper(
            self, self.discovery_path, self._antientropy_cfg)
        with self.indexes_lock:
            engines = list(self.indexes.values())
        for index in engines:
            self._wire_engine(index)
        self._antientropy.start()
        logger.info("anti-entropy sweeper started (rank %d, group %s, interval %.1fs)",
                    self.rank, self.shard_group, self._antientropy_cfg.interval_s)

    def _serve_digest(self, conn, state: "_ConnState", payload) -> None:
        """Answer one KIND_DIGEST with this rank's per-index digests and
        watermarks (a KIND_ERROR on failure), on the worker pool: a digest
        cache miss hashes O(rows). The contact is itself liveness evidence
        for this rank's failure detector."""
        t0 = time.perf_counter()
        try:
            req = payload if isinstance(payload, dict) else {}
            if self._antientropy is not None:
                self._antientropy.health.note_inbound(req.get("rank"), req.get("group"))
            want = req.get("want")
            with self.indexes_lock:
                snapshot = [(iid, idx) for iid, idx in self.indexes.items()
                            if want is None or iid in want]
            resp = {
                "rank": self.rank,
                "shard_group": self.shard_group,
                "digests": {iid: idx.replica_digest() for iid, idx in snapshot},
                # the peer min-merges these to prune the deletion ledgers
                "watermarks": {iid: idx.version_watermark() for iid, idx in snapshot},
                "compaction": {"held": (self._antientropy.may_compact()
                                        if self._antientropy is not None else True)},
            }
            parts = rpc.pack_frame(rpc.KIND_DIGEST_RESP, resp)
            self.perf.record("digest_exchange", time.perf_counter() - t0)
        except Exception:
            tb = traceback.format_exc()
            logger.error("digest exchange failed: %s", tb)
            parts = rpc.pack_frame(rpc.KIND_ERROR, tb)
        self._send_untagged(conn, state, parts, "digest")

    def _serve_shard_fetch(self, conn, state: "_ConnState", payload) -> None:
        """Answer one KIND_SHARD_FETCH with the engine's export_snapshot as a
        KIND_SHARD_DATA frame (a KIND_ERROR on failure), on the worker
        pool."""
        t0 = time.perf_counter()
        try:
            (index_id,) = tuple(payload)[:1]
            snapshot = self._get_index(index_id).export_snapshot()
            parts = rpc.pack_frame(rpc.KIND_SHARD_DATA, snapshot)
            self.perf.record("fetch_shard", time.perf_counter() - t0)
        except Exception:
            tb = traceback.format_exc()
            logger.error("shard fetch failed: %s", tb)
            parts = rpc.pack_frame(rpc.KIND_ERROR, tb)
        self._send_untagged(conn, state, parts, "shard transfer")

    def _send_untagged(self, conn, state: "_ConnState", parts, what: str) -> None:
        try:
            with state.wlock:
                rpc.send_parts(conn, parts)
        except OSError as e:
            logger.info("%s write failed (peer gone?): %s", what, e)

    def get_config_path(self, index_id: str) -> str:
        return os.path.join(self.index_storage_dir, index_id, str(self.rank), "cfg.json")

    def set_omp_num_threads(self, num_threads: int) -> None:
        # kept for the reference's API; host-side libraries read it
        os.environ["OMP_NUM_THREADS"] = str(num_threads)

    def get_perf_stats(self, raw: bool = False) -> dict:
        """Per-RPC latency summaries; ``"scheduler"`` its queue and batch
        distributions, ``"rpc"`` the mux calls in flight, the calls served
        by dialect (``mux_calls``, ``legacy_calls``), the worker pool's size
        and the wire encoding this rank is willing to speak (the use is per
        connection), ``"engine"`` each index's device-launch latencies,
        ``"mutation"`` each index's tombstone, compaction and version
        counters, ``"replication"`` this rank's group and ``"antientropy"``
        the sweeper's counters, suspects and lease, ``"process"`` this
        process's peak resident set, ``"tracing"`` the span ring's occupancy
        and the metrics listener's port (0 = off).

        ``raw=True`` adds each latency summary's bucket counts and
        exemplars (the Prometheus exporter's view); a row whose tail bucket
        holds a sampled trace carries ``p99_exemplar`` either way."""
        out = self.perf.summary(raw=raw)
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.perf_stats(raw=raw)
        with self._mux_lock:
            out["rpc"] = {"in_flight": self._mux_inflight, **self._mux_counters}
        out["rpc"]["workers"] = self._rpc_worker_count
        out["rpc"]["wire"] = "binary" if self._wire_enabled else "pickle"
        out["replication"] = {"rank": self.rank, "shard_group": self.shard_group,
                              "last_transfer": self.last_transfer}
        out["antientropy"] = (self._antientropy.stats() if self._antientropy is not None
                              else {"enabled": False})
        # ru_maxrss is in KiB on Linux
        out["process"] = {"peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}
        with self.indexes_lock:
            snapshot = list(self.indexes.items())
        out["engine"] = {iid: idx.perf_stats(raw=raw) for iid, idx in snapshot}
        out["mutation"] = {iid: idx.mutation_stats() for iid, idx in snapshot}
        # one read of the listener: stop() clears it concurrently
        metrics = self._metrics
        out["tracing"] = {**self.spans.stats(),
                          "metrics_port": metrics.port if metrics else 0}
        return out

    def get_trace_spans(self, trace_id: Optional[str] = None, limit: int = 4096) -> list:
        """This rank's spans of ``trace_id`` (every retained span when
        None), oldest first, the newest ``limit``."""
        spans = self.spans.snapshot(trace_id)
        return spans[-int(limit):] if limit else spans

    def ping(self) -> dict:
        """Liveness probe: this rank, its device, each index's state, and
        ``kernels``, each kernel wrapper's launches in this process since it
        started (0 on the CPU, where the wrappers run their plain
        versions). ``flat_list_scan_select`` counts the K1 launches that
        selected in-kernel (also in ``flat_list_scan``), ``topk_select``
        the merges of their candidates: an IVF-Flat search at k <= 256
        moves both, one past it neither."""
        with self.indexes_lock:
            snapshot = list(self.indexes.items())
        return {"rank": self.rank, "device": str(self.device),
                "indexes": {iid: idx.get_state().name for iid, idx in snapshot},
                "kernels": {"flat_list_scan": flat_scan.flat_list_scan.launches,
                            "flat_list_scan_select": flat_scan.flat_list_scan_select.launches,
                            "topk_select": topk.topk_select.launches,
                            "adc_scan": adc_scan.adc_scan.launches,
                            "adc_scan_nibble": adc_scan.adc_scan_nibble.launches,
                            "adc_scan_lists": adc_scan.adc_scan_lists.launches,
                            "adc_scan_shared": adc_scan.adc_scan_shared.launches}}

    def stop(self) -> None:
        logger.info("stopping server rank=%d", self.rank)
        self._stopping.set()
        # the metrics listener first: a scrape must not walk engines that
        # are being saved
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None
        # first the sweeper: a heal mid-stop would race the saves for the
        # engine locks (its dials are bounded, so the join is)
        if self._antientropy is not None:
            self._antientropy.stop()
        if self.socket is not None:
            try:
                self.socket.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.socket.close()
            self.socket = None
        if self.scheduler is not None:
            self.scheduler.stop()
        self._rpc_workers.shutdown(wait=False)
        with self._threads_lock:
            train_threads = list(self._train_threads)
            conns = list(self._conns)
        for conn in conns:
            # a stopped rank stops answering: its clients see a transport
            # error now, and a refused redial after
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in train_threads:
            t.join(timeout=30.0)
            if t.is_alive():
                logger.warning("training thread %s still running at stop", t.name)
        with self.indexes_lock:
            indexes = list(self.indexes.values())
        for index in indexes:
            index.save()
            index.retire()

    # ------------------------------------------------------------ serving loops

    def bind(self, port: int = rpc.DEFAULT_PORT, v6: bool = False) -> int:
        """Bind and listen, and start the metrics listener when configured;
        returns the bound port (pass 0 for a free one)."""
        s = socket.socket(socket.AF_INET6 if v6 else socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        s.listen(16)
        self.socket = s
        self._start_metrics()
        return s.getsockname()[1]

    def _start_metrics(self) -> None:
        """The Prometheus listener on base + rank (``TracingCfg.
        metrics_port``; 0 = none). A bind failure only logs: metrics never
        take serving down."""
        base = self.tracing_cfg.metrics_port
        if self._metrics is not None or base <= 0:
            return
        try:
            self._metrics = obs_export.MetricsExporter(
                lambda: self.get_perf_stats(raw=True), port=base + self.rank,
                rank=self.rank).start()
            logger.info("metrics listener rank=%d on :%d", self.rank, self._metrics.port)
        # OverflowError: base + rank past 65535
        except (OSError, OverflowError) as e:
            logger.warning("metrics listener for rank %d failed to bind port %d: %s",
                           self.rank, base + self.rank, e)

    def _listening_socket(self, port: int, v6: bool, load_index: bool) -> socket.socket:
        if load_index:
            self.load_index()
        if self.socket is None:
            self.bind(port, v6)
        self._start_antientropy()
        return self.socket

    def _admit(self, conn: socket.socket) -> bool:
        """Set up an accepted connection and track it for stop(); False
        (closed) once stopping."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rpc.bound_send_timeout(conn)
        with self._threads_lock:
            if self._stopping.is_set():
                conn.close()
                return False
            self._conns.add(conn)
        return True

    def _drop(self, conn: socket.socket) -> None:
        with self._threads_lock:
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def start_blocking(self, port: int = rpc.DEFAULT_PORT, v6: bool = False,
                       load_index: bool = False) -> None:
        """Thread-per-connection accept loop (binds first unless ``bind``
        already ran)."""
        s = self._listening_socket(port, v6, load_index)
        logger.info("server rank=%d listening on :%d", self.rank, s.getsockname()[1])
        while not self._stopping.is_set():
            try:
                conn, addr = s.accept()
            except OSError:
                break
            if not self._admit(conn):
                break
            # lifetime is the connection's: exits when the peer closes
            threading.Thread(target=self._serve_connection, args=(conn, addr),
                             name=f"conn:r{self.rank}:{addr[0]}:{addr[1]}",
                             daemon=True).start()

    def start(self, port: int = rpc.DEFAULT_PORT, v6: bool = False) -> None:
        """Selector loop: one thread accepts and decodes every connection.
        A readable connection is read one whole frame at a time; tagged
        calls are dispatched to the scheduler and the worker pool without
        blocking, untagged ones are served inline with an eager flush, and
        frames already buffered in the connection's reader are served before
        the next ``select`` (buffered bytes never make a socket readable)."""
        s = self._listening_socket(port, v6, load_index=False)
        s.setblocking(True)
        sel = selectors.DefaultSelector()
        sel.register(s, selectors.EVENT_READ, data=None)
        logger.info("selector server rank=%d on :%d", self.rank, s.getsockname()[1])
        try:
            while not self._stopping.is_set():
                try:
                    events = sel.select(timeout=0.5)
                except OSError:
                    break
                for key, _ in events:
                    if key.data is None:
                        try:
                            conn, addr = s.accept()
                        except OSError:
                            continue
                        if self._admit(conn):
                            sel.register(conn, selectors.EVENT_READ,
                                         data=_ConnState(addr, rpc.FrameReader(conn)))
                        continue
                    conn, state = key.fileobj, key.data
                    try:
                        self._one_call(conn, state, eager=True)
                        while state.reader.pending:
                            self._one_call(conn, state, eager=True)
                    except (rpc.ClientExit, EOFError, OSError):
                        sel.unregister(conn)
                        self._drop(conn)
                    except Exception as e:
                        # malformed frame / undecodable payload: drop this
                        # connection only
                        logger.warning("dropping connection from %s: %s", state.addr, e)
                        sel.unregister(conn)
                        self._drop(conn)
        finally:
            for key in list(sel.get_map().values()):
                if key.data is not None:
                    self._drop(key.fileobj)
            sel.close()

    def _serve_connection(self, conn: socket.socket, addr) -> None:
        state = _ConnState(addr, rpc.FrameReader(conn))
        try:
            while True:
                self._one_call(conn, state)
        except (rpc.ClientExit, EOFError):
            pass
        except OSError as e:
            logger.info("socket error from %s: %s", addr, e)
        except Exception as e:
            # malformed frame / undecodable payload: drop this connection only
            logger.warning("dropping connection from %s: %s", addr, e)
        finally:
            self._drop(conn)

    def _one_call(self, conn, state: _ConnState, eager: bool = False) -> None:
        kind, payload, was_binary = state.reader.recv_frame_ex()
        if kind == rpc.KIND_CLOSE:
            raise rpc.ClientExit("client closed")
        if kind == rpc.KIND_SHARD_FETCH:
            # the bulk export and send must not occupy the reader
            self._rpc_workers.submit(self._serve_shard_fetch, conn, state, payload)
            return
        if kind == rpc.KIND_DIGEST:
            self._rpc_workers.submit(self._serve_digest, conn, state, payload)
            return
        if kind != rpc.KIND_CALL:
            raise RuntimeError(f"unexpected frame kind {kind}")
        fname, args, kwargs = payload[:3]
        frame_meta = payload[3] if len(payload) > 3 else None
        deadline = req_id = trace_id = None
        if isinstance(frame_meta, dict):
            if frame_meta.get("deadline_s") is not None:
                deadline = time.monotonic() + float(frame_meta["deadline_s"])
            req_id = frame_meta.get("req_id")
            trace_id = frame_meta.get(obs_spans.TRACE_META_KEY)
            if was_binary or frame_meta.get(rpc.WIRE_META_KEY):
                # the client decodes binary skeletons: search responses on
                # this connection may go out binary from here on
                state.peer_wire = True
        if fname.startswith("_") or not callable(getattr(self, fname, None)):
            fname = f"unknown:{fname}"
        t0 = time.perf_counter()
        if req_id is None:
            with self._mux_lock:
                self._mux_counters["legacy_calls"] += 1
            kind, payload = self._call(fname, args, kwargs, deadline, t0, eager, trace_id)
            try:
                parts = rpc.pack_frame(kind, payload)
            except Exception:
                parts = rpc.pack_frame(rpc.KIND_ERROR, traceback.format_exc())
            self._write(conn, state, parts, fname, trace_id)
            return
        with self._mux_lock:
            self._mux_counters["mux_calls"] += 1
            self._mux_inflight += 1
        if fname == "search" and self.scheduler is not None:
            self._dispatch_scheduled(conn, state, args, kwargs, deadline, req_id, t0, trace_id)
            return
        try:
            self._rpc_workers.submit(self._dispatch_direct, conn, state, fname, args,
                                     kwargs, deadline, req_id, t0, trace_id)
        except RuntimeError:  # the pool is shut down: the server is stopping
            self._mux_done()
            raise

    def _mux_done(self) -> None:
        with self._mux_lock:
            self._mux_inflight -= 1

    def _write(self, conn, state: _ConnState, parts, fname, trace_id, **extra) -> None:
        """Send one response frame under the connection's write lock; a
        traced one records its ``server.write`` span after the send."""
        if trace_id is None:
            with state.wlock:
                rpc.send_parts(conn, parts)
            return
        w0, p0 = time.time(), time.perf_counter()
        with state.wlock:
            rpc.send_parts(conn, parts)
        self.spans.record(trace_id, "server.write", w0, time.perf_counter() - p0,
                          fname=fname, **extra)

    def _call(self, fname, args, kwargs, deadline, t0, eager=False, trace_id=None):
        """Serve one call on this thread -> (response kind, payload)."""
        try:
            if fname.startswith("unknown:"):
                raise AttributeError(f"IndexServer has no RPC op {fname[8:]!r}")
            if fname == "search" and self.scheduler is not None:
                vals = self._checked_search_args(args, kwargs)
                ret = self.scheduler.submit(
                    vals["index_id"], vals["query_batch"], vals["top_k"],
                    bool(vals.get("return_embeddings", False)), deadline=deadline,
                    eager=eager, trace_id=trace_id)
            else:
                ret = getattr(self, fname)(*args, **(kwargs or {}))
            self.perf.record(fname, time.perf_counter() - t0, exemplar=trace_id)
            return rpc.KIND_RESULT, ret
        except Exception as e:
            busy = self._classify_scheduler_reject(e)
            if busy is not None:
                self.perf.record(busy[0], time.perf_counter() - t0)
                return rpc.KIND_BUSY, busy[1]
            tb = traceback.format_exc()
            logger.error("exception in %s: %s", fname, tb)
            return rpc.KIND_ERROR, tb

    @staticmethod
    def _classify_scheduler_reject(error):
        """Scheduler admission/shed error -> (perf name, BUSY payload), or None."""
        if isinstance(error, SchedulerBusy):
            return "search:busy", {"reason": "queue_full", "queue_depth": error.queue_depth,
                                   "max_queue": error.max_queue}
        if isinstance(error, SchedulerStopped):
            return "search:busy", {"reason": "stopping"}
        if isinstance(error, DeadlineExpired):
            return "search:shed", {"reason": "deadline"}
        return None

    def _dispatch_scheduled(self, conn, state, args, kwargs, deadline, req_id, t0,
                            trace_id=None) -> None:
        """Hand a mux search to the scheduler without blocking the reader;
        its completion callback queues the tagged response write on the
        worker pool (never socket I/O on the batcher thread)."""

        def done(result, error):
            try:
                self._rpc_workers.submit(self._finish_scheduled, conn, state, req_id,
                                         result, error, t0, trace_id)
            except RuntimeError:
                # the pool is shut down (server stopping): the client sees
                # the drop
                self._mux_done()

        try:
            vals = self._checked_search_args(args, kwargs)
            self.scheduler.submit_async(
                vals["index_id"], vals["query_batch"], vals["top_k"],
                bool(vals.get("return_embeddings", False)), deadline=deadline,
                callback=done, trace_id=trace_id)
        except Exception as e:
            # admission rejected or bad args: answered now, never queued
            self._finish_scheduled(conn, state, req_id, None, e, t0, trace_id)

    def _finish_scheduled(self, conn, state, req_id, result, error, t0, trace_id=None) -> None:
        if error is None:
            self.perf.record("search", time.perf_counter() - t0, exemplar=trace_id)
            self._send_tagged(conn, state, rpc.KIND_RESULT, result, req_id, "search", trace_id)
            return
        busy = self._classify_scheduler_reject(error)
        if busy is not None:
            self.perf.record(busy[0], time.perf_counter() - t0)
            self._send_tagged(conn, state, rpc.KIND_BUSY, busy[1], req_id, "search", trace_id)
            return
        tb = "".join(traceback.format_exception(type(error), error, error.__traceback__))
        logger.error("exception in scheduled search: %s", tb)
        self._send_tagged(conn, state, rpc.KIND_ERROR, tb, req_id, "search", trace_id)

    def _dispatch_direct(self, conn, state, fname, args, kwargs, deadline, req_id, t0,
                         trace_id=None):
        """Worker-pool target for mux ops other than scheduled searches."""
        kind, payload = self._call(fname, args, kwargs, deadline, t0, trace_id=trace_id)
        self._send_tagged(conn, state, kind, payload, req_id, fname, trace_id)

    def _pack_tagged(self, state, base_kind, payload, req_id, fname):
        """A tagged response's frame parts: a binary skeleton when the
        connection negotiated it and the op is in the binary search family,
        pickle otherwise (also for a payload the binary schema cannot
        carry: the per-frame fallback)."""
        if self._wire_enabled and state.peer_wire and fname in wire.BINARY_CALL_OPS:
            parts = rpc.pack_binary_response(base_kind, payload, req_id)
            if parts is not None:
                return parts
        return rpc.pack_tagged_response(base_kind, payload, req_id)

    def _send_tagged(self, conn, state, base_kind, payload, req_id, fname,
                     trace_id=None) -> None:
        """Write one tagged response; the one end of every mux call, so the
        in-flight count drops here."""
        try:
            try:
                parts = self._pack_tagged(state, base_kind, payload, req_id, fname)
            except Exception:
                parts = rpc.pack_tagged_response(rpc.KIND_ERROR, traceback.format_exc(),
                                                 req_id)
            self._write(conn, state, parts, fname, trace_id, req_id=req_id)
        except OSError as e:
            logger.info("mux response write failed (req=%s): %s", req_id, e)
            try:
                # a partial frame may be on the stream: wake the reader so
                # the connection is dropped
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        finally:
            self._mux_done()

    # ------------------------------------------------------------ internals

    def _get_index(self, index_id: str) -> Index:
        with self.indexes_lock:
            if index_id not in self.indexes:
                raise RuntimeError(f"Server has no index with id={index_id}")
            return self.indexes[index_id]

    def _get_storage_dir(self, index_id: str, cfg: Optional[IndexCfg]) -> str:
        base = cfg.index_storage_dir if cfg and cfg.index_storage_dir else None
        if not base:
            return os.path.join(self.index_storage_dir, index_id, str(self.rank))
        return os.path.join(base, str(self.rank))


def _array_bytes(obj) -> int:
    """Bytes of the ndarrays in a (nested) snapshot: the bulk of a shard
    transfer, beside its pickled metadata."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_array_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_array_bytes(v) for v in obj if isinstance(v, (np.ndarray, dict)))
    return 0


def main(argv=None):
    """Run one index server rank: python -m distributed_faiss_tpu_torch.parallel.server"""
    import argparse

    parser = argparse.ArgumentParser(description="run one index server rank")
    parser.add_argument("--port", default=rpc.DEFAULT_PORT, type=int)
    parser.add_argument("--rank", default=0, type=int)
    parser.add_argument("--storage-dir", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--load-index", action="store_true")
    parser.add_argument("--discovery", default=None,
                        help="discovery file; enables the anti-entropy sweeper (its peers)")
    args = parser.parse_args(argv)
    setup_server_logging()
    server = IndexServer(args.rank, args.storage_dir, device=args.device,
                         discovery_path=args.discovery)
    server.start_blocking(args.port, load_index=args.load_index)


if __name__ == "__main__":
    main()
