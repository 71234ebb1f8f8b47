"""Cluster client: discovery, per-server stubs, fan-out, merge (counterpart
of distributed_faiss_tpu/parallel/client.py; reference
distributed_faiss/client.py:57-345).

Kept from the JAX package: the discovery-file wait with exponential
backoff (``count\\nhost,port`` lines, restarted ranks deduped), one
multiplexed RPC stub per server with a sized fan-out executor
(DFT_CLIENT_POOL), round-robin add placement that reroutes a batch past a
transport-dead rank, broadcast ops that retry per rank and raise a
``MultiRankError`` carrying every rank's outcome, the fan-out search with
the client-side top-k merge (``merge_result_blocks``: dot scores negated
before the min-merge and returned negated), partial-result search
(``allow_partial``: transport-dead ranks are skipped and listed), the
metadata-filtered search with over-fetch and requery
(``search_with_filter``), ``get_ids``, ``get_centroids``,
``add_buffer_to_index``, ``set_omp_num_threads`` and the cluster state
aggregation. Each rank is its own shard (one replica per group).

Mutation and versions: every add, upsert and delete call ticks the
client's hybrid logical clock once (DFT_VERSIONING, seeded per index from
the ranks' ``get_id_sets`` watermarks on first use) and carries that one
version to every rank; ``remove_ids`` goes to every rank, since
round-robin placement can put an id anywhere, and raises a
``MultiRankError`` naming the transport-dead ranks after every rank was
tried. ``search(read_your_writes=True)`` demands this client's last
acknowledged version (``min_version``) of every rank;
``pin_generations`` and ``search_at_generation`` serve each rank's pinned
committed generation.

Not ported yet: replication groups, quorums and the repair queue,
anti-entropy and trace export.
"""

import itertools
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.mutation import versions as _versions
from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.utils.config import IndexCfg, VersioningCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

logger = logging.getLogger()


def client_pool_size(num_indexes: int) -> int:
    """Fan-out worker budget: DFT_CLIENT_POOL overrides; the default
    budgets 8 concurrent full fan-outs (threads spawn lazily)."""
    raw = os.environ.get("DFT_CLIENT_POOL")
    if raw:
        return max(int(raw), num_indexes)
    return 8 * max(num_indexes, 1)


def parse_discovery_lines(lines) -> Tuple[Optional[int], List[Tuple[str, int]]]:
    """``(advertised_count, [(host, port), ...])`` of a discovery file. The
    count is None when line 0 is missing or garbled; entries dedupe on
    first occurrence (a restarted rank re-appends its line) and garbled
    lines are skipped (a half-written append must never crash a reader)."""
    count: Optional[int] = None
    entries: List[Tuple[str, int]] = []
    seen = set()
    for idx, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        if idx == 0:
            try:
                count = int(line)
            except ValueError:
                count = None
            continue
        try:
            host, port = line.split(",")[:2]
            entry = (host.strip(), int(port))
        except ValueError:
            continue
        if entry not in seen:
            seen.add(entry)
            entries.append(entry)
    return count, entries


def merge_result_blocks(blocks: List[np.ndarray], topk: int) -> Tuple[np.ndarray, np.ndarray]:
    """k-way min-merge of per-server (nq, k) score blocks. Returns (D (nq,
    topk) ascending, I (nq, topk) int64 indices into the horizontal
    concatenation of the blocks)."""
    all_d = np.concatenate(blocks, axis=1)
    if all_d.shape[1] > topk:
        part = np.argpartition(all_d, topk - 1, axis=1)[:, :topk]
        part_d = np.take_along_axis(all_d, part, axis=1)
        order = np.argsort(part_d, kind="stable", axis=1)
        ids = np.take_along_axis(part, order, axis=1)
    else:
        ids = np.argsort(all_d, kind="stable", axis=1)[:, :topk]
    return np.take_along_axis(all_d, ids, axis=1), ids.astype(np.int64)


class _FailedRank:
    """A rank that failed a partial fan-out call: its stub and error (cannot
    be mistaken for a server's (scores, meta, embs) tuple)."""

    __slots__ = ("stub", "error")

    def __init__(self, stub, error):
        self.stub, self.error = stub, error


class MultiRankError(RuntimeError):
    """A broadcast op failed on one or more ranks. ``outcomes`` holds one
    dict per rank: ``{"server", "host", "port", "ok", "result"|"error",
    "exception"}``."""

    def __init__(self, op: str, outcomes: List[dict]):
        self.op = op
        self.outcomes = outcomes
        failed = [o for o in outcomes if not o["ok"]]
        detail = "; ".join(f"rank {o['server']} ({o['host']}:{o['port']}): {o['error']}"
                           for o in failed)
        super().__init__(f"{op} failed on {len(failed)}/{len(outcomes)} ranks: {detail}")

    @property
    def failures(self) -> List[dict]:
        return [o for o in self.outcomes if not o["ok"]]

    @property
    def results(self) -> List[object]:
        return [o["result"] for o in self.outcomes if o["ok"]]


class IndexClient:
    """Handle to a cluster of index servers (one shard each)."""

    def __init__(self, server_list_path: str, cfg_path: Optional[str] = None,
                 retry_policy: Optional[rpc.RetryPolicy] = None,
                 versioning_cfg: Optional[VersioningCfg] = None):
        machine_ports = IndexClient.read_server_list(server_list_path)
        self.sub_indexes = IndexClient.setup_connection(machine_ports)
        self.num_indexes = len(self.sub_indexes)
        self.pool = ThreadPoolExecutor(max_workers=client_pool_size(self.num_indexes),
                                       thread_name_prefix="indexclient-fanout")
        self.retry = retry_policy if retry_policy is not None else rpc.RetryPolicy()
        # logical rank -> stub position (reference client.py:69-76)
        ranks = list(self.pool.map(lambda s: self._call_with_retry(s, "get_rank"),
                                   self.sub_indexes))
        self.index_rank_to_id = {r: i for i, r in enumerate(ranks)}
        self.cur_server_ids = {}
        self._rng = random.Random()  # private: placement never touches the global RNG
        # guards cur_server_ids, reroutes and the version bookkeeping
        self._lock = threading.Lock()
        self.reroutes: List[dict] = []
        # one clock per client stamps every mutation call; None when
        # versioning is off (the frames then carry no version)
        self.vcfg = versioning_cfg if versioning_cfg is not None else VersioningCfg.from_env()
        self._hlc = _versions.HLC() if self.vcfg.enabled else None
        self._seeded = set()  # index ids whose clock seed ran
        self._last_write_version = {}  # index id -> newest acked stamp
        self.cfg = IndexCfg.from_json(cfg_path) if cfg_path is not None else None

    # ------------------------------------------------------------ discovery

    @staticmethod
    def read_server_list(server_list_path: str, initial_timeout: float = 0.1,
                         backoff_factor: float = 1.5,
                         total_max_timeout: float = 7200) -> List[Tuple[str, int]]:
        """Wait with exponential backoff until the discovery file lists the
        advertised number of servers; a missing or empty file counts as
        "0 of N registered"."""
        time_waited = 0.0
        while True:
            try:
                with open(server_list_path) as f:
                    num_servers, res = parse_discovery_lines(f)
            except FileNotFoundError:
                num_servers, res = None, []
                msg = f"server list {server_list_path} not created yet."
            else:
                if num_servers is not None and len(res) >= num_servers:
                    if len(res) > num_servers:
                        logger.warning("server list %s advertises %d servers but has %d "
                                       "distinct entries; connecting to all of them",
                                       server_list_path, num_servers, len(res))
                    return res
                msg = (f"server list {server_list_path} is empty." if num_servers is None
                       else f"{num_servers} != {len(res)} in server list {server_list_path}.")
            if time_waited + initial_timeout >= total_max_timeout:
                raise RuntimeError(msg + f" Timed out after waiting {round(time_waited, 2)} seconds")
            logger.info("%s waiting %.2fs for servers to register...", msg, initial_timeout)
            time.sleep(initial_timeout)
            time_waited += initial_timeout
            initial_timeout *= backoff_factor

    @staticmethod
    def setup_connection(machine_ports) -> List[rpc.Client]:
        return [rpc.Client(i, host, port) for i, (host, port) in enumerate(machine_ports)]

    # ------------------------------------------------------- fault-tolerant fan-out

    def _call_with_retry(self, stub, fname: str, args=(), kwargs=None):
        """One rank's RPC under the retry policy (transport failures and BUSY
        only; an application error propagates at once)."""
        return self.retry.run(stub.generic_fun, fname, args, kwargs)

    def _broadcast(self, fname: str, args=(), kwargs=None) -> list:
        """Run ``fname`` on every rank with per-rank retry; every rank runs to
        an outcome, and any failure raises ``MultiRankError`` with all of
        them. Full success returns the results in stub order."""

        def one(stub):
            try:
                return True, self._call_with_retry(stub, fname, args, kwargs)
            except Exception as e:
                logger.warning("broadcast %s failed on rank %s (%s:%s): %s",
                               fname, stub.id, stub.host, stub.port, e)
                return False, e

        outcomes = []
        for stub, (ok, val) in zip(self.sub_indexes, self.pool.map(one, self.sub_indexes)):
            o = {"server": stub.id, "host": stub.host, "port": stub.port, "ok": ok}
            if ok:
                o["result"] = val
            else:
                o["error"] = f"{type(val).__name__}: {val}"
                o["exception"] = val
            outcomes.append(o)
        if not all(o["ok"] for o in outcomes):
            raise MultiRankError(fname, outcomes)
        return [o["result"] for o in outcomes]

    # ------------------------------------------------------------ lifecycle

    def create_index(self, index_id: str, cfg: Optional[IndexCfg] = None):
        if cfg is not None:
            self.cfg = cfg
        if self.cfg is None:
            self.cfg = IndexCfg()
        return self._broadcast("create_index", (index_id, self.cfg))

    def drop_index(self, index_id: str):
        self._broadcast("drop_index", (index_id,))

    def save_index(self, index_id: str):
        self._broadcast("save_index", (index_id,))

    def load_index(self, index_id: str, cfg: Optional[IndexCfg] = None,
                   force_reload: bool = True) -> bool:
        if force_reload:
            self._broadcast("drop_index", (index_id,))
        all_loaded = self._broadcast("load_index", (index_id, cfg))
        if cfg is None:
            config_paths = self._broadcast("get_config_path", (index_id,))
            if config_paths and os.path.isfile(config_paths[0]):
                cfg = IndexCfg.from_json(config_paths[0])
            else:
                cfg = IndexCfg()
        self.cfg = cfg
        if all(all_loaded):
            return True
        if any(all_loaded):
            logger.warning("some server nodes can't load index: %s", all_loaded)
        return False

    # ------------------------------------------------------------ ingest

    def add_index_data(self, index_id: str, embeddings: np.ndarray,
                       metadata: Optional[List[object]] = None,
                       train_async_if_triggered: bool = True) -> None:
        """Round-robin placement: the first target is random, then cyclic;
        each call lands on ONE server. A rank that stays transport-dead
        after retries is skipped (recorded in ``self.reroutes``) and the
        batch goes to the next rank; an application error propagates. The
        batch carries one version, stamped before placement, so a retry or
        reroute carries the same one."""
        version = self._stamp(index_id)
        n = self.num_indexes
        with self._lock:
            if index_id not in self.cur_server_ids:
                self.cur_server_ids[index_id] = self._rng.randint(0, n - 1)
            start = self.cur_server_ids[index_id] % n
        last_exc = None
        for offset in range(n):
            pos = (start + offset) % n
            stub = self.sub_indexes[pos]
            try:
                self._mutation_call(pos, "add_index_data",
                                    (index_id, embeddings, metadata, train_async_if_triggered),
                                    version)
            except rpc.TRANSPORT_ERRORS + (rpc.BusyError,) as e:
                logger.warning("add_index_data: rank %s (%s:%s) unreachable after retries, "
                               "rerouting batch: %s", stub.id, stub.host, stub.port, e)
                with self._lock:
                    self.reroutes.append({"index_id": index_id, "skipped_server": stub.id,
                                          "host": stub.host, "port": stub.port,
                                          "error": f"{type(e).__name__}: {e}"})
                last_exc = e
                continue
            with self._lock:
                self.cur_server_ids[index_id] = (pos + 1) % n
            self._note_write_acked(index_id, version)
            return
        raise RuntimeError(f"add_index_data for {index_id!r} failed on every rank") from last_exc

    # ------------------------------------------------------------ versions

    def _stamp(self, index_id: str):
        """One fresh version for a mutation call (None with versioning
        off). The first use per index seeds the clock from the ranks'
        watermarks. The stamp becomes the read-your-writes floor only once
        the write is acknowledged (``_note_write_acked``)."""
        if self._hlc is None:
            return None
        with self._lock:
            need_seed = index_id not in self._seeded
        if need_seed:
            self._seed_clock(index_id)
        return self._hlc.tick()

    def _note_write_acked(self, index_id: str, version) -> None:
        """Record an acknowledged stamp as the index's read-your-writes
        floor (monotone: fan-out threads may finish out of order)."""
        if version is None:
            return
        with self._lock:
            if _versions.compare(version, self._last_write_version.get(index_id)) > 0:
                self._last_write_version[index_id] = version

    def _seed_clock(self, index_id: str) -> None:
        """Observe every reachable rank's watermark (``get_id_sets``), so a
        client restarted on a machine whose clock went backward still
        stamps ahead of its earlier writes. A rank that answers with an
        error (no such index) has nothing to observe; when no rank answers
        at all the seed is retried on the next mutation."""

        def one(stub):
            try:
                return True, stub.generic_fun("get_id_sets", (index_id,), timeout=30.0)
            except rpc.ServerException:
                return True, None
            except rpc.TRANSPORT_ERRORS:
                return False, None

        answered = False
        for ok, sets in self.pool.map(one, self.sub_indexes):
            answered = answered or ok
            try:
                self._hlc.observe((sets or {}).get("watermark"))
            except (ValueError, TypeError):
                pass  # a garbled watermark
        if not answered:
            logger.warning("clock seed for %r reached no rank; retrying on the next "
                           "mutation", index_id)
            return
        with self._lock:
            self._seeded.add(index_id)

    def _mutation_call(self, pos: int, fname: str, args, version):
        """One rank's mutation RPC, ``version`` as a keyword unless None
        (versioning off: the frame is the unversioned one)."""
        kwargs = {"version": version} if version is not None else None
        return self._call_with_retry(self.sub_indexes[pos], fname, args, kwargs)

    def last_write_version(self, index_id: str):
        """The newest acknowledged version this client stamped onto
        ``index_id`` (None before any): what ``read_your_writes`` demands."""
        with self._lock:
            return self._last_write_version.get(index_id)

    # ------------------------------------------------------------ mutation

    def remove_ids(self, index_id: str, ids) -> int:
        """Delete by metadata id on every rank (round-robin placement puts
        an id anywhere); returns the rows tombstoned, summed. One version
        for the call. Every rank is tried; a rank that stays transport-dead
        makes the call raise ``MultiRankError`` afterwards, naming the
        ranks that missed the delete (it applied on the others; ids are
        safe to retry). An application error propagates at once."""
        ids = list(ids)
        if not ids:
            return 0
        version = self._stamp(index_id)

        def one(pos):
            try:
                return True, self._mutation_call(pos, "remove_ids", (index_id, ids), version)
            except rpc.TRANSPORT_ERRORS + (rpc.BusyError,) as e:
                return False, e

        outcomes = []
        for stub, (ok, val) in zip(self.sub_indexes,
                                   self.pool.map(one, range(self.num_indexes))):
            o = {"server": stub.id, "host": stub.host, "port": stub.port, "ok": ok}
            if ok:
                o["result"] = val
            else:
                o["error"] = f"{type(val).__name__}: {val}"
                o["exception"] = val
            outcomes.append(o)
        if not all(o["ok"] for o in outcomes):
            raise MultiRankError("remove_ids", outcomes)
        self._note_write_acked(index_id, version)
        return sum(int(o["result"]) for o in outcomes)

    def upsert(self, index_id: str, ids, embeddings: np.ndarray,
               metadata: Optional[List[object]] = None) -> int:
        """Delete + add: tombstone every live row of ``ids`` on every rank,
        then place the replacements through ``add_index_data``. The old
        rows stop serving before this returns, the new ones serve once
        their chunk drains; never both. Returns the rows tombstoned."""
        ids = list(ids)
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.shape[0] != len(ids):
            raise RuntimeError("upsert ids length should match the batch size of the embeddings")
        if metadata is None:
            if self.cfg is None:
                # without the cfg the id's position in the metadata is unknown
                raise RuntimeError("upsert without explicit metadata needs the client cfg "
                                   "(cfg_path) to know custom_meta_id_idx; pass metadata")
            if self.cfg.custom_meta_id_idx != 0:
                raise RuntimeError("upsert needs explicit metadata when custom_meta_id_idx != 0")
            metadata = [(i,) for i in ids]
        removed = self.remove_ids(index_id, ids)
        self.add_index_data(index_id, embeddings, metadata)
        return removed

    def compact_index(self, index_id: str) -> list:
        """A compaction pass on every rank now; the per-rank booleans."""
        return self._broadcast("compact_index", (index_id,))

    def sync_train(self, index_id: str) -> None:
        self._broadcast("sync_train", (index_id,))

    def async_train(self, index_id: str) -> None:
        self._broadcast("async_train", (index_id,))

    def add_buffer_to_index(self, index_id: str):
        self._broadcast("add_buffer_to_index", (index_id,))

    # ------------------------------------------------------------ query

    def search(self, query: np.ndarray, topk: int, index_id: str,
               return_embeddings: bool = False, allow_partial: bool = False,
               partial_timeout: Optional[float] = None,
               deadline: Optional[float] = None, min_version=None,
               read_your_writes: bool = False) -> tuple:
        """Fan-out search with the client-side top-k merge; returns (D, meta)
        or (D, meta, embs), plus a trailing ``missing`` list with
        ``allow_partial``.

        allow_partial=False: any rank's failure raises. allow_partial=True:
        a rank that is dead at the transport level (unreachable, connection
        lost, deadline expired) or still BUSY after the retry budget is
        skipped, top-k is served from the rest, and ``missing`` holds one
        {server, host, port, error} dict per skipped rank (empty: complete).
        An application error from a live rank (ServerException: index not
        loaded or trained, bad args) still raises, and so does a call on
        which every rank is dead. ``partial_timeout`` bounds each rank's
        call with a socket wait, so a hung rank degrades too; the stub
        redials on its next call.

        ``deadline`` (seconds of budget) rides every per-rank frame so an
        overloaded rank can shed the request before it reaches the device;
        BUSY rejections retry under the RetryPolicy backoff, never past the
        deadline.

        ``read_your_writes=True`` demands every rank reflect this client's
        last acknowledged versioned write: each per-rank call carries
        ``min_version`` (which may also be passed, e.g. handed over from
        another client), and a rank behind it answers with the stale-read
        error, which raises here (one rank per shard: nothing to fail over
        to)."""
        if read_your_writes:
            own = self.last_write_version(index_id)
            if min_version is None or _versions.compare(own, min_version) > 0:
                min_version = own
        search_kwargs = {"min_version": min_version} if min_version is not None else None
        if self.cfg is None:
            # without the metric the merge cannot be right (dot is negated)
            raise RuntimeError("IndexClient has no cfg for this index: pass cfg_path at "
                               "construction, or call create_index/load_index first")
        abs_deadline = None if deadline is None else time.time() + deadline
        maximize_metric = self.cfg.metric == "dot"

        def call_stub(stub, timeout=None):
            return self.retry.run_filtered(
                (rpc.BusyError,), abs_deadline, stub.generic_fun, "search",
                (index_id, query, topk, return_embeddings), search_kwargs, timeout=timeout,
                deadline=abs_deadline)

        if not allow_partial:
            results = self.pool.map(call_stub, self.sub_indexes)
            return IndexClient._aggregate_results(results, topk, query.shape[0],
                                                  maximize_metric, return_embeddings)

        def one_partial(stub):
            try:
                return call_stub(stub, timeout=partial_timeout)
            except rpc.TRANSPORT_ERRORS + (rpc.BusyError, rpc.DeadlineExceeded) as e:
                logger.warning("rank %s (%s:%s) unreachable during search, serving "
                               "without it: %s", stub.id, stub.host, stub.port, e)
                return _FailedRank(stub, e)

        raw = list(self.pool.map(one_partial, self.sub_indexes))
        ok = [r for r in raw if not isinstance(r, _FailedRank)]
        missing = [{"server": f.stub.id, "host": f.stub.host, "port": f.stub.port,
                    "error": f"{type(f.error).__name__}: {f.error}"}
                   for f in raw if isinstance(f, _FailedRank)]
        if not ok:
            raise RuntimeError(f"search failed on every rank: {[m['error'] for m in missing]}")
        merged = IndexClient._aggregate_results(iter(ok), topk, query.shape[0],
                                                maximize_metric, return_embeddings)
        return merged + (missing,)

    @staticmethod
    def _aggregate_results(results, topk: int, q_size: int, maximize_metric: bool,
                           return_embeddings: bool):
        """Merge per-server (scores, meta, embs) tuples (reference heap
        semantics, client.py:265-310): dot scores are negated before the
        min-merge and returned negated; metadata and embeddings join through
        the synthetic concat ids."""
        meta, embs, blocks = [], [], []
        for DI, MetaI, e in results:
            blocks.append(-DI if maximize_metric else DI)
            meta.extend(itertools.chain(*MetaI))
            if return_embeddings:
                embs.extend(itertools.chain(*e))
        D, ids = merge_result_blocks(blocks, topk)
        s, j = ids // topk, ids % topk
        i = np.arange(q_size, dtype=np.int64)[:, None]
        flat = (s * q_size * topk + i * topk + j).reshape(-1).tolist()

        def to_matrix(items):
            return [items[r:r + topk] for r in range(0, len(items), topk)]

        selected_meta = to_matrix([meta[f] for f in flat])
        if return_embeddings:
            return D, selected_meta, to_matrix([embs[f] for f in flat])
        return D, selected_meta

    def search_with_filter(self, query: np.ndarray, top_k: int, index_id: str,
                           filter_pos: int = -1, filter_value=None, max_requery: int = 2):
        """Metadata-filtered search with over-fetch (reference
        client.py:213-263): fetch 3*k, drop the rows whose
        ``meta[filter_pos] == filter_value``, keep the first k survivors.
        Returns (list of (n_kept, 1) score arrays, list of kept metadata).

        A query left short is searched again with a factor three times
        larger, up to ``max_requery`` times, and never past the whole index
        (``max_requery=0`` keeps the reference's short rows)."""
        filter_top_factor = 3
        if filter_pos < 0:
            return self.search(query, top_k, index_id)

        def filter_rows(scores, meta):
            out_scores, out_meta, short = [], [], []
            for i, meta_list in enumerate(meta):
                kept_meta, kept_scores = [], []
                for j, m in enumerate(meta_list):
                    if not m:
                        continue
                    if len(m) > filter_pos and m[filter_pos] != filter_value:
                        kept_meta.append(m)
                        kept_scores.append(scores[i, j])
                    if len(kept_meta) >= top_k:
                        break
                if len(kept_meta) < top_k:
                    short.append(i)
                out_meta.append(kept_meta)
                out_scores.append(np.asarray(kept_scores).reshape(-1, 1))
            return out_scores, out_meta, short

        factor = filter_top_factor
        scores, meta = self.search(query, factor * top_k, index_id)
        new_scores, new_meta, short_ids = filter_rows(scores, meta)

        ntotal = None
        for _ in range(max_requery):
            if not short_ids:
                break
            if ntotal is None:
                ntotal = self.get_ntotal(index_id)
            if factor * top_k >= ntotal:
                break  # already saw the whole index
            factor *= filter_top_factor
            requery = np.asarray(query)[short_ids]
            s2, m2 = self.search(requery, min(factor * top_k, ntotal), index_id)
            f_scores, f_meta, still_short = filter_rows(s2, m2)
            for pos, qi in enumerate(short_ids):
                new_scores[qi] = f_scores[pos]
                new_meta[qi] = f_meta[pos]
            short_ids = [short_ids[pos] for pos in still_short]
        if short_ids:
            logger.info("%d samples returned fewer than %d results after filtering",
                        len(short_ids), top_k)
        return new_scores, new_meta

    # ------------------------------------------------- generation-pinned reads

    def pin_generations(self, index_id: str) -> dict:
        """``{stub position: generation}``: each reachable rank's newest
        committed generation (ranks with none committed, or unreachable,
        are left out). Take it before a burst of mutations and pass it to
        ``search_at_generation`` after."""

        def one(stub):
            try:
                gen = self._call_with_retry(stub, "get_generation", (index_id,))
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException,):
                return None
            return int(gen) if gen else None

        return {pos: gen for pos, gen in enumerate(self.pool.map(one, self.sub_indexes))
                if gen is not None}

    def search_at_generation(self, query: np.ndarray, topk: int, index_id: str,
                             pins: Optional[dict] = None) -> tuple:
        """Point-in-time fan-out search: every rank serves the committed
        generation ``pins`` names for it (``pin_generations``; fetched now
        when None), whatever changed since. A rank without a pin, or one
        that no longer retains its pinned generation, raises. Merged like
        ``search``; returns ``(D, meta)``."""
        query = np.asarray(query, np.float32)
        if self.cfg is None:
            raise RuntimeError("IndexClient has no cfg for this index: pass cfg_path at "
                               "construction, or call create_index/load_index first")
        if pins is None:
            pins = self.pin_generations(index_id)
        missing = [pos for pos in range(self.num_indexes) if pos not in pins]
        if missing:
            raise RuntimeError(f"ranks at positions {missing} have no pinned committed "
                               f"generation for {index_id!r}")

        def one(pos):
            return self._call_with_retry(self.sub_indexes[pos], "search_at_generation",
                                         (index_id, query, topk, pins[pos]))

        results = self.pool.map(one, range(self.num_indexes))
        return IndexClient._aggregate_results(results, topk, query.shape[0],
                                              self.cfg.metric == "dot", False)

    # ------------------------------------------------------------ observability

    def get_state(self, index_id: str) -> IndexState:
        states = list(self.pool.map(
            lambda s: self._call_with_retry(s, "get_state", (index_id,)), self.sub_indexes))
        return IndexState.get_aggregated_states(states)

    def get_ntotal(self, index_id: str) -> int:
        return sum(self.pool.map(
            lambda s: self._call_with_retry(s, "get_ntotal", (index_id,)), self.sub_indexes))

    def get_buffer_depth(self, index_id: str) -> int:
        """Buffered, not-yet-indexed rows over the cluster (zero + TRAINED ==
        fully indexed)."""
        return sum(self.pool.map(
            lambda s: self._call_with_retry(s, "get_aggregated_ntotal", (index_id,)),
            self.sub_indexes))

    def get_ids(self, index_id: str) -> set:
        id_sets = self.pool.map(
            lambda s: self._call_with_retry(s, "get_ids", (index_id,)), self.sub_indexes)
        return set().union(*id_sets)

    def get_centroids(self, index_id: str) -> list:
        return list(self.pool.map(
            lambda s: self._call_with_retry(s, "get_centroids", (index_id,)),
            self.sub_indexes))

    def set_nprobe(self, index_id: str, nprobe: int):
        return self._broadcast("set_nprobe", (index_id, nprobe))

    def set_omp_num_threads(self, num_threads: int) -> None:
        self._broadcast("set_omp_num_threads", (num_threads,))

    def get_perf_stats(self) -> list:
        """Per-server latency summaries; each entry gains this client's view
        of the stub (``rpc.Client.rpc_stats``: wire encoding, whether the
        peer answered in binary, pipelining depth, wire round trips) under
        ``"rpc_client"``."""
        stats = self._broadcast("get_perf_stats")
        for stub, entry in zip(self.sub_indexes, stats):
            entry["rpc_client"] = stub.rpc_stats()
        return stats

    def ping(self, timeout: float = 10.0) -> list:
        """Health-check every server; dead or hung ones come back as error
        dicts instead of raising."""

        def one(stub):
            try:
                return stub.generic_fun("ping", (), {}, timeout=timeout)
            except Exception as e:
                return {"rank": None, "server": stub.id, "host": stub.host,
                        "port": stub.port, "error": f"{type(e).__name__}: {e}"}

        return list(self.pool.map(one, self.sub_indexes))

    def get_num_servers(self) -> int:
        return self.num_indexes

    def close(self):
        for stub in self.sub_indexes:
            stub.close()
        self.pool.shutdown(wait=False)
