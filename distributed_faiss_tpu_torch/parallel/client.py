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

Not ported yet: replication groups and repair, versioned writes and
read-your-writes (``min_version``), mutation ops, generation-pinned reads
and trace export.
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

from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.utils.config import IndexCfg
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
                 retry_policy: Optional[rpc.RetryPolicy] = None):
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
        self._lock = threading.Lock()  # guards cur_server_ids and reroutes
        self.reroutes: List[dict] = []
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
        batch goes to the next rank; an application error propagates."""
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
                self._call_with_retry(stub, "add_index_data",
                                      (index_id, embeddings, metadata, train_async_if_triggered))
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
            return
        raise RuntimeError(f"add_index_data for {index_id!r} failed on every rank") from last_exc

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
               deadline: Optional[float] = None) -> tuple:
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
        deadline."""
        if self.cfg is None:
            # without the metric the merge cannot be right (dot is negated)
            raise RuntimeError("IndexClient has no cfg for this index: pass cfg_path at "
                               "construction, or call create_index/load_index first")
        abs_deadline = None if deadline is None else time.time() + deadline
        maximize_metric = self.cfg.metric == "dot"

        def call_stub(stub, timeout=None):
            return self.retry.run_filtered(
                (rpc.BusyError,), abs_deadline, stub.generic_fun, "search",
                (index_id, query, topk, return_embeddings), None, timeout=timeout,
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
