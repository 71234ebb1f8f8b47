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
aggregation.

Replication (parallel/replication.py, ``ReplicationCfg``): the ranks form
replica GROUPS of R in discovery order (a rank's registered group wins),
one logical shard each. A write fans out to every replica of the placed
group and is acknowledged at the write quorum (default a majority); the
replicas that missed an acknowledged write are recorded in a bounded
repair queue (``repair_under_replicated``), and a batch whose whole group
is transport-dead is rerouted to the next group. A read goes to ONE
replica per group and fails over to the next on a transport error, a
drain refusal or a stale-read refusal, so one dead rank costs neither rows
nor availability and the merge sees one block per shard. R = 1 (the
default) is one group per rank: reroute past a dead rank, and a search
that raises on it.

Mutation and versions: every add, upsert and delete call ticks the
client's hybrid logical clock once (DFT_VERSIONING, seeded per index from
the replicas' ``get_id_sets`` watermarks on first use) and carries that
one version to every replica; ``remove_ids`` goes to every replica of
every group, since placement can put an id anywhere, is acknowledged per
group at the quorum and raises a ``QuorumError`` (a ``MultiRankError``
with every replica's outcome) when a group missed it.
``search(read_your_writes=True)`` demands this client's last acknowledged
version (``min_version``); ``pin_generations`` and
``search_at_generation`` serve each replica's pinned committed generation.

Tracing (observability/): a search samples a trace (DFT_TRACE_SAMPLE) or
takes one (``trace_id=``), records its ``client.search`` span and a
``client.failover`` span for each replica it moved past, and sends the id
to every rank it calls; ``get_trace_spans`` merges this process's spans
with every reachable rank's. ``get_perf_stats`` answers a dead rank with an
error row and the survivors' stats.
"""

import itertools
import logging
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.mutation import versions as _versions
from distributed_faiss_tpu_torch.observability import spans as obs_spans
from distributed_faiss_tpu_torch.parallel import replication, rpc
from distributed_faiss_tpu_torch.utils import envutil, lockdep
from distributed_faiss_tpu_torch.utils.atomics import AtomicCounters
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg, VersioningCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

logger = logging.getLogger()

# the ring of recent reroute records; the totals live in ``counters``
REROUTE_LOG_LEN = 256


def client_pool_size(num_indexes: int) -> int:
    """Fan-out worker budget: DFT_CLIENT_POOL overrides; the default
    budgets 8 concurrent full fan-outs (threads spawn lazily)."""
    pool = envutil.env_int("DFT_CLIENT_POOL")
    if pool:
        return max(pool, num_indexes)
    return 8 * max(num_indexes, 1)


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


def _outcome(stub, ok: bool, val) -> dict:
    o = {"server": stub.id, "host": stub.host, "port": stub.port, "ok": ok}
    if ok:
        o["result"] = val
    else:
        o["error"] = f"{type(val).__name__}: {val}"
        o["exception"] = val
    return o


class QuorumError(MultiRankError):
    """A replicated write reached fewer replicas of a group than the write
    quorum. It is not acknowledged (callers may retry it), and the replicas
    that missed it are in the repair queue. ``acked`` are that group's
    positions that applied it, ``needed`` the quorum; ``outcomes`` (the
    ``MultiRankError`` view) hold every replica the call tried."""

    def __init__(self, op: str, index_id: str, group: int, acked: List[int], needed: int,
                 outcomes: List[dict]):
        self.op = op
        self.index_id = index_id
        self.group = group
        self.acked = list(acked)
        self.needed = needed
        self.outcomes = outcomes
        RuntimeError.__init__(
            self, f"{op}: write quorum missed for {index_id!r} group {group}: "
                  f"{len(self.acked)}/{needed} acks (failed replicas: "
                  f"{[o['server'] for o in self.failures]})")


class IndexClient:
    """Handle to a cluster of index servers: one logical shard per replica
    group."""

    def __init__(self, server_list_path: str, cfg_path: Optional[str] = None,
                 retry_policy: Optional[rpc.RetryPolicy] = None,
                 versioning_cfg: Optional[VersioningCfg] = None,
                 replication_cfg: Optional[ReplicationCfg] = None):
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
        # guards cur_server_ids, the reroute ring, the read pins, the
        # suspects and the version bookkeeping
        self._lock = lockdep.lock("IndexClient._stats_lock")
        self.reroutes = deque(maxlen=REROUTE_LOG_LEN)
        self.counters = AtomicCounters(
            ("reroutes", "failovers", "under_replicated", "quorum_failures"))
        self.rcfg = replication_cfg if replication_cfg is not None else ReplicationCfg.from_env()
        eff_r = min(self.rcfg.replication, max(self.num_indexes, 1))
        self.quorum = replication.quorum_size(eff_r, min(self.rcfg.write_quorum, eff_r))
        self.repair_queue = replication.RepairQueue(self.rcfg.repair_queue_len)
        # group -> the replica position the read path tries first (the last
        # one that answered)
        self._preferred = {}
        # positions the servers' failure detectors call suspect
        # (refresh_health): tried last by the read walk, never removed
        self._suspects = set()
        self.membership = self._build_membership()
        self._register_groups()
        # one clock per client stamps every mutation call; None when
        # versioning is off (the frames then carry no version)
        self.vcfg = versioning_cfg if versioning_cfg is not None else VersioningCfg.from_env()
        self._hlc = _versions.HLC() if self.vcfg.enabled else None
        self._seeded = set()  # index ids whose clock seed ran
        self._last_write_version = {}  # index id -> newest acked stamp
        self.cfg = IndexCfg.from_json(cfg_path) if cfg_path is not None else None
        # DFT_REPAIR_INTERVAL > 0: a thread drains the repair queue and
        # refreshes the suspects; joined in close()
        self._repair_stop = threading.Event()
        self._repair_thread: Optional[threading.Thread] = None
        if self.rcfg.repair_interval_s > 0:
            self._repair_thread = threading.Thread(target=self._repair_loop,
                                                   name="repair-loop", daemon=True)
            self._repair_thread.start()

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
                    num_servers, res = replication.parse_discovery_lines(f)
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

    # ------------------------------------------------------- replica membership

    def _build_membership(self) -> replication.MembershipTable:
        """Groups from each rank's registered shard group, discovery-order
        striping (``assign_groups``) for ranks with none or unreachable."""
        derived = replication.assign_groups(self.num_indexes, self.rcfg.replication)

        def one(pos):
            try:
                gid = self._call_with_retry(self.sub_indexes[pos], "get_shard_group")
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException,):
                gid = None
            return derived[pos] if gid is None else int(gid)

        return replication.MembershipTable(list(self.pool.map(one, range(self.num_indexes))))

    def _register_groups(self) -> None:
        """Push each rank's group to it (best effort: a dead rank keeps the
        client's derived group until it rejoins)."""

        def one(pos):
            stub = self.sub_indexes[pos]
            try:
                self._call_with_retry(stub, "set_shard_group", (self.membership.group_of(pos),))
            except Exception as e:
                logger.debug("shard_group registration skipped for rank %s: %s", stub.id, e)

        list(self.pool.map(one, range(self.num_indexes)))

    def mark_rank_left(self, pos: int) -> None:
        """Take a stub position out of rotation (a planned decommission);
        its group serves from the replicas it has left."""
        self.membership.remove(pos)
        with self._lock:
            self._preferred = {g: p for g, p in self._preferred.items() if p != pos}

    def resync_rank(self, index_id: str, pos: int, source_pos: Optional[int] = None) -> dict:
        """Online (re)join: the rank at ``pos`` streams the shard from a live
        replica of its group (``source_pos``, or each other replica in turn;
        server.sync_shard_from) and is registered into the group again."""
        group = self.membership.group_of(pos)
        if group is None:
            raise RuntimeError(f"stub position {pos} is in no replica group")
        candidates = ([source_pos] if source_pos is not None
                      else [p for p in self.membership.replicas(group) if p != pos])
        if not candidates:
            raise RuntimeError(f"group {group} has no live replica to seed rank {pos} from")
        last_exc = None
        for src in candidates:
            src_stub = self.sub_indexes[src]
            try:
                # the transfer can outlast the default socket wait of a call
                out = self.sub_indexes[pos].generic_fun(
                    "sync_shard_from", (index_id, src_stub.host, src_stub.port, group),
                    timeout=600.0)
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException,) as e:
                last_exc = e
                logger.warning("resync of rank %s from replica %s failed: %s", pos, src, e)
                continue
            self.membership.register(pos, group)
            return out
        raise RuntimeError(f"no replica of group {group} could seed rank {pos}") from last_exc

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

        outcomes = [_outcome(stub, ok, val) for stub, (ok, val)
                    in zip(self.sub_indexes, self.pool.map(one, self.sub_indexes))]
        if not all(o["ok"] for o in outcomes):
            raise MultiRankError(fname, outcomes)
        return [o["result"] for o in outcomes]

    def _groups(self) -> List[Tuple[int, List[int]]]:
        groups = sorted(self.membership.snapshot().items())
        if not groups:
            raise RuntimeError("no replica groups registered")
        return groups

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
        """Round-robin placement over the groups (the first one random):
        the batch goes to every replica of the placed group and is
        acknowledged when ``quorum`` of them (at most the group's size)
        applied it; the replicas that missed it go to the repair queue. A
        group below quorum but not empty raises ``QuorumError`` (rerouting
        would duplicate rows across shards). A wholly transport-dead group
        is skipped (recorded in ``reroutes``) and the batch goes to the next
        group; only when every group refuses does the call raise. The batch
        carries one version, stamped before placement, so every replica, a
        reroute and a repair re-send carry the same one."""
        groups = self._groups()
        version = self._stamp(index_id)
        with self._lock:
            if index_id not in self.cur_server_ids:
                self.cur_server_ids[index_id] = self._rng.randint(0, len(groups) - 1)
            start = self.cur_server_ids[index_id] % len(groups)
        last_exc = None
        for offset in range(len(groups)):
            gi = (start + offset) % len(groups)
            gid, reps = groups[gi]
            needed = min(self.quorum, len(reps))
            args = (index_id, embeddings, metadata, train_async_if_triggered)
            results = self._fan_out(reps, "add_index_data", args, version)
            acked = [p for p, r in results if not isinstance(r, BaseException)]
            failed = [(p, e) for p, e in results if isinstance(e, BaseException)]
            if len(acked) >= needed:
                if failed:
                    self._record_repair(index_id, gid, failed, op="add", embeddings=embeddings,
                                        metadata=metadata, version=version)
                with self._lock:
                    self.cur_server_ids[index_id] = (gi + 1) % len(groups)
                self._note_write_acked(index_id, version)
                return
            if acked:
                self._record_repair(index_id, gid, failed, op="add", embeddings=embeddings,
                                    metadata=metadata, version=version)
                self.counters.inc("quorum_failures")
                raise QuorumError("add_index_data", index_id, gid, acked, needed,
                                  self._outcomes(results))
            next_reps = groups[(gi + 1) % len(groups)][1]
            with self._lock:
                for pos, e in failed:
                    stub = self.sub_indexes[pos]
                    logger.warning("add_index_data: rank %s (%s:%s) unreachable after retries, "
                                   "rerouting the batch to the next group: %s",
                                   stub.id, stub.host, stub.port, e)
                    self.reroutes.append({"index_id": index_id, "skipped_server": stub.id,
                                          "host": stub.host, "port": stub.port,
                                          "error": f"{type(e).__name__}: {e}",
                                          "rerouted_to": next_reps[0] if next_reps else None})
                    self.counters.inc("reroutes")
                    last_exc = e
        raise RuntimeError(f"add_index_data for {index_id!r} failed on every rank") from last_exc

    def _fan_out(self, positions: List[int], fname: str, args, version) -> list:
        """``fname`` on every position: ``[(position, result or transport
        error)]``. An application error propagates at once: it would repeat
        on every replica."""

        def one(pos):
            try:
                return pos, self._mutation_call(pos, fname, args, version)
            except rpc.TRANSPORT_ERRORS + (rpc.BusyError,) as e:
                return pos, e

        return list(self.pool.map(one, positions))

    def _outcomes(self, results) -> List[dict]:
        return [_outcome(self.sub_indexes[p], not isinstance(r, BaseException), r)
                for p, r in results]

    def _record_repair(self, index_id: str, gid: int, failed, op: str, **payload) -> None:
        """One repair record per (call, group): everything a re-send needs,
        with the call's version, which makes a re-send to a replica that has
        the write already a no-op."""
        self.repair_queue.record({
            "op": op, "index_id": index_id, "group": gid,
            "missing": [pos for pos, _e in failed],
            "failures": [{"skipped_server": self.sub_indexes[pos].id,
                          "host": self.sub_indexes[pos].host,
                          "port": self.sub_indexes[pos].port,
                          "error": f"{type(e).__name__}: {e}"} for pos, e in failed],
            **payload})
        self.counters.inc("under_replicated")

    def _repair_send(self, item: dict, pos: int) -> None:
        if item.get("op") == "remove_ids":
            self._mutation_call(pos, "remove_ids", (item["index_id"], item["ids"]),
                                item.get("version"))
        else:
            self._mutation_call(pos, "add_index_data", (item["index_id"], item["embeddings"],
                                                        item["metadata"], True),
                                item.get("version"))

    def repair_under_replicated(self) -> dict:
        """Re-send every recorded under-replicated write (adds and deletes)
        to the replicas that missed it; records still failing go back on
        the queue. ``{"repaired": n, "still_pending": m}``."""
        repaired = still_pending = 0
        for item in self.repair_queue.drain():
            missing = []
            for pos in item["missing"]:
                try:
                    self._repair_send(item, pos)
                except Exception as e:
                    logger.warning("repair of %s group %s on rank %s still failing: %s",
                                   item["index_id"], item["group"], pos, e)
                    missing.append(pos)
            if missing:
                item["missing"] = missing
                self.repair_queue.record(item)
                still_pending += 1
            else:
                self.repair_queue.mark_repaired()
                repaired += 1
        return {"repaired": repaired, "still_pending": still_pending}

    def _repair_loop(self) -> None:
        """The repair loop (DFT_REPAIR_INTERVAL): drain the queue, then
        refresh the suspects. The stop event is the sleep."""
        while not self._repair_stop.wait(self.rcfg.repair_interval_s):
            try:
                out = self.repair_under_replicated()
                if out["repaired"] or out["still_pending"]:
                    logger.info("repair loop: %s", out)
            except Exception:
                logger.exception("periodic repair pass failed")
            try:
                self.refresh_health()
            except Exception:
                logger.exception("periodic health refresh failed")

    def refresh_health(self) -> set:
        """Ask one reachable replica of each group with a sweeper for its
        ``get_health`` view and make its suspects this client's: the read
        walk tries them last. Returns the suspect positions."""
        addr_to_pos = {(s.host, s.port): pos for pos, s in enumerate(self.sub_indexes)}
        suspects = set()
        for _group, reps in sorted(self.membership.snapshot().items()):
            for pos in reps:
                try:
                    health = self.sub_indexes[pos].generic_fun("get_health", (), {},
                                                               timeout=5.0)
                except rpc.TRANSPORT_ERRORS + (rpc.ServerException,):
                    continue
                if not health.get("enabled"):
                    continue  # no sweeper there: ask the next replica
                for s in health.get("suspects") or ():
                    spos = addr_to_pos.get((s.get("host"), s.get("port")))
                    if spos is not None:
                        suspects.add(spos)
                break
        with self._lock:
            self._suspects = set(suspects)
        return suspects

    # ------------------------------------------------------------ versions

    def _stamp(self, index_id: str):
        """One fresh version for a mutation call (None with versioning
        off). The first use per index seeds the clock from the replicas'
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
        """Observe every reachable replica's watermark (``get_id_sets``),
        all of them: a write acked at a quorum lives on some replicas only.
        A client restarted on a machine whose clock went backward then still
        stamps ahead of its earlier writes. A replica that answers with an
        error (no such index) has nothing to observe; when no replica
        answers the seed is retried on the next mutation."""
        positions = [p for _g, reps in sorted(self.membership.snapshot().items()) for p in reps]

        def one(pos):
            try:
                return True, self.sub_indexes[pos].generic_fun("get_id_sets", (index_id,),
                                                               timeout=30.0)
            except rpc.ServerException:
                return True, None
            except rpc.TRANSPORT_ERRORS:
                return False, None

        answered = False
        for ok, sets in self.pool.map(one, positions):
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
        """One replica's mutation RPC, ``version`` as a keyword unless None
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
        """Delete by metadata id on every replica of every group (placement
        puts an id anywhere), acknowledged per group at the quorum; the
        replicas that missed it go to the repair queue (a delete is
        idempotent, so the re-send is exact). A group below quorum is never
        rerouted (no other group holds its rows): every group is tried and
        then ``QuorumError`` raises, with every replica's outcome; the
        delete applied wherever it acked and is safe to retry. Returns, per
        group, the most rows a replica tombstoned, summed. One version for
        the call. An application error propagates at once."""
        ids = list(ids)
        if not ids:
            return 0
        groups = self._groups()
        version = self._stamp(index_id)
        results = self._fan_out([p for _g, reps in groups for p in reps], "remove_ids",
                                (index_id, ids), version)
        by_pos = dict(results)
        removed = 0
        quorum_failure = None
        for gid, reps in groups:
            needed = min(self.quorum, len(reps))
            acked = [(p, by_pos[p]) for p in reps if not isinstance(by_pos[p], BaseException)]
            failed = [(p, by_pos[p]) for p in reps if isinstance(by_pos[p], BaseException)]
            if acked:
                removed += max(int(r) for _p, r in acked)
            if failed:
                self._record_repair(index_id, gid, failed, op="remove_ids", ids=ids,
                                    version=version)
            if len(acked) < needed:
                self.counters.inc("quorum_failures")
                if quorum_failure is None:
                    quorum_failure = (gid, [p for p, _r in acked], needed)
        if quorum_failure is not None:
            raise QuorumError("remove_ids", index_id, *quorum_failure, self._outcomes(results))
        self._note_write_acked(index_id, version)
        return removed

    def upsert(self, index_id: str, ids, embeddings: np.ndarray,
               metadata: Optional[List[object]] = None) -> int:
        """Delete + add: tombstone every live row of ``ids`` on every group,
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
        """A compaction pass on every rank now (past any lease); the
        per-rank booleans."""
        return self._broadcast("compact_index", (index_id,))

    def sync_train(self, index_id: str) -> None:
        self._broadcast("sync_train", (index_id,))

    def async_train(self, index_id: str) -> None:
        self._broadcast("async_train", (index_id,))

    def add_buffer_to_index(self, index_id: str):
        self._broadcast("add_buffer_to_index", (index_id,))

    # ------------------------------------------------------------ query

    def _read_plan(self):
        with self._lock:
            preferred = dict(self._preferred)
            suspects = frozenset(self._suspects)
        plan = replication.plan_read_fanout(self.membership, preferred, suspects)
        if not plan:
            raise RuntimeError("no replica groups registered")
        return plan

    def search(self, query: np.ndarray, topk: int, index_id: str,
               return_embeddings: bool = False, allow_partial: bool = False,
               partial_timeout: Optional[float] = None,
               deadline: Optional[float] = None, min_version=None,
               read_your_writes: bool = False, trace_id: Optional[str] = None) -> tuple:
        """Fan-out search with the client-side top-k merge over ONE replica
        per group; returns (D, meta) or (D, meta, embs), plus a trailing
        ``missing`` list with ``allow_partial``.

        Each group walks its replicas, the last one that answered first and
        suspects last: a transport error, a BUSY past the retry budget, the
        drain refusal (state ADD) and the stale-read refusal fail over to
        the next replica (which is then pinned), so results stay complete
        through a rank death. allow_partial=False: a group none of whose
        replicas answers raises the last error. allow_partial=True: such a
        group is skipped and ``missing`` holds one {server, host, port,
        error} dict per replica it tried (empty: complete); a call on which
        every group fails raises. Any other application error
        (ServerException: index not loaded or trained, bad args) raises.
        ``partial_timeout`` bounds each call with a socket wait, so a hung
        rank degrades too; the stub redials on its next call.

        ``deadline`` (seconds of budget) rides every per-rank frame so an
        overloaded rank can shed the request before it reaches the device;
        BUSY rejections retry under the RetryPolicy backoff, never past the
        deadline, and an expired one ends the group's walk.

        ``read_your_writes=True`` demands this client's last acknowledged
        versioned write (``min_version``, which may also be passed): a
        replica behind it refuses, and the walk moves to a peer that has it
        (the write acked at quorum); a whole group behind raises.

        ``trace_id`` pins the search to a trace; by default one is sampled
        (DFT_TRACE_SAMPLE; 0 = never, and the frames carry no trace key). A
        traced search records ``client.search`` over the whole fan-out and
        ``client.failover`` for each replica it moved past, and sends the id
        to every rank it calls; ``get_trace_spans(trace_id)`` merges them."""
        if trace_id is None:
            trace_id = obs_spans.maybe_sample()
        fanout_w0 = time.time() if trace_id is not None else 0.0
        fanout_p0 = time.perf_counter()
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
        plan = self._read_plan()
        timeout = partial_timeout if allow_partial else None

        def note_hop(group, stub, error, att_w0, att_p0):
            """The span of a failed replica attempt: which replica cost how
            much of the call before the group moved on."""
            if trace_id is not None:
                obs_spans.local_buffer().record(
                    trace_id, "client.failover", att_w0, time.perf_counter() - att_p0,
                    group=group, replica=stub.id, error=type(error).__name__)

        def record_fanout():
            if trace_id is not None:
                obs_spans.local_buffer().record(
                    trace_id, "client.search", fanout_w0, time.perf_counter() - fanout_p0,
                    index_id=index_id, groups=len(plan), rows=int(query.shape[0]),
                    topk=int(topk))

        def walk(item):
            """The group's answer, or the list of _FailedRank it tried."""
            group, _pick, ordering = item
            fails = []
            for i, pos in enumerate(ordering):
                stub = self.sub_indexes[pos]
                att_w0 = time.time() if trace_id is not None else 0.0
                att_p0 = time.perf_counter()
                try:
                    out = self.retry.run_filtered(
                        (rpc.BusyError,), abs_deadline, stub.generic_fun, "search",
                        (index_id, query, topk, return_embeddings), search_kwargs,
                        timeout=timeout, deadline=abs_deadline, trace_id=trace_id)
                except rpc.DeadlineExceeded as e:
                    # the budget is spent: no replica answers sooner
                    note_hop(group, stub, e, att_w0, att_p0)
                    fails.append(_FailedRank(stub, e))
                    break
                except rpc.TRANSPORT_ERRORS + (rpc.BusyError,) as e:
                    logger.warning("replica %s (%s:%s) of group %s failed during search: %s",
                                   stub.id, stub.host, stub.port, group, e)
                    note_hop(group, stub, e, att_w0, att_p0)
                    fails.append(_FailedRank(stub, e))
                    continue
                except rpc.ServerException as e:
                    if ((replication.drain_failover_eligible(e)
                         or replication.stale_read_failover_eligible(e))
                            and i + 1 < len(ordering)):
                        logger.info("replica %s of group %s cannot serve this search yet; "
                                    "failing over: %s", stub.id, group, e)
                        note_hop(group, stub, e, att_w0, att_p0)
                        fails.append(_FailedRank(stub, e))
                        continue
                    raise
                if i > 0:
                    self.counters.inc("failovers")
                    with self._lock:
                        self._preferred[group] = pos
                return out
            return fails

        raw = list(self.pool.map(walk, plan))
        if not allow_partial:
            for r in raw:
                if isinstance(r, list):
                    raise r[-1].error
            merged = IndexClient._aggregate_results(raw, topk, query.shape[0],
                                                    maximize_metric, return_embeddings)
            record_fanout()
            return merged
        ok = [r for r in raw if not isinstance(r, list)]
        missing = [{"server": f.stub.id, "host": f.stub.host, "port": f.stub.port,
                    "error": f"{type(f.error).__name__}: {f.error}"}
                   for fails in raw if isinstance(fails, list) for f in fails]
        if not ok:
            raise RuntimeError(f"search failed on every rank: {[m['error'] for m in missing]}")
        merged = IndexClient._aggregate_results(iter(ok), topk, query.shape[0],
                                                maximize_metric, return_embeddings)
        record_fanout()
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
        """``{stub position: generation}``: each reachable replica's newest
        committed generation (replicas with none committed, or unreachable,
        are left out). Take it before a burst of mutations and pass it to
        ``search_at_generation`` after."""
        positions = [p for _g, reps in sorted(self.membership.snapshot().items()) for p in reps]

        def one(pos):
            try:
                gen = self._call_with_retry(self.sub_indexes[pos], "get_generation", (index_id,))
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException,):
                return pos, None
            return pos, (int(gen) if gen else None)

        return {pos: gen for pos, gen in self.pool.map(one, positions) if gen is not None}

    def search_at_generation(self, query: np.ndarray, topk: int, index_id: str,
                             pins: Optional[dict] = None) -> tuple:
        """Point-in-time fan-out search: each group serves from a replica
        with a pin in ``pins`` (``pin_generations``; fetched now when None),
        the committed generation pinned for it, whatever changed since. A
        replica that fails or no longer retains its generation hands over
        to the group's next pinned replica; a group with none raises.
        Merged like ``search``; returns ``(D, meta)``."""
        query = np.asarray(query, np.float32)
        if self.cfg is None:
            raise RuntimeError("IndexClient has no cfg for this index: pass cfg_path at "
                               "construction, or call create_index/load_index first")
        if pins is None:
            pins = self.pin_generations(index_id)
        plan = self._read_plan()
        unpinned = [g for g, _pick, ordering in plan if not any(p in pins for p in ordering)]
        if unpinned:
            raise RuntimeError(f"groups {unpinned} have no pinned committed generation for "
                               f"{index_id!r} on any replica")

        def one_group(item):
            group, _pick, ordering = item
            last = None
            for pos in (p for p in ordering if p in pins):
                stub = self.sub_indexes[pos]
                try:
                    return stub.generic_fun("search_at_generation",
                                            (index_id, query, topk, pins[pos]))
                except rpc.TRANSPORT_ERRORS + (rpc.BusyError, rpc.ServerException) as e:
                    logger.warning("replica %s of group %s cannot serve its pinned "
                                   "generation: %s", stub.id, group, e)
                    last = e
            raise last

        results = self.pool.map(one_group, plan)
        return IndexClient._aggregate_results(results, topk, query.shape[0],
                                              self.cfg.metric == "dot", False)

    # ------------------------------------------------------------ observability

    def get_state(self, index_id: str) -> IndexState:
        states = list(self.pool.map(
            lambda s: self._call_with_retry(s, "get_state", (index_id,)), self.sub_indexes))
        return IndexState.get_aggregated_states(states)

    def get_ntotal(self, index_id: str) -> int:
        """Logical rows: per group the most any live replica holds (replicas
        may differ mid-repair), summed, so a replicated row counts once. A
        dead replica degrades to its peers; a group with no reachable
        replica raises its error (with R = 1, any dead rank)."""
        snapshot = sorted(self.membership.snapshot().items())
        positions = [p for _g, reps in snapshot for p in reps]

        def one(pos):
            try:
                return self._call_with_retry(self.sub_indexes[pos], "get_ntotal", (index_id,))
            except rpc.TRANSPORT_ERRORS as e:
                return e

        counts = dict(zip(positions, self.pool.map(one, positions)))
        total = 0
        for _g, reps in snapshot:
            live = [counts[p] for p in reps if not isinstance(counts[p], BaseException)]
            if not live:
                raise next(counts[p] for p in reps)
            total += max(live)
        return total

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
        """Per-server latency summaries; each entry's ``"rpc"`` key gains
        this client's view of the stub under ``"client"``
        (``rpc.Client.rpc_stats``: serial or multiplexed, wire encoding,
        whether the peer answered in binary, calls in flight, wire round
        trips), and its ``"replication"`` key this client's counters,
        membership and repair queue (``get_replication_stats``) under
        ``"client"``.

        A dead or unreachable rank does not fail the call (an operator
        reaches for it in an outage): its entry is ``{"error", "server",
        "host", "port"}`` with the same two client views, and the
        survivors' stats come back intact."""

        def one(stub):
            try:
                return self._call_with_retry(stub, "get_perf_stats")
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException, rpc.BusyError) as e:
                return {"error": f"{type(e).__name__}: {e}", "server": stub.id,
                        "host": stub.host, "port": stub.port}

        stats = list(self.pool.map(one, self.sub_indexes))
        repl = self.get_replication_stats()
        for stub, entry in zip(self.sub_indexes, stats):
            entry.setdefault("rpc", {})["client"] = stub.rpc_stats()
            entry.setdefault("replication", {})["client"] = repl
        return stats

    def get_trace_spans(self, trace_id: Optional[str] = None) -> list:
        """One timeline of ``trace_id`` (every retained span when None):
        this process's spans merged with every reachable rank's ring (the
        ``get_trace_spans`` op); a dead rank is skipped."""

        def one(stub):
            try:
                return self._call_with_retry(stub, "get_trace_spans", (trace_id,))
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException, rpc.BusyError) as e:
                logger.debug("trace fetch skipped rank %s: %s", stub.id, e)
                return []

        remote = list(self.pool.map(one, self.sub_indexes))
        return obs_spans.merge_timelines(obs_spans.local_buffer().snapshot(trace_id), *remote)

    def get_replication_stats(self) -> dict:
        """This client's replication view: the monotonic reroute, failover,
        under-replicated and quorum-failure counts, the reroute ring's
        length, the quorum, the groups, the repair queue (``degraded`` once
        it dropped a record: only the server-side sweep heals that), the
        suspects and the clock."""
        with self._lock:
            recent = len(self.reroutes)
            suspects = sorted(self._suspects)
        repair = self.repair_queue.stats()
        return {
            "counters": self.counters.snapshot(),
            "recent_reroutes": recent,
            "quorum": self.quorum,
            "replication": self.rcfg.replication,
            "groups": self.membership.snapshot(),
            "repair": repair,
            "degraded": repair["dropped"] > 0,
            "suspects": suspects,
            "versioning": {"enabled": self._hlc is not None,
                           "writer_id": self._hlc.writer_id if self._hlc is not None else None},
        }

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
        # the repair loop re-sends through the stubs: stop it first
        self._repair_stop.set()
        t = self._repair_thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
        for stub in self.sub_indexes:
            stub.close()
        self.pool.shutdown(wait=False)
