"""Server-side anti-entropy: replica digests, peer repair, health and the
compaction lease (counterpart of distributed_faiss_tpu/parallel/antientropy.py).

Each rank with a discovery file runs one sweeper thread that:

1. exchanges per-index replica digests (``engine.replica_digest``) with
   its group's peers over the ``KIND_DIGEST`` frame pair, peers resolved
   from the discovery file;
2. on a mismatch heals by pulling: the peer's deletion ledger first
   (``reconcile_deletes``; a delete is never undone by a sweep), then the
   rows it lacks, as an id-set delta of at most ``delta_max_rows`` rows
   fetched in hash-verified chunks (``export_rows_versioned``), else as a
   full shard transfer (``sync_shard_from``, committed as a generation);
   a peer serving an index this rank lacks is fetched whole;
3. is the failure detector: ``suspect_after`` failed round trips mark a
   peer suspect (``get_health``; clients try suspects last);
4. prunes the deletion ledgers below the group's lowest watermark once
   every peer was heard and every digest matched;
5. holds the group's compaction lease: the lowest live rank of a group
   compacts, the others' watchers defer (``Index.compaction_gate``).

Pull only: a sweep never pushes rows into a peer; each side pulls what it
lacks. No lock is held across socket I/O or an engine call.
"""

import logging
import socket as socketmod
import threading
import time
from typing import Dict, List, Optional, Tuple

from distributed_faiss_tpu_torch.mutation import versions as _versions
from distributed_faiss_tpu_torch.mutation.tombstones import id_match_key
from distributed_faiss_tpu_torch.parallel import replication, rpc
from distributed_faiss_tpu_torch.utils import lockdep, serialization
from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg

logger = logging.getLogger()

# hosts that mean this machine beside our own port: the sweeper's own entry
_SELF_HOSTS = frozenset({"localhost", "127.0.0.1", "::1", socketmod.gethostname()})

# rows per export_rows_versioned call of a delta repair: bounds one frame
# (about 1 MB of f32 at d=128), not the total
_DELTA_CHUNK = 2048

# socket deadline of the heal calls: looser than the heartbeat's (id sets
# are O(rows) on the peer) but bounded, so stop() can always join
_HEAL_CALL_TIMEOUT_S = 30.0

# a peer skipped as another group's is re-probed every this many sweeps:
# its group may be registered after the first exchange
_GROUP_REFRESH_SWEEPS = 10


def read_peers(discovery_path: str) -> List[Tuple[str, int]]:
    """The discovery file's (host, port) entries in registration order; a
    missing or garbled file gives [] (the sweeper idles until ranks
    register)."""
    try:
        with open(discovery_path) as f:
            return replication.parse_discovery_lines(f)[1]
    except OSError:
        return []


def digests_match(mine: Optional[dict], theirs: Optional[dict]) -> bool:
    """Convergence on the live side only: converged replicas may hold
    different ledgers (a delete of an id a replica never held). The
    versioned plane compares only when both sides send it."""
    if not isinstance(mine, dict) or not isinstance(theirs, dict):
        return False
    if (mine.get("live_n") != theirs.get("live_n")
            or mine.get("live_hash") != theirs.get("live_hash")):
        return False
    mv, tv = mine.get("live_vhash"), theirs.get("live_vhash")
    return mv is None or tv is None or mv == tv


class HealthTable:
    """One rank's failure-detector state: an entry per contacted peer
    address, and the peers whose sweeps reached us (liveness evidence when
    our own probes fail). Reads copy under the lock."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = lockdep.lock("HealthTable._lock")
        self._peers: Dict[Tuple[str, int], dict] = {}
        self._inbound: Dict[int, dict] = {}

    def known_group(self, host: str, port: int):
        """(known, group): known after one answered exchange; the group may
        be None."""
        with self._lock:
            e = self._peers.get((host, port))
            if e is None or not e.get("known"):
                return False, None
            return True, e.get("group")

    def note_ok(self, addr: Tuple[str, int], rank, group) -> None:
        now = self._clock()
        with self._lock:
            e = self._peers.setdefault(tuple(addr), {})
            was_suspect = e.get("suspect", False)
            e.update(known=True, rank=rank, group=group, failures=0, suspect=False,
                     last_ok=now, last_error=None)
        if was_suspect:
            logger.info("anti-entropy: peer %s:%d (rank %s) recovered", addr[0], addr[1], rank)

    def note_fail(self, addr: Tuple[str, int], suspect_after: int, exc: BaseException) -> bool:
        """Record a failed round trip; True when it crossed the threshold."""
        with self._lock:
            e = self._peers.setdefault(tuple(addr), {})
            e["failures"] = e.get("failures", 0) + 1
            e["last_error"] = f"{type(exc).__name__}: {exc}"
            newly = not e.get("suspect", False) and e["failures"] >= suspect_after
            if newly:
                e["suspect"] = True
        if newly:
            logger.warning("anti-entropy: peer %s:%d suspect after %d consecutive failed "
                           "digest round trips (%s)", addr[0], addr[1], suspect_after, exc)
        return newly

    def note_inbound(self, rank, group) -> None:
        if rank is None:
            return
        with self._lock:
            self._inbound[int(rank)] = {"group": group, "t": self._clock()}

    def alive_ranks(self, group, ttl_s: float) -> set:
        """Ranks of ``group`` heard from, either way, within ``ttl_s``: the
        compaction lease's electorate."""
        now = self._clock()
        out = set()
        with self._lock:
            for e in self._peers.values():
                if (e.get("rank") is not None and e.get("group") == group
                        and e.get("last_ok") is not None and now - e["last_ok"] <= ttl_s):
                    out.add(int(e["rank"]))
            for r, rec in self._inbound.items():
                if rec.get("group") == group and now - rec["t"] <= ttl_s:
                    out.add(int(r))
        return out

    def suspects(self) -> List[dict]:
        with self._lock:
            return [{"host": h, "port": p, "rank": e.get("rank"), "group": e.get("group"),
                     "failures": e.get("failures", 0), "last_error": e.get("last_error")}
                    for (h, p), e in sorted(self._peers.items()) if e.get("suspect")]

    def snapshot(self) -> dict:
        with self._lock:
            return {f"{h}:{p}": dict(e) for (h, p), e in sorted(self._peers.items())}


class AntiEntropySweeper:
    """One per IndexServer. ``sweep_once`` is the unit tests drive; the
    thread loops it every ``cfg.interval_s``. Its counters are the
    ``antientropy`` perf-stats key and part of ``get_health``."""

    def __init__(self, server, discovery_path: str, cfg: Optional[AntiEntropyCfg] = None):
        self.server = server
        self.discovery_path = discovery_path
        self.cfg = cfg if cfg is not None else AntiEntropyCfg.from_env()
        self.health = HealthTable()
        self._lock = lockdep.lock("AntiEntropySweeper._lock")
        self._counters = {"sweeps": 0, "digests_matched": 0, "digests_mismatched": 0,
                          "rows_repaired": 0, "rows_refreshed": 0, "full_syncs": 0,
                          "empty_deltas": 0,
                          # pulled chunks whose sha256 did not match: never applied
                          "chunk_hash_mismatch": 0,
                          # ledger entries pruned below the group's watermark
                          "ledger_pruned": 0}
        self._last_empty_warn = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name=f"antientropy:r{self.server.rank}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() and t is not threading.current_thread():
            t.join(timeout=10.0)

    def _run(self) -> None:
        # the stop event is the sleep: stop() wakes the sweeper at once
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.sweep_once()
            except Exception:
                logger.exception("anti-entropy sweep failed (rank %d)", self.server.rank)

    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    # ------------------------------------------------------------- sweeping

    def _is_self(self, host: str, port: int) -> bool:
        sock = self.server.socket
        if sock is None:
            return False
        try:
            my_port = sock.getsockname()[1]
        except OSError:
            return False
        return port == my_port and host in _SELF_HOSTS

    def sweep_once(self) -> dict:
        """One round: re-assert the compaction gates, exchange digests with
        every peer not known to be another group's, heal mismatches, prune
        the ledgers when safe. Returns a summary."""
        server = self.server
        my_group = server.shard_group
        summary = {"contacted": 0, "skipped": 0, "failed": 0, "healed": []}
        with self._lock:
            refresh = self._counters["sweeps"] % _GROUP_REFRESH_SWEEPS == 0
        with server.indexes_lock:
            engines = dict(server.indexes)
        for engine in engines.values():
            engine.compaction_gate = self.may_compact
        # this round's evidence for pruning: each group peer's watermark per
        # index, the indexes something disqualified, and whether anything
        # blocks the whole round
        prune_watermarks = {iid: [] for iid in engines}
        prune_blocked = set()
        prune_unsafe = False
        round_peers = set()
        for host, port in read_peers(self.discovery_path):
            if self._is_self(host, port):
                continue
            round_peers.add((host, port))
            known, peer_group = self.health.known_group(host, port)
            # only a concrete other group skips (a None group is a peer not
            # registered yet), and skips are re-probed on refresh sweeps
            if (not refresh and known and peer_group is not None and my_group is not None
                    and peer_group != my_group):
                summary["skipped"] += 1
                continue
            try:
                resp = rpc.digest_exchange(
                    host, port, {"rank": server.rank, "group": my_group, "want": None},
                    timeout=self.cfg.exchange_timeout_s)
            except rpc.TRANSPORT_ERRORS + (rpc.ServerException,) as e:
                self.health.note_fail((host, port), self.cfg.suspect_after, e)
                summary["failed"] += 1
                continue
            peer_rank = resp.get("rank")
            peer_group = resp.get("shard_group")
            self.health.note_ok((host, port), peer_rank, peer_group)
            summary["contacted"] += 1
            if my_group is None or peer_group != my_group:
                if peer_group is None:
                    # an unregistered peer may be one of ours that misses a
                    # delete: pruning past it could resurrect rows
                    prune_unsafe = True
                continue
            peer_wms = resp.get("watermarks") or {}
            for iid in engines:
                vk = _versions.version_key(peer_wms.get(iid))
                if vk is None:
                    prune_blocked.add(iid)
                else:
                    prune_watermarks[iid].append(vk)
            for index_id, theirs in sorted((resp.get("digests") or {}).items()):
                with server.indexes_lock:
                    engine = server.indexes.get(index_id)
                    dropped = index_id in server._dropped
                if dropped:
                    continue  # the peer missed our drop: never pull it back
                if engine is None:
                    # the peer serves an index we lack (restarted empty)
                    try:
                        server.sync_shard_from(index_id, host, port)
                        self._bump("full_syncs")
                        summary["healed"].append({"index_id": index_id, "peer": (host, port),
                                                  "full_sync": True})
                    except Exception:
                        logger.exception("anti-entropy: full sync of missing index %r from "
                                         "%s:%d failed", index_id, host, port)
                    continue
                if digests_match(engine.replica_digest(), theirs):
                    self._bump("digests_matched")
                    continue
                self._bump("digests_mismatched")
                prune_blocked.add(index_id)  # heal first, prune next round
                try:
                    out = self._heal(index_id, engine, host, port)
                    out.update(index_id=index_id, peer=(host, port))
                    summary["healed"].append(out)
                except rpc.TRANSPORT_ERRORS as e:
                    # the peer died mid-heal, or a chunk failed its hash twice
                    self.health.note_fail((host, port), self.cfg.suspect_after, e)
                    summary["failed"] += 1
                    logger.warning("anti-entropy: heal of %r from %s:%d failed on transport: "
                                   "%s", index_id, host, port, e)
                except Exception:
                    logger.exception("anti-entropy: heal of %r from %s:%d failed", index_id,
                                     host, port)
        if not prune_unsafe:
            self._prune_ledgers(engines, prune_watermarks, prune_blocked, summary, round_peers)
        self._bump("sweeps")
        return summary

    def _prune_ledgers(self, engines, prune_watermarks, prune_blocked, summary,
                       round_peers) -> None:
        """Drop the ledger entries every replica of the group has passed.
        All or nothing: only with a group, every dial of the round answered,
        no suspect that may be one of ours, and per index a watermark from
        every group peer and matched digests. Our own watermark joins the
        minimum, so an entry lives until the slowest replica passes it."""
        my_group = self.server.shard_group
        if my_group is None or summary["failed"]:
            return
        if any((s.get("host"), s.get("port")) in round_peers
               and (s.get("group") is None or s.get("group") == my_group)
               for s in self.health.suspects()):
            return
        for index_id, engine in engines.items():
            if index_id in prune_blocked:
                continue
            with self.server.indexes_lock:
                # an index dropped or swapped mid-sweep: a retired engine must
                # not rewrite the sidecar
                if (index_id in self.server._dropped
                        or self.server.indexes.get(index_id) is not engine):
                    continue
            own = _versions.version_key(engine.version_watermark())
            if own is None:
                continue
            floor = min(prune_watermarks.get(index_id, []) + [own])
            pruned = engine.prune_ledger(floor, min_age_s=self.cfg.ledger_prune_age_s)
            if pruned:
                self._bump("ledger_pruned", pruned)
                logger.info("anti-entropy: pruned %d deletion-ledger entries on %r (group "
                            "watermark floor %s)", pruned, index_id, list(floor))

    def _heal(self, index_id: str, engine, host: str, port: int) -> dict:
        """Pull this rank's missing state of one index from one peer.

        The peer's ledger applies first (LWW-gated, durable), then the id
        sets decide: rows the peer holds live that we lack (or hold at an
        older version) are pulled through the engine's LWW add gates. A full
        transfer replaces the local engine, so it runs only when more than
        ``delta_max_rows`` rows are missing and nothing is local-only: no
        local live row or delete the peer lacks, no local write newer than
        the peer's, no local write that outranked a peer delete. Otherwise
        even a large divergence heals by chunked delta."""
        peer = rpc.Client(-1, host, port, connect_timeout=5.0)
        try:
            sets = peer.generic_fun("get_id_sets", (index_id,), timeout=_HEAL_CALL_TIMEOUT_S)
            mine = engine.id_sets()
            my_live = {id_match_key(k) for k in mine["live"]}
            my_dead = {id_match_key(k) for k in mine["dead"]}
            my_live_v = {id_match_key(k): _versions.version_key(v)
                         for k, v in mine.get("live_versions") or ()}
            my_dead_v = {id_match_key(k): _versions.version_key(v)
                         for k, v in mine.get("dead_versions") or ()}
            peer_live_raw = list(sets.get("live") or ())
            peer_dead = [id_match_key(k) for k in sets.get("dead") or ()]
            peer_live_v = {id_match_key(k): _versions.version_key(v)
                           for k, v in sets.get("live_versions") or ()}
            peer_dead_v = {id_match_key(k): _versions.version_key(v)
                           for k, v in sets.get("dead_versions") or ()}
            removed = (engine.reconcile_deletes(peer_dead, sets.get("dead_versions"))
                       if peer_dead else 0)
            # peer deletes our live write outranked: a full sync would bring
            # them back deleted
            gated_deletes = sum(
                1 for k in set(peer_dead)
                if k in my_live and my_live_v.get(k) is not None
                and _versions.compare(my_live_v.get(k), peer_dead_v.get(k)) >= 0)
            my_dead |= set(peer_dead)
            missing, refresh, seen = [], [], set()
            peer_live_keys = set()
            local_newer = 0
            for raw in peer_live_raw:
                k = id_match_key(raw)
                peer_live_keys.add(k)
                if k in seen:
                    continue
                seen.add(k)
                vl = peer_live_v.get(k)
                if k in my_live:
                    mv = my_live_v.get(k)
                    if _versions.compare(vl, mv) > 0:
                        refresh.append(raw)  # the peer's write is newer
                    elif _versions.compare(mv, vl) > 0:
                        local_newer += 1  # the peer's own sweep pulls ours
                    continue
                if k in my_dead and not _versions.compare(vl, my_dead_v.get(k)) > 0:
                    continue  # our delete outranks it
                missing.append(raw)
            pulled, refreshed, full = 0, 0, False
            local_only = my_live - peer_live_keys - set(peer_dead)
            extra_dead = my_dead - set(peer_dead)
            candidates = missing + refresh
            if candidates:
                if (len(missing) > self.cfg.delta_max_rows and not local_only
                        and not extra_dead and not local_newer and not gated_deletes):
                    self.server.sync_shard_from(index_id, host, port)
                    self._bump("full_syncs")
                    full = True
                else:
                    def pull(batch):
                        got = 0  # rows the peer returned (it may have deleted some)
                        for i in range(0, len(batch), _DELTA_CHUNK):
                            chunk = batch[i:i + _DELTA_CHUNK]
                            emb, meta, vers = self._fetch_chunk_verified(
                                peer, index_id, chunk, host, port)
                            if len(meta):
                                engine.add_batch(emb, meta, version=vers)
                                got += len(meta)
                        return got

                    pulled = pull(missing)
                    refreshed = pull(refresh)
                    if pulled:
                        self._bump("rows_repaired", pulled)
                    if refreshed:
                        self._bump("rows_refreshed", refreshed)
            if removed or pulled or full:
                logger.info("anti-entropy: healed %r from %s:%d (%d deletes applied, %d rows "
                            "pulled, %d refreshed%s)", index_id, host, port, removed, pulled,
                            refreshed, ", full sync" if full else "")
            elif (not candidates and not local_only and not extra_dead and not local_newer
                  and not gated_deletes):
                # digests differ but the id sets agree both ways: typically an
                # id duplicated by an at-least-once retry. A sweep cannot heal
                # multiplicity, so it says so (at most once a minute).
                self._bump("empty_deltas")
                now = time.monotonic()
                with self._lock:
                    warn = now - self._last_empty_warn >= 60.0
                    if warn:
                        self._last_empty_warn = now
                if warn:
                    logger.warning(
                        "anti-entropy: digest mismatch on %r vs %s:%d but the id-set delta is "
                        "empty (likely an id duplicated by an ingest retry); re-ingest the id "
                        "or resync the smaller replica (sync_shard_from)", index_id, host, port)
        finally:
            peer.close()
        return {"removed": removed, "pulled": pulled, "refreshed": refreshed,
                "full_sync": full}

    def _fetch_chunk_verified(self, peer, index_id: str, chunk, host: str, port: int):
        """One delta chunk, its sha256 recomputed over what arrived before
        any row is applied. A mismatch is counted and the chunk refetched
        once; a second one raises FrameError (a transport error: the peer
        is marked failed, nothing is installed)."""
        for _attempt in range(2):
            emb, meta, vers, digest = peer.generic_fun(
                "export_rows_versioned", (index_id, chunk), {"with_hash": True},
                timeout=_HEAL_CALL_TIMEOUT_S)
            if serialization.row_payload_hash(emb, meta, vers) == digest:
                return emb, meta, vers
            self._bump("chunk_hash_mismatch")
            logger.warning("anti-entropy: row-chunk hash mismatch from %s:%d on %r (%d ids); "
                           "refetching", host, port, index_id, len(chunk))
        raise rpc.FrameError(f"row-chunk hash mismatch from {host}:{port} on {index_id!r} "
                             "after a retry: not applying the pull")

    # ------------------------------------------------------ compaction lease

    def may_compact(self) -> bool:
        """True while this rank holds its group's compaction token: the
        lowest rank of the group heard from within ``lease_ttl_s``, itself
        included. A rank with no group always holds its own. A dead
        leader's evidence ages out and the next rank takes over; two
        replicas may pass within one TTL of a leader flap (the lease bounds
        overlap, it is no mutex)."""
        group = self.server.shard_group
        if group is None:
            return True
        alive = self.health.alive_ranks(group, self.cfg.lease_ttl_s)
        alive.add(self.server.rank)
        return self.server.rank == min(alive)

    # -------------------------------------------------------- observability

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out["enabled"] = True
        out["suspect_peers"] = self.health.suspects()
        out["compaction_held"] = self.may_compact()
        return out

    def health_snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
        return {
            "enabled": True,
            "rank": self.server.rank,
            "shard_group": self.server.shard_group,
            "peers": self.health.snapshot(),
            "suspects": self.health.suspects(),
            "compaction": {"held": self.may_compact(), "group": self.server.shard_group,
                           "lease_ttl_s": self.cfg.lease_ttl_s},
            "counters": counters,
        }
