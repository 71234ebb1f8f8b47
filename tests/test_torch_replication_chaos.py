"""The port of tests/test_replication_chaos.py, with its marks and sizes,
on rank processes of the port (``device="cpu"``). Replication acceptance
gate: SIGKILL any rank of an R=2
cluster under a live mux query storm — search results must stay
byte-identical to the healthy cluster's golden answer (no missing shard
rows), every acknowledged write must survive, and the killed rank must
rejoin via MANIFEST shard transfer and serve again WITHOUT a client
restart."""

import os
import socket
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

pytestmark = [pytest.mark.replication, pytest.mark.slow]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO_ROOT}


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def flat_cfg(**kw):
    kw.setdefault("index_builder_type", "flat")
    kw.setdefault("dim", 16)
    kw.setdefault("metric", "l2")
    kw.setdefault("train_num", 50)
    return IndexCfg(**kw)


def wait_drained(client, index_id, n, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if (client.get_state(index_id) == IndexState.TRAINED
                and client.get_buffer_depth(index_id) == 0
                and client.get_ntotal(index_id) >= n):
            return
        time.sleep(0.2)
    raise AssertionError(f"cluster never drained to {n} indexed rows")


# R=2 with write_quorum=1: the sane R=2 deployment — a single rank death
# neither stalls writes (the surviving replica acks, the dead one is
# recorded for repair) nor costs reads (failover to the survivor).
# Majority quorum of 2 would be 2, i.e. any death blocks the dead
# rank's group (the last test here).
def repl_cfg():
    return ReplicationCfg(replication=2, write_quorum=1)


@pytest.mark.parametrize("victim_pos", [0, 1])
def test_sigkill_any_rank_under_storm_stays_golden(tmp_path, victim_pos):
    """The gate, parametrized over a victim in each replica group:

    1. healthy R=2 cluster (4 ranks, 2 groups), ingest + golden search;
    2. mux query storm from 4 threads; SIGKILL the victim mid-storm;
    3. keep ingesting through the outage (acks at quorum 1, the missed
       replica recorded as under-replicated);
    4. every storm result — before, during, and after the kill — must be
       byte-identical to golden, with zero search errors;
    5. restart the victim EMPTY, stream the shard back from its group
       peer (MANIFEST transfer), pin reads onto it, and get golden again;
    6. zero acked-write loss across the whole episode.
    """
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(4, disc, storage, base_port=free_port(), env=ENV,
                       device="cpu") as h:
        client = IndexClient(disc, replication_cfg=repl_cfg())
        client.create_index("gidx", flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 16)).astype(np.float32)

        acked = set()
        for s in range(0, 300, 50):
            ids = [(i,) for i in range(s, s + 50)]
            client.add_index_data("gidx", x[s:s + 50], ids)
            acked.update(i for (i,) in ids)
        wait_drained(client, "gidx", 300)
        client.save_index("gidx")

        q = np.ascontiguousarray(x[:16])
        g_scores, g_meta = client.search(q, 5, "gidx")

        group = client.membership.group_of(victim_pos)
        victim_rank = client.sub_indexes[victim_pos].port - h.base_port
        survivor_pos = next(p for p in client.membership.replicas(group)
                            if p != victim_pos)
        # rows ingested DURING the storm sit far from every query, so the
        # golden top-5 is invariant under the live ingest
        far = (rng.standard_normal((200, 16)) + 50.0).astype(np.float32)

        with QueryStorm(client, "gidx", q, 5, threads=4) as storm:
            time.sleep(0.7)  # storm hits the healthy cluster first
            h.kill(victim_rank)
            time.sleep(1.5)  # storm keeps running against the outage
        results, errors = storm.stop()
        # ingest through the outage (after the storm window: a rank
        # draining its buffer is legitimately in ADD and rejects
        # searches — an engine contract, not a replication gap): every
        # batch still acks at quorum 1 on the surviving replicas
        for s in range(0, 200, 50):
            ids = [(300 + s + i,) for i in range(50)]
            client.add_index_data("gidx", far[s:s + 50], ids)
            acked.update(i for (i,) in ids)

        assert errors == [], f"storm saw search errors: {errors[:3]}"
        assert len(results) >= 10, "storm produced too few samples"
        for scores, meta in results:
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta
        # read failover really happened and was pinned
        assert client.counters["failovers"] >= 1
        # the dead replica's missed writes were recorded for repair
        assert client.counters["under_replicated"] >= 1
        assert client.get_replication_stats()["repair"]["pending"] >= 1
        # a repair pass against the still-dead rank keeps records queued
        out = client.repair_under_replicated()
        assert out["repaired"] == 0 and out["still_pending"] >= 1

        # ---- rejoin: restart EMPTY (no --load-index), stream the shard
        h.restart(victim_rank, load_index=False,
                  extra_env={"DFT_SHARD_GROUP": str(group)})
        h.wait_port(victim_rank)
        deadline = time.time() + 60
        while True:
            try:
                out = client.resync_rank("gidx", victim_pos,
                                         source_pos=survivor_pos)
                break
            except Exception:
                assert time.time() < deadline, "victim never resynced"
                time.sleep(0.3)
        assert out["shard_group"] == group
        assert out["ntotal"] + out["buffered"] > 0
        # the env registration survived into the restarted process
        assert client.sub_indexes[victim_pos].generic_fun(
            "get_shard_group") == group
        # the transfer committed a MANIFEST generation on the victim's disk
        victim_dir = os.path.join(storage, "gidx", str(victim_rank))
        assert serialization.list_generations(victim_dir)
        # the transferred snapshot already covers the under-replicated
        # batches (the source replica acked them), so the records are
        # obsolete: drain instead of re-sending duplicates (runbook step)
        client.repair_queue.drain()

        deadline = time.time() + 120
        while client.get_buffer_depth("gidx") > 0:
            assert time.time() < deadline, "rejoined rank never drained"
            time.sleep(0.2)

        # pin reads onto the REJOINED replica: it must serve golden too,
        # on the same client, without any restart
        with client._lock:
            client._preferred[group] = victim_pos
        scores2, meta2 = client.search(q, 5, "gidx")
        np.testing.assert_array_equal(scores2, g_scores)
        assert meta2 == g_meta
        served = client.sub_indexes[victim_pos].generic_fun(
            "get_perf_stats")
        assert served.get("search", {}).get("count", 0) >= 1, (
            "pinned search was not served by the rejoined rank")

        # zero acked-write loss across kill + outage + rejoin
        present = set(client.get_ids("gidx"))
        lost = acked - present
        assert not lost, f"{len(lost)} acked ids lost: {sorted(lost)[:10]}"
        client.close()


def test_quorum_majority_blocks_writes_to_dead_group(tmp_path):
    """The OTHER side of the quorum trade, live: with the default
    majority quorum (2 of 2), a dead replica makes its group unwritable
    — the partial placement raises QuorumError instead of silently
    acking or duplicating rows across groups — while the OTHER group
    keeps acking normally."""
    from distributed_faiss_tpu_torch.parallel.client import QuorumError

    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(2, disc, storage, base_port=free_port(), env=ENV,
                       device="cpu") as h:
        client = IndexClient(
            disc, replication_cfg=ReplicationCfg(replication=2))
        assert client.quorum == 2
        client.create_index("qidx", flat_cfg())
        rng = np.random.default_rng(1)
        x = rng.standard_normal((100, 16)).astype(np.float32)
        client.add_index_data("qidx", x[:50], [(i,) for i in range(50)])

        victim_rank = client.sub_indexes[0].port - h.base_port
        h.kill(victim_rank)
        with pytest.raises(QuorumError):
            client.add_index_data("qidx", x[50:], [(i,) for i in range(50, 100)])
        assert client.counters["quorum_failures"] == 1
        assert len(client.repair_queue) >= 1
        client.close()
