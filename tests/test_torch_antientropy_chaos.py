"""The port of tests/test_antientropy_chaos.py, with its marks, sizes and
knobs, on rank processes of the port (``device="cpu"``). Anti-entropy
acceptance gate: R=2 cluster with the repair
queue shrunk so under-replicated records are PROVABLY dropped, a replica
SIGKILLed and restarted mid-ingest, and **zero** client-driven repair
calls — the server-side sweep alone must converge both replicas to
byte-identical digests and byte-identical search results under a live
mux query storm, with deleted ids never resurrected; a second SIGKILL
mid-heal must fall back cleanly (no torn generation); and the compaction
lease must sit on exactly one replica of the group."""

import os
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.parallel import antientropy, rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_base

pytestmark = [pytest.mark.antientropy, pytest.mark.chaos, pytest.mark.slow]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fast sweeps so convergence lands inside the test budget; compaction
# watcher off to keep the gate focused on repair (the lease has its own
# assertion via get_health)
ENV = {"PYTHONPATH": REPO_ROOT,
       "DFT_ANTIENTROPY_INTERVAL": "0.5", "DFT_COMPACT": "0"}

DIM = 16


def flat_cfg():
    return IndexCfg(index_builder_type="flat", dim=DIM, metric="l2",
                    train_num=50)


def wait_drained(client, index_id, n, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if (client.get_state(index_id) == IndexState.TRAINED
                and client.get_buffer_depth(index_id) == 0
                and client.get_ntotal(index_id) >= n):
            return
        time.sleep(0.2)
    raise AssertionError(f"cluster never drained to {n} indexed rows")


def rank_digest(port, index_id, timeout=5.0):
    """This rank's replica digest for one index, over the wire (the same
    KIND_DIGEST exchange the sweepers use)."""
    resp = antientropy_exchange(port, timeout)
    return resp["digests"].get(index_id)


def antientropy_exchange(port, timeout=5.0):
    return rpc.digest_exchange(
        "localhost", port, {"rank": None, "group": None, "want": None},
        timeout=timeout)


def wait_converged(ports, index_id, timeout=90.0):
    """Poll both ranks' wire digests until byte-identical (and present)."""
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            digs = [rank_digest(p, index_id) for p in ports]
        except Exception as e:  # a rank mid-restart: keep polling
            last = e
            time.sleep(0.3)
            continue
        if all(d is not None for d in digs) and all(d == digs[0]
                                                    for d in digs):
            return digs[0]
        last = digs
        time.sleep(0.3)
    raise AssertionError(f"replicas never converged: {last}")


def test_sweeper_converges_dropped_repairs_under_storm_gate(tmp_path):
    """The gate, end to end:

    1. healthy R=2 group (2 ranks), 300 rows ingested + saved, repair
       queue shrunk to ONE slot;
    2. SIGKILL replica 1; delete 12 ids (acks at quorum 1; replica 1
       misses them); golden = post-delete search;
    3. mux query storm; ingest 4 more batches through the outage — the
       1-slot queue provably DROPS records (degraded=true) and the
       client NEVER calls repair_under_replicated();
    4. restart replica 1 from its (pre-delete, pre-ingest) storage: the
       server-side sweep alone pulls the missing rows, applies the
       deletes, and both replicas converge to byte-identical wire
       digests;
    5. SIGKILL replica 1 again mid-heal, restart: no torn generation —
       it loads, re-heals, re-converges;
    6. zero storm errors, every storm result byte-identical to golden,
       no deleted id ever served; reads pinned onto the healed replica
       serve golden on the SAME client; the compaction lease sits on
       exactly one live replica of the group.
    """
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(2, disc, storage, base_port=free_base(2), env=ENV,
                       device="cpu") as h:
        client = IndexClient(
            disc, replication_cfg=ReplicationCfg(
                replication=2, write_quorum=1, repair_queue_len=1))
        group = client.membership.group_of(0)
        assert client.membership.replicas(group) == [0, 1]
        client.create_index("gidx", flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, DIM)).astype(np.float32)
        acked = set()
        for s in range(0, 300, 50):
            ids = [(i,) for i in range(s, s + 50)]
            client.add_index_data("gidx", x[s:s + 50], ids)
            acked.update(i for (i,) in ids)
        wait_drained(client, "gidx", 300)
        client.save_index("gidx")

        victim_pos = 1
        victim_rank = client.sub_indexes[victim_pos].port - h.base_port
        victim_port = client.sub_indexes[victim_pos].port
        survivor_port = client.sub_indexes[0].port
        victim_dir = os.path.join(storage, "gidx", str(victim_rank))
        assert serialization.list_generations(victim_dir)

        # ---- kill the victim, then mutate while it is down (mid-ingest)
        h.kill(victim_rank)
        doomed = list(range(0, 12))
        removed = client.remove_ids("gidx", doomed)
        assert removed == len(doomed)
        acked -= set(doomed)
        dead_meta = {(i,) for i in doomed}

        # ingest through the outage: every batch acks at quorum 1 on the
        # survivor; the 1-slot repair queue PROVABLY drops records (the
        # delete record + 4 add records -> >= 3 dropped). Ingest runs
        # BEFORE the storm window (a lone live replica draining its
        # buffer is legitimately in ADD and rejects searches — an engine
        # contract, not an anti-entropy gap; the replication gate makes
        # the same split). The far rows sit far from every query, so the
        # golden top-5 is invariant under them.
        far = (rng.standard_normal((200, DIM)) + 50.0).astype(np.float32)
        for s in range(0, 200, 50):
            ids = [(300 + s + i,) for i in range(50)]
            client.add_index_data("gidx", far[s:s + 50], ids)
            acked.update(i for (i,) in ids)
        repl = client.get_replication_stats()
        assert repl["repair"]["dropped"] >= 3, repl["repair"]
        assert repl["degraded"] is True
        assert len(client.repair_queue) == 1  # only ONE record survives
        survivor = client.sub_indexes[0]
        deadline = time.time() + 120
        while survivor.generic_fun("get_aggregated_ntotal", ("gidx",)) > 0:
            assert time.time() < deadline, "survivor never drained"
            time.sleep(0.2)

        # golden AFTER the mutations (served by the survivor via failover)
        q = np.ascontiguousarray(x[50:58])
        g_scores, g_meta = client.search(q, 5, "gidx")
        assert not any(m in dead_meta for row in g_meta for m in row)

        def reload_gidx():
            # restart mechanics only (NOT a repair call): point the
            # restarted process back at its on-disk gidx generation —
            # stale by 12 deletes and 200 rows, which the sweep must heal
            deadline = time.time() + 60
            while True:
                try:
                    client.sub_indexes[victim_pos].generic_fun(
                        "load_index", ("gidx", None), timeout=30.0)
                    return
                except Exception:
                    assert time.time() < deadline, "victim never reloaded"
                    time.sleep(0.3)

        with QueryStorm(client, "gidx", q, 5, threads=4) as storm:
            time.sleep(0.5)  # storm baseline against the degraded group

            # ---- restart from (stale) storage; ZERO client repair calls:
            # the sweepers alone must converge the group
            h.restart(victim_rank,
                      extra_env={"DFT_SHARD_GROUP": str(group)})
            h.wait_port(victim_rank)
            reload_gidx()
            wait_converged([survivor_port, victim_port], "gidx")

            # ---- SIGKILL again mid-heal window, restart: the heal's
            # commits ride the generation protocol — no torn state
            h.kill(victim_rank)
            time.sleep(0.3)
            h.restart(victim_rank,
                      extra_env={"DFT_SHARD_GROUP": str(group)})
            h.wait_port(victim_rank)
            reload_gidx()
            final_digest = wait_converged([survivor_port, victim_port],
                                          "gidx")
            time.sleep(1.0)  # storm keeps sampling the converged group
        results, errors = storm.stop()

        assert errors == [], f"storm saw search errors: {errors[:3]}"
        assert len(results) >= 10, "storm produced too few samples"
        for scores, meta in results:
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta
            assert not any(m in dead_meta for row in meta for m in row)

        # digests converged byte-identically and carry the deletes
        assert final_digest["dead_n"] >= len(doomed)

        # the victim really drained its pulled rows, then serves golden
        # on the SAME client when reads pin onto it
        deadline = time.time() + 120
        while client.get_buffer_depth("gidx") > 0:
            assert time.time() < deadline, "healed rank never drained"
            time.sleep(0.2)
        with client._lock:
            client._preferred[group] = victim_pos
        scores2, meta2 = client.search(q, 5, "gidx")
        np.testing.assert_array_equal(scores2, g_scores)
        assert meta2 == g_meta
        served = client.sub_indexes[victim_pos].generic_fun("get_perf_stats")
        assert served.get("search", {}).get("count", 0) >= 1, (
            "pinned search was not served by the healed rank")
        # the healed rank repaired rows server-side (its own counters)
        ae = served["antientropy"]
        assert ae["enabled"] and (ae["rows_repaired"] > 0
                                  or ae["full_syncs"] > 0)

        # no acked id lost, no deleted id resurrected, cluster-wide
        present = set(client.get_ids("gidx"))
        lost = acked - present
        assert not lost, f"{len(lost)} acked ids lost: {sorted(lost)[:10]}"
        assert not (set(doomed) & present), "deleted ids resurrected"

        # ---- compaction lease: exactly one live replica holds it
        held = []
        for port in (survivor_port, victim_port):
            health = rpc.Client(9, "localhost", port,
                                mux=False).generic_fun("get_health")
            held.append(bool(health["compaction"]["held"]))
        assert held.count(True) == 1, held
        client.close()
