"""The port of tests/test_versions_chaos.py, with its marks, sizes and
knobs, on rank processes of the port (``device="cpu"``). Per-id version
acceptance gate: upserts RACING deletes
across an R=2 group under a live mux query storm, with the victim
SIGKILLed (twice — the second kill lands mid-sweep/heal) and restarted
from pre-mutation storage. Every replica must converge to the LAST
WRITER's value — the upserted rows survive the replica that only ever
saw the delete (the interleaving where a delete used to win and
lose the upsert), nothing resurrects, and a client repair replay of the
outage's records double-applies NOTHING (versioned no-op fast path).
Convergence is verified by byte-identical wire digests (including the
versioned live_vhash plane) and golden result comparison; the same
cluster then serves ``search_at_generation`` against the PRE-mutation
retained generations."""

import os
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_base

pytestmark = [pytest.mark.versions, pytest.mark.chaos, pytest.mark.slow]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fast sweeps so convergence lands inside the test budget; compaction off
# to keep the gate focused on LWW reconciliation
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
    resp = rpc.digest_exchange(
        "localhost", port, {"rank": None, "group": None, "want": None},
        timeout=timeout)
    return resp["digests"].get(index_id)


def wait_converged(ports, index_id, timeout=90.0):
    """Poll both ranks' wire digests until byte-identical (dict equality
    covers the versioned live_vhash plane too)."""
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


def test_upsert_vs_delete_storm_converges_to_last_writer_gate(tmp_path):
    """The gate, end to end:

    1. healthy R=2 group, 240 rows ingested + saved on both replicas;
       pre-mutation generations PINNED (the point-in-time handle);
    2. delete a victim-id set on BOTH replicas (versioned), then SIGKILL
       replica 1 and UPSERT the same ids with fresh vectors — replica 1
       now holds only the delete, the survivor the newer re-add: the
       delete-wins interleaving that used to destroy the upsert;
    3. golden = post-mutation search on the survivor (upserted vectors
       must surface); mux query storm starts against the degraded group;
    4. restart replica 1 from its stale storage — the sweepers alone
       must converge it to the LAST WRITER (upserts live, nothing
       resurrected), through a second SIGKILL landing mid-sweep;
    5. byte-identical wire digests (id AND version planes), zero storm
       errors, every storm result byte-identical to golden, reads pinned
       onto the healed replica serve golden;
    6. the client's repair replay of the outage's records double-applies
       NOTHING on the healed replica (versioned no-ops, counted);
    7. ``search_at_generation`` with the pre-mutation pins returns the
       PRE-mutation results on the same cluster.
    """
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(2, disc, storage, base_port=free_base(2), env=ENV,
                       device="cpu") as h:
        client = IndexClient(
            disc, replication_cfg=ReplicationCfg(
                replication=2, write_quorum=1))
        group = client.membership.group_of(0)
        assert client.membership.replicas(group) == [0, 1]
        client.create_index("vidx", flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((240, DIM)).astype(np.float32)
        for s in range(0, 240, 60):
            client.add_index_data("vidx", x[s:s + 60],
                                  [(i,) for i in range(s, s + 60)])
        wait_drained(client, "vidx", 240)
        client.save_index("vidx")

        # the point-in-time handle, taken BEFORE any mutation
        pins = client.pin_generations("vidx")
        assert set(pins) == {0, 1}, pins
        q = np.ascontiguousarray(x[50:58])
        pre_scores, pre_meta = client.search(q, 5, "vidx")

        victim_pos = 1
        victim_rank = client.sub_indexes[victim_pos].port - h.base_port
        victim_port = client.sub_indexes[victim_pos].port
        survivor_port = client.sub_indexes[0].port

        # ---- the race: delete lands EVERYWHERE, upsert only on the
        # survivor (the victim is down) — the replica that only saw the
        # delete used to win reconciliation and destroy the upsert
        doomed = list(range(50, 58))
        removed = client.remove_ids("vidx", doomed)
        assert removed == len(doomed)
        h.kill(victim_rank)
        new_vecs = (x[doomed] + 0.25).astype(np.float32)
        client.upsert("vidx", doomed, new_vecs,
                      [(i,) for i in doomed])
        # plus plain ingest through the outage (repair records pile up)
        far = (rng.standard_normal((60, DIM)) + 50.0).astype(np.float32)
        client.add_index_data("vidx", far,
                              [(240 + i,) for i in range(60)])
        repl = client.get_replication_stats()
        assert repl["repair"]["pending"] >= 1, repl["repair"]
        survivor = client.sub_indexes[0]
        deadline = time.time() + 120
        while survivor.generic_fun("get_aggregated_ntotal", ("vidx",)) > 0:
            assert time.time() < deadline, "survivor never drained"
            time.sleep(0.2)

        # golden AFTER the mutations: the UPSERTED vectors must be the
        # top hits for their own queries (the last writer's value)
        g_scores, g_meta = client.search(q, 5, "vidx")
        upq = np.ascontiguousarray(new_vecs)
        gu_scores, gu_meta = client.search(upq, 1, "vidx")
        assert [m[0] for m in gu_meta] == [(i,) for i in doomed]

        def reload_vidx():
            deadline = time.time() + 60
            while True:
                try:
                    client.sub_indexes[victim_pos].generic_fun(
                        "load_index", ("vidx", None), timeout=30.0)
                    return
                except Exception:
                    assert time.time() < deadline, "victim never reloaded"
                    time.sleep(0.3)

        with QueryStorm(client, "vidx", q, 5, threads=4) as storm:
            time.sleep(0.5)  # storm baseline against the degraded group

            # ---- restart from stale (delete-only) storage: the sweep
            # must converge to the last writer, not delete-wins
            h.restart(victim_rank,
                      extra_env={"DFT_SHARD_GROUP": str(group)})
            h.wait_port(victim_rank)
            reload_vidx()
            wait_converged([survivor_port, victim_port], "vidx")

            # ---- SIGKILL again mid-sweep window, restart, re-converge
            h.kill(victim_rank)
            time.sleep(0.3)
            h.restart(victim_rank,
                      extra_env={"DFT_SHARD_GROUP": str(group)})
            h.wait_port(victim_rank)
            reload_vidx()
            final_digest = wait_converged([survivor_port, victim_port],
                                          "vidx")
            time.sleep(1.0)  # storm keeps sampling the converged group
        results, errors = storm.stop()

        assert errors == [], f"storm saw search errors: {errors[:3]}"
        assert len(results) >= 10, "storm produced too few samples"
        for scores, meta in results:
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta

        # digests carry both planes and the deletes' ledger entries
        assert "live_vhash" in final_digest
        assert final_digest["dead_n"] >= 0

        # the healed replica serves the LAST WRITER's values: pin reads
        # onto it — the upserted vectors hit, byte-identical to golden
        deadline = time.time() + 120
        while client.get_buffer_depth("vidx") > 0:
            assert time.time() < deadline, "healed rank never drained"
            time.sleep(0.2)
        with client._lock:
            client._preferred[group] = victim_pos
        v_scores, v_meta = client.search(upq, 1, "vidx")
        np.testing.assert_array_equal(v_scores, gu_scores)
        assert v_meta == gu_meta
        v_scores5, v_meta5 = client.search(q, 5, "vidx")
        np.testing.assert_array_equal(v_scores5, g_scores)
        assert v_meta5 == g_meta

        # ---- zero double-applies: replay the outage's repair records
        # against the ALREADY-HEALED replica — versioned no-ops only
        stub = client.sub_indexes[victim_pos]
        nt_before = stub.generic_fun("get_ntotal", ("vidx",))
        dg_before = rank_digest(victim_port, "vidx")
        out = client.repair_under_replicated()
        assert out["still_pending"] == 0, out
        deadline = time.time() + 60
        while stub.generic_fun("get_aggregated_ntotal", ("vidx",)) > 0:
            assert time.time() < deadline
            time.sleep(0.2)
        assert stub.generic_fun("get_ntotal", ("vidx",)) == nt_before
        assert rank_digest(victim_port, "vidx") == dg_before
        mut = stub.generic_fun("get_perf_stats")["mutation"]["vidx"]
        assert (mut["version_noop_adds"] > 0
                or mut["version_noop_deletes"] > 0), mut

        # no acked id lost, upserted ids live everywhere, cluster-wide
        present = set(client.get_ids("vidx"))
        assert set(doomed) <= present, "upserted ids lost (delete won)"
        assert {240 + i for i in range(60)} <= present

        # ---- point-in-time: the PRE-mutation pins still serve the
        # pre-mutation truth on the same (now fully mutated) cluster
        pin_scores, pin_meta = client.search_at_generation(
            q, 5, "vidx", pins=pins)
        np.testing.assert_array_equal(pin_scores, pre_scores)
        assert pin_meta == pre_meta
        client.close()
