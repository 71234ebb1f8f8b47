"""Mutation acceptance gates of the port (the port of
tests/test_mutation_chaos.py, with its marks and sizes), and the two crash
windows that both packages' ``Index.compact`` docstrings name, held on
the port's storage dir by both packages.

The slow gates: on an R=2 replicated cluster of port rank processes
(``device="cpu"``) under a live mux query storm, delete 30% of one
group's ids, trigger compaction, SIGKILL the compacting rank mid-pass —
no deleted id may ever appear in any storm result, the rank must restart
on the pre-compaction generation with tombstones intact, and
post-restart results must be byte-identical to a freshly built index
over the surviving rows; and a compaction that runs to commit under a
storm changes no result byte.

The fast cases (tier-1): the engine hook ``DFT_COMPACT_TEST_DELAY_S``
(honoured, serving live during it), then each crash window in a child
process of the port on the CPU:

- SIGKILL inside the rebuild (phase 2, widened by the hook);
- SIGKILL after the compacted generation's MANIFEST landed and before
  the standalone tombstone sidecar was rewritten (the child kills itself
  at that write), with a delete carried into the new layout.

After each, the storage dir is loaded by both packages'
``Index.from_storage_dir``: the same live ids, the same deleted ids and
the same top-k ids (and distances within 1e-3) on tie-free queries; the
port's top-k also equals a freshly built exact index over the survivors.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_base, read_line

pytestmark = [pytest.mark.mutation]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# DFT_COMPACT=0: the gate triggers compaction explicitly (compact_index)
# so the SIGKILL lands deterministically inside the widened mid-pass
# window (DFT_COMPACT_TEST_DELAY_S)
ENV = {"PYTHONPATH": REPO_ROOT, "DFT_COMPACT": "0", "DFT_COMPACT_TEST_DELAY_S": "4.0"}

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


@pytest.mark.chaos
@pytest.mark.slow
def test_sigkill_mid_compaction_under_storm_gate(tmp_path):
    """The gate, end to end:

    1. healthy R=2 cluster (4 ranks, 2 groups), 300 rows ingested + saved;
    2. delete 30% of group 0's ids cluster-wide (quorum delete);
    3. golden = post-delete search; verified byte-identical against a
       freshly built local index over the surviving rows;
    4. 4-thread mux query storm; trigger compaction on one group-0 replica
       and SIGKILL it inside the pass (before its commit point);
    5. zero storm errors, every storm result byte-identical to golden, no
       deleted id in any result (failover + the peer's tombstones);
    6. restart the victim from storage: it comes back on the
       PRE-compaction generation with tombstones intact (sidecar), pinned
       reads serve golden again on the same client.
    """
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(4, disc, storage, base_port=free_base(4), env=ENV,
                       device="cpu") as h:
        client = IndexClient(
            disc, replication_cfg=ReplicationCfg(replication=2,
                                                 write_quorum=1))
        client.create_index("gidx", flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, DIM)).astype(np.float32)
        for s in range(0, 300, 50):
            client.add_index_data("gidx", x[s:s + 50],
                                  [(i,) for i in range(s, s + 50)])
        wait_drained(client, "gidx", 300)
        client.save_index("gidx")

        # ---- delete 30% of ONE group's ids (cluster-wide quorum delete)
        group = 0
        g0_pos = client.membership.replicas(group)[0]
        g0_ids = sorted(client.sub_indexes[g0_pos].generic_fun(
            "get_ids", ("gidx",)))
        doomed = g0_ids[: max(1, int(0.3 * len(g0_ids)))]
        removed = client.remove_ids("gidx", doomed)
        assert removed == len(doomed)
        dead_meta = {(i,) for i in doomed}

        # ---- golden AND the freshly-built-over-survivors oracle
        q = np.ascontiguousarray(x[:8])
        g_scores, g_meta = client.search(q, 5, "gidx")
        survivors = [i for i in range(300) if i not in set(doomed)]
        fresh = FlatIndex(DIM, "l2", device="cpu")
        fresh.train(x)
        fresh.add(x[survivors])
        f_scores, f_ids = fresh.search(q, 5)
        np.testing.assert_array_equal(g_scores, f_scores)
        assert g_meta == [[(survivors[j],) for j in row]
                          for row in f_ids.tolist()]

        # ---- storm + compaction + SIGKILL mid-pass
        victim_pos = g0_pos
        victim_rank = client.sub_indexes[victim_pos].port - h.base_port
        victim_dir = os.path.join(storage, "gidx", str(victim_rank))
        gens_before = serialization.list_generations(victim_dir)
        assert gens_before, "victim never committed its save"

        compact_err = []

        def trigger_compaction():
            try:
                client.sub_indexes[victim_pos].generic_fun(
                    "compact_index", ("gidx",), timeout=30.0)
            except Exception as e:  # the kill lands mid-call: expected
                compact_err.append(e)

        with QueryStorm(client, "gidx", q, 5, threads=4) as storm:
            time.sleep(0.7)  # storm baseline against the healthy cluster
            t = threading.Thread(target=trigger_compaction, daemon=True)
            t.start()
            time.sleep(1.5)  # compaction is inside its (4s) mid-pass window
            h.kill(victim_rank)
            time.sleep(1.5)  # storm keeps running against the outage
        results, errors = storm.stop()

        assert errors == [], f"storm saw search errors: {errors[:3]}"
        assert len(results) >= 10, "storm produced too few samples"
        for scores, meta in results:
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta
            assert not any(m in dead_meta for row in meta for m in row)

        # ---- the killed compaction never committed a generation
        assert (serialization.list_generations(victim_dir)[0][0]
                == gens_before[0][0])

        # ---- restart from storage: pre-compaction generation + sidecar
        h.restart(victim_rank, load_index=False,
                  extra_env={"DFT_SHARD_GROUP": str(group)})
        h.wait_port(victim_rank)
        deadline = time.time() + 60
        while True:
            try:
                assert client.sub_indexes[victim_pos].generic_fun(
                    "load_index", ("gidx", None), timeout=30.0)
                stats = client.sub_indexes[victim_pos].generic_fun(
                    "get_perf_stats", timeout=10.0)
                if stats["mutation"]["gidx"]["tombstoned_rows"] \
                        == len(doomed):
                    break
            except AssertionError:
                raise
            except Exception:
                pass
            assert time.time() < deadline, "victim never restored tombstones"
            time.sleep(0.3)
        mu = stats["mutation"]["gidx"]
        assert mu["compactions"] == 0  # it restarted PRE-compaction
        assert mu["live_fraction"] == pytest.approx(
            1.0 - len(doomed) / len(g0_ids))

        # pinned reads on the restarted rank: byte-identical to golden ==
        # byte-identical to the freshly built index over survivors
        with client._lock:
            client._preferred[group] = victim_pos
        scores2, meta2 = client.search(q, 5, "gidx")
        np.testing.assert_array_equal(scores2, g_scores)
        assert meta2 == g_meta
        served = client.sub_indexes[victim_pos].generic_fun("get_perf_stats")
        assert served.get("search", {}).get("count", 0) >= 1, (
            "pinned search was not served by the restarted rank")
        client.close()


@pytest.mark.chaos
@pytest.mark.slow
def test_compaction_commits_and_serves_identically_under_storm(tmp_path):
    """The non-crash half: a compaction that RUNS TO COMMIT under a live
    storm changes no result byte and reclaims the tombstones."""
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    env = dict(ENV, DFT_COMPACT_TEST_DELAY_S="0.5")
    with ServerHarness(2, disc, storage, base_port=free_base(2), env=env,
                       device="cpu"):
        client = IndexClient(disc, replication_cfg=ReplicationCfg())
        client.create_index("cidx", flat_cfg())
        rng = np.random.default_rng(1)
        x = rng.standard_normal((200, DIM)).astype(np.float32)
        for s in range(0, 200, 50):
            client.add_index_data("cidx", x[s:s + 50],
                                  [(i,) for i in range(s, s + 50)])
        wait_drained(client, "cidx", 200)
        client.save_index("cidx")
        client.remove_ids("cidx", list(range(0, 60)))
        q = np.ascontiguousarray(x[100:108])
        g_scores, g_meta = client.search(q, 5, "cidx")

        with QueryStorm(client, "cidx", q, 5, threads=4) as storm:
            time.sleep(0.3)
            outcomes = client.compact_index("cidx")
            time.sleep(0.5)
        results, errors = storm.stop()
        assert errors == []
        assert any(outcomes)  # ranks holding tombstones compacted
        for scores, meta in results:
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta
        # post-compaction: same bytes, tombstones reclaimed
        scores2, meta2 = client.search(q, 5, "cidx")
        np.testing.assert_array_equal(scores2, g_scores)
        assert meta2 == g_meta
        for entry in client.get_perf_stats():
            mu = entry["mutation"]["cidx"]
            assert mu["tombstoned_rows"] == 0 or mu["compactions"] >= 1
        client.close()


# ------------------------------------------------- the hook and the windows

N = 300
K = 5
# every third id is deleted before the compaction; LATE_ID during it
DOOMED = list(range(0, N, 3))
LATE_ID = 100
# a query row is tie-free when its exact top-(K+1) distances are this far
# apart, relative to the row's scale
TIE_REL = 1e-4
WINDOW_CFGS = {
    "flat": dict(index_builder_type="flat"),
    # every list probed: the exact answer whatever the centroids
    "ivf_simple": dict(index_builder_type="ivf_simple", centroids=4, nprobe=4),
}


def corpus():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    return x, q


def window_engine(storage, builder):
    x, _q = corpus()
    cfg = IndexCfg(dim=DIM, metric="l2", train_num=50, index_storage_dir=storage,
                   **WINDOW_CFGS[builder])
    idx = TIndex(cfg, device="cpu")
    idx.add_batch(x, [(i,) for i in range(N)], train_async_if_triggered=False)
    deadline = time.time() + 60
    while not (idx.get_state() == IndexState.TRAINED and idx.get_idx_data_num() == (0, N)):
        assert time.time() < deadline, "train/drain timed out"
        time.sleep(0.02)
    return idx


def test_compact_test_delay_is_honoured_with_serving_live(tmp_path, monkeypatch):
    """DFT_COMPACT_TEST_DELAY_S sleeps inside the rebuild, after the
    phase-1 snapshot and with no lock held: searches keep answering (the
    tombstoned rows masked) and the generation stays put until the
    commit; unset, the compaction does not wait."""
    monkeypatch.setenv("DFT_COMPACT", "0")
    monkeypatch.delenv("DFT_COMPACT_TEST_DELAY_S", raising=False)
    x, q = corpus()
    idx = window_engine(str(tmp_path / "shard"), "flat")
    assert idx.save()
    idx.remove_ids(DOOMED)
    golden = idx.search(q, K)
    gen0 = idx.current_generation()

    delay = 2.0
    monkeypatch.setenv("DFT_COMPACT_TEST_DELAY_S", str(delay))
    done = {}
    t = threading.Thread(target=lambda: done.update(ok=idx.compact(), t=time.perf_counter()),
                         daemon=True)
    t0 = time.perf_counter()
    t.start()
    served, slowest = 0, 0.0
    while t.is_alive():
        assert time.perf_counter() - t0 < 60, "the compaction never finished"
        t1 = time.perf_counter()
        scores, meta, _ = idx.search(q, K)
        gen = idx.current_generation()
        # the commit comes after the delay's sleep, and the thread lives on
        # a moment past the commit: before the delay is up, no commit
        if time.perf_counter() - t0 < delay:
            assert gen == gen0
        if t.is_alive():
            served += 1
            slowest = max(slowest, time.perf_counter() - t1)
        np.testing.assert_array_equal(scores, golden[0])
        assert meta == golden[1]
        assert not any(m[0] in DOOMED for row in meta for m in row)
        time.sleep(0.01)
    t.join(timeout=60)
    assert not t.is_alive()
    assert done["ok"] and done["t"] - t0 >= delay
    # searches answered during the delay, none held for it
    assert served >= 2 and slowest < delay / 2, (served, slowest)
    assert idx.current_generation() > gen0
    assert idx.mutation_stats()["compactions"] == 1
    scores, meta, _ = idx.search(q, K)
    np.testing.assert_array_equal(scores, golden[0])
    assert meta == golden[1]

    # unset: the default is 0.0, no wait
    monkeypatch.delenv("DFT_COMPACT_TEST_DELAY_S")
    idx.remove_ids([1, 2])
    t0 = time.perf_counter()
    assert idx.compact()
    assert time.perf_counter() - t0 < 1.0
    idx.retire()


CHILD = r"""
import os, signal, sys, threading, time
sys.path.insert(0, {repo!r})
import numpy as np
from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.mutation import tombstones
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

storage, window = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0)
x = rng.standard_normal(({n}, {dim})).astype(np.float32)
idx = Index(IndexCfg(dim={dim}, metric="l2", train_num=50, index_storage_dir=storage,
                     **{cfg!r}), device="cpu")
idx.add_batch(x, [(i,) for i in range({n})], train_async_if_triggered=False)
while not (idx.get_state() == IndexState.TRAINED and idx.get_idx_data_num() == (0, {n})):
    time.sleep(0.01)
assert idx.save()
idx.remove_ids({doomed!r})
if window == "sidecar":
    layout = idx.tombstones.layout
    write = tombstones.write_sidecar

    def crash_at_compacted_sidecar(storage_dir, payload):
        # the standalone sidecar rewrite of the compacted layout comes right
        # after the new generation's MANIFEST: the process dies there
        if payload.get("layout") != layout:
            os.kill(os.getpid(), signal.SIGKILL)
        write(storage_dir, payload)

    tombstones.write_sidecar = crash_at_compacted_sidecar

    def late_delete():
        time.sleep(0.3)  # inside the rebuild: carried onto the new layout
        idx.remove_ids([{late}])

    threading.Thread(target=late_delete).start()
print("COMPACTING", flush=True)
idx.compact()
print("COMMITTED", flush=True)
"""


def run_window(tmp_path, builder, window):
    """Run the child to its crash; the storage dir and the generation it
    had committed before compacting."""
    storage = str(tmp_path / f"{builder}-{window}")
    script = tmp_path / f"child-{builder}-{window}.py"
    script.write_text(CHILD.format(repo=REPO_ROOT, n=N, dim=DIM, cfg=WINDOW_CFGS[builder],
                                   doomed=DOOMED, late=LATE_ID))
    delay = "30.0" if window == "rebuild" else "1.0"
    env = {**os.environ, "DFT_COMPACT": "0", "DFT_COMPACT_TEST_DELAY_S": delay}
    err = tmp_path / f"child-{builder}-{window}.err"
    with open(err, "w") as err_file:
        proc = subprocess.Popen([sys.executable, str(script), storage, window], env=env,
                                stdout=subprocess.PIPE, stderr=err_file, text=True)
    try:
        assert read_line(proc, err).strip() == "COMPACTING"
        gen_before = serialization.list_generations(storage)[0][0]
        if window == "rebuild":
            time.sleep(0.5)  # the rebuild sleeps 30 s: the kill lands inside it
            proc.kill()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGKILL, proc.returncode
    assert proc.stdout.read() == ""  # it never reported a commit
    return storage, gen_before


def tie_free(x, q):
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    top = np.sort(d2, axis=1)[:, : K + 1]
    return np.diff(top, axis=1).min(axis=1) > TIE_REL * np.maximum(1.0, top[:, -1])


def held_by_both(storage, dead):
    """Both packages load the dir alike, and the port serves the exact
    top-k over the survivors."""
    from distributed_faiss_tpu.engine import Index as JIndex
    from distributed_faiss_tpu_torch.mutation.tombstones import id_match_key

    x, q = corpus()
    t = TIndex.from_storage_dir(storage, device="cpu")
    j = JIndex.from_storage_dir(storage)
    try:
        live = set(range(N)) - dead
        assert t.get_ids() == j.get_ids() == live
        t_sets, j_sets = t.id_sets(), j.id_sets()
        assert {id_match_key(k) for k in t_sets["dead"]} == \
            {id_match_key(k) for k in j_sets["dead"]} == dead
        survivors = np.asarray(sorted(live))
        golden = FlatIndex(DIM, "l2", device="cpu")
        golden.train(x)
        golden.add(x[survivors])
        g_scores, g_pos = golden.search(q, K)
        t_scores, t_meta, _ = t.search(q, K)
        j_scores, j_meta, _ = j.search(q, K)
        free = np.flatnonzero(tie_free(x[survivors], q))
        assert free.size >= q.shape[0] // 2
        for i in free:
            want = [(int(survivors[p]),) for p in g_pos[i]]
            assert t_meta[i] == j_meta[i] == want, (i, t_meta[i], j_meta[i], want)
            np.testing.assert_allclose(t_scores[i], g_scores[i], rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(j_scores[i], g_scores[i], rtol=1e-3, atol=1e-3)
        return t
    finally:
        j.retire()


@pytest.mark.parametrize("builder", list(WINDOW_CFGS))
def test_sigkill_inside_the_rebuild_loads_the_previous_generation(tmp_path, builder):
    """Window 1: SIGKILL inside the rebuild. Nothing of the compaction was
    committed: the pre-compaction generation loads with its tombstones in
    both packages."""
    storage, gen_before = run_window(tmp_path, builder, "rebuild")
    assert serialization.list_generations(storage)[0][0] == gen_before
    t = held_by_both(storage, set(DOOMED))
    assert t.current_generation() == gen_before
    assert t.mutation_stats()["tombstoned_rows"] == len(DOOMED)
    t.retire()


@pytest.mark.parametrize("builder", list(WINDOW_CFGS))
def test_sigkill_after_the_manifest_before_the_sidecar(tmp_path, builder):
    """Window 2: SIGKILL after the compacted generation's MANIFEST landed,
    before the standalone sidecar was rewritten. The new generation loads
    with its own payload (the late delete carried onto the new layout);
    the standalone sidecar, still of the old layout, changes nothing."""
    from distributed_faiss_tpu_torch.mutation import tombstones

    storage, gen_before = run_window(tmp_path, builder, "sidecar")
    gen, mpath = serialization.list_generations(storage)[0]
    manifest = serialization.load_manifest(mpath)
    assert gen > gen_before and manifest["compacted"] is True
    assert tombstones.load_sidecar(storage)["layout"] != gen  # the stale one
    t = held_by_both(storage, set(DOOMED) | {LATE_ID})
    assert t.current_generation() == gen
    assert t.model.ntotal == N - len(DOOMED)
    assert t.mutation_stats()["tombstoned_rows"] == 1  # the carried late delete
    t.retire()
