"""Replica clusters of the port on the CPU: four ``IndexServer(device="cpu")``
ranks in one process on free loopback ports, in two groups of R = 2, under
one ``IndexClient``. The same script runs on a cluster of JAX servers and
must give the same ids at each step and the same final digests (a ``flat``
index; clients with the same injected clock and placement). Then the
replica paths on their own: quorum acks and ``QuorumError``, the reroute
past a dead group, partial results that name a group only when both its
replicas are dead, ``get_ntotal`` counting each group once, sweeps that
never bring back a deleted id or a dropped index, the compaction lease,
``resync_rank``; and, marked slow, the SIGKILL-under-storm gate over the
port's ``ServerHarness`` with ``--device cpu`` ranks."""

import os
import socket
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.mutation import versions as jversions
from distributed_faiss_tpu.parallel import rpc as jrpc
from distributed_faiss_tpu.parallel.client import IndexClient as JClient
from distributed_faiss_tpu.parallel.server import IndexServer as JServer
from distributed_faiss_tpu.utils.config import AntiEntropyCfg as JAntiEntropyCfg
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.config import ReplicationCfg as JReplicationCfg
from distributed_faiss_tpu_torch.mutation import versions as tversions
from distributed_faiss_tpu_torch.parallel import antientropy, rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient, QuorumError
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg, IndexCfg, ReplicationCfg

D = 16


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("DFT_COMPACT", "0")
    monkeypatch.delenv("DFT_SHARD_GROUP", raising=False)


def free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def free_base(n: int) -> int:
    """A base port below the ephemeral range whose next ``n`` ports bind now."""
    rng = np.random.default_rng()
    while True:
        base = int(rng.integers(20000, 29000))
        try:
            for p in range(base, base + n):
                socket.create_server(("", p)).close()
            return base
        except OSError:
            continue


def wait_until(pred, timeout=60.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, msg
        time.sleep(0.02)


PKGS = {
    "port": dict(server=lambda r, store, disc, cfg: IndexServer(
                     r, store, device="cpu", discovery_path=disc, antientropy_cfg=cfg),
                 client=IndexClient, idx_cfg=IndexCfg, rcfg=ReplicationCfg,
                 aecfg=AntiEntropyCfg, versions=tversions, rpc=rpc, lock="_lock"),
    "jax": dict(server=lambda r, store, disc, cfg: JServer(
                    r, store, discovery_path=disc, antientropy_cfg=cfg),
                client=JClient, idx_cfg=JCfg, rcfg=JReplicationCfg,
                aecfg=JAntiEntropyCfg, versions=jversions, rpc=jrpc, lock="_stats_lock"),
}


class Cluster:
    """``n`` ranks of one package on free loopback ports, a discovery file,
    sweepers that only run when a test calls ``sweep``, and a client with
    R = 2 and ``write_quorum``."""

    def __init__(self, tmp_path, pkg="port", n=4, write_quorum=1, **rcfg):
        self.p = PKGS[pkg]
        self.tmp = tmp_path
        self.store = str(tmp_path / f"store-{pkg}")
        self.ports = [free_port() for _ in range(n)]
        self.disc = str(tmp_path / f"disc-{pkg}.txt")
        with open(self.disc, "w") as f:
            f.write(f"{n}\n" + "".join(f"localhost,{p}\n" for p in self.ports))
        self.servers = [self.start(r) for r in range(n)]
        self.client = self.p["client"](
            self.disc, replication_cfg=self.p["rcfg"](replication=2, write_quorum=write_quorum,
                                                      **rcfg),
            retry_policy=self.p["rpc"].RetryPolicy(max_attempts=1))

    def start(self, rank, group=None):
        if group is not None:
            os.environ["DFT_SHARD_GROUP"] = str(group)
        try:
            srv = self.p["server"](rank, self.store, self.disc,
                                   self.p["aecfg"](interval_s=600))
        finally:
            os.environ.pop("DFT_SHARD_GROUP", None)
        threading.Thread(target=srv.start_blocking, args=(self.ports[rank],),
                         daemon=True).start()
        wait_until(lambda: srv._antientropy is not None, msg="sweeper never started")
        return srv

    def restart(self, rank, group):
        self.servers[rank] = self.start(rank, group)
        stub = self.client.sub_indexes[rank]
        # the stub redials once its cooldown after the failed dials is over
        wait_until(lambda: _answers(stub), msg=f"rank {rank} never answered")

    def pin(self, group, pos):
        with getattr(self.client, self.p["lock"]):
            self.client._preferred[group] = pos

    def sweep(self):
        return [s._antientropy.sweep_once() for s in self.servers if s.socket is not None]

    def digests(self, iid):
        return [s.indexes[iid].replica_digest() for s in self.servers]

    def close(self):
        self.client.close()
        for s in self.servers:
            s.stop()


def _answers(stub) -> bool:
    try:
        stub.generic_fun("get_rank", timeout=5.0)
        return True
    except Exception:
        return False


@pytest.fixture
def cluster(tmp_path):
    made = []

    def make(**kw):
        c = Cluster(tmp_path, **kw)
        made.append(c)
        return c

    try:
        yield make
    finally:
        for c in made:
            c.close()


def _data(n=240, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32)


def _ingest(c, iid, x, start=0, bsz=20):
    for s in range(0, x.shape[0], bsz):
        c.client.add_index_data(iid, x[s:s + bsz], [(start + i,) for i in range(s, s + bsz)])


def _settled(c, iid, n):
    wait_until(lambda: c.client.get_ntotal(iid) == n and c.client.get_buffer_depth(iid) == 0,
               msg=f"{iid} never settled at {n} rows")


def _flat(cls, **kw):
    return cls(index_builder_type="flat", dim=D, metric="l2", train_num=10, **kw)


def _script(c, x, q):
    """Ingest, stop one replica of group 0, ingest + delete + upsert, restart
    it empty, sweep until its digests match its peer's, read pinned on it.
    Returns the ids served at each step and the final digests."""
    client = c.client
    fixed_ms = 1_700_000_000_000
    client._hlc = c.p["versions"].HLC(writer_id=7, clock_ms=lambda: fixed_ms)
    client.create_index("t", _flat(c.p["idx_cfg"]))
    client.cur_server_ids["t"] = 0
    _ingest(c, "t", x[:200])
    _settled(c, "t", 200)
    steps = [client.search(q, 5, "t")[1]]
    assert [s.get_ntotal("t") for s in c.servers] == [100] * 4
    c.servers[0].stop()
    _ingest(c, "t", x[200:240], start=200)
    assert client.remove_ids("t", [1, 2, 3, 203]) == 4
    assert client.upsert("t", [4], q[:1]) == 1
    wait_until(lambda: client.get_ntotal("t") == 241
               and all(s.get_aggregated_ntotal("t") == 0 for s in c.servers[1:]))
    steps.append(client.search(q, 5, "t")[1])
    c.restart(0, group=0)
    for _ in range(3):
        c.sweep()
    wait_until(lambda: c.servers[0].get_aggregated_ntotal("t") == 0)
    digests = c.digests("t")
    assert antientropy.digests_match(digests[0], digests[2]) and digests[0] == digests[2]
    c.pin(0, 0)
    steps.append(client.search(q, 5, "t")[1])
    c.pin(0, 2)
    steps.append(client.search(q, 5, "t")[1])
    return steps, digests


def test_four_rank_clusters_match_jax(cluster, tmp_path):
    """The port cluster and the JAX cluster give the same ids at every step
    of the script, and the same digests on every rank at the end; the
    healed rank serves like its survivor and no deleted id."""
    x = _data()
    q = x[:12] + 0.01
    port, jax_ = cluster(pkg="port"), cluster(pkg="jax")
    got, got_d = _script(port, x, q)
    want, want_d = _script(jax_, x, q)
    assert got == want
    assert got_d == want_d
    assert got[2] == got[3]
    served = {m[0] for step in got[1:] for row in step for m in row}
    assert not served & {1, 2, 3, 203}
    assert got[2][0][0] == (4,)  # the upserted row (at q[0]) is query 0's top-1
    assert port.servers[0]._antientropy.stats()["full_syncs"] == 1


def test_quorum_acks_and_quorum_error(cluster):
    """Quorum 1 acks with one replica dead and records it for repair; the
    repair re-send heals it once it is back. Quorum 2 refuses the same
    write with a QuorumError naming the dead replica, and the read-your-
    writes floor does not move."""
    x = _data(80)
    c = cluster(write_quorum=1)
    c.client.create_index("t", _flat(IndexCfg))
    c.client.cur_server_ids["t"] = 0
    _ingest(c, "t", x[:40])
    _settled(c, "t", 40)
    c.servers[2].stop()
    c.client.add_index_data("t", x[40:60], [(i,) for i in range(40, 60)])  # group 0
    stats = c.client.get_replication_stats()
    assert stats["counters"]["under_replicated"] == 1 and stats["repair"]["pending"] == 1
    assert c.client.repair_under_replicated() == {"repaired": 0, "still_pending": 1}
    c.restart(2, group=0)
    c.servers[2].load_index("t")
    assert c.client.repair_under_replicated() == {"repaired": 1, "still_pending": 0}
    wait_until(lambda: c.servers[2].get_ntotal("t") == c.servers[0].get_ntotal("t"))
    c.client.quorum = 2
    c.servers[2].stop()
    floor = c.client.last_write_version("t")
    c.client.cur_server_ids["t"] = 0
    with pytest.raises(QuorumError) as err:
        c.client.add_index_data("t", x[60:80], [(i,) for i in range(60, 80)])
    assert err.value.group == 0 and err.value.acked == [0] and err.value.needed == 2
    assert [f["server"] for f in err.value.failures] == [2]
    assert c.client.last_write_version("t") == floor
    with pytest.raises(QuorumError):
        c.client.remove_ids("t", [0])
    assert c.client.get_replication_stats()["counters"]["quorum_failures"] == 2


def test_reroute_when_a_whole_group_is_dead(cluster):
    """With both replicas of group 1 stopped, every batch lands on group 0,
    each skip is recorded, and a strict search raises while a partial one
    names both dead replicas."""
    x = _data(100)
    c = cluster()
    c.client.create_index("t", _flat(IndexCfg))
    _ingest(c, "t", x[:40])
    _settled(c, "t", 40)
    c.servers[1].stop()
    c.servers[3].stop()
    c.client.cur_server_ids["t"] = 1
    _ingest(c, "t", x[40:100], start=0)
    wait_until(lambda: c.servers[0].get_aggregated_ntotal("t") == 0)
    assert c.servers[0].get_ntotal("t") == c.servers[2].get_ntotal("t") == 80
    stats = c.client.get_replication_stats()["counters"]
    assert stats["reroutes"] == 2 * 3 and len(c.client.reroutes) == 6
    assert {r["rerouted_to"] for r in c.client.reroutes} == {0}
    with pytest.raises(rpc.TRANSPORT_ERRORS):
        c.client.search(x[:2], 3, "t")
    _d, _m, missing = c.client.search(x[:2], 3, "t", allow_partial=True, partial_timeout=5.0)
    assert sorted(m["server"] for m in missing) == [1, 3]


def test_partial_names_a_group_only_when_both_replicas_are_dead(cluster):
    x = _data(80)
    q = x[:6] + 0.01
    c = cluster()
    c.client.create_index("t", _flat(IndexCfg))
    _ingest(c, "t", x)
    _settled(c, "t", 80)
    full = c.client.search(q, 4, "t")
    c.servers[1].stop()
    d, m, missing = c.client.search(q, 4, "t", allow_partial=True, partial_timeout=5.0)
    assert missing == [] and m == full[1]
    np.testing.assert_array_equal(d, full[0])
    assert c.client.search(q, 4, "t")[1] == full[1]  # strict: failed over too
    assert c.client.get_replication_stats()["counters"]["failovers"] >= 1
    c.servers[3].stop()
    _d, m2, missing = c.client.search(q, 4, "t", allow_partial=True, partial_timeout=5.0)
    assert sorted(x["server"] for x in missing) == [1, 3]
    survivors = {r[0] for row in m2 for r in row if r}
    assert survivors <= {r[0] for row in full[1] for r in row} | set(range(80))


def test_get_ntotal_counts_each_group_once(cluster):
    x = _data(120)
    c = cluster()
    c.client.create_index("t", _flat(IndexCfg))
    _ingest(c, "t", x)
    _settled(c, "t", 120)
    assert sum(s.get_ntotal("t") for s in c.servers) == 240
    c.servers[2].stop()
    assert c.client.get_ntotal("t") == 120
    c.servers[0].stop()
    with pytest.raises(rpc.TRANSPORT_ERRORS):
        c.client.get_ntotal("t")


def test_sweeps_never_bring_back_a_delete_or_a_dropped_index(cluster):
    """A replica restarted from its own storage still holds rows deleted
    while it was down: its sweep applies the peer's ledger (delete first)
    and its peer's sweep pulls nothing back. An index dropped on one rank
    only is not synced back from its peer."""
    x = _data(80)
    c = cluster()
    c.client.create_index("t", _flat(IndexCfg))
    c.client.cur_server_ids["t"] = 0
    _ingest(c, "t", x)
    _settled(c, "t", 80)
    c.client.save_index("t")
    c.servers[2].stop()  # saves its shard
    gone = [0, 1, 40, 41, 60]
    assert c.client.remove_ids("t", gone) == 5
    c.restart(2, group=0)
    c.servers[2].load_index("t")
    assert {(i,) for i in gone} & set(map(lambda v: (v,), c.servers[2].get_ids("t")))
    for _ in range(2):
        out = c.sweep()
    assert not any(h.get("pulled") for o in out for h in o["healed"])
    for s in c.servers:
        assert not set(gone) & s.get_ids("t")
    d = c.digests("t")
    assert d[0] == d[2] and d[1] == d[3]
    c.servers[1].drop_index("t")
    c.sweep()
    assert "t" not in c.servers[1].indexes
    assert c.servers[1]._antientropy.stats()["full_syncs"] == 0


def test_suspects_repair_loop_and_a_planned_leave(cluster):
    """Three failed sweeps mark a stopped replica suspect; refresh_health
    makes it the client's suspect, tried last by the read walk; the repair
    loop re-sends the write it missed once it is back; mark_rank_left
    takes a position out of its group."""
    from distributed_faiss_tpu_torch.parallel import replication

    x = _data(60)
    c = cluster(repair_interval_s=0.2)
    c.client.create_index("t", _flat(IndexCfg))
    c.client.cur_server_ids["t"] = 0
    _ingest(c, "t", x[:40])
    _settled(c, "t", 40)
    c.client.save_index("t")
    c.servers[2].stop()
    c.client.add_index_data("t", x[40:60], [(i,) for i in range(40, 60)])
    for _ in range(3):
        c.servers[0]._antientropy.sweep_once()
    assert [s["port"] for s in c.servers[0].get_health()["suspects"]] == [c.ports[2]]
    wait_until(lambda: c.client.get_replication_stats()["suspects"] == [2])
    plan = replication.plan_read_fanout(c.client.membership, {0: 2}, {2})
    assert plan[0][2] == [0, 2]
    c.restart(2, group=0)
    c.servers[2].load_index("t")
    wait_until(lambda: c.client.get_replication_stats()["repair"]["repaired"] == 1)
    wait_until(lambda: c.servers[2].get_ntotal("t") == c.servers[0].get_ntotal("t") == 40)
    c.client.mark_rank_left(2)
    assert c.client.get_replication_stats()["groups"] == {0: [0], 1: [1, 3]}
    assert c.client.get_ntotal("t") == 60


def test_compaction_lease_and_resync(cluster):
    """After a sweep each group's lowest rank holds the compaction lease
    (get_health); resync_rank streams a shard to an emptied replica."""
    x = _data(60)
    c = cluster()
    c.client.create_index("t", _flat(IndexCfg))
    _ingest(c, "t", x)
    _settled(c, "t", 60)
    c.sweep()
    held = [s.get_health()["compaction"]["held"] for s in c.servers]
    assert held == [True, True, False, False]
    assert c.servers[2].get_perf_stats()["antientropy"]["compaction_held"] is False
    c.servers[3].drop_index("t")
    out = c.client.resync_rank("t", 3)
    assert out["ntotal"] == c.servers[1].get_ntotal("t") and out["shard_group"] == 1
    wait_until(lambda: c.servers[3].get_aggregated_ntotal("t") == 0)
    assert c.digests("t")[3] == c.digests("t")[1]
    assert c.servers[3].indexes["t"].current_generation() >= 1


@pytest.mark.slow
def test_sigkill_under_storm_over_the_harness(tmp_path):
    """Four --device cpu rank processes, R = 2: a SIGKILLed replica costs no
    request of a running query storm, a divergence under quorum 1 heals by
    delta once the victim is back with its storage, and an empty restart
    heals by a full transfer; the healed ranks serve their survivors' ids."""
    from distributed_faiss_tpu_torch.testing.chaos import QueryStorm, ServerHarness

    x = _data(400)
    q = x[:8] + 0.01
    disc = str(tmp_path / "disc.txt")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": repo, "DFT_ANTIENTROPY_INTERVAL": "0.5", "DFT_COMPACT": "0"}
    h = ServerHarness(4, disc, str(tmp_path / "store"), base_port=free_base(4),
                      env=env, device="cpu")
    h.start()
    client = None
    try:
        for r in range(4):
            h.wait_port(r)
        client = IndexClient(disc, replication_cfg=ReplicationCfg(replication=2, write_quorum=1))
        # ranks register in the order they come up: map them to positions
        pos = client.index_rank_to_id
        ranks = {g: [r for r in range(4) if client.membership.group_of(pos[r]) == g]
                 for g in (0, 1)}
        client.create_index("default", _flat(IndexCfg))
        client.cur_server_ids["default"] = 0
        for s in range(0, 400, 40):
            client.add_index_data("default", x[s:s + 40], [(i,) for i in range(s, s + 40)])
        wait_until(lambda: client.get_ntotal("default") == 400
                   and client.get_buffer_depth("default") == 0)
        client.save_index("default")
        golden = client.search(q, 5, "default")[1]
        (v0, s0), (v1, s1) = ranks[0], ranks[1]
        with QueryStorm(client, "default", q, 5, threads=4) as storm:
            time.sleep(0.3)
            h.kill(v0)
            time.sleep(0.5)
        results, errors = storm.stop()
        assert errors == [] and results and all(r[1] == golden for r in results)
        client.remove_ids("default", [2, 4])
        client.cur_server_ids["default"] = 0
        client.add_index_data("default", x[:40] + 3.0, [(1000 + i,) for i in range(40)])
        h.restart(v0, load_index=True, extra_env={"DFT_SHARD_GROUP": "0"})
        h.wait_port(v0)

        def converged(a, b):
            da = rpc.digest_exchange("localhost", h.port(a), {"want": None})["digests"]
            db = rpc.digest_exchange("localhost", h.port(b), {"want": None})["digests"]
            return da.get("default") == db.get("default") and da.get("default")

        wait_until(lambda: converged(v0, s0))
        h.kill(v1)
        h.restart(v1, extra_env={"DFT_SHARD_GROUP": "1"})
        h.wait_port(v1)
        wait_until(lambda: converged(v1, s1))
        with client._lock:
            client._preferred.update({0: pos[v0], 1: pos[v1]})
        wait_until(lambda: all(_answers(client.sub_indexes[pos[v]]) for v in (v0, v1)))
        served = client.search(q, 5, "default")[1]
        assert not {m[0] for row in served for m in row} & {2, 4}
        ae = {s["replication"]["rank"]: s["antientropy"] for s in client.get_perf_stats()}
        assert ae[v0]["rows_repaired"] == 40 and ae[v0]["full_syncs"] == 0
        assert ae[v1]["full_syncs"] == 1
    finally:
        if client is not None:
            client.close()
        h.stop()
