"""The port's anti-entropy surface against the JAX package's, on the CPU:
the failure detector (clock injected), the digest comparison, the peer list,
the compaction lease, the deletion-ledger additions of the tombstone set,
the engine's replica digest, id sets, hash-verified row exports, ledger
reconciliation and pruning, and shard snapshots crossing the packages both
ways; the server's ``ping`` kernel counts and its lease-gated watcher."""

import time
import types

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.mutation import tombstones as jtombstones
from distributed_faiss_tpu.parallel import antientropy as jae
from distributed_faiss_tpu.utils import serialization as jser
from distributed_faiss_tpu.utils.config import AntiEntropyCfg as JAntiEntropyCfg
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.mutation import tombstones as ttombstones
from distributed_faiss_tpu_torch.parallel import antientropy as tae
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils import serialization as tser
from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg, IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D = 16


@pytest.fixture(autouse=True)
def _no_background_compaction(monkeypatch):
    monkeypatch.setenv("DFT_COMPACT", "0")


def wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def drained(idx, n):
    states = (IndexState.TRAINED, JState.TRAINED)
    return lambda: idx.get_idx_data_num() == (0, n) and idx.get_state() in states


# ------------------------------------------------------------ failure detector


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_health_table_matches_jax(monkeypatch):
    """The same contacts, failures and clock steps give both tables the same
    suspects, electorates and snapshots."""
    clock = _Clock()
    monkeypatch.setattr(jae, "time", types.SimpleNamespace(monotonic=clock))
    tables = [tae.HealthTable(clock=clock), jae.HealthTable()]
    a, b = ("h", 1), ("h", 2)
    script = [("ok", a, 0, 0), ("fail", b, 2), ("fail", b, 2), ("inbound", 5, 0),
              ("inbound", 7, 1), ("tick", 4.0), ("ok", b, 3, 0), ("fail", a, 1),
              ("tick", 7.0), ("inbound", None, 0)]
    for step in script:
        if step[0] == "tick":
            clock.t += step[1]
        for t in tables:
            if step[0] == "ok":
                t.note_ok(step[1], rank=step[2], group=step[3])
            elif step[0] == "fail":
                assert t.note_fail(step[1], step[2], OSError("refused")) in (True, False)
            elif step[0] == "inbound":
                t.note_inbound(step[1], step[2])
        ours, theirs = tables
        assert ours.suspects() == theirs.suspects()
        assert ours.snapshot() == theirs.snapshot()
        for group in (0, 1):
            for ttl in (0.0, 5.0, 20.0):
                assert ours.alive_ranks(group, ttl) == theirs.alive_ranks(group, ttl)
        assert ours.known_group(*a) == theirs.known_group(*a)
    assert [s["port"] for s in tables[0].suspects()] == [1]


DIGESTS = [
    ({"live_n": 1, "live_hash": "a"}, {"live_n": 1, "live_hash": "a"}),
    ({"live_n": 1, "live_hash": "a"}, {"live_n": 2, "live_hash": "a"}),
    ({"live_n": 1, "live_hash": "a", "dead_hash": "x"}, {"live_n": 1, "live_hash": "a",
                                                         "dead_hash": "y"}),
    ({"live_n": 1, "live_hash": "a", "live_vhash": "v"}, {"live_n": 1, "live_hash": "a",
                                                          "live_vhash": "w"}),
    ({"live_n": 1, "live_hash": "a", "live_vhash": "v"}, {"live_n": 1, "live_hash": "a"}),
    (None, {"live_n": 0}),
]


@pytest.mark.parametrize("mine,theirs", DIGESTS)
def test_digests_match_matches_jax(mine, theirs):
    assert tae.digests_match(mine, theirs) == jae.digests_match(mine, theirs)
    assert tae.digests_match(theirs, mine) == jae.digests_match(theirs, mine)


@pytest.mark.parametrize("text", [None, "", "3\nhosta,1000\n\nhostb,2000\nhosta,1000\nbad\n"])
def test_read_peers_matches_jax(tmp_path, text):
    p = tmp_path / "disc.txt"
    if text is not None:
        p.write_text(text)
    assert tae.read_peers(str(p)) == jae.read_peers(str(p))


class _FakeServer:
    def __init__(self, rank, group):
        self.rank, self.shard_group, self.socket = rank, group, None


def test_compaction_lease_matches_jax(tmp_path):
    """The lowest rank of the group heard within the TTL holds the lease;
    another group's ranks do not count; a rank with no group holds its
    own."""
    for mod, cfg_cls in ((tae, AntiEntropyCfg), (jae, JAntiEntropyCfg)):
        cfg = cfg_cls(interval_s=600, lease_ttl_s=10.0)
        sw = mod.AntiEntropySweeper(_FakeServer(2, 0), str(tmp_path / "d"), cfg)
        got = [sw.may_compact()]
        sw.health.note_ok(("peer", 1), rank=5, group=0)
        got.append(sw.may_compact())
        sw.health.note_ok(("peer", 2), rank=0, group=1)
        got.append(sw.may_compact())
        sw.health.note_inbound(1, 0)
        got.append(sw.may_compact())
        alone = mod.AntiEntropySweeper(_FakeServer(9, None), str(tmp_path / "d"), cfg)
        got.append(alone.may_compact())
        assert got == [True, True, True, False, True]


def test_tombstone_ledger_surface_matches_jax():
    """ids, ledger, ledger_update, prune_ledger (with and without the age
    bound) and max_version give the same answers and the same payload."""
    out = []
    for mod in (ttombstones, jtombstones):
        s = mod.TombstoneSet({4: (4, "a"), 9: None}, layout=1)
        s.add([11, 12], [11, 12], version=(500, 0, 1))
        got = [sorted(s.ids(), key=repr), sorted(s.ledger(), key=repr)]
        got.append(s.ledger_update([13, 11, (4, "a")]))
        got.append(s.ledger_update_versioned([(14, (600, 0, 2)), (11, (700, 0, 1))]))
        s.set_live_version(3, (900, 1, 1))
        got.append(s.max_version())
        got.append(s.prune_ledger((650, 0, 0), max_wall_ms=550))
        got.append(s.prune_ledger((650, 0, 0)))
        got.append(s.prune_ledger(None))
        got.append(mod.dump_payload(s.to_payload()))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][5:8] == [1, 1, 0]


def test_row_payload_hash_matches_jax():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((4, D)).astype(np.float32)
    meta = [(1, "a"), [2, {3, 1}], None, (np.int64(4), {"k": 1.5})]
    vers = [(1, 2, 3), None, [4, 5, 6], None]
    assert tser.row_payload_hash(emb, meta, vers) == jser.row_payload_hash(emb, meta, vers)
    assert tser.row_payload_hash(emb[:3], meta[:3], vers[:3]) != tser.row_payload_hash(
        emb, meta, vers)


# ------------------------------------------------------------ engines


def _cfg(cls, storage, **kw):
    base = dict(index_builder_type="flat", dim=D, metric="l2", train_num=10,
                index_storage_dir=storage)
    base.update(kw)
    return cls(**base)


def _steps(e, x, y):
    """The same add, delete, upsert and compact steps on one engine, with
    fixed versions; returns the row count it should drain to."""
    e.add_batch(x[:30], [(i,) for i in range(30)], train_async_if_triggered=False,
                version=(1000, 0, 1))
    assert wait_until(drained(e, 30))
    e.add_batch(x[30:], [(i,) for i in range(30, 50)], train_async_if_triggered=False,
                version=(1001, 0, 1))
    e.remove_ids([3, 4, 31], version=(1002, 0, 1))
    e.remove_ids([7])  # unversioned: delete wins
    e.upsert([5], y[:1], version=(1003, 0, 2))
    assert wait_until(drained(e, 51))
    assert e.compact() is True
    e.remove_ids([40, 99], version=(1004, 0, 1))
    e.add_batch(y[1:3], [(60,), (61,)], train_async_if_triggered=False)
    return 48


@pytest.mark.parametrize("builder", ["flat", "ivfsq"])
def test_replica_surface_matches_jax(tmp_path, builder):
    """A JAX and a port engine that applied the same steps give the same
    replica digest, id sets and hash-verified row exports, byte for byte;
    reconcile_deletes and prune_ledger then answer alike."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((50, D)).astype(np.float32)
    y = rng.standard_normal((3, D)).astype(np.float32)
    kw = dict(index_builder_type=builder, centroids=4, nprobe=4) if builder == "ivfsq" else {}
    j = JIndex(_cfg(JCfg, str(tmp_path / "jax"), **kw))
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "port"), **kw), device="cpu")
    try:
        n = [_steps(e, x, y) for e in (j, t)][0]
        for e in (j, t):
            assert wait_until(drained(e, n))
        assert t.replica_digest() == j.replica_digest()
        assert t.replica_digest()["live_n"] == 47 and t.replica_digest()["dead_n"] == 6
        assert t.id_sets() == j.id_sets()
        ids = [0, 5, 31, 45, 60, 61, 77]
        te, je = (e.export_rows_versioned(ids, with_hash=True) for e in (t, j))
        np.testing.assert_array_equal(te[0], je[0])
        assert te[1:] == je[1:]
        assert te[3] == tser.row_payload_hash(*te[:3])
        assert [m[0] for m in t.export_rows(ids)[1]] == [0, 45, 5, 60, 61]  # row order
        # a peer's ledger: a delete newer than the live write (applies), one
        # older (gated), an unversioned one against a versioned row (gated),
        # one for an id never held (ledgered only)
        dead = [10, 5, 12, 200]
        dv = [[10, (1005, 0, 3)], [5, (900, 0, 3)], [200, (1006, 0, 3)]]
        got = [e.reconcile_deletes(dead, dv) for e in (t, j)]
        assert got == [1, 1]
        assert t.replica_digest() == j.replica_digest()
        assert t.id_sets() == j.id_sets()
        pruned = [e.prune_ledger((1003, 0, 0)) for e in (t, j)]
        assert pruned[0] == pruned[1] > 0
        assert t.id_sets() == j.id_sets()
        assert t.mutation_stats()["ledger_pruned"] == pruned[0]
    finally:
        j.retire()
        t.retire()


def _built(cls, cfg, x, **kw):
    e = cls(cfg, **kw)
    e.add_batch(x, [(i,) for i in range(x.shape[0])], train_async_if_triggered=False)
    assert wait_until(drained(e, x.shape[0]))
    return e


SNAPSHOT_CASES = [dict(index_builder_type="ivf_simple", centroids=8, nprobe=8),
                  dict(faiss_factory="IVF8,PQ8", centroids=8, nprobe=8),
                  dict(index_builder_type="knnlm", code_size=8, centroids=8, nprobe=8)]


@pytest.mark.parametrize("kw", SNAPSHOT_CASES, ids=["ivf_simple", "IVF8,PQ8", "knnlm"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_snapshot_crosses_the_packages(tmp_path, kw, direction):
    """A donor engine (one package) deletes a few ids and keeps some rows
    buffered, exports a snapshot; the other package imports it into a fresh
    dir and serves the donor's ids, distances within 1e-3, with the same
    digest; the import committed a generation that loads again."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, D)).astype(np.float32)
    q = x[:10] + 0.01
    jcfg = _cfg(JCfg, str(tmp_path / "donor"), train_num=300, **kw)
    tcfg = _cfg(IndexCfg, str(tmp_path / "donor"), train_num=300, **kw)
    if direction == "jax->port":
        donor = _built(JIndex, jcfg, x)
    else:
        donor = _built(TIndex, tcfg, x, device="cpu")
    donor.remove_ids([1, 2, 50], version=(2000, 0, 1))
    snap = donor.export_snapshot()
    target = str(tmp_path / "joined")
    if direction == "jax->port":
        got = TIndex.import_snapshot(snap, target, device="cpu")
    else:
        got = JIndex.import_snapshot(snap, target)
    try:
        assert wait_until(drained(got, 400))
        (wd, wm, _), (gd, gm, _) = donor.search(q, 5), got.search(q, 5)
        assert gm == wm
        np.testing.assert_allclose(gd, wd, rtol=1e-3, atol=1e-3)
        assert not {m[0] for row in gm for m in row if m} & {1, 2, 50}
        assert got.replica_digest() == donor.replica_digest()
        assert got.current_generation() >= 1
    finally:
        got.retire()
        donor.retire()
    back = (TIndex.from_storage_dir(target, device="cpu") if direction == "jax->port"
            else JIndex.from_storage_dir(target))
    try:
        assert back.get_ids() == set(range(400)) - {1, 2, 50}
    finally:
        back.retire()


# ------------------------------------------------------------ server


def test_ping_counts_kernel_launches_zero_on_the_cpu(tmp_path):
    """ping() names every kernel wrapper with its launches in this
    process; a CPU rank serves through the plain versions and counts
    none."""
    srv = IndexServer(0, str(tmp_path / "store"), device="cpu")
    try:
        x = np.random.default_rng(1).standard_normal((64, D)).astype(np.float32)
        srv.create_index("k", IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2",
                                       train_num=64, centroids=4, nprobe=4))
        srv.add_index_data("k", x, [(i,) for i in range(64)], False)
        assert wait_until(lambda: srv.get_state("k") == IndexState.TRAINED
                          and srv.get_aggregated_ntotal("k") == 0)
        srv.search("k", x[:4], 3)
        kernels = srv.ping()["kernels"]
        assert kernels == {"flat_list_scan": 0, "flat_list_scan_select": 0, "topk_select": 0,
                           "adc_scan": 0, "adc_scan_nibble": 0, "adc_scan_lists": 0,
                           "adc_scan_shared": 0}
    finally:
        srv.stop()


def test_watcher_defers_without_the_lease(tmp_path, monkeypatch):
    """An engine whose gate says another replica holds the lease does not
    compact past the threshold; the explicit compact op still does."""
    monkeypatch.setenv("DFT_COMPACT", "1")
    monkeypatch.setenv("DFT_COMPACT_INTERVAL", "0.05")
    e = TIndex(_cfg(IndexCfg, str(tmp_path / "gate")), device="cpu")
    try:
        e.compaction_gate = lambda: False
        x = np.random.default_rng(2).standard_normal((20, D)).astype(np.float32)
        e.add_batch(x, [(i,) for i in range(20)], train_async_if_triggered=False)
        assert wait_until(drained(e, 20))
        e.remove_ids(list(range(10)))
        time.sleep(0.4)
        assert e.mutation_stats()["compactions"] == 0
        e.compaction_gate = lambda: True
        assert wait_until(lambda: e.mutation_stats()["compactions"] == 1)
    finally:
        e.retire()
