"""The port's per-id versions against the JAX package's, on the CPU: the
hybrid logical clock and the last-writer-wins gates over an enumerated
table, versioned writes on both packages' engines (replays, upsert against
delete, restart, read-your-writes, pinned reads and the retained
generations), and the client's stamping over loopback against one port
``IndexServer(device="cpu")``. The wall clock is injected, never slept on."""

import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.mutation import tombstones as jtombstones
from distributed_faiss_tpu.mutation import versions as jversions
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.config import MutationCfg as JMutationCfg
from distributed_faiss_tpu.utils.config import VersioningCfg as JVersioningCfg
from distributed_faiss_tpu.utils.state import STALE_READ_REJECTION_FMT as J_STALE
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.mutation import tombstones as ttombstones
from distributed_faiss_tpu_torch.mutation import versions as tversions
from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.config import IndexCfg, MutationCfg, VersioningCfg
from distributed_faiss_tpu_torch.utils.state import STALE_READ_REJECTION_FMT, IndexState

D = 16

# versions around one instant: below, equal, above in each component,
# another writer at the same instant, and unversioned
_V = [None, (100, 0, 1), (100, 0, 2), (100, 1, 1), (99, 5, 1), (101, 0, 0)]
TABLE = [(v, live, dead) for v in _V[1:] for live in _V for dead in _V]


@pytest.fixture(autouse=True)
def _no_background_compaction(monkeypatch):
    monkeypatch.setenv("DFT_COMPACT", "0")


@pytest.mark.parametrize("gate", ["add_loses", "delete_loses"])
def test_lww_gates_match_jax(gate):
    """Each gate answers as the JAX package's over every (v, live, dead)
    triple of the table, ties and unversioned entries included."""
    got = [getattr(tversions, gate)(v, live, dead) for v, live, dead in TABLE]
    want = [getattr(jversions, gate)(v, live, dead) for v, live, dead in TABLE]
    assert got == want and any(got) and not all(got)


@pytest.mark.parametrize("fn", ["compare", "newest"])
def test_version_order_matches_jax(fn):
    pairs = [(a, b) for a in _V for b in _V] + [([100, 0, 1], (100, 0, 1))]
    assert ([getattr(tversions, fn)(a, b) for a, b in pairs]
            == [getattr(jversions, fn)(a, b) for a, b in pairs])
    with pytest.raises(ValueError):
        tversions.version_key((1, 2))


def test_hlc_matches_jax():
    """The same injected wall clock, ticks and observes give both clocks
    the same versions, including a clock that runs backward."""
    times = [5, 5, 5, 7, 6, 6, 20, 20, 3, 3, 3, 3]
    clocks = []
    for mod in (tversions, jversions):
        it = iter(times)
        clocks.append(mod.HLC(writer_id=9, clock_ms=lambda it=it: next(it)))
    out = []
    for c in clocks:
        seq = [c.tick(), c.tick(), c.tick(), c.tick(), c.tick()]
        c.observe((30, 4, 1))
        seq += [c.tick(), c.tick()]
        c.observe([30, 2, 5])  # older than what it holds: no change
        seq += [c.tick(), c.tick()]
        out.append(seq)
    assert out[0] == out[1]
    assert out[0][5] == (30, 5, 9)


def test_env_cfgs_match_jax(monkeypatch):
    """MutationCfg and VersioningCfg read the JAX package's variables with
    its defaults and validation."""
    for ours, theirs in ((MutationCfg, JMutationCfg), (VersioningCfg, JVersioningCfg)):
        assert ours.from_env({}).__dict__ == theirs.from_env({}).__dict__
    env = {"DFT_COMPACT": "0", "DFT_COMPACT_THRESHOLD": "0.5", "DFT_COMPACT_INTERVAL": "2",
           "DFT_VERSIONING": "false", "DFT_RETAIN_GENERATIONS": "4"}
    assert MutationCfg.from_env(env).__dict__ == JMutationCfg.from_env(env).__dict__
    assert VersioningCfg.from_env(env).__dict__ == JVersioningCfg.from_env(env).__dict__
    for bad in ({"DFT_COMPACT_THRESHOLD": "0"}, {"DFT_COMPACT_INTERVAL": "0"}):
        with pytest.raises(ValueError):
            MutationCfg.from_env(bad)
    with pytest.raises(ValueError):
        VersioningCfg.from_env({"DFT_RETAIN_GENERATIONS": "1"})
    assert STALE_READ_REJECTION_FMT == J_STALE


def test_tombstone_payload_round_trip_matches_jax():
    """The same set built in both packages dumps the same JSON; each
    package's payload loads in the other to the same set, and a format-1
    payload upgrades with every version None."""
    sets = []
    for mod in (ttombstones, jtombstones):
        s = mod.TombstoneSet({4: (4, "a"), 9: None}, layout=3)
        s.add([11], [(11, "a")], version=(5, 0, 1))
        s.ledger_update_versioned([((12, "a"), (6, 1, 2))])
        s.set_live_version((2, "a"), (7, 0, 1))
        s.unledger([(4, "a")])
        sets.append(s)
    assert (ttombstones.dump_payload(sets[0].to_payload())
            == jtombstones.dump_payload(sets[1].to_payload()))
    jp = sets[1].to_payload()
    back = ttombstones.TombstoneSet.from_payload(jp)
    assert back.to_payload() == jp
    legacy = {"dead_rows": [1, 2], "dead_ids": [[1], [2]], "layout": 0}
    assert (ttombstones.TombstoneSet.from_payload(legacy).to_payload()
            == jtombstones.TombstoneSet.from_payload(legacy).to_payload())


# ------------------------------------------------------------ engines


def _cfg(cls, storage):
    return cls(index_builder_type="flat", dim=D, metric="l2", train_num=10,
               index_storage_dir=storage)


def _drained(e, n):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if e.get_idx_data_num() == (0, n) and e.get_state() in (IndexState.TRAINED,
                                                                JState.TRAINED):
            return
        time.sleep(0.02)
    raise AssertionError(f"engine never drained to {n} rows")


@pytest.fixture
def engines(tmp_path):
    """A JAX and a port engine over the same flat cfg, each over its own
    dir; both retired in teardown."""
    made = []

    def make():
        j = JIndex(_cfg(JCfg, str(tmp_path / "jax")))
        t = TIndex(_cfg(IndexCfg, str(tmp_path / "port")), device="cpu")
        made.extend([j, t])
        return j, t

    try:
        yield make
    finally:
        for e in made:
            e.retire()


def _both(pair, fn):
    return [fn(e) for e in pair]


def test_versioned_add_replay_is_a_noop(rng, engines):
    x = rng.standard_normal((40, D)).astype(np.float32)
    v1 = (1000, 0, 1)
    pair = engines()
    for e in pair:
        e.add_batch(x, [(i,) for i in range(40)], train_async_if_triggered=False, version=v1)
        _drained(e, 40)
        e.add_batch(x, [(i,) for i in range(40)], train_async_if_triggered=False, version=v1)
        assert e.get_idx_data_num() == (0, 40)
    stats = _both(pair, lambda e: e.mutation_stats())
    assert stats[0]["version_noop_adds"] == stats[1]["version_noop_adds"] == 40
    assert stats[0]["version_watermark"] == stats[1]["version_watermark"] == [1000, 0, 1]


def test_upsert_vs_delete_converges_to_the_last_writer(rng, engines):
    """A delete replayed after a newer upsert no-ops; a newer delete still
    wins; an upsert replay no-ops both halves; both packages agree on
    every answer and on the id sets."""
    x = rng.standard_normal((40, D)).astype(np.float32)
    y = rng.standard_normal((2, D)).astype(np.float32)
    v = [(1000 + i, 0, 1) for i in range(6)]
    pair = engines()
    answers = []
    for e in pair:
        e.add_batch(x, [(i,) for i in range(40)], train_async_if_triggered=False, version=v[0])
        _drained(e, 40)
        got = [e.remove_ids([7], version=v[1])]
        e.upsert([7], y[:1], version=v[2])
        _drained(e, 41)
        got.append(e.remove_ids([7], version=v[1]))  # stale replay
        got.append(7 in e.get_ids())
        e.upsert([7], y[1:], version=v[2])  # upsert replay
        time.sleep(0.1)
        got.append(e.get_idx_data_num())
        got.append(e.remove_ids([7], version=v[3]))  # newer delete
        got.append(7 in e.get_ids())
        got.append(e.remove_ids([99], version=v[4]))  # no row: ledgered only
        answers.append(got)
    assert answers[0] == answers[1] == [1, 0, True, (0, 41), 1, False, 0]
    sets = _both(pair, lambda e: e.id_sets())
    assert sets[0] == sets[1]
    assert [99, v[4]] in sets[1]["dead_versions"]


def test_per_row_versions_replace_older_live_rows(rng, engines):
    """Per-row versions (the delta-pull shape): a row newer than its id's
    live row replaces it in place, an older or equal one no-ops; a
    single-stamp batch only appends. Both packages agree."""
    x = rng.standard_normal((10, D)).astype(np.float32)
    y = rng.standard_normal((3, D)).astype(np.float32)
    pair = engines()
    for e in pair:
        e.add_batch(x, [(i,) for i in range(10)], train_async_if_triggered=False,
                    version=(100, 0, 1))
        _drained(e, 10)
        e.add_batch(y, [(2,), (3,), (4,)], train_async_if_triggered=False,
                    version=[(200, 0, 1), (100, 0, 1), (50, 0, 1)])
        _drained(e, 11)
        e.add_batch(y[1:2], [(5,)], train_async_if_triggered=False, version=(300, 0, 1))
        _drained(e, 12)
    stats = _both(pair, lambda e: e.mutation_stats())
    assert stats[0] == stats[1]
    assert (stats[1]["version_replaced"], stats[1]["version_noop_adds"]) == (1, 2)
    assert _both(pair, lambda e: e.id_sets()) == [pair[0].id_sets()] * 2
    assert _both(pair, lambda e: e.search(y[:2], 1)[1]) == [[[(2,)], [(5,)]]] * 2


def test_versioned_state_survives_a_restart(rng, engines, tmp_path):
    """The version planes and the watermark come back from the dir; a stale
    delete stays a no-op after the restart; both packages agree."""
    x = rng.standard_normal((30, D)).astype(np.float32)
    pair = engines()
    for e in pair:
        e.add_batch(x, [(i,) for i in range(30)], train_async_if_triggered=False,
                    version=(500, 0, 3))
        _drained(e, 30)
        e.remove_ids([4], version=(600, 0, 3))
        e.upsert([5], x[5:6], version=(700, 0, 3))
        _drained(e, 31)
        assert e.save() is True
        e.retire()
    j = JIndex.from_storage_dir(str(tmp_path / "jax"))
    t = TIndex.from_storage_dir(str(tmp_path / "port"), device="cpu")
    try:
        assert t.id_sets() == j.id_sets()
        assert t.version_watermark() == j.version_watermark() == (700, 0, 3)
        assert t.remove_ids([5], version=(650, 0, 3)) == 0
        assert t.mutation_stats()["version_noop_deletes"] == 1
    finally:
        j.retire()
        t.retire()


def test_assert_min_version_is_per_writer(rng, tmp_path):
    x = rng.standard_normal((20, D)).astype(np.float32)
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "port")), device="cpu")
    try:
        t.add_batch(x, [(i,) for i in range(20)], train_async_if_triggered=False,
                    version=(100, 3, 1))
        t.assert_min_version(None)
        t.assert_min_version((100, 3, 1))
        t.assert_min_version([99, 9, 1])
        for ahead in ((100, 4, 1), (50, 0, 2)):  # later, or another writer
            with pytest.raises(RuntimeError, match="has not applied version"):
                t.assert_min_version(ahead)
    finally:
        t.retire()


def test_search_at_generation_and_retained_generations(rng, tmp_path, monkeypatch):
    """A pinned read serves its generation as committed; with
    DFT_RETAIN_GENERATIONS=3 three generations stay readable, and a pruned
    one raises; the JAX engine reads the same pinned results."""
    monkeypatch.setenv("DFT_RETAIN_GENERATIONS", "3")
    x = rng.standard_normal((30, D)).astype(np.float32)
    storage = str(tmp_path / "port")
    t = TIndex(_cfg(IndexCfg, storage), device="cpu")
    try:
        assert t.versioning.retain_generations == 3
        t.add_batch(x, [(i,) for i in range(30)], train_async_if_triggered=False)
        _drained(t, 30)
        gens = []
        for i in range(4):
            t.remove_ids([i], version=(100 + i, 0, 1))
            assert t.save() is True  # a delete alone commits
            gens.append(t.current_generation())
        assert [g for g, _ in serialization.list_generations(storage)] == gens[:0:-1]
        _, meta, _ = t.search_at_generation(x[2:3], 1, generation=gens[1])
        assert meta == [[(2,)]]  # deleted in gens[2]
        _, meta, _ = t.search_at_generation(x[2:3], 1, generation=gens[2])
        assert meta != [[(2,)]] and t.search(x[2:3], 1)[1] == meta
        with pytest.raises(RuntimeError, match="not retained"):
            t.search_at_generation(x[:1], 1, generation=gens[0])
        j = JIndex(_cfg(JCfg, storage))
        try:
            assert (j.search_at_generation(x[:5], 3, generation=gens[1])[1]
                    == t.search_at_generation(x[:5], 3, generation=gens[1])[1])
        finally:
            j.retire()
    finally:
        t.retire()


# ------------------------------------------------------------ client


@pytest.fixture
def served(tmp_path):
    """One port IndexServer(device="cpu") on a loopback port; yields a
    function that makes clients of it (closed in teardown)."""
    srv = IndexServer(0, str(tmp_path / "store"), device="cpu")
    port = srv.bind(0)
    threading.Thread(target=srv.start_blocking, daemon=True).start()
    disc = tmp_path / "disc.txt"
    disc.write_text(f"1\nlocalhost,{port}\n")
    clients = []

    def client(**kw):
        c = IndexClient(str(disc), **kw)
        clients.append(c)
        return c

    try:
        yield srv, client
    finally:
        for c in clients:
            c.close()
        srv.stop()


def _create(c, iid="v"):
    c.create_index(iid, IndexCfg(index_builder_type="flat", dim=D, metric="l2", train_num=10))


def test_client_stamps_one_version_per_batch(rng, served):
    srv, client = served
    c = client()
    _create(c)
    x = rng.standard_normal((20, D)).astype(np.float32)
    c.add_index_data("v", x[:10], [(i,) for i in range(10)])
    c.add_index_data("v", x[10:], [(i,) for i in range(10, 20)])
    live = {k: tuple(v) for k, v in srv.indexes["v"].id_sets()["live_versions"]}
    first, second = {live[i] for i in range(10)}, {live[i] for i in range(10, 20)}
    assert len(first) == len(second) == 1
    (v1,), (v2,) = first, second
    assert v1 < v2 and v1[2] == v2[2] == c._hlc.writer_id
    assert c.last_write_version("v") == v2


def test_client_seeds_its_clock_from_the_watermark(rng, served):
    """A client whose wall clock is far behind still stamps above what the
    rank has incorporated, because its first mutation observes the
    watermark from get_id_sets."""
    srv, client = served
    ahead, behind = client(), client()
    ahead._hlc = tversions.HLC(writer_id=1, clock_ms=lambda: 9_000_000)
    behind._hlc = tversions.HLC(writer_id=2, clock_ms=lambda: 1_000)
    _create(ahead)
    x = rng.standard_normal((4, D)).astype(np.float32)
    ahead.add_index_data("v", x[:2], [(0,), (1,)])
    behind.add_index_data("v", x[2:], [(2,), (3,)])
    v_ahead, v_behind = ahead.last_write_version("v"), behind.last_write_version("v")
    assert v_ahead[0] == 9_000_000 and tversions.compare(v_behind, v_ahead) > 0
    assert srv.indexes["v"].version_watermark() == v_behind


def test_failed_write_does_not_poison_read_your_writes(rng, served):
    """A mutation that fails everywhere leaves the read-your-writes floor
    where it was: the next RYW search is answered. A version the rank has
    not seen is refused with the stale-read error."""
    srv, client = served
    c = client()
    _create(c)
    x = rng.standard_normal((30, D)).astype(np.float32)
    c.add_index_data("v", x, [(i,) for i in range(30)])
    deadline = time.monotonic() + 30
    while not (c.get_state("v") == IndexState.TRAINED and c.get_ntotal("v") == 30):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    floor = c.last_write_version("v")
    with pytest.raises(rpc.ServerException):
        c.remove_ids("absent", [1])
    assert c.last_write_version("v") == floor
    d, meta = c.search(x[:2], 3, "v", read_your_writes=True)
    assert meta[0][0] == (0,) and meta[1][0] == (1,)
    behind = (floor[0] + 1, 0, floor[2])
    with pytest.raises(rpc.ServerException, match="has not applied version"):
        c.search(x[:2], 3, "v", min_version=behind)
    assert c.remove_ids("v", [0]) == 1
    assert tversions.compare(c.last_write_version("v"), floor) > 0
    assert c.search(x[:1], 1, "v", read_your_writes=True)[1][0][0] != (0,)


def test_versioning_off_sends_no_version(rng, served):
    srv, client = served
    c = client(versioning_cfg=VersioningCfg(enabled=False))
    assert c._hlc is None
    _create(c)
    x = rng.standard_normal((6, D)).astype(np.float32)
    c.add_index_data("v", x, [(i,) for i in range(6)])
    c.remove_ids("v", [1])
    sets = srv.indexes["v"].id_sets()
    assert sets["watermark"] is None and sets["live_versions"] == []
    assert sets["dead_versions"] == [] and c.last_write_version("v") is None


def test_client_mutation_ops_and_pinned_reads(rng, served):
    """remove_ids, upsert, compact_index, pin_generations and
    search_at_generation through the client; the ``mutation`` perf key."""
    srv, client = served
    c = client()
    _create(c)
    x = rng.standard_normal((50, D)).astype(np.float32)
    c.add_index_data("v", x, [(i,) for i in range(50)])
    deadline = time.monotonic() + 30
    while not (c.get_state("v") == IndexState.TRAINED and c.get_ntotal("v") == 50):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    c.save_index("v")
    pins = c.pin_generations("v")
    assert pins == {0: 1}
    assert c.remove_ids("v", [3, 4]) == 2
    assert c.upsert("v", [5], x[3:4]) == 1
    deadline = time.monotonic() + 30
    while True:
        try:
            _, meta = c.search(x[3:4], 1, "v", read_your_writes=True)
        except rpc.ServerException as e:
            assert "state: IndexState.ADD" in str(e)  # the drain, never a stale read
            meta = None
        if meta == [[(5,)]]:
            break
        assert time.monotonic() < deadline
        time.sleep(0.02)
    assert c.get_ids("v") == set(range(50)) - {3, 4}
    _, meta = c.search_at_generation(x[3:5], 1, "v", pins=pins)
    assert meta == [[(3,)], [(4,)]]
    assert c.compact_index("v") == [True]
    assert c.pin_generations("v") == {0: 2}
    stats = c.get_perf_stats()[0]["mutation"]["v"]
    assert stats["compactions"] == 1 and stats["tombstoned_rows"] == 0
    with pytest.raises(RuntimeError, match="no pinned"):
        c.search_at_generation(x[:1], 1, "v", pins={})


def test_remove_ids_names_the_ranks_that_missed_it(rng, tmp_path):
    """Deletes go to every rank; with one of two ranks stopped the call
    tries both, applies on the live one and raises a MultiRankError that
    names the stopped one; the read-your-writes floor does not move."""
    from distributed_faiss_tpu_torch.parallel.client import MultiRankError

    servers, lines = [], []
    for rank in range(2):
        srv = IndexServer(rank, str(tmp_path / "store"), device="cpu")
        lines.append(f"localhost,{srv.bind(0)}")
        threading.Thread(target=srv.start_blocking, daemon=True).start()
        servers.append(srv)
    disc = tmp_path / "disc.txt"
    disc.write_text("2\n" + "\n".join(lines) + "\n")
    c = IndexClient(str(disc), retry_policy=rpc.RetryPolicy(max_attempts=1))
    try:
        _create(c)
        x = rng.standard_normal((40, D)).astype(np.float32)
        for s in range(0, 40, 10):
            c.add_index_data("v", x[s:s + 10], [(i,) for i in range(s, s + 10)])
        deadline = time.monotonic() + 30
        while not (c.get_state("v") == IndexState.TRAINED and c.get_ntotal("v") == 40):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        floor = c.last_write_version("v")
        servers[1].stop()
        with pytest.raises(MultiRankError) as err:
            c.remove_ids("v", list(range(40)))
        assert [f["server"] for f in err.value.failures] == [1]
        assert err.value.results == [20]
        assert servers[0].indexes["v"].get_ids() == set()
        assert c.last_write_version("v") == floor
    finally:
        c.close()
        for srv in servers:
            srv.stop()
