"""The port's program cache (utils/programs.py) on the CPU, with its capture
backend injected: ``programs.RecordingGraphs`` runs a "capture" and each
"replay" eagerly and counts them, so the cache's keys, evictions, launch
accounting, compilecheck records and the sanitizer's and ``eager()``'s op
by op path are driven here as on a card. The pow2 buckets and the block
loop's padding are the JAX package's own (``ops/distance.py``,
``models/base.py``). A steady serving window through the port's
``SearchScheduler`` captures nothing and syncs at exactly the block
loop's two sites, one upload and one fetch."""

import threading
import warnings

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.models import base as jbase
from distributed_faiss_tpu.ops import distance as jdistance
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models import base as tbase
from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.ops import distance as tdistance
from distributed_faiss_tpu_torch.ops import flat_scan
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.serving.scheduler import SearchScheduler
from distributed_faiss_tpu_torch.utils import compilecheck, programs, xfercheck
from distributed_faiss_tpu_torch.utils.config import IndexCfg, SchedulerCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, K = 16, 5


def make_data(seed, n, nq, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, 8, nq)] + rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def recorded(model):
    """Inject the recording backend into the model's cache."""
    backend = programs.RecordingGraphs()
    model.programs.backend = backend
    return backend


def ivf_flat(x, nlist=8, nprobe=4, **kw):
    idx = IVFFlatIndex(D, nlist, "l2", device="cpu", **kw)
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(nprobe)
    return idx


@pytest.fixture
def counted_k1(monkeypatch):
    """K1's plain versions counting a launch as the CUDA wrapper does (the
    selecting one in ``flat_list_scan_select`` too), so the CPU path shows
    the replay accounting."""
    for name, wrappers in (("flat_list_scan_plain", (flat_scan.flat_list_scan,)),
                           ("flat_list_scan_select_plain",
                            (flat_scan.flat_list_scan, flat_scan.flat_list_scan_select))):
        monkeypatch.setattr(flat_scan, name, _counting(getattr(flat_scan, name), wrappers))
    monkeypatch.setattr(flat_scan.flat_list_scan, "launches", 0)
    monkeypatch.setattr(flat_scan.flat_list_scan_select, "launches", 0)
    return flat_scan.flat_list_scan


def _counting(plain, wrappers):
    def counting(*a, **kw):
        programs.count_launches(flat_scan._counter_lock, *wrappers)
        return plain(*a, **kw)

    return counting


@pytest.fixture
def tally():
    compilecheck.reset()
    compilecheck.install()
    yield
    compilecheck.uninstall()
    compilecheck.reset()


# ------------------------------------------------------------ buckets


def test_buckets_and_pow2_match_jax():
    for n in range(1, 4097):
        assert tdistance.bucket_size(n) == jdistance.bucket_size(n)
        assert tbase._next_pow2(n, 1) == jbase._next_pow2(n, 1)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(tdistance.pad_rows(x, 16), jdistance.pad_rows(x, 16))
    blocks = [(s, n, b.shape) for s, n, b in tbase.query_blocks(np.zeros((300, 3), np.float32),
                                                                 128)]
    assert blocks == [(s, n, b.shape) for s, n, b in
                      jbase.query_blocks(np.zeros((300, 3), np.float32), 128)]
    assert blocks == [(0, 128, (128, 3)), (128, 128, (128, 3)), (256, 44, (64, 3))]


def test_block_buckets_share_a_program():
    """Windows of 100 and 120 rows pad to one bucket: one capture, then a
    replay; a window of 20 rows is another bucket."""
    x, q = make_data(1, 600, 130)
    idx = ivf_flat(x)
    backend = recorded(idx)
    idx.search(q[:100], K)
    idx.search(q[:120], K)
    assert (backend.captures, backend.replays) == (1, 2)
    idx.search(q[:20], K)
    assert (idx.programs.captures, idx.programs.replays) == (2, 3)
    assert len(idx.programs) == 2


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("make", ["flat", "ivf_flat", "ivf_pq", "flat_pq"])
def test_steady_window_replays_the_eager_answer(make):
    x, q = make_data(2, 800, 40)
    if make == "flat":
        idx = FlatIndex(D, "l2", device="cpu")
    elif make == "ivf_flat":
        idx = IVFFlatIndex(D, 8, "l2", codec="sq8", refine_k_factor=4, device="cpu")
    else:
        idx = IVFPQIndex(D, 8 if make == "ivf_pq" else 1, m=8, refine_k_factor=4, device="cpu")
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(4)
    with programs.eager():
        want = idx.search(q, K)
    assert idx.programs.captures == 0
    recorded(idx)
    first = idx.search(q, K)
    again = idx.search(q, K)
    assert idx.programs.captures == 1 and idx.programs.replays == 2
    for got in (first, again):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_add_that_grows_the_lists_recaptures_and_evicts(counted_k1):
    x, q = make_data(3, 400, 20)
    idx = ivf_flat(x[:200])
    recorded(idx)
    idx.search(q, K)
    cap = idx.lists.cap
    idx.add(np.concatenate([x[200:]] * 4))  # the fullest list overflows
    assert idx.lists.cap > cap
    d, i = idx.search(q, K)
    assert idx.programs.captures == 2 and idx.programs.evictions == 1
    assert len(idx.programs) == 1
    with programs.eager():
        np.testing.assert_array_equal(idx.search(q, K)[1], i)
    assert i.max() >= 200  # the new rows serve


def test_set_nprobe_is_another_program():
    x, q = make_data(4, 400, 20)
    idx = ivf_flat(x)
    recorded(idx)
    idx.search(q, K)
    idx.set_nprobe(8)
    idx.search(q, K)
    idx.set_nprobe(4)
    idx.search(q, K)
    assert (idx.programs.captures, idx.programs.replays) == (2, 3)


def test_tombstone_in_place_keeps_the_program_and_is_read_by_replay():
    x, q = make_data(5, 400, 20)
    for idx in (ivf_flat(x), FlatIndex(D, "l2", device="cpu")):
        if isinstance(idx, FlatIndex):
            idx.add(x)
        recorded(idx)
        _, i = idx.search(q, K)
        idx.remove_rows(np.asarray([0]))  # allocates the flat live mask: a new key
        idx.search(q, K)
        captures = idx.programs.captures
        dead = np.unique(i[:, 0])
        idx.remove_rows(dead)  # written in place
        _, i2 = idx.search(q, K)
        assert idx.programs.captures == captures
        assert not np.isin(i2, dead).any()


def test_load_is_a_new_state():
    x, q = make_data(6, 400, 20)
    idx = ivf_flat(x)
    recorded(idx)
    idx.search(q, K)
    loaded = IVFFlatIndex.from_state_dict(idx.state_dict(), device="cpu")
    backend = recorded(loaded)
    np.testing.assert_array_equal(loaded.search(q, K)[1], idx.search(q, K)[1])
    assert backend.captures == 1
    reads = lambda m: programs.signature((m.lists.data, m.lists.ids, m.lists.sizes))  # noqa: E731
    assert reads(loaded) != reads(idx)


def test_lru_bound_and_clear():
    x, q = make_data(7, 400, 20)
    idx = ivf_flat(x)
    recorded(idx)
    idx.programs.max_programs = 2
    for k in (1, 2, 3):
        idx.search(q, k)
    assert len(idx.programs) == 2 and idx.programs.evictions == 1
    idx.release_programs()
    assert len(idx.programs) == 0 and idx.programs.stats()["programs"] == 0


def test_engine_frees_programs_at_each_swap(tmp_path, monkeypatch):
    """Compaction, drop and retire free the swapped-out model's programs;
    a pinned read's snapshot model has a cache of its own."""
    monkeypatch.setenv("DFT_COMPACT", "0")
    x, q = make_data(8, 300, 10)
    cfg = IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=200, centroids=8,
                   index_storage_dir=str(tmp_path / "idx"))
    t = TIndex(cfg, device="cpu")
    try:
        t.add_batch(x, [(i,) for i in range(300)], train_async_if_triggered=False)
        for _ in range(1500):
            if t.get_idx_data_num() == (0, 300) and t.get_state() == IndexState.TRAINED:
                break
            threading.Event().wait(0.02)
        old = t.model
        recorded(old)
        t.search(q, K)
        assert len(old.programs) == 1
        t.remove_ids([int(i) for i in range(20)])
        assert t.save() is True
        gen = t.current_generation()
        t.search_at_generation(q, K, generation=gen)
        snap = t._pinned_cache[1][0]
        assert snap is not old and snap.programs is not old.programs
        assert t.compact() is True
        assert t.model is not old and len(old.programs) == 0
        recorded(t.model)
        t.search(q, K)
        model = t.model
        t.drop_index()
        assert len(model.programs) == 0
    finally:
        t.retire()


def test_retire_frees_the_model_programs(tmp_path):
    x, q = make_data(9, 300, 10)
    cfg = IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=200, centroids=8)
    t = TIndex(cfg, device="cpu")
    t.add_batch(x, [(i,) for i in range(300)], train_async_if_triggered=False)
    for _ in range(1500):
        if t.get_idx_data_num() == (0, 300) and t.get_state() == IndexState.TRAINED:
            break
        threading.Event().wait(0.02)
    recorded(t.model)
    t.search(q, K)
    assert len(t.model.programs) == 1
    t.retire()
    assert len(t.model.programs) == 0


# ------------------------------------------------------------ launch counts


def test_replayed_launches_reach_the_wrapper(counted_k1):
    """The warm-up launches run and count; the capture records them; each
    replay adds them again."""
    x, q = make_data(10, 400, 20)
    idx = ivf_flat(x, nprobe=4)
    nprobe, _, g = idx._search_plan(K)
    groups = nprobe // g  # one K1 launch a probe group: one a block
    assert groups == 1
    recorded(idx)
    idx.search(q, K)  # warm-up (counts), capture (recorded), replay (counts)
    assert counted_k1.launches == 2 * groups
    idx.search(q, K)
    idx.search(q, K)
    assert counted_k1.launches == 4 * groups
    with programs.eager():
        idx.search(q, K)
    assert counted_k1.launches == 5 * groups
    assert flat_scan.flat_list_scan_select.launches == counted_k1.launches


def test_tally_and_count_under_capture():
    """``tally`` sees launches captured or not; ``count`` defers an update
    to the replays of the program being captured."""
    lock = threading.Lock()

    def wrapper():
        pass

    wrapper.launches = 0
    hits = []
    with programs.tally() as t:
        programs.count_launches(lock, wrapper)
        with programs.recording([]) as rec:
            programs.count_launches(lock, wrapper)
            programs.count(lambda: hits.append(1))
    assert t[wrapper] == 2 and wrapper.launches == 1 and hits == [] and len(rec) == 2
    for update in rec:
        update()
    assert wrapper.launches == 2 and hits == [1]


def test_mesh_shard_launches_count_replays(counted_k1):
    x, q = make_data(11, 800, 12)
    mesh = tmesh.make_mesh(4, device="cpu", virtual=True)
    idx = tmesh.ShardedIVFFlatIndex(D, 8, "l2", mesh=mesh, kmeans_iters=4)
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(8)
    with programs.eager():
        want = idx.search(q, K)
        eager_shards = idx.shard_launches.copy()
    idx.shard_launches[:] = 0
    recorded(idx)
    for _ in range(3):
        got = idx.search(q, K)
    np.testing.assert_array_equal(got[1], want[1])
    # warm-up + three replays, each the eager search's launches a shard
    np.testing.assert_array_equal(idx.shard_launches, 4 * eager_shards)
    assert idx.launches == 4 and idx.programs.captures == 1
    routed = tmesh.ShardedIVFFlatIndex(D, 8, "l2", mesh=mesh, kmeans_iters=4,
                                       probe_routing=True)
    routed.train(x)
    routed.add(x)
    with programs.eager():
        routed_want = routed.search(q, K)
        routed_shards = routed.shard_launches.copy()
    routed.shard_launches[:] = 0
    recorded(routed)
    for _ in range(2):
        got = routed.search(q, K)
    # routed mode is a program a block too: captured once, then replayed
    np.testing.assert_array_equal(got[1], routed_want[1])
    assert (routed.programs.captures, routed.programs.replays) == (1, 2)
    np.testing.assert_array_equal(routed.shard_launches, 3 * routed_shards)


# ------------------------------------------------------------ witnesses


def test_compilecheck_sees_each_capture(tally):
    x, q = make_data(12, 400, 20)
    idx = ivf_flat(x)
    recorded(idx)
    snap = compilecheck.snapshot()
    idx.search(q, K)
    assert compilecheck.new_since(snap) == {"capture:ivf_flat.block": 1}
    snap = compilecheck.snapshot()
    idx.search(q, K)
    assert compilecheck.new_since(snap) == {}
    nb = idx._search_plan(K)[1]
    idx.search(np.concatenate([q] * (nb // q.shape[0] + 1)), K)  # past one block
    assert compilecheck.new_since(snap) == {"capture:ivf_flat.fused": 1}


def test_sanitizer_and_eager_capture_nothing(monkeypatch):
    x, q = make_data(13, 400, 20)
    idx = ivf_flat(x)
    backend = recorded(idx)
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    want = idx.search(q, K)
    monkeypatch.delenv("GRAFT_SANITIZE")
    with programs.eager():
        np.testing.assert_array_equal(idx.search(q, K)[1], want[1])
    assert backend.captures == 0 and backend.replays == 0
    np.testing.assert_array_equal(idx.search(q, K)[1], want[1])
    assert backend.captures == 1


def test_eager_holds_for_other_threads():
    x, q = make_data(14, 400, 20)
    idx = ivf_flat(x)
    backend = recorded(idx)
    with programs.eager():
        th = threading.Thread(target=idx.search, args=(q, K))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    assert backend.captures == 0 and not programs.is_eager()


def test_a_failed_capture_raises_and_serves_nothing_op_by_op():
    """No fallback: a capture that fails raises to the caller."""
    x, q = make_data(15, 400, 20)
    idx = ivf_flat(x)

    class Refusing(programs.RecordingGraphs):
        def capture(self, run, traced, device, pool):
            raise RuntimeError("operation not permitted when stream is capturing")

    idx.programs.backend = Refusing()
    with pytest.raises(RuntimeError, match="capturing"):
        idx.search(q, K)
    assert idx.programs.replays == 0


def _warn_on_sync(monkeypatch):
    """A synchronizing CUDA call on the card warns (torch's sync debug
    mode); on the CPU the designed device transfers stand in: the upload's
    copy_ into the program's input, a copy to the host, item/tolist/
    nonzero."""
    def warned(orig, is_sync=lambda *a, **kw: True):
        def call(*a, **kw):
            if xfercheck.armed() and is_sync(*a, **kw):
                warnings.warn(xfercheck.SYNC_WARNING, UserWarning)
            return orig(*a, **kw)
        return call

    def to_host(self, *a, **kw):
        return any(str(v) == "cpu" for v in a) or str(kw.get("device")) == "cpu"

    monkeypatch.setattr(torch.Tensor, "copy_", warned(torch.Tensor.copy_))
    monkeypatch.setattr(torch.Tensor, "to", warned(torch.Tensor.to, to_host))
    for name in ("cpu", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, warned(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", warned(torch.nonzero))


def test_steady_scheduler_window_captures_nothing_and_syncs_twice(tmp_path, monkeypatch,
                                                                   tally):
    """A warmed window through the port's SearchScheduler: no ``capture:``
    record, no implicit sync, and the designed syncs are the JAX block loop's,
    one upload and one fetch a window."""
    monkeypatch.setenv("DFT_COMPACT", "0")
    x, q = make_data(16, 400, 64)
    cfg = IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=300, centroids=8)
    t = TIndex(cfg, device="cpu")
    sched = None
    try:
        t.add_batch(x, [(i,) for i in range(400)], train_async_if_triggered=False)
        for _ in range(1500):
            if t.get_idx_data_num() == (0, 400) and t.get_state() == IndexState.TRAINED:
                break
            threading.Event().wait(0.02)
        recorded(t.model)
        sched = SearchScheduler(lambda iid, qb, k, emb: t.search_batched(qb, k, emb),
                                SchedulerCfg(max_batch_rows=16, max_wait_ms=1.0))
        sched.submit("i", q[:16], K, False)  # the warm-up window captures
        want = t.search(q[:16], K)[1]
        monkeypatch.setenv("DFT_XFERCHECK", "1")
        xfercheck.reset()
        _warn_on_sync(monkeypatch)
        snap = compilecheck.snapshot()
        windows = 4
        for _ in range(windows):
            got = sched.submit("i", q[:16], K, False)
            assert got[1] == want
        assert compilecheck.new_since(snap) == {}
        assert xfercheck.drain() == []
        sites = xfercheck.syncs()
        assert sorted(s.split(" (")[0] for s in sites) == ["program query upload",
                                                          "program result fetch"]
        assert all(n == windows for n in sites.values()) and all(
            "programs.py:" in s for s in sites)
    finally:
        if sched is not None:
            sched.stop()
        t.retire()
        xfercheck.reset()
