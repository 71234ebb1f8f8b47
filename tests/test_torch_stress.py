"""Threaded stress tests of the port's engine (the port of
tests/test_stress.py, with its bounds): one ``engine.Index`` on the CPU
hammered with concurrent add/search/save/state traffic, asserting the
same invariants (no exceptions besides the documented not-trained error,
conserved vector counts, consistent final state), the drain re-trigger,
drop racing the add worker, and ``get_ids`` building its set outside
``buffer_lock``.
"""

import threading
import time

import numpy as np

from distributed_faiss_tpu_torch.engine import Index as _Index
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState


def Index(cfg):
    return _Index(cfg, device="cpu")


def test_concurrent_add_search_save(rng, tmp_path):
    cfg = IndexCfg(index_builder_type="flat", dim=16, metric="l2",
                   train_num=50, buffer_bsz=64,
                   index_storage_dir=str(tmp_path / "shard"))
    idx = Index(cfg)
    errors = []
    n_writers, batches, bs = 4, 12, 25
    stop = threading.Event()

    def writer(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(batches):
                idx.add_batch(r.standard_normal((bs, 16)).astype(np.float32), None)
                time.sleep(0.001)
        except Exception as e:
            errors.append(("writer", e))

    def searcher():
        r = np.random.default_rng(99)
        try:
            while not stop.is_set():
                try:
                    idx.search(r.standard_normal((3, 16)).astype(np.float32), 5)
                except RuntimeError as e:
                    # only the documented not-trained refusal is acceptable
                    if "not trained" not in str(e):
                        raise
                time.sleep(0.001)
        except Exception as e:
            errors.append(("searcher", e))

    def saver():
        try:
            while not stop.is_set():
                idx.save()
                time.sleep(0.005)
        except Exception as e:
            errors.append(("saver", e))

    def poller():
        try:
            while not stop.is_set():
                idx.get_state()
                idx.get_idx_data_num()
                time.sleep(0.001)
        except Exception as e:
            errors.append(("poller", e))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n_writers)]
    aux = [threading.Thread(target=searcher), threading.Thread(target=saver),
           threading.Thread(target=poller)]
    for t in aux:
        t.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    total = n_writers * batches * bs
    deadline = time.time() + 60
    while time.time() < deadline:
        buf, indexed = idx.get_idx_data_num()
        if idx.get_state() == IndexState.TRAINED and buf == 0 and indexed == total:
            break
        time.sleep(0.05)
    stop.set()
    for t in aux:
        t.join()

    assert not errors, errors
    buf, indexed = idx.get_idx_data_num()
    assert (buf, indexed) == (0, total)
    assert len(idx.id_to_metadata) == total
    # post-stress search works and metadata joins hold
    D, M, _ = idx.search(np.zeros((2, 16), np.float32), 5)
    assert D.shape == (2, 5)


def test_no_stranded_rows_after_add_race(rng):
    """Rows appended in the drain-exit window must still reach the index
    without further add_batch calls (the reference strands them until the
    next add; our drain re-trigger fixes it)."""
    for trial in range(3):
        idx = Index(IndexCfg(index_builder_type="flat", dim=8, metric="l2",
                             train_num=1, buffer_bsz=256))

        def writer(seed):
            r = np.random.default_rng(seed)
            for _ in range(20):
                idx.add_batch(r.standard_normal((37, 8)).astype(np.float32), None)

        threads = [threading.Thread(target=writer, args=(trial * 10 + i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = 4 * 20 * 37
        deadline = time.time() + 60
        while time.time() < deadline:
            buf, n = idx.get_idx_data_num()
            if buf == 0 and n == total and idx.get_state() == IndexState.TRAINED:
                break
            time.sleep(0.05)
        assert idx.get_idx_data_num() == (0, total)


def test_concurrent_drop_during_add(rng):
    """drop_index racing the async add worker must not wedge the state."""
    for trial in range(3):
        cfg = IndexCfg(index_builder_type="flat", dim=8, metric="l2",
                       train_num=10, buffer_bsz=32)
        idx = Index(cfg)
        idx.add_batch(rng.standard_normal((64, 8)).astype(np.float32), None,
                      train_async_if_triggered=False)
        idx.add_batch(rng.standard_normal((256, 8)).astype(np.float32), None)
        time.sleep(0.002 * trial)
        idx.drop_index()
        time.sleep(0.2)
        st = idx.get_state()
        assert st == IndexState.NOT_TRAINED, st
        assert idx.get_idx_data_num() == (0, 0)
        # shard is reusable after the drop
        idx.add_batch(rng.standard_normal((20, 8)).astype(np.float32), None,
                      train_async_if_triggered=False)
        deadline = time.time() + 30
        while idx.get_state() != IndexState.TRAINED and time.time() < deadline:
            time.sleep(0.02)
        assert idx.get_state() == IndexState.TRAINED


def test_get_ids_does_not_stall_adds_on_large_store():
    """get_ids builds its set OUTSIDE buffer_lock: a 1e6-row metadata store
    must not stall a concurrent add_batch for the duration of the O(ntotal)
    Python iteration (as in the JAX engine)."""
    idx = Index(IndexCfg(index_builder_type="flat", dim=8, metric="l2",
                         train_num=10**9, buffer_bsz=10**9))
    n = 1_000_000
    idx.id_to_metadata.extend((i, f"m{i}") for i in range(n))

    t0 = time.time()
    ids = idx.get_ids()
    get_ids_s = time.time() - t0
    assert len(ids) == n

    done = threading.Event()
    waits = []

    def prober():
        while not done.is_set():
            t = time.time()
            with idx.buffer_lock:
                pass
            waits.append(time.time() - t)
            time.sleep(0.001)

    p = threading.Thread(target=prober)
    p.start()
    for _ in range(3):
        idx.get_ids()
    done.set()
    p.join()

    # the lock is held only for the (array ref, length) snapshot — even with
    # the whole-store iteration in flight, a waiter must get through orders
    # of magnitude faster than one full get_ids pass. Assert on the MEDIAN
    # wait with a 0.25 s floor, not the max with 0.05 s: on a loaded
    # single-core CI host, scheduler jitter alone can park the prober past
    # 50 ms once, and a single descheduling must not fail the test — a
    # genuinely held lock would drag the median, not just the tail.
    assert waits, "prober never ran"
    median_wait = sorted(waits)[len(waits) // 2]
    assert median_wait < max(0.25, get_ids_s / 4), (median_wait, max(waits), get_ids_s)
