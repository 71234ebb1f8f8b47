"""The port's SearchBatcher (distributed_faiss_tpu_torch/utils/batching.py)
against the JAX package's, on the same numpy inputs: concurrent searches
coalesce into shared launches and every caller gets exactly what an
individual search gives; errors reach their whole group and only it; a
leader hands off under load; and the port's engine searches through it."""

import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.utils.batching import SearchBatcher as JBatcher
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.utils.batching import SearchBatcher as TBatcher
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

@pytest.fixture
def rng():
    """This file's own generator: its draws neither take from nor shift the
    session-wide one other test files share."""
    return np.random.default_rng(0)


def brute(q, x, k):
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(2)
    ids = np.argsort(d2, axis=1)[:, :k]
    return np.take_along_axis(d2, ids, axis=1), ids


def make_runner(x, counter=None, delay=0.0):
    def run(q, k):
        if counter is not None:
            counter.append(q.shape[0])
        if delay:
            time.sleep(delay)
        return brute(q, x, k)
    return run


def run_threads(targets, timeout=20.0):
    ts = [threading.Thread(target=fn, args=args) for fn, args in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a caller never returned"


def concurrent_results(batcher, x, qs, k, window_ms):
    b = TBatcher(make_runner(x), window_ms=window_ms)
    got = [None] * len(qs)

    def worker(i):
        got[i] = b.search(qs[i], k)

    run_threads([(worker, (i,)) for i in range(len(qs))])
    return got


@pytest.mark.parametrize("window_ms", [0.0, 20.0])
def test_batched_results_equal_individual_and_jax(rng, window_ms):
    """16 concurrent callers through the port's batcher get what an
    individual search gives, and what the JAX package's batcher gives."""
    x = rng.standard_normal((500, 8)).astype(np.float32)
    qs = [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(16)]
    port = concurrent_results(TBatcher, x, qs, 4, window_ms)
    ref = concurrent_results(JBatcher, x, qs, 4, window_ms)
    for q, (ps, pi), (rs, ri) in zip(qs, port, ref):
        ws, wi = brute(q, x, 4)
        np.testing.assert_array_equal(pi, wi)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, ws, rtol=1e-5)
        np.testing.assert_allclose(ps, rs, rtol=1e-5)


def test_window_coalesces_concurrent_callers(rng):
    """Followers that arrive during the leader's wait ride its launch."""
    x = rng.standard_normal((200, 4)).astype(np.float32)
    calls = []
    b = TBatcher(make_runner(x, counter=calls), window_ms=150)
    start = threading.Barrier(8)

    def worker():
        start.wait()
        b.search(np.zeros((2, 4), np.float32), 3)

    run_threads([(worker, ())] * 8)
    assert len(calls) < 8
    assert sum(calls) == 16  # every row searched exactly once


def test_mixed_k_grouping(rng):
    x = rng.standard_normal((100, 4)).astype(np.float32)
    b = TBatcher(make_runner(x), window_ms=50)
    out = {}

    def worker(i, k):
        out[(i, k)] = b.search(np.full((1, 4), i, np.float32), k)

    run_threads([(worker, (i, k)) for i, k in enumerate([2, 5, 2, 5, 2])])
    assert len(out) == 5
    for (i, k), (_s, ids) in out.items():
        assert ids.shape == (1, k)
        np.testing.assert_array_equal(ids, brute(np.full((1, 4), i, np.float32), x, k)[1])


def test_error_propagates_to_all_group_members():
    def run(q, k):
        raise ValueError("device on fire")

    b = TBatcher(run, window_ms=50)
    errs = []

    def worker():
        try:
            b.search(np.zeros((1, 4), np.float32), 3)
        except ValueError as e:
            errs.append(e)

    run_threads([(worker, ())] * 4)
    assert len(errs) == 4
    with pytest.raises(ValueError):  # not wedged afterwards
        b.search(np.zeros((1, 4), np.float32), 3)


def test_base_exception_wakes_every_group():
    """A BaseException from one group's launch wakes the callers of every
    group in the popped batch, and the batcher serves afterwards."""
    calls = []

    def run(q, k):
        calls.append(k)
        if len(calls) == 1:
            raise KeyboardInterrupt
        return np.zeros((q.shape[0], k), np.float32), np.zeros((q.shape[0], k), np.int64)

    b = TBatcher(run, window_ms=80)
    results = {}

    def worker(i, k):
        try:
            results[i] = ("ok", b.search(np.full((1, 4), i, np.float32), k))
        except BaseException as e:  # noqa: BLE001 - the test wants the class
            results[i] = ("err", type(e).__name__)

    run_threads([(worker, (i, k)) for i, k in enumerate([2, 2, 5, 5])], timeout=10)
    assert len(results) == 4
    _s, ids = b.search(np.zeros((1, 4), np.float32), 3)
    assert ids.shape == (1, 3)


def test_bad_dim_caller_fails_alone(rng):
    x = rng.standard_normal((100, 8)).astype(np.float32)
    b = TBatcher(make_runner(x), window_ms=60)
    qs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    results, errs = {}, {}

    def good(i):
        results[i] = b.search(qs[i], 3)

    def bad():
        try:
            b.search(np.zeros((2, 5), np.float32), 3)  # wrong dim
        except ValueError as e:
            errs["bad"] = e

    run_threads([(good, (i,)) for i in range(3)] + [(bad, ())])
    assert "bad" in errs
    for i in range(3):
        np.testing.assert_array_equal(results[i][1], brute(qs[i], x, 3)[1])
    with pytest.raises(ValueError):
        b.search(np.zeros((4,), np.float32), 3)  # 1-D refused at entry


def test_leadership_handoff_under_load():
    """With max_rounds=1 a follower that arrives during the leader's launch
    is promoted to leader and still served."""
    x = np.arange(400, dtype=np.float32).reshape(100, 4)
    calls = []
    b = TBatcher(make_runner(x, counter=calls, delay=0.15), window_ms=0, max_rounds=1)
    got = {}

    def first():
        got["first"] = b.search(np.zeros((1, 4), np.float32), 3)

    def second():
        time.sleep(0.05)  # arrive while the leader's launch is in flight
        got["second"] = b.search(np.full((1, 4), 400.0, np.float32), 3)

    run_threads([(first, ()), (second, ())], timeout=10)
    assert got["first"][1].tolist() == [[0, 1, 2]]
    assert got["second"][1].tolist() == [[99, 98, 97]]
    assert calls == [1, 1]


def _trained(idx, state):
    deadline = time.time() + 60
    while idx.get_state() != state or idx.get_idx_data_num()[0] > 0:
        assert time.time() < deadline, "train/drain timed out"
        time.sleep(0.02)


def test_engine_concurrent_search_matches_jax(rng):
    """The port's engine searches through its batcher (batch_window_ms):
    concurrent searches return what sequential ones do, and what the JAX
    engine returns for the same rows and queries."""
    x = rng.standard_normal((400, 16)).astype(np.float32)
    tidx = TIndex(IndexCfg(index_builder_type="flat", dim=16, metric="l2", train_num=1,
                           batch_window_ms=30), device="cpu")
    jidx = JIndex(JCfg(index_builder_type="flat", dim=16, metric="l2", train_num=1))
    for idx, state in ((tidx, IndexState.TRAINED), (jidx, JState.TRAINED)):
        idx.add_batch(x, list(range(400)), train_async_if_triggered=False)
        _trained(idx, state)
    calls = []
    run = tidx._device_search
    tidx._batcher._run = lambda q, k: (calls.append(q.shape[0]), run(q, k))[1]

    want = [jidx.search(x[i:i + 2], 3) for i in range(0, 20, 2)]
    got = [None] * 10

    def worker(j):
        got[j] = tidx.search(x[2 * j:2 * j + 2], 3)

    run_threads([(worker, (j,)) for j in range(10)])
    for (ws, wm, _), (gs, gm, _) in zip(want, got):
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
        assert gm == wm
    assert sum(calls) == 20 and len(calls) < 10  # the window coalesced
    # the scheduler's entry skips the batcher
    n = len(calls)
    tidx.search_batched(x[:2], 3)
    assert len(calls) == n
