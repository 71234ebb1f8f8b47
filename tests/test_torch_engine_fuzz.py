"""Randomized op-sequence fuzz of the port's engine state machine, held
against the JAX engine (the port of tests/test_engine_fuzz.py).

The same 4 seeds and the same operation mix (add / search / save-load /
state) drive one ``distributed_faiss_tpu_torch.engine.Index`` on the CPU
and one ``distributed_faiss_tpu.engine.Index`` side by side. Besides the
JAX fuzz's own invariants (the state lattice, search iff TRAINED,
positional metadata, a save/load round trip at any point), every
checkpoint compares the two engines: state, buffered + indexed rows,
``get_ids`` and, on a search, the top-k ids on the tie-free queries
(distances within 1e-3). The IVF index probes all of its 4 lists, so
both engines answer the exact top-k whatever centroids each trained.

Metadata is ``(row,)`` rather than the JAX fuzz's bare ints, so that
``get_ids`` (which reads ``custom_meta_id_idx`` 0) has an id to return.
"""

import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.utils.config import IndexCfg as TCfg
from distributed_faiss_tpu_torch.utils.state import IndexState as TState

D = 8
K = 3
# a query row is tie-free when its exact top-(K+1) distances are this far
# apart, relative to the row's scale
TIE_REL = 1e-4


def cfgs():
    kw = dict(index_builder_type="ivf_simple", dim=D, metric="l2", train_num=150,
              centroids=4, nprobe=4)
    return TCfg(**kw), JCfg(**kw)


def settle(idx, trained_state, timeout=60):
    deadline = time.time() + timeout
    while idx.get_state() != trained_state:
        assert time.time() < deadline, f"stuck in {idx.get_state()}"
        time.sleep(0.02)


def wait_trained(idx, states, timeout=60):
    deadline = time.time() + timeout
    while idx.get_state() not in states:
        assert time.time() < deadline, f"stuck in {idx.get_state()}"
        time.sleep(0.02)


def tie_free(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    top = np.sort(d2, axis=1)[:, : K + 1]
    gaps = np.diff(top, axis=1).min(axis=1)
    return gaps > TIE_REL * np.maximum(1.0, top[:, -1])


def same_top_k(t_out, j_out, x, q, what):
    t_scores, t_meta, _ = t_out
    j_scores, j_meta, _ = j_out
    assert np.asarray(t_scores).shape == np.asarray(j_scores).shape == (q.shape[0], K)
    free = tie_free(x, q)
    for i in np.flatnonzero(free):
        assert t_meta[i] == j_meta[i], (what, i, t_meta[i], j_meta[i])
        np.testing.assert_allclose(t_scores[i], j_scores[i], rtol=1e-3, atol=1e-3)


def compare(t, j, what):
    assert t.get_state().name == j.get_state().name, what
    assert sum(t.get_idx_data_num()) == sum(j.get_idx_data_num()), what
    assert t.get_ids() == j.get_ids(), what


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_engine_random_op_sequence_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    tcfg, jcfg = cfgs()
    t = TIndex(tcfg, device="cpu")
    j = JIndex(jcfg)
    total = 0
    rows = []
    t_store = str(tmp_path / f"port{seed}")
    j_store = str(tmp_path / f"jax{seed}")

    for step in range(30):
        op = rng.choice(["add", "search", "save_load", "state"])
        what = f"seed {seed} step {step} {op}"
        if op == "add":
            n = int(rng.integers(1, 80))
            x = rng.standard_normal((n, D)).astype(np.float32)
            meta = [(i,) for i in range(total, total + n)]
            t.add_batch(x, meta)
            j.add_batch(x, meta)
            rows.append(x)
            total += n
            if total >= tcfg.train_num:
                # settle to TRAINED so later ops see a deterministic state
                settle(t, TState.TRAINED)
                settle(j, JState.TRAINED)
            else:
                assert t.get_state() == TState.NOT_TRAINED
                assert j.get_state() == JState.NOT_TRAINED
        elif op == "search":
            q = rng.standard_normal((2, D)).astype(np.float32)
            if t.get_state() == TState.TRAINED:
                # an add's drain may still be moving rows into the index
                settle_drained(t, j, total)
                t_out = t.search(q, K)
                j_out = j.search(q, K)
                assert len(t_out[1]) == 2
                for row in t_out[1]:
                    for m in row:
                        assert m is None or 0 <= m[0] < total
                same_top_k(t_out, j_out, np.concatenate(rows), q, what)
            else:
                assert j.get_state() != JState.TRAINED
                with pytest.raises(RuntimeError):
                    t.search(q, K)
                with pytest.raises(RuntimeError):
                    j.search(q, K)
        elif op == "save_load" and t.get_state() == TState.TRAINED:
            t.cfg.index_storage_dir = t_store
            j.cfg.index_storage_dir = j_store
            settle_drained(t, j, total)
            t.save()
            j.save()
            t2 = TIndex.from_storage_dir(t_store, device="cpu")
            j2 = JIndex.from_storage_dir(j_store)
            wait_trained(t2, (TState.TRAINED, TState.NOT_TRAINED))
            wait_trained(j2, (JState.TRAINED, JState.NOT_TRAINED))
            assert t2.get_state() == TState.TRAINED
            buf, nidx = t.get_idx_data_num()
            buf2, nidx2 = t2.get_idx_data_num()
            assert buf + nidx == buf2 + nidx2 == total
            compare(t2, j2, what + " (reloaded)")
            q = rng.standard_normal((1, D)).astype(np.float32)
            s1, m1, _ = t.search(q, K)
            s2, m2, _ = t2.search(q, K)
            np.testing.assert_allclose(s1, s2, rtol=1e-5)
            assert m1 == m2
            same_top_k((s2, m2, None), j2.search(q, K), np.concatenate(rows), q,
                       what + " (reloaded)")
        else:
            st = t.get_state()
            assert st in (TState.NOT_TRAINED, TState.TRAINING, TState.ADD, TState.TRAINED)
            if total >= tcfg.train_num:
                # the async train thread may not have flipped the state yet
                settle(t, TState.TRAINED)
                settle(j, JState.TRAINED)
            buf, nidx = t.get_idx_data_num()
            assert buf + nidx == total
        compare(t, j, what)


def settle_drained(t, j, total, timeout=60):
    """Both engines TRAINED with every row moved out of the buffer."""
    deadline = time.time() + timeout
    for idx, trained in ((t, TState.TRAINED), (j, JState.TRAINED)):
        while not (idx.get_state() == trained and idx.get_idx_data_num() == (0, total)):
            assert time.time() < deadline, f"never drained: {idx.get_idx_data_num()}"
            time.sleep(0.02)
