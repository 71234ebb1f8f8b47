"""The port's HNSWSQIndex (distributed_faiss_tpu_torch/models/hnsw.py) against
the JAX package's, on the same numpy inputs. Both drive native/hnsw.cpp, so
on tie-free data with the graph built on one thread a state written by
either package serves the same ids in the other, distances within 1e-3.
The port builds its own copy of the library under build/ on first use."""

import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.models import hnsw as jhnsw
from distributed_faiss_tpu.models.factory import index_from_state_dict as j_from_state
from distributed_faiss_tpu.utils import serialization as jser
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models import hnsw
from distributed_faiss_tpu_torch.models.factory import index_from_state_dict as t_from_state
from distributed_faiss_tpu_torch.utils import serialization as tser
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState


@pytest.fixture
def rng():
    """This file's own generator: its draws neither take from nor shift the
    session-wide one other test files share."""
    return np.random.default_rng(0)


def brute_l2_ids(q, x, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :k]


def recall(ids, gt):
    k = gt.shape[1]
    return np.mean([len(set(ids[i]) & set(gt[i])) / k for i in range(len(gt))])


@pytest.fixture
def one_thread(monkeypatch):
    """Graph construction on one thread: the same insert order, so the same
    graph, in both packages."""
    monkeypatch.setenv("DFT_HNSW_THREADS", "1")


@pytest.fixture
def built(rng):
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    idx = hnsw.HNSWSQIndex(24, "l2", M=16, ef_construction=80, device="cpu")
    assert not idx.is_trained
    idx.train(x[:1000])
    idx.add(x[:1500])
    idx.add(x[1500:])
    return idx, x


def test_library_is_the_ports_own_build():
    """The graph library is built from native/hnsw.cpp into build/, named by
    a hash of the source, the flags and the host CPU's features; the JAX
    package's artifact beside the source is not what the port loads."""
    import os
    import re

    lib = hnsw.load_library()
    path = hnsw.library_path()
    assert path.exists() and path.parent == hnsw.BUILD_DIR
    assert hnsw.BUILD_DIR.parts[-2] == "build"
    assert re.fullmatch(r"libdfthnsw-[0-9a-f]{12}\.so", path.name)
    assert hnsw.SOURCE.name == "hnsw.cpp" and hnsw.SOURCE.parent.name == "native"
    assert os.path.realpath(lib._name) == os.path.realpath(path)


def test_compiler_error_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises with the
    compiler's error."""
    bad = tmp_path / "hnsw.cpp"
    bad.write_text("this is not c++\n")
    monkeypatch.setattr(hnsw, "SOURCE", bad)
    monkeypatch.setattr(hnsw, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native hnsw build failed") as ei:
        hnsw.build_library()
    assert "error" in str(ei.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_and_recall(built, rng):
    idx, x = built
    assert idx.ntotal == 3000
    q = rng.standard_normal((20, 24)).astype(np.float32)
    idx.set_nprobe(128)  # efSearch
    D, I = idx.search(q, 10)
    assert recall(I, brute_l2_ids(q, x, 10)) > 0.85
    assert np.all(np.diff(D, axis=1) >= 0)


def test_ef_tradeoff(built, rng):
    idx, x = built
    q = rng.standard_normal((20, 24)).astype(np.float32)
    gt = brute_l2_ids(q, x, 10)

    def at(ef):
        idx.set_nprobe(ef)
        return recall(idx.search(q, 10)[1], gt)

    assert at(256) >= at(10) - 0.05


def test_self_query_and_reconstruct(built):
    idx, x = built
    idx.set_nprobe(64)
    _, I = idx.search(x[:8], 1)
    assert (I[:, 0] == np.arange(8)).sum() >= 7  # SQ8 noise may miss one
    assert np.max(np.abs(idx.reconstruct_batch(np.arange(4)) - x[:4])) < 0.1


def test_untrained_add_raises():
    idx = hnsw.HNSWSQIndex(8, "l2", device="cpu")
    with pytest.raises(RuntimeError, match="trained"):
        idx.add(np.zeros((3, 8), np.float32))
    with pytest.raises(RuntimeError, match="l2"):
        hnsw.HNSWSQIndex(8, "dot", device="cpu")


def test_concurrent_searches_consistent(rng):
    import threading

    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    idx = hnsw.HNSWSQIndex(16, "l2", M=16, ef_construction=60, refine_k_factor=4,
                           device="cpu")
    idx.train(x)
    idx.add(x)
    D0, I0 = idx.search(q, 5)
    outs = [None] * 6

    def worker(t):
        outs[t] = idx.search(q, 5)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    for D, I in outs:
        np.testing.assert_array_equal(I, I0)
        np.testing.assert_allclose(D, D0, rtol=1e-6)


def test_refine_lifts_recall_past_095(rng):
    """The exact rescore of the shortlist on the model's device clears 0.95
    where the bare SQ8 graph does not, and survives a state round trip."""
    n, d = 8000, 48
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((30, d)).astype(np.float32)
    gt = brute_l2_ids(q, x, 10)

    def build(rf):
        idx = hnsw.HNSWSQIndex(d, "l2", M=24, ef_construction=100, refine_k_factor=rf,
                               device="cpu")
        idx.train(x[:2000])
        idx.add(x)
        idx.set_nprobe(128)
        return idx

    plain, refined = build(0), build(8)
    r_plain, r_ref = recall(plain.search(q, 10)[1], gt), recall(refined.search(q, 10)[1], gt)
    assert r_ref >= 0.95 and r_ref > r_plain, (r_plain, r_ref)
    D, _ = refined.search(q, 10)
    assert np.all(np.diff(D, axis=1) >= 0)
    again = hnsw.HNSWSQIndex.from_state_dict(refined.state_dict(), device="cpu")
    again.set_nprobe(128)
    assert recall(again.search(q, 10)[1], gt) >= 0.95


def test_refine_keeps_k_columns_on_tiny_corpus(rng):
    idx = hnsw.HNSWSQIndex(16, "l2", M=8, ef_construction=40, refine_k_factor=8,
                           device="cpu")
    idx.train(rng.standard_normal((100, 16)).astype(np.float32))
    idx.add(rng.standard_normal((5, 16)).astype(np.float32))
    D, I = idx.search(rng.standard_normal((3, 16)).astype(np.float32), 10)
    assert D.shape == (3, 10) and I.shape == (3, 10)
    assert (I >= 0).sum(axis=1).tolist() == [5, 5, 5]
    assert np.isinf(D[:, 5:]).all()


@pytest.mark.parametrize("refine", [0, 8])
def test_same_results_as_jax_on_the_same_rows(rng, one_thread, refine):
    """Built from the same rows on one thread, the two packages' indexes give
    the same ids; distances within 1e-3."""
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((25, 16)).astype(np.float32)
    port = hnsw.HNSWSQIndex(16, "l2", M=16, ef_construction=64, refine_k_factor=refine,
                            device="cpu")
    ref = jhnsw.HNSWSQIndex(16, "l2", M=16, ef_construction=64, refine_k_factor=refine)
    for idx in (port, ref):
        idx.train(x[:800])
        idx.add(x[:1200])
        idx.add(x[1200:])
        idx.set_nprobe(48)
    (pd, pi), (rd, ri) = port.search(q, 10), ref.search(q, 10)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_served_by_the_other_package(rng, one_thread, tmp_path, direction):
    """A state written as npz by one package loads in the other with the same
    state_dict keys and serves the writer's ids, distances within 1e-3."""
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    if direction == "jax_to_port":
        writer = jhnsw.HNSWSQIndex(16, "l2", M=12, ef_construction=50, refine_k_factor=8)
    else:
        writer = hnsw.HNSWSQIndex(16, "l2", M=12, ef_construction=50, refine_k_factor=8,
                                  device="cpu")
    writer.train(x)
    writer.add(x)
    writer.set_nprobe(40)
    path = str(tmp_path / "h.npz")
    if direction == "jax_to_port":
        jser.save_state(path, writer.state_dict())
        reader = t_from_state(tser.load_state(path), device="cpu")
    else:
        tser.save_state(path, writer.state_dict())
        reader = j_from_state(jser.load_state(path))
    assert sorted(reader.state_dict()) == sorted(writer.state_dict())
    assert reader.ntotal == 1500 and reader.nprobe == 40
    (wd, wi), (rd, ri) = writer.search(q, 8), reader.search(q, 8)
    np.testing.assert_array_equal(ri, wi)
    np.testing.assert_allclose(rd, wd, rtol=1e-3, atol=1e-3)


def _wait(idx, trained, timeout=60.0):
    deadline = time.time() + timeout
    while idx.get_state() != trained or idx.get_idx_data_num()[0] > 0:
        assert time.time() < deadline, "train/drain timed out"
        time.sleep(0.05)


def test_engine_storage_dir_both_ways(rng, one_thread, tmp_path):
    """The hnswsq builder through each engine's lifecycle (nprobe ->
    efSearch): each package's storage dir loads in the other and serves the
    same metadata ids."""
    x = rng.standard_normal((800, 16)).astype(np.float32)
    q = x[:6] + 0.01 * rng.standard_normal((6, 16)).astype(np.float32)
    meta = [("d", i) for i in range(800)]
    kw = dict(index_builder_type="hnswsq", dim=16, metric="l2", train_num=300, nprobe=64,
              store_n=16, ef_construction=40)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jidx = JIndex(JCfg(index_storage_dir=jdir, **kw))
    tidx = TIndex(IndexCfg(index_storage_dir=tdir, **kw), device="cpu")
    for idx, trained in ((jidx, JState.TRAINED), (tidx, IndexState.TRAINED)):
        idx.add_batch(x, meta, train_async_if_triggered=False)
        _wait(idx, trained)
        assert idx.save() is True
        idx.retire()
    assert type(tidx.model).__name__ == "HNSWSQIndex" and tidx.model.M == 16
    _, want_j, _ = jidx.search(q, 5)
    _, want_t, _ = tidx.search(q, 5)
    assert sum(want_t[i][0] == ("d", i) for i in range(6)) >= 5
    port_from_jax = TIndex.from_storage_dir(jdir, device="cpu")
    jax_from_port = JIndex.from_storage_dir(tdir)
    try:
        assert port_from_jax.search(q, 5)[1] == want_j
        assert jax_from_port.search(q, 5)[1] == want_t
    finally:
        port_from_jax.retire()
        jax_from_port.retire()
