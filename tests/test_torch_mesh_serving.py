"""Mesh-backed indexes behind the port's factory and engine, against the JAX
package: the builders and their env knobs and warnings, one counted model
call a merged window, the generation + MANIFEST round trip and its
torn-generation fallback, deletes on every sharded kind, and storage dirs
crossing the packages both ways. The port runs on a virtual CPU mesh
(``mesh_virtual`` / DFT_MESH_VIRTUAL), the JAX package on the suite's 8
virtual devices."""

import json
import logging
import os
import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models.pretransform import PreTransformIndex
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils import serialization as tser
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, NLIST, K, N = 16, 8, 5, 600


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((NLIST, D)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, NLIST, N)] + rng.standard_normal((N, D)).astype(np.float32)
    q = centers[rng.integers(0, NLIST, 12)] + rng.standard_normal((12, D)).astype(np.float32)
    return x, q


@pytest.fixture
def host_mesh(monkeypatch):
    """Both packages' host mesh: 4 shards (virtual on the port's CPU),
    masked mode, no compaction watcher."""
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    monkeypatch.delenv("DFT_MESH_MODE", raising=False)
    monkeypatch.setenv("DFT_COMPACT", "0")


# ------------------------------------------------------------------ builders


BUILDERS = [
    ("ivf_tpu", {}, tmesh.IvfTpuIndex, jmesh.IvfTpuIndex),
    ("ivf_tpu", {"shard_lists": True}, tmesh.ShardedIVFFlatIndex, jmesh.ShardedIVFFlatIndex),
    ("knnlm", {"shard_lists": True, "code_size": 4}, tmesh.ShardedIVFPQIndex,
     jmesh.ShardedIVFPQIndex),
    ("flat", {"mesh_shards": True}, tmesh.ShardedFlatIndex, jmesh.ShardedFlatIndex),
]


@pytest.mark.parametrize("builder,extra,tcls,jcls", BUILDERS,
                         ids=["ivf_tpu", "ivf_tpu-shard_lists", "knnlm-shard_lists",
                              "flat-mesh_shards"])
def test_builders_match_jax(builder, extra, tcls, jcls, monkeypatch):
    """The same cfg builds the counterpart class in both packages; the
    host's DFT_MESH_* fill in what cfg.extra leaves unset, and cfg.extra
    pins win."""
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_MODE", "routed")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    kw = dict(index_builder_type=builder, dim=D, metric="l2", centroids=NLIST, **extra)
    t = tfactory.build_index(IndexCfg(**kw), device="cpu")
    j = jfactory.build_index(JCfg(**kw))
    assert type(t) is tcls and type(j) is jcls
    assert t.mesh.shape["shard"] == j.mesh.shape["shard"] == 4
    assert getattr(t, "probe_routing", None) == getattr(j, "probe_routing", None)
    pinned = dict(kw, mesh_devices=2, mesh_virtual=True, probe_routing=False)
    t2 = tfactory.build_index(IndexCfg(**pinned), device="cpu")
    assert t2.mesh.shape["shard"] == 2 and getattr(t2, "probe_routing", False) is False


def test_knnlm_shard_lists_under_opq(monkeypatch):
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    t = tfactory.build_index(IndexCfg(index_builder_type="knnlm", dim=D, centroids=NLIST,
                                      code_size=4, opq=True, shard_lists=True,
                                      mesh_devices=3), device="cpu")
    assert isinstance(t, PreTransformIndex) and isinstance(t.inner, tmesh.ShardedIVFPQIndex)
    assert t.inner.mesh.size == 3


WARNINGS = [
    (dict(index_builder_type="flat", mesh_devices=1), "mesh_shards"),
    (dict(index_builder_type="knnlm", code_size=4, probe_routing=True), "shard_lists"),
    (dict(index_builder_type="ivf_tpu", probe_routing=True), "shard_lists"),
    (dict(index_builder_type="ivf_tpu", shard_lists=True, pallas_flat=True), "pallas_flat"),
]


@pytest.mark.parametrize("extra,word", WARNINGS,
                         ids=["flat-devices", "knnlm-routing", "ivf_tpu-routing",
                              "ivf_tpu-pallas_flat"])
def test_builders_warn_where_jax_warns(extra, word, caplog):
    kw = dict(dim=D, metric="l2", centroids=NLIST, **extra)
    with caplog.at_level(logging.WARNING):
        jfactory.build_index(JCfg(**kw))
    assert any(word in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tfactory.build_index(IndexCfg(**kw), device="cpu")
    assert any(word in r.getMessage() for r in caplog.records)


# -------------------------------------------------------------- the engine


def wait_until(pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def drained(e, n):
    return lambda: (e.get_idx_data_num() == (0, n)
                    and e.get_state() in (IndexState.TRAINED, JState.TRAINED))


KINDS = {
    "sharded_flat": dict(index_builder_type="flat", mesh_shards=True),
    "sharded_ivf_flat": dict(index_builder_type="ivf_tpu", shard_lists=True),
    "sharded_ivf_pq": dict(index_builder_type="knnlm", shard_lists=True, code_size=8,
                           refine_k_factor=4, kmeans_iters=4),
}


def _cfg(cls, storage, kind, **kw):
    base = dict(dim=D, metric="l2", train_num=300, centroids=NLIST, nprobe=3,
                index_storage_dir=storage, **KINDS[kind])
    base.update(kw)
    return cls(**base)


def _engine(cls, storage, kind, x, **kw):
    e = cls(_cfg(JCfg if cls is JIndex else IndexCfg, storage, kind), **kw)
    e.add_batch(x, [(i,) for i in range(x.shape[0])], train_async_if_triggered=False)
    assert wait_until(drained(e, x.shape[0]))
    return e


@pytest.mark.parametrize("kind", list(KINDS))
def test_merged_window_is_one_counted_call(data, tmp_path, host_mesh, kind):
    """engine.search_batched (a scheduler window) is one counted model call
    on every mesh kind; search and search_batched answer alike."""
    x, q = data
    e = _engine(TIndex, str(tmp_path), kind, x, device="cpu")
    try:
        assert e.model.mesh.size == 4 and e.model.state_dict()["kind"] == kind
        q32 = np.concatenate([q, q, q])[:32]
        for _ in range(3):
            e.search_batched(q32, 3)
        s = e.perf_stats()
        assert s["device_launches"]["count"] == 3 and s["device_launches"]["max_s"] == 1.0
        assert s["rows_per_launch"]["max_s"] == 32.0
        (d1, m1, _), (d2, m2, _) = e.search(q, K), e.search_batched(q, K)
        np.testing.assert_array_equal(d1, d2)
        assert m1 == m2
    finally:
        e.retire()


@pytest.mark.parametrize("kind", list(KINDS))
def test_generation_round_trip_and_torn_fallback(data, tmp_path, host_mesh, kind):
    """A mesh-backed engine saves, restores with the same answers; a torn
    newest generation is quarantined and the previous one serves."""
    x, q = data
    storage = str(tmp_path / "shard")
    e = _engine(TIndex, storage, kind, x[:500], device="cpu")
    golden = e.search_batched(q, 3)
    assert e.save()
    e.add_batch(x[500:], [(i,) for i in range(500, N)], train_async_if_triggered=False)
    assert wait_until(drained(e, N))
    assert e.save()
    e.retire()
    loaded = TIndex.from_storage_dir(storage, device="cpu")
    assert loaded.model.ntotal == N and loaded.model.state_dict()["kind"] == kind
    loaded.retire()
    gen, mpath = tser.list_generations(storage)[0]
    with open(mpath) as f:
        victim = os.path.join(storage, json.load(f)["files"]["index"]["name"])
    with open(victim, "r+b") as f:
        f.seek(12)
        f.write(b"\xde\xad\xbe\xef")
    loaded = TIndex.from_storage_dir(storage, device="cpu")
    try:
        assert loaded.model.ntotal == 500
        got = loaded.search_batched(q, 3)
        np.testing.assert_array_equal(golden[0], got[0])
        assert golden[1] == got[1]
        assert os.listdir(os.path.join(storage, "quarantine"))
        assert loaded.perf_stats()["device_launches"]["max_s"] == 1.0
    finally:
        loaded.retire()


@pytest.mark.parametrize("kind", list(KINDS))
def test_deletes_on_sharded_kinds_match_jax(data, tmp_path, host_mesh, kind):
    """remove_ids and upsert through both engines on each sharded kind: the
    JAX engine's ids, no deleted id served, and the same after the port
    compacts."""
    x, q = data
    j = _engine(JIndex, str(tmp_path / "jax"), kind, x)
    # the port engine over the JAX engine's shard (its trained state and rows)
    e = TIndex.import_snapshot(j.export_snapshot(), str(tmp_path / "port"), device="cpu")
    try:
        assert isinstance(e.model, tfactory._STATE_KINDS[kind])
        near = sorted({m[0] for row in j.search(q, 8)[1] for m in row if m})
        dead = near[:10] + list(range(0, N, 9))
        assert e.remove_ids(dead) == j.remove_ids(dead)
        e.upsert([dead[0]], q[:1])
        j.upsert([dead[0]], q[:1])
        assert wait_until(drained(e, N + 1)) and wait_until(drained(j, N + 1))
        (jd, jm, _), (td, tm, _) = j.search(q, K), e.search(q, K)
        assert tm == jm
        np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)
        served = {m[0] for row in tm for m in row if m}
        assert not served & set(dead[1:])
        assert tm[0][0] == (dead[0],)
        assert e.compact() is True
        assert e.search(q, K)[1] == tm
    finally:
        j.retire()
        e.retire()


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_sharded_dir_served_by_port(data, tmp_path, host_mesh, kind):
    """A JAX engine's sharded storage dir (after a delete) is served by the
    port engine with the JAX engine's ids."""
    x, q = data
    storage = str(tmp_path / "jax")
    j = _engine(JIndex, storage, kind, x)
    j.remove_ids(list(range(0, N, 7)))
    assert j.save() is True
    j.retire()
    want = JIndex.from_storage_dir(storage)
    got = TIndex.from_storage_dir(storage, device="cpu")
    try:
        assert isinstance(got.model, tfactory._STATE_KINDS[kind])
        (wd, wm, _), (gd, gm, _) = want.search(q, K), got.search(q, K)
        assert gm == wm
        np.testing.assert_allclose(gd, wd, rtol=1e-3, atol=1e-3)
        assert got.get_ids() == want.get_ids()
    finally:
        want.retire()
        got.retire()


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_sharded_dir_served_by_jax(data, tmp_path, host_mesh, kind):
    """The port engine builds, deletes and saves a sharded dir; the JAX
    engine loads it and serves the port's ids."""
    x, q = data
    storage = str(tmp_path / "port")
    t = _engine(TIndex, storage, kind, x, device="cpu")
    t.remove_ids(list(range(0, N, 7)))
    want_d, want_m, _ = t.search(q, K)
    assert t.save() is True
    t.retire()
    j = JIndex.from_storage_dir(storage)
    try:
        assert j.tpu_index.state_dict()["kind"] == kind
        d, m, _ = j.search(q, K)
        assert m == want_m
        np.testing.assert_allclose(d, want_d, rtol=1e-3, atol=1e-3)
    finally:
        j.retire()
