"""The port's mutation slice (tombstone deletes, upsert, compaction) against
the JAX package's, on the same numpy inputs, on the CPU.

Model layer: an index trained in JAX is carried into the port, the same
rows are removed on both sides, and both search the same queries: the same
ids (tie-free data) and distances within rtol/atol 1e-3 (1e-4 for ADC
scores, the JAX package's bar, models/ivf.py:590-593); the port's masked
index also answers like one rebuilt over the survivors. Engine layer:
buffered deletes, upsert ordering, the sidecar bytes, crash recovery, the
compaction watcher and the refusal of graph kinds. Interop: each package
serves a storage dir the other mutated."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.mutation import compaction as jcompaction
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch import engine as tengine
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.mutation import compaction as tcompaction
from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan
from distributed_faiss_tpu_torch.utils import racecheck
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, NLIST, K = 16, 8, 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    centers = rng.standard_normal((NLIST, D)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, NLIST, 600)]
         + rng.standard_normal((600, D)).astype(np.float32))
    q = (centers[rng.integers(0, NLIST, 12)]
         + rng.standard_normal((12, D)).astype(np.float32))
    return x, q


def assert_same_results(port, ref, tol):
    (dp, ip), (dr, ir) = port, ref
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_array_equal(np.isinf(dp), np.isinf(dr))
    f = np.isfinite(dr)
    np.testing.assert_allclose(dp[f], dr[f], rtol=tol, atol=tol)


def _dead_rows(ref, q):
    """Every query's two nearest rows (so the delete changes each top-k)
    and every 7th row."""
    _, i = ref.search(q, 2)
    return np.union1d(i.ravel(), np.arange(0, 600, 7))


# (label, JAX factory spec or builder cfg, metric, score tolerance)
MODEL_CASES = [
    ("Flat-l2", dict(faiss_factory="Flat"), "l2", 1e-3),
    ("Flat-dot", dict(faiss_factory="Flat"), "dot", 1e-3),
    ("SQ8-l2", dict(faiss_factory="SQ8"), "l2", 1e-3),
    ("IVF8,Flat-l2", dict(faiss_factory="IVF8,Flat"), "l2", 1e-3),
    ("IVF8,SQfp16-l2", dict(faiss_factory="IVF8,SQfp16"), "l2", 1e-3),
    ("IVF8,SQfp16-dot", dict(faiss_factory="IVF8,SQfp16"), "dot", 1e-3),
    ("ivfsq-pallas", dict(index_builder_type="ivfsq", pallas_flat=True), "l2", 1e-3),
    ("IVF8,PQ4-l2", dict(faiss_factory="IVF8,PQ4"), "l2", 1e-4),  # K2 geometry
    ("IVF8,PQ8-l2", dict(faiss_factory="IVF8,PQ8"), "l2", 1e-4),  # K3 geometry
    ("IVF8,PQ8-dot", dict(faiss_factory="IVF8,PQ8"), "dot", 1e-4),
    ("knnlm-bf16", dict(index_builder_type="knnlm", code_size=8, pallas_adc=True,
                        adc_lut_bf16=True, refine_k_factor=4), "l2", 1e-3),
    ("PQ4-l2", dict(faiss_factory="PQ4"), "l2", 1e-4),  # flat PQ: K4's path
    ("PQ8,RFlat-dot", dict(faiss_factory="PQ8,RFlat"), "dot", 1e-3),
]


def _jax_model(x, spec, metric):
    ref = jfactory.build_index(JCfg(dim=D, metric=metric, centroids=NLIST, nprobe=3,
                                    kmeans_iters=4, **spec))
    if hasattr(ref, "pq_iters"):
        ref.pq_iters = 4
    ref.train(x[:400])
    ref.add(x)
    ref.set_nprobe(3)
    return ref


@pytest.mark.parametrize("label,spec,metric,tol", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_remove_rows_matches_jax(data, label, spec, metric, tol):
    """The same deletes on both packages' models give the same ids and
    distances; no deleted row surfaces; and the port's masked index
    answers like the index rebuilt over the survivors (its compacted
    state, same centroids and codebooks)."""
    x, q = data
    ref = _jax_model(x, spec, metric)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    dead = _dead_rows(ref, q)
    ref.remove_rows(dead)
    port.remove_rows(dead)
    got = port.search(q, K)
    assert_same_results(got, ref.search(q, K), tol)
    assert not np.intersect1d(got[1].ravel(), dead).size
    keep = np.ones(600, bool)
    keep[dead] = False
    fresh = tfactory.index_from_state_dict(
        tcompaction.compact_state(port.state_dict(), keep), device="cpu")
    fresh.set_nprobe(3)
    fd, fi = fresh.search(q, K)
    survivors = np.flatnonzero(keep)
    assert_same_results(got, (fd, np.where(fi >= 0, survivors[fi], -1)), tol)


@pytest.mark.parametrize("spec", ["Flat", "IVF8,SQfp16", "IVF8,PQ8", "PQ4"])
def test_k_beyond_live_rows_gives_sentinels(data, spec):
    """With three rows left, a top-10 holds those three and seven sentinels
    (id -1, distance +inf), as in the JAX package."""
    x, q = data
    ref = _jax_model(x, dict(faiss_factory=spec), "l2")
    ref.set_nprobe(NLIST)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    dead = np.setdiff1d(np.arange(600), [5, 300, 599])
    ref.remove_rows(dead)
    port.remove_rows(dead)
    d, i = port.search(q, 10)
    assert_same_results((d, i), ref.search(q, 10), 1e-3)
    assert (np.sort(i[:, :3], axis=1) == [5, 300, 599]).all()
    assert (i[:, 3:] == -1).all() and np.isposinf(d[:, 3:]).all()


class _OpLog(TorchDispatchMode):
    """Names of the aten ops a block of code dispatches."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("spec", ["Flat", "SQ8", "IVF8,SQfp16", "IVF8,PQ8", "IVF8,PQ4", "PQ8"])
def test_delete_nothing_issues_the_same_ops(data, spec):
    """An index nothing was deleted from searches with exactly the ops (and
    kernel launches) it did before the mutation slice: no live mask is
    allocated, and an empty delete changes nothing."""
    x, q = data
    port = interop.from_jax_state(_jax_model(x, dict(faiss_factory=spec), "l2").state_dict(),
                                  device="cpu")

    def traced():
        wrappers = (flat_scan.flat_list_scan, adc_scan.adc_scan, adc_scan.adc_scan_lists,
                    adc_scan.adc_scan_shared)
        for w in wrappers:
            w.launches = 0
        with _OpLog() as log:
            out = port.search(q, K)
        return log.ops, [w.launches for w in wrappers], out

    ops0, launches0, (d0, i0) = traced()
    port.remove_rows(np.zeros(0, np.int64))
    ops1, launches1, (d1, i1) = traced()
    assert getattr(getattr(port, "store", None), "live", None) is None
    assert ops1 == ops0 and launches1 == launches0
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)


@pytest.mark.parametrize("spec", ["OPQ8,PQ8", "PCA8,IVF8,Flat"])
def test_pretransform_delegates_the_mask(data, spec):
    """A pre-transform masks through its inner index: same results as the
    JAX package after the same deletes."""
    x, q = data
    ref = _jax_model(x, dict(faiss_factory=spec, opq_iters=2), "l2")
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert port.supports_remove_rows()
    dead = _dead_rows(ref, q)
    ref.remove_rows(dead)
    port.remove_rows(dead)
    assert_same_results(port.search(q, K), ref.search(q, K), 1e-3)


@pytest.mark.parametrize("spec", ["Flat", "SQ8", "IVF8,SQ8,RFlat", "IVF8,Flat", "IVF8,PQ4,RFlat",
                                  "PQ8"])
def test_compact_state_matches_jax(data, spec):
    """compact_state gives the JAX package's arrays on the same state dict,
    key for key."""
    x, q = data
    ref = _jax_model(x, dict(faiss_factory=spec), "l2")
    state = {k: (np.array(v) if hasattr(v, "__array__") else v)
             for k, v in ref.state_dict().items()}
    keep = np.ones(600, bool)
    keep[_dead_rows(ref, q)] = False
    want = jcompaction.compact_state(state, keep)
    got = tcompaction.compact_state(state, keep)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v, err_msg=key)
        else:
            assert got[key] == v, key


def test_compaction_refuses_graph_and_pretransform_kinds():
    for kind in ("pretransform", "hnswsq"):
        with pytest.raises(tcompaction.CompactionUnsupported):
            tcompaction.compact_state({"kind": kind}, np.ones(3, bool))


# ------------------------------------------------------------ engine layer


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


def _cfg(cls, storage, **kw):
    base = dict(index_builder_type="ivfsq", dim=D, metric="l2", train_num=300, centroids=NLIST,
                nprobe=NLIST, index_storage_dir=storage)
    base.update(kw)
    return cls(**base)


def _engines(tmp_path, **kw):
    """A JAX and a port engine over the same cfg, each with its dir."""
    j = JIndex(_cfg(JCfg, str(tmp_path / "jax"), **kw))
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "port"), **kw), device="cpu")
    return j, t


@pytest.fixture
def no_watcher(monkeypatch):
    monkeypatch.setenv("DFT_COMPACT", "0")


def test_buffered_deletes_never_serve(data, tmp_path, no_watcher):
    """Ids deleted while their rows sit in the add buffer (before training,
    and mid-ingest after it) never serve once the rows drain; both
    packages answer the same."""
    x, q = data
    j, t = _engines(tmp_path, buffer_bsz=100)
    meta = [(i,) for i in range(600)]
    dead = list(range(0, 600, 5))
    try:
        for e in (j, t):
            e.add_batch(x[:200], meta[:200], train_async_if_triggered=False)
            assert e.remove_ids(dead[:40]) == 40  # all buffered, no model yet
            e.add_batch(x[200:], meta[200:], train_async_if_triggered=False)
            e.remove_ids(dead[40:])
            assert wait_until(drained(e, 600))
        (jd, jm, _), (td, tm, _) = j.search(q, K), t.search(q, K)
        assert tm == jm
        np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)
        assert not {m[0] for row in tm for m in row} & set(dead)
        assert t.get_ids() == j.get_ids() == set(range(600)) - set(dead)
    finally:
        j.retire()
        t.retire()


def test_upsert_visibility_order(data, tmp_path, no_watcher):
    """After upsert returns the old row no longer serves; the new one
    serves once its chunk drains; the id never serves twice."""
    x, q = data
    _, t = _engines(tmp_path)
    try:
        t.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
        assert wait_until(drained(t, 600))
        _, m, _ = t.search(q[:1], 1)
        old = m[0][0][0]
        assert t.upsert([old], q[:1] + 100.0) == 1
        with t.index_lock:  # the drain of the new row may be under way
            _, ids = t.model.search(q[:1], 600)
        assert old not in ids[0]
        assert wait_until(drained(t, 601))
        _, m, _ = t.search(q[:1] + 100.0, 600)
        assert m[0][0] == (old,) and m[0].count((old,)) == 1
        assert t.mutation_stats()["tombstoned_rows"] == 1
    finally:
        t.retire()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_sidecar_payloads_are_the_jax_bytes(data, tmp_path, no_watcher):
    """The same deletes, versioned and not, an upsert and a save leave
    byte-equal standalone sidecars and generation tombstone files."""
    x, _ = data
    j, t = _engines(tmp_path)
    meta = [(i, "doc") for i in range(600)]
    try:
        for e in (j, t):
            e.add_batch(x, meta, train_async_if_triggered=False)
            assert wait_until(drained(e, 600))
            e.remove_ids([3, 4, 5])
            e.remove_ids([6, 7, 1000], version=(1700000000000, 0, 42))
            e.upsert([9], x[:1], [(9, "doc")], version=(1700000000001, 0, 42))
            assert wait_until(drained(e, 601))
            assert e.save() is True
        for name in ("tombstones.json", "tombstones-g00000001.json"):
            want = _read(tmp_path / "jax" / name)
            assert _read(tmp_path / "port" / name) == want
        payload = json.loads(want)
        assert payload["dead_rows"] == [3, 4, 5, 6, 7, 9]
        assert [1000, [1700000000000, 0, 42]] in payload["dead_versions"]
    finally:
        j.retire()
        t.retire()


def _served_ids(e, q):
    return {m[0] for row in e.search(q, 20)[1] for m in row if m}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_crash_fallback_keeps_tombstones(data, tmp_path, no_watcher, pkg):
    """A delete acknowledged after the last save survives a restart (the
    standalone sidecar); a delete after a compaction survives a restart
    whose compacted generation tore (re-applied by id on the older
    layout). Both packages, the same steps, the same ids served."""
    x, q = data
    storage = str(tmp_path / "shard")
    cls, kw = (JIndex, {}) if pkg == "jax" else (TIndex, {"device": "cpu"})
    e = cls(_cfg(JCfg if pkg == "jax" else IndexCfg, storage), **kw)
    e.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
    assert wait_until(drained(e, 600))
    near = sorted(_served_ids(e, q))
    assert e.save() is True  # generation 1
    e.remove_ids(near[:10])  # only in the standalone sidecar
    e.retire()
    e = cls.from_storage_dir(storage, **kw)
    assert not _served_ids(e, q) & set(near[:10])
    assert e.save() is True  # generation 2 holds the deletes
    assert e.compact() is True  # generation 3, layout 3
    e.remove_ids(near[10:20])
    e.retire()
    # tear generation 3: its index file no longer matches the manifest
    with open(os.path.join(storage, "index-g00000003.npz"), "ab") as f:
        f.write(b"torn")
    e = cls.from_storage_dir(storage, **kw)
    try:
        assert e.current_generation() == 2
        assert e._mutation_counters["load_fallbacks"] == 1
        assert not _served_ids(e, q) & set(near[:20])
        assert e.get_ids() == set(range(600)) - set(near[:20])
    finally:
        e.retire()


def test_compaction_watcher_over_threshold(data, tmp_path, monkeypatch):
    """Past DFT_COMPACT_THRESHOLD the watcher compacts on its own into a
    fresh generation; the ids served stay the same."""
    monkeypatch.setenv("DFT_COMPACT_INTERVAL", "0.05")
    monkeypatch.setenv("DFT_COMPACT_THRESHOLD", "0.25")
    x, q = data
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "shard")), device="cpu")
    try:
        t.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
        assert wait_until(drained(t, 600))
        t.remove_ids(range(100))
        time.sleep(0.3)
        assert t.mutation_stats()["compactions"] == 0  # 1/6 < 0.25
        before = t.search(q, K)[1]
        t.remove_ids(range(100, 200))
        after = t.search(q, K)[1]
        assert wait_until(lambda: t.mutation_stats()["compactions"] == 1)
        assert t.get_idx_data_num() == (0, 400) and t.tombstone_fraction() == 0.0
        assert t.search(q, K)[1] == after
        assert not {m[0] for row in after for m in row} & set(range(200))
        assert before != after
    finally:
        t.retire()


def test_compacted_model_lands_on_the_engine_device(data, tmp_path, no_watcher, monkeypatch):
    """Compaction builds the new model on the engine's device directly."""
    x, _ = data
    seen = []
    real = tengine.index_from_state_dict

    def spy(state, device="cuda"):
        seen.append(device)
        return real(state, device=device)

    monkeypatch.setattr(tengine, "index_from_state_dict", spy)
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "shard"), refine_k_factor=0), device="cpu")
    try:
        t.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
        assert wait_until(drained(t, 600))
        t.remove_ids(range(50))
        assert t.compact() is True
        assert seen == [t.device]
        with racecheck.peeking():  # a white-box read of the engine's model
            m = t.model
        tensors = [m.centroids, m.lists.data, m.lists.ids, m.lists.sizes, m.norm_lists.data]
        assert all(v.device == t.device == torch.device("cpu") for v in tensors)
        assert m.ntotal == 550
    finally:
        t.retire()


@pytest.mark.parametrize("kw", [dict(index_builder_type="hnswsq"),
                                dict(index_builder_type=None, faiss_factory="HNSW32")],
                         ids=["hnswsq", "HNSW32"])
def test_graph_kinds_refuse_deletes_up_front(data, tmp_path, no_watcher, kw):
    """The port has no flat fallback for the graph kinds, so a delete or
    upsert is refused even while every row is still buffered, and nothing
    is tombstoned."""
    x, _ = data
    t = TIndex(_cfg(IndexCfg, str(tmp_path / "shard"), train_num=10_000, **kw), device="cpu")
    try:
        t.add_batch(x[:50], [(i,) for i in range(50)])
        assert t.model is None
        with pytest.raises(RuntimeError, match="does not support remove/upsert"):
            t.remove_ids([1, 2])
        with pytest.raises(RuntimeError, match="does not support remove/upsert"):
            t.upsert([3], x[:1])
        assert len(t.tombstones) == 0 and t.get_ids() == set(range(50))
    finally:
        t.retire()


# ------------------------------------------------------------ interop


@pytest.mark.parametrize("builder", ["ivfsq", "knnlm"])
def test_port_serves_a_tombstoned_jax_dir(data, tmp_path, no_watcher, builder):
    """A JAX engine deletes, saves, deletes again (sidecar only) and
    upserts; the port loads its dir and serves the JAX engine's ids."""
    x, q = data
    storage = str(tmp_path / "jax")
    j = JIndex(_cfg(JCfg, storage, index_builder_type=builder, code_size=8))
    j.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
    assert wait_until(drained(j, 600))
    near = sorted(_served_ids(j, q))
    j.remove_ids(near[:8], version=(1700000000000, 0, 7))
    assert j.save() is True
    j.remove_ids(near[8:16])
    j.upsert([near[0]], q[:1], version=(1700000000001, 0, 7))
    j.retire()
    want = JIndex.from_storage_dir(storage, ignore_buffer=False)
    got = TIndex.from_storage_dir(storage, ignore_buffer=False, device="cpu")
    try:
        assert wait_until(drained(got, 600)) and wait_until(drained(want, 600))
        assert got.get_ids() == want.get_ids()
        (wd, wm, _), (gd, gm, _) = want.search(q, K), got.search(q, K)
        assert gm == wm
        np.testing.assert_allclose(gd, wd, rtol=1e-3, atol=1e-3)
        assert not {m[0] for row in gm for m in row} & set(near[1:16])
        assert got.version_watermark() == want.version_watermark()
    finally:
        want.retire()
        got.retire()


def test_jax_serves_a_port_dir_after_delete_and_compaction(data, tmp_path, no_watcher):
    """The port deletes, compacts and deletes again; the JAX engine loads
    the dir and serves the port's ids."""
    x, q = data
    storage = str(tmp_path / "port")
    t = TIndex(_cfg(IndexCfg, storage), device="cpu")
    t.add_batch(x, [(i,) for i in range(600)], train_async_if_triggered=False)
    assert wait_until(drained(t, 600))
    near = sorted(_served_ids(t, q))
    t.remove_ids(near[:10])
    assert t.compact() is True
    t.remove_ids(near[10:20])
    want_d, want_m, _ = t.search(q, K)
    t.retire()
    j = JIndex.from_storage_dir(storage)
    try:
        assert j.get_ids() == set(range(600)) - set(near[:20])
        d, m, _ = j.search(q, K)
        assert m == want_m
        np.testing.assert_allclose(d, want_d, rtol=1e-3, atol=1e-3)
    finally:
        j.retire()
