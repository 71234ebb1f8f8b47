"""The port's IVF-PQ (``IVFPQIndex``, the ``knnlm`` builder, the PQ factory
specs) against the JAX package's, through carried-over state: an index
trained in JAX is carried into the port and both search the same queries;
an index trained in the port loads in JAX; and a small ``knnlm`` index runs
through the port's IndexServer/IndexClient on the CPU.

Ids are compared exactly (tie-free data), ADC distances within 1e-4 and
refined distances within 1e-3 (the JAX package's own bar,
models/ivf.py:590-593)."""

import os
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.models.ivf import IVFPQIndex as JIVFPQ
from distributed_faiss_tpu.utils import serialization as jser
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.models import base as tbase
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models import ivf as tivf
from distributed_faiss_tpu_torch.models.ivf import IVFPQIndex as TIVFPQ
from distributed_faiss_tpu_torch.ops import adc_scan as tadc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils import serialization as tser
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, NLIST, K = 16, 8, 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
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


# (metric, m, knobs): m=4 takes the K2 geometry, m=8 the K3 one
CASES = [("l2", 4, {}), ("dot", 4, {}), ("l2", 8, {}), ("dot", 8, {}),
         ("l2", 4, {"refine_k_factor": 4}), ("dot", 8, {"refine_k_factor": 4}),
         ("l2", 8, {"use_pallas": True, "adc_lut_bf16": True}),
         ("l2", 8, {"use_pallas": True, "adc_lut_bf16": True, "refine_k_factor": 4}),
         ("dot", 4, {"use_pallas": True})]


def _case_id(case):
    metric, m, kw = case
    return "-".join([metric, f"m{m}"] + sorted(kw))


def _jax_index(x, metric, m, kw):
    ref = JIVFPQ(D, NLIST, m=m, metric=metric, kmeans_iters=4, pq_iters=4, **kw)
    ref.train(x[:400])
    ref.add(x)
    ref.set_nprobe(3)
    return ref


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ivf_pq_from_jax_state(data, case):
    """A JAX-trained index served by the port: same ids, ADC distances
    within 1e-4 (rtol/atol), refined ones within 1e-3; with use_pallas the
    JAX side runs its Pallas kernel in interpret mode, and with
    adc_lut_bf16 both sides scan the bf16 LUT. The port's state loads back
    in the JAX package and serves the same results."""
    metric, m, kw = case
    x, q = data
    ref = _jax_index(x, metric, m, kw)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(port, TIVFPQ)
    assert (port.nprobe, port.ntotal, port.m) == (3, 600, m)
    assert port.use_pallas == bool(kw.get("use_pallas", False))
    assert port.adc_lut_bf16 == bool(kw.get("adc_lut_bf16", False))
    np.testing.assert_array_equal(port.get_assignments(), ref.get_assignments())
    want = ref.search(q, K)
    tol = 1e-3 if kw.get("refine_k_factor") else 1e-4
    assert_same_results(port.search(q, K), want, tol)
    back = jfactory.index_from_state_dict(interop.to_state_dict(port))
    assert_same_results(back.search(q, K), want, 0)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_reconstruct_batch(data, metric):
    x, _ = data
    ref = _jax_index(x, metric, 8, {})
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    ids = np.array([0, 5, 599, 123, 5])
    np.testing.assert_allclose(port.reconstruct_batch(ids), ref.reconstruct_batch(ids),
                               rtol=1e-5, atol=1e-5)


def test_fewer_candidates_than_k(data):
    """Too few live rows for k: +inf distances with id -1, as in JAX."""
    x, q = data
    ref = JIVFPQ(D, NLIST, m=4, metric="l2", kmeans_iters=4, pq_iters=4)
    ref.train(x[:400])
    ref.add(x[:20])
    ref.set_nprobe(1)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    dp, ip = port.search(q, 30)
    assert_same_results((dp, ip), ref.search(q, 30), 1e-4)
    assert (ip == -1).any() and np.isposinf(dp[ip == -1]).all()


@pytest.mark.parametrize("spec", ["IVF8,PQ4", "IVF8,PQ8x8,RFlat", "PQ4"])
def test_port_snapshot_loads_in_jax(data, tmp_path, spec):
    """Trained in the port, saved as npz by the port, loaded and searched by
    the JAX package: same ids; and the JAX package's npz of that index
    loads back in the port."""
    x, q = data
    port = tfactory.build_index(IndexCfg(faiss_factory=spec, dim=D, metric="l2",
                                         kmeans_iters=4), device="cpu")
    port.train(x[:400])
    port.add(x)
    if port.nlist > 1:
        port.set_nprobe(3)
    path = str(tmp_path / "index.npz")
    tser.save_state(path, port.state_dict())
    ref = jfactory.index_from_state_dict(jser.load_state(path))
    tol = 1e-3 if port.refine_k_factor else 1e-4
    assert_same_results(port.search(q, K), ref.search(q, K), tol)
    jpath = str(tmp_path / "index_jax.npz")
    jser.save_state(jpath, ref.state_dict())
    again = tfactory.index_from_state_dict(tser.load_state(jpath), device="cpu")
    assert_same_results(again.search(q, K), port.search(q, K), 0)


def test_knnlm_builder_knobs():
    cfg = IndexCfg(index_builder_type="knnlm", dim=D, centroids=8, metric="dot",
                   code_size=8, pallas_adc=True, adc_lut_bf16=True, refine_k_factor=8,
                   kmeans_iters=3)
    idx = tfactory.build_index(cfg, device="cpu")
    assert isinstance(idx, TIVFPQ)
    assert (idx.nlist, idx.m, idx.nbits, idx.metric, idx.kmeans_iters) == (8, 8, 8, "dot", 3)
    assert idx.use_pallas and idx.adc_lut_bf16 and idx.refine_k_factor == 8
    default = tfactory.build_index(IndexCfg(index_builder_type="knnlm", dim=128,
                                            centroids=4), device="cpu")
    assert (default.m, default.use_pallas, default.adc_lut_bf16,
            default.refine_k_factor) == (64, False, False, 0)
    with pytest.raises(ValueError, match="8-bit"):
        tfactory.build_index(IndexCfg(index_builder_type="knnlm", dim=D, centroids=4,
                                      code_size=4, nbits=4), device="cpu")


@pytest.mark.parametrize("extra", ["opq", "shard_lists"])
def test_knnlm_unported_variants_raise(extra):
    """shard_lists, alone or under the OPQ rotation, builds the mesh-sharded
    IVF-PQ (parallel/mesh.py), never a quietly unsharded index."""
    from distributed_faiss_tpu_torch.models.pretransform import PreTransformIndex
    from distributed_faiss_tpu_torch.parallel.mesh import ShardedIVFPQIndex

    cfg = IndexCfg(index_builder_type="knnlm", dim=D, centroids=4, code_size=4,
                   **{extra: True, "shard_lists": True})
    idx = tfactory.build_index(cfg, device="cpu")
    if extra == "opq":
        assert isinstance(idx, PreTransformIndex)
        idx = idx.inner
    assert isinstance(idx, ShardedIVFPQIndex)


def test_pq_factory_specs():
    def build(spec, **kw):
        return tfactory.build_index(IndexCfg(faiss_factory=spec, dim=D, **kw), device="cpu")

    flat_pq = build("PQ4")
    assert isinstance(flat_pq, TIVFPQ) and (flat_pq.nlist, flat_pq.nprobe, flat_pq.m) == (1, 1, 4)
    ivf = build("IVF{centroids},PQ8x8,RFlat", centroids=16)
    assert (ivf.nlist, ivf.m, ivf.refine_k_factor, ivf.use_pallas) == (16, 8, 8, False)
    refined = build("IVF8,PQ4,Refine(Flat)", refine_k_factor=3)
    assert refined.refine_k_factor == 3
    with pytest.raises(RuntimeError, match="only 8-bit"):
        build("IVF8,PQ4x4")


# ---------------------------------------------------------------- flat PQ


FLAT_CASES = [("PQ4", "l2"), ("PQ4", "dot"), ("PQ8,RFlat", "l2"), ("PQ8,RFlat", "dot")]


def _jax_flat_pq(x, spec, metric):
    ref = jfactory.build_index(JCfg(faiss_factory=spec, dim=D, metric=metric))
    ref.pq_iters = 4
    ref.train(x[:400])
    ref.add(x)
    return ref


@pytest.mark.parametrize("spec,metric", FLAT_CASES, ids=[f"{s}-{m}" for s, m in FLAT_CASES])
def test_flat_pq_from_jax_state(data, monkeypatch, spec, metric):
    """Flat PQ (one list) built in the JAX package, served by the port's
    shared-list path: same ids, ADC distances within 1e-4, refined ones
    within 1e-3; the state goes back to JAX and serves the same. The port
    never gathers a per-query copy of the codes on this path."""
    x, q = data
    ref = _jax_flat_pq(x, spec, metric)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(port, TIVFPQ) and port.nlist == 1 and port.ntotal == 600

    def no_group_inputs(*a, **k):
        raise AssertionError("per-query code gather on the one-list path")

    monkeypatch.setattr(tivf, "_pq_group_inputs", no_group_inputs)
    want = ref.search(q, K)
    tol = 1e-3 if port.refine_k_factor else 1e-4
    assert_same_results(port.search(q, K), want, tol)
    back = jfactory.index_from_state_dict(interop.to_state_dict(port))
    assert_same_results(back.search(q, K), want, 0)


WIDE_D = 768


@pytest.fixture(scope="module")
def wide_data():
    """600 rows and 12 queries at d = 768 around 8 centers."""
    rng = np.random.default_rng(22)
    centers = rng.standard_normal((NLIST, WIDE_D)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, NLIST, 600)]
         + rng.standard_normal((600, WIDE_D)).astype(np.float32))
    q = (centers[rng.integers(0, NLIST, 12)]
         + rng.standard_normal((12, WIDE_D)).astype(np.float32))
    return x, q


# (spec, metric, m, kernel wrapper, slices of its LUT on the card): wider
# than one slice of shared memory on the card (K4 f32 75, K3 f32 224)
WIDE_CASES = [("PQ128", "l2", 128, "adc_scan_shared", 2),
              ("PQ128,RFlat", "dot", 128, "adc_scan_shared", 2),
              ("IVF8,PQ256", "l2", 256, "adc_scan_nibble", 2)]


@pytest.mark.parametrize("spec,metric,m,wrapper,slices", WIDE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in WIDE_CASES])
def test_wide_pq_from_jax_state(wide_data, spec, metric, m, wrapper, slices):
    """PQ widths whose f32 LUT is wider than a block's shared memory on the
    card, built in the JAX package and served by the port: same ids, ADC
    distances within 1e-4, refined ones within 1e-3. On the card the
    wrapper scores them in ``slices`` subspace slices."""
    x, q = wide_data
    ref = jfactory.build_index(JCfg(faiss_factory=spec, dim=WIDE_D, metric=metric,
                                    kmeans_iters=4))
    ref.pq_iters = 4
    ref.train(x[:400])
    ref.add(x)
    if ref.nlist > 1:
        ref.set_nprobe(3)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert port.m == m and port.ntotal == 600
    fn = getattr(tadc, wrapper)
    width = tadc.slice_width(m, 256, 4, fn)
    assert -(-m // width) == slices
    tol = 1e-3 if port.refine_k_factor else 1e-4
    assert_same_results(port.search(q, K), ref.search(q, K), tol)


def test_flat_pq_chunks_span_the_list(data, monkeypatch):
    """A payload budget of 100 rows a chunk for the query block splits the
    600-row list into 6 shared scans per block, merged into the same top-k
    as the JAX package's one pass."""
    x, q = data
    ref = _jax_flat_pq(x, "PQ8,RFlat", "l2")
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    # the budget also sizes the query block, down to its 256-row floor
    monkeypatch.setattr(tbase, "_QUERY_PAYLOAD_BUDGET", 100 * 4 * 256)
    _, nb, _ = port._search_plan()
    assert nb == 256 and tivf.shared_chunk_rows(nb) == 100
    widths = []
    orig = tadc.adc_scan_shared
    monkeypatch.setattr(tadc, "adc_scan_shared",
                        lambda lut, codes: widths.append(codes.shape[0]) or orig(lut, codes))
    got = port.search(q, K)
    assert widths == [100] * 6
    assert_same_results(got, ref.search(q, K), 1e-3)
    # fewer rows than k in the last chunks: pad slots stay -1 / +inf
    dp, ip = port.search(q[:2], 700)
    assert (ip[:, 600:] == -1).all() and np.isposinf(dp[:, 600:]).all()
    assert sorted(ip[0, :600]) == list(range(600))


def test_flat_pq_bf16_lut_through_knnlm(data):
    """knnlm with one centroid, pallas_adc and adc_lut_bf16: the JAX side
    runs its per-pair Pallas kernel (interpret mode) over a bf16 LUT, the
    port its shared-list path over the same bf16 LUT: same ids, distances
    within 1e-4."""
    x, q = data
    cfg = JCfg(index_builder_type="knnlm", dim=D, metric="l2", centroids=1, code_size=8,
               pallas_adc=True, adc_lut_bf16=True, kmeans_iters=4)
    ref = jfactory.build_index(cfg)
    ref.pq_iters = 4
    ref.train(x[:400])
    ref.add(x)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert port.nlist == 1 and port.lut_bf16
    assert_same_results(port.search(q, K), ref.search(q, K), 1e-4)


def test_multi_list_search_never_takes_the_shared_path(data, monkeypatch):
    """With nlist > 1 the probe-group path runs unchanged: no shared scan."""
    x, q = data
    ref = _jax_index(x, "l2", 8, {})
    port = interop.from_jax_state(ref.state_dict(), device="cpu")

    def no_shared(*a, **k):
        raise AssertionError("shared-list scan on an IVF path")

    monkeypatch.setattr(tadc, "adc_scan_shared", no_shared)
    assert_same_results(port.search(q, K), ref.search(q, K), 1e-4)


# ---------------------------------------------------------------- serving


def wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def server(tmp_path):
    """One port IndexServer on a loopback port and a client over a
    discovery file; both stopped at teardown."""
    storage = str(tmp_path / "store")
    srv = IndexServer(0, storage, device="cpu")
    port = srv.bind(0)
    threading.Thread(target=srv.start_blocking, name="test-ivfpq-server", daemon=True).start()
    disc = str(tmp_path / "discovery.txt")
    with open(disc, "w") as f:
        f.write(f"1\nlocalhost,{port}\n")
    client = IndexClient(disc)
    try:
        yield client, storage
    finally:
        client.close()
        srv.stop()


def test_knnlm_served_create_add_train_search_save_load(data, server):
    client, _ = server
    x, _ = data
    cfg = IndexCfg(index_builder_type="knnlm", dim=D, metric="l2", train_num=400,
                   centroids=NLIST, nprobe=NLIST, code_size=8, pallas_adc=True,
                   adc_lut_bf16=True, refine_k_factor=8, kmeans_iters=4)
    assert client.create_index("pq", cfg) == [True]
    for s in range(0, 600, 100):
        client.add_index_data("pq", x[s:s + 100], [("m", i) for i in range(s, s + 100)])
    assert wait_until(lambda: client.get_state("pq") == IndexState.TRAINED
                      and client.get_buffer_depth("pq") == 0 and client.get_ntotal("pq") == 600)
    D1, M1 = client.search(x[:6] + 1e-4, 4, "pq")
    assert D1.shape == (6, 4) and np.all(np.diff(D1, axis=1) >= 0)
    # every row's nearest neighbour is itself after the exact refine
    assert [m[0] for m in M1] == [("m", i) for i in range(6)]
    client.save_index("pq")
    client.drop_index("pq")
    assert client.load_index("pq")
    D2, M2 = client.search(x[:6] + 1e-4, 4, "pq")
    assert M2 == M1
    np.testing.assert_array_equal(D2, D1)


def test_jax_knnlm_storage_dir_served_by_port(data, server):
    """The JAX engine writes a knnlm storage dir; the port's server loads it
    and serves the ids and metadata the JAX engine serves from it."""
    client, storage = server
    x, _ = data
    q = x[:8] + 0.01
    cfg = JCfg(index_builder_type="knnlm", dim=D, metric="l2", train_num=400,
               centroids=NLIST, nprobe=4, code_size=4, kmeans_iters=4,
               index_storage_dir=os.path.join(storage, "jpq", "0"))
    jidx = JIndex(cfg)
    jidx.add_batch(x, [{"doc": i} for i in range(600)], train_async_if_triggered=False)
    assert wait_until(lambda: jidx.get_state() == JState.TRAINED
                      and jidx.get_idx_data_num() == (0, 600))
    assert jidx.save() is True
    jidx.retire()
    want_d, want_m, _ = JIndex.from_storage_dir(cfg.index_storage_dir).search(q, 5)
    assert client.load_index("jpq")
    assert client.get_ntotal("jpq") == 600
    got_d, got_m = client.search(q, 5, "jpq")
    assert got_m == want_m
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-4)


def test_flat_pq_served_over_loopback(data, server):
    """PQ8,RFlat through the port's IndexServer/IndexClient on the CPU:
    threshold train, add, search (each row finds itself after the exact
    refine), save -> drop -> load with identical results."""
    client, _ = server
    x, _ = data
    cfg = IndexCfg(faiss_factory="PQ8,RFlat", dim=D, metric="l2", train_num=400)
    assert client.create_index("fpq", cfg) == [True]
    for s in range(0, 600, 100):
        client.add_index_data("fpq", x[s:s + 100], [("f", i) for i in range(s, s + 100)])
    assert wait_until(lambda: client.get_state("fpq") == IndexState.TRAINED
                      and client.get_buffer_depth("fpq") == 0 and client.get_ntotal("fpq") == 600)
    D1, M1 = client.search(x[:6] + 1e-4, 4, "fpq")
    assert D1.shape == (6, 4) and np.all(np.diff(D1, axis=1) >= 0)
    assert [m[0] for m in M1] == [("f", i) for i in range(6)]
    client.save_index("fpq")
    client.drop_index("fpq")
    assert client.load_index("fpq")
    D2, M2 = client.search(x[:6] + 1e-4, 4, "fpq")
    assert M2 == M1
    np.testing.assert_array_equal(D2, D1)
