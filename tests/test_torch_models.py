"""The port's index models against the JAX package's, through carried-over
state: an index trained in JAX is carried into the port (and one trained in
the port into JAX), and both search the same queries."""

import numpy as np
import pytest

from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.models.flat import FlatIndex as JFlat
from distributed_faiss_tpu.models.ivf import IVFFlatIndex as JIVF
from distributed_faiss_tpu.utils import serialization as jser
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models.flat import FlatIndex as TFlat
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex as TIVF
from distributed_faiss_tpu_torch.utils import serialization as tser

D, NLIST, K = 16, 8, 5


@pytest.fixture
def data(rng):
    centers = rng.standard_normal((NLIST, D)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, NLIST, 600)]
         + rng.standard_normal((600, D)).astype(np.float32))
    q = (centers[rng.integers(0, NLIST, 12)]
         + rng.standard_normal((12, D)).astype(np.float32))
    return x, q


def assert_same_results(port, ref, rtol=1e-3, atol=1e-3):
    """Ids exactly (tie-free data), distances within rtol/atol 1e-3 — the
    tolerance the JAX package holds its own kernel to
    (models/ivf.py:590-593)."""
    (dp, ip), (dr, ir) = port, ref
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_array_equal(np.isinf(dp), np.isinf(dr))
    f = np.isfinite(dr)
    np.testing.assert_allclose(dp[f], dr[f], rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("codec", ["f32", "f16", "bf16", "sq8"])
def test_flat_from_jax_state(data, metric, codec):
    x, q = data
    ref = JFlat(D, metric, codec=codec)
    ref.train(x)
    ref.add(x)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(port, TFlat) and port.ntotal == 600
    assert_same_results(port.search(q, K), ref.search(q, K))


IVF_CASES = [(codec, metric, {}) for codec in ("f32", "f16", "sq8")
             for metric in ("l2", "dot")]
IVF_CASES += [
    ("sq8", "l2", {"refine_k_factor": 4}),  # IVF<n>,SQ8,RFlat
    ("f16", "l2", {"refine_k_factor": 4, "scan_bf16": True}),
    ("f16", "l2", {"use_pallas": True}),  # the JAX side runs its kernel
]


def _case_id(case):
    codec, metric, kw = case
    return "-".join([codec, metric] + sorted(kw))


@pytest.mark.parametrize("case", IVF_CASES, ids=_case_id)
def test_ivf_flat_from_jax_state(data, case):
    codec, metric, kw = case
    x, q = data
    ref = JIVF(D, NLIST, metric, codec=codec, kmeans_iters=4, **kw)
    ref.train(x[:400])
    ref.add(x)
    ref.set_nprobe(3)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(port, TIVF)
    assert port.nprobe == 3 and port.ntotal == 600
    assert port.use_pallas == bool(kw.get("use_pallas", False))
    np.testing.assert_array_equal(port.get_assignments(), ref.get_assignments())
    assert_same_results(port.search(q, K), ref.search(q, K))
    # and back: the port's state_dict loads in the JAX package
    back = jfactory.index_from_state_dict(interop.to_state_dict(port))
    assert_same_results(back.search(q, K), ref.search(q, K), rtol=0, atol=0)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_empty_slots_are_minus_one(data, metric):
    """Fewer live candidates than k: +inf (l2) / -inf (dot) distances with
    id -1 in both packages."""
    x, q = data
    ref = JIVF(D, NLIST, metric, codec="f16", kmeans_iters=4)
    ref.train(x[:400])
    ref.add(x[:20])
    ref.set_nprobe(1)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    k = 30
    dp, ip = port.search(q, k)
    dr, ir = ref.search(q, k)
    assert_same_results((dp, ip), (dr, ir))
    pad = ip == -1
    assert pad.any()
    assert (dp[pad] == (np.inf if metric == "l2" else -np.inf)).all()
    flat = JFlat(D, metric)
    flat.add(x[:3])
    tflat = interop.from_jax_state(flat.state_dict(), device="cpu")
    dp, ip = tflat.search(q, 6)
    assert_same_results((dp, ip), flat.search(q, 6))
    assert (ip[:, 3:] == -1).all()


@pytest.mark.parametrize("spec", ["IVF8,Flat", "IVF8,SQfp16", "IVF8,SQ8,RFlat", "SQ8"])
def test_port_snapshot_loads_in_jax(data, tmp_path, spec):
    """Trained in the port, saved as npz by the port, loaded and searched by
    the JAX package: same ids, same distances."""
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    x, q = data
    port = tfactory.build_index(IndexCfg(faiss_factory=spec, dim=D, metric="l2",
                                         kmeans_iters=4), device="cpu")
    port.train(x[:400])
    port.add(x)
    port.set_nprobe(3)
    path = str(tmp_path / "index.npz")
    tser.save_state(path, port.state_dict())
    ref = jfactory.index_from_state_dict(jser.load_state(path))
    assert_same_results(port.search(q, K), ref.search(q, K))
    # and the JAX package's npz of the same index loads in the port
    jpath = str(tmp_path / "index_jax.npz")
    jser.save_state(jpath, ref.state_dict())
    again = tfactory.index_from_state_dict(tser.load_state(jpath), device="cpu")
    assert_same_results(again.search(q, K), port.search(q, K), rtol=0, atol=0)


def test_factory_refuses_unported(data):
    """The mesh builders and the sharded snapshot kinds are ported
    (parallel/mesh.py); a factory spec outside the grammar still raises
    "not yet ported"."""
    from distributed_faiss_tpu_torch.parallel import mesh
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    for cfg, cls in ((IndexCfg(index_builder_type="ivf_tpu", dim=D, centroids=4),
                      mesh.IvfTpuIndex),
                     (IndexCfg(index_builder_type="flat", dim=D, mesh_shards=True),
                      mesh.ShardedFlatIndex)):
        assert type(tfactory.build_index(cfg, device="cpu")) is cls
    for kind, cls in (("sharded_ivf_pq", mesh.ShardedIVFPQIndex),
                      ("sharded_flat", mesh.ShardedFlatIndex)):
        assert tfactory._STATE_KINDS[kind] is cls
    with pytest.raises(RuntimeError, match="not yet ported"):
        tfactory.build_index(IndexCfg(faiss_factory="IVF4,LSH", dim=D), device="cpu")


@pytest.mark.parametrize("spec", [dict(index_builder_type="hnswsq"),
                                  dict(faiss_factory="HNSW32"),
                                  dict(faiss_factory="OPQ4,HNSW32")],
                         ids=["hnswsq", "HNSW32", "OPQ4,HNSW32"])
def test_factory_builds_hnsw(data, monkeypatch, spec):
    """The hnswsq builder (store_n 128, ef_construction 100, refine 8 by
    default) and the HNSW<M> specs, bare or behind OPQ, build the native
    graph: each finds its own rows, and the JAX package's index of the same
    cfg, carried into the port, serves the JAX package's ids."""
    from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
    from distributed_faiss_tpu_torch.models.hnsw import HNSWSQIndex
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    monkeypatch.setenv("DFT_HNSW_THREADS", "1")
    x, q = data
    port = tfactory.build_index(IndexCfg(dim=D, metric="l2", nprobe=64, **spec), device="cpu")
    graph = getattr(port, "inner", port)
    assert isinstance(graph, HNSWSQIndex)
    assert (graph.M, graph.ef_construction, graph.refine_k_factor) == (
        128 if "index_builder_type" in spec else 32, 100, 8)
    port.train(x)
    port.add(x)
    port.set_nprobe(64)
    assert graph.nprobe == 64  # nprobe is efSearch
    _, ids = port.search(x[:8], 1)
    assert (ids[:, 0] == np.arange(8)).all()
    ref = jfactory.build_index(JCfg(dim=D, metric="l2", nprobe=64, **spec))
    ref.train(x)
    ref.add(x)
    ref.set_nprobe(64)
    carried = tfactory.index_from_state_dict(ref.state_dict(), device="cpu")
    assert_same_results(carried.search(q, K), ref.search(q, K))
    with pytest.raises(RuntimeError, match="l2"):
        tfactory.build_index(IndexCfg(dim=D, metric="dot", **spec), device="cpu")
