"""The port's pre-transforms (ops/opq.py, models/pretransform.py and the
OPQ/PCA/PCAR factory prefixes) against the JAX package's, on the same numpy
inputs and through carried-over state and storage dirs.

The OPQ training inside runs each package's own k-means (threefry vs torch
RNG), so trained rotations differ between packages; the tests compare what
is shared (the seeded initial rotation, the PCA basis) and carry trained
state across for the search parity. Ids exactly (tie-free data), distances
within rtol/atol 1e-3 (models/ivf.py:590-593 of the JAX package)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.models.pretransform import PreTransformIndex as JPre
from distributed_faiss_tpu.ops import opq as jopq
from distributed_faiss_tpu.utils import serialization as jser
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models.flat import FlatIndex as TFlat
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex as TIVF
from distributed_faiss_tpu_torch.models.ivf import IVFPQIndex as TIVFPQ
from distributed_faiss_tpu_torch.models.pretransform import PreTransformIndex as TPre
from distributed_faiss_tpu_torch.ops import opq as topq
from distributed_faiss_tpu_torch.ops import pq as tpq
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils import serialization as tser
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, K = 64, 5


@pytest.fixture(scope="module")
def data():
    """Correlated rows (a random mixing matrix), where rotations and
    projections matter."""
    rng = np.random.default_rng(31)
    a = rng.standard_normal((D, D)).astype(np.float32)
    x = rng.standard_normal((1200, D)).astype(np.float32) @ a
    q = rng.standard_normal((10, D)).astype(np.float32) @ a
    return x, q


def build(spec, device="cpu", dim=D, metric="l2", **extra):
    return tfactory.build_index(IndexCfg(faiss_factory=spec, dim=dim, metric=metric, **extra),
                                device=device)


def assert_same_results(port, ref, tol=1e-3):
    (dp, ip), (dr, ir) = port, ref
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_array_equal(np.isinf(dp), np.isinf(dr))
    f = np.isfinite(dr)
    np.testing.assert_allclose(dp[f], dr[f], rtol=tol, atol=tol)


# ---- the transforms ------------------------------------------------------


@pytest.mark.parametrize("d_out", [None, 32])
def test_opq_initial_rotation_is_the_jax_one(data, d_out):
    """With no iteration both packages return their seeded starting
    rotation: the same matrix."""
    x, _ = data
    r_port, cb = topq.opq_train(x, 8, d_out=d_out, opq_iters=0, seed=3)
    r_jax, _ = jopq.opq_train(x, 8, d_out=d_out, opq_iters=0, seed=3)
    assert cb is None and tuple(r_port.shape) == (D, d_out or D)
    np.testing.assert_array_equal(r_port.numpy(), np.asarray(r_jax))


@pytest.mark.parametrize("d_out", [None, 32])
def test_trained_rotation_has_orthonormal_columns(data, d_out):
    x, _ = data
    r, cb = topq.opq_train(x, 8, d_out=d_out, opq_iters=2, pq_iters=3)
    assert tuple(cb.shape) == (8, 256, (d_out or D) // 8)
    np.testing.assert_allclose((r.T @ r).numpy(), np.eye(d_out or D), atol=1e-4)


def test_opq_rotation_beats_or_matches_plain_pq_reconstruction():
    """The JAX package's own check (tests/test_factory_grammar.py): on
    correlated data OPQ's PQ reconstruction error is no worse than plain
    PQ's (within 2%)."""
    rng = np.random.default_rng(5)
    d, n = 32, 4000
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)
                        @ rng.standard_normal((d, d)).astype(np.float32))
    cb = tpq.pq_train(x, 4, iters=8)
    err_plain = float(((x - tpq.pq_decode(tpq.pq_encode(x, cb), cb)) ** 2).mean())
    r, cb_r = topq.opq_train(x, 4, opq_iters=6, pq_iters=8)
    xr = x @ r
    err_opq = float(((xr - tpq.pq_decode(tpq.pq_encode(xr, cb_r), cb_r)) ** 2).mean())
    assert err_opq <= err_plain * 1.02, (err_opq, err_plain)


def test_opq_refuses_bad_dims(data):
    x, _ = data
    with pytest.raises(ValueError, match="> input dim"):
        topq.opq_train(x, 8, d_out=128)
    with pytest.raises(ValueError, match="not divisible"):
        topq.opq_train(x, 7)


def test_pca_basis_spans_the_jax_basis(data):
    """Same rows, both packages' PCA fits: the same mean and the same
    principal axes, column by column up to sign (|cos| within 1e-4)."""
    from distributed_faiss_tpu.models.flat import FlatIndex as JFlat

    x, _ = data
    jpre = JPre(JFlat(16, "l2"), D, pca=True)
    jpre.train(x)
    tpre = TPre(TFlat(16, "l2", device="cpu"), D, pca=True)
    tpre.train(x)
    np.testing.assert_allclose(tpre.mean.numpy(), jpre.mean, rtol=1e-4, atol=1e-3)
    cos = np.abs((tpre.matrix.numpy() * jpre.matrix).sum(0))
    np.testing.assert_allclose(cos, np.ones(16), atol=1e-4)


def test_pca_needs_d_out_rows(data):
    x, _ = data
    idx = build("PCA32,Flat")
    with pytest.raises(RuntimeError, match="needs >= 32 training rows"):
        idx.train(x[:20])


# ---- the factory grammar -------------------------------------------------


def test_prefixes_build_pretransforms():
    idx = build("OPQ8,IVF16,PQ8")
    assert isinstance(idx, TPre) and isinstance(idx.inner, TIVFPQ)
    assert idx.opq_m == 8 and idx.inner.m == 8 and idx.inner.nlist == 16
    reduced = build("OPQ8_32,IVF16,PQ8")
    assert reduced.dim == D and reduced.inner.dim == 32
    pca = build("PCA32,IVF16,Flat")
    assert pca.pca and isinstance(pca.inner, TIVF) and pca.inner.dim == 32
    pcar = build("PCAR32,PQ8,RFlat", opq_iters=3)
    assert pcar.pca and isinstance(pcar.inner, TIVFPQ) and pcar.inner.nlist == 1
    assert pcar.inner.refine_k_factor == 8
    assert build("OPQ8,PQ8", opq_iters=3).opq_iters == 3
    assert isinstance(build("PCAR32,Flat").inner, TFlat)


def test_prefix_errors_mirror_the_jax_grammar():
    """tests/test_factory_grammar.py's error cases: an output dim above the
    input dim is refused at parse time, unknown specs raise."""
    for spec in ("PCA128,Flat", "OPQ8_128,IVF16,PQ8"):
        with pytest.raises(RuntimeError, match="> input dim"):
            build(spec)
    for spec in ("IVF16,XX", "Junk", "OPQ8,Junk", "HNSW32,PQ8"):
        with pytest.raises(RuntimeError):
            build(spec)


def test_knnlm_builder_opq_extra():
    cfg = IndexCfg(index_builder_type="knnlm", dim=32, metric="l2", centroids=8,
                   code_size=8, opq=True, kmeans_iters=4, opq_iters=2)
    idx = tfactory.build_index(cfg, device="cpu")
    assert isinstance(idx, TPre) and isinstance(idx.inner, TIVFPQ)
    assert idx.opq_m == 8 and idx.opq_iters == 2 and idx.inner.nlist == 8
    assert cfg.extra.get("opq") is True  # the caller's cfg is not changed


# ---- search parity on carried state --------------------------------------


SPECS = ["OPQ8,PQ8", "OPQ8_32,IVF16,PQ8", "PCA32,IVF16,Flat", "PCAR32,PQ8,RFlat",
         "OPQ8,IVF4,PQ8,RFlat", "knnlm-opq"]


def _jax_cfg(spec):
    if spec == "knnlm-opq":
        return JCfg(index_builder_type="knnlm", dim=D, metric="l2", centroids=8, code_size=8,
                    opq=True, kmeans_iters=4, opq_iters=2)
    return JCfg(faiss_factory=spec, dim=D, metric="l2", kmeans_iters=4, opq_iters=2)


@pytest.mark.parametrize("spec", SPECS)
def test_pretransform_from_jax_state(data, spec):
    """Trained in the JAX package, served by the port from its state: same
    ids, distances within 1e-3; the port's state loads back in JAX and
    serves the same; reconstruction maps back through the transform."""
    x, q = data
    ref = jfactory.build_index(_jax_cfg(spec))
    ref.train(x[:1000])
    ref.add(x)
    ref.set_nprobe(4)
    # the scalars as numpy scalars, the form a loaded npz or a device
    # array's item gives them
    state = {k: (np.asarray(v)[()] if isinstance(v, (bool, int, float)) else v)
             for k, v in ref.state_dict().items()}
    assert isinstance(state["inner.nprobe"], np.integer)
    port = interop.from_jax_state(state, device="cpu")
    assert isinstance(port, TPre) and port.ntotal == 1200 and port.is_trained
    assert (port.opq_m, port.pca) == (ref.opq_m, ref.pca)
    want = ref.search(q, K)
    assert_same_results(port.search(q, K), want)
    back = jfactory.index_from_state_dict(interop.to_state_dict(port))
    assert isinstance(back, JPre)
    assert_same_results(back.search(q, K), want, 0)
    ids = np.array([0, 7, 1199])
    np.testing.assert_allclose(port.reconstruct_batch(ids), ref.reconstruct_batch(ids),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("spec", ["OPQ8,PQ8", "PCA32,IVF16,SQfp16"])
def test_port_snapshot_loads_in_jax(data, tmp_path, spec):
    """Trained in the port and saved as npz, loaded and searched by the JAX
    package: same ids; the JAX package's npz of it loads back in the port."""
    x, q = data
    port = build(spec, kmeans_iters=4, opq_iters=2)
    port.train(x[:1000])
    port.add(x)
    port.set_nprobe(4)
    path = str(tmp_path / "pt.npz")
    tser.save_state(path, port.state_dict())
    ref = jfactory.index_from_state_dict(jser.load_state(path))
    ref.set_nprobe(4)
    assert_same_results(port.search(q, K), ref.search(q, K))
    jpath = str(tmp_path / "pt_jax.npz")
    jser.save_state(jpath, ref.state_dict())
    again = tfactory.index_from_state_dict(tser.load_state(jpath), device="cpu")
    assert isinstance(again, TPre) and again.inner.nprobe == 4
    assert_same_results(again.search(q, K), port.search(q, K), 0)


def test_unfit_state_round_trips():
    """An untrained pre-transform keeps its fit mode through the state."""
    idx = build("OPQ8,PQ8")
    again = tfactory.index_from_state_dict(idx.state_dict(), device="cpu")
    assert again.opq_m == 8 and again.matrix is None and not again.is_trained
    jagain = jfactory.index_from_state_dict(idx.state_dict())
    assert jagain.opq_m == 8 and jagain.matrix is None


# ---- storage dirs across packages ----------------------------------------


def wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_jax_storage_dir_served_by_port(data, tmp_path):
    """The JAX engine writes an OPQ8,PQ8,RFlat storage dir; a port server
    loads it and serves the ids and metadata the JAX engine serves."""
    x, q = data
    storage = str(tmp_path / "store")
    cfg = JCfg(faiss_factory="OPQ8,PQ8,RFlat", dim=D, metric="l2", train_num=1000,
               opq_iters=2, index_storage_dir=os.path.join(storage, "opq", "0"))
    jidx = JIndex(cfg)
    jidx.add_batch(x, [{"doc": i} for i in range(1200)], train_async_if_triggered=False)
    assert wait_until(lambda: jidx.get_state() == JState.TRAINED
                      and jidx.get_idx_data_num() == (0, 1200))
    assert jidx.save() is True
    jidx.retire()
    want_d, want_m, _ = JIndex.from_storage_dir(cfg.index_storage_dir).search(q, K)
    srv = IndexServer(0, storage, device="cpu")
    port = srv.bind(0)
    threading.Thread(target=srv.start_blocking, name="test-pretransform-server",
                     daemon=True).start()
    disc = str(tmp_path / "discovery.txt")
    with open(disc, "w") as f:
        f.write(f"1\nlocalhost,{port}\n")
    client = IndexClient(disc)
    try:
        assert client.load_index("opq")
        assert client.get_ntotal("opq") == 1200
        got_d, got_m = client.search(q, K, "opq")
    finally:
        client.close()
        srv.stop()
    assert got_m == want_m
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)


def test_port_engine_dir_loads_in_jax(data, tmp_path):
    """The port engine's generation + MANIFEST dir of a PCA32,IVF8,Flat
    index loads in the JAX engine and serves the same ids and metadata."""
    x, q = data
    storage = str(tmp_path / "shard")
    cfg = IndexCfg(faiss_factory="PCA32,IVF8,Flat", dim=D, metric="l2", train_num=1000,
                   nprobe=8, kmeans_iters=4, index_storage_dir=storage)
    tidx = TIndex(cfg, device="cpu")
    tidx.add_batch(x, [("r", i) for i in range(1200)], train_async_if_triggered=False)
    assert wait_until(lambda: tidx.get_state() == IndexState.TRAINED
                      and tidx.get_idx_data_num() == (0, 1200))
    assert tidx.save() is True
    got_d, got_m, _ = tidx.search(q, K)
    want_d, want_m, _ = JIndex.from_storage_dir(storage).search(q, K)
    assert got_m == want_m
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)
