"""The port's product quantization (distributed_faiss_tpu_torch/ops/pq.py) and
batched k-means against the JAX package's on the same numpy inputs.

Codebooks trained in the two packages differ by design (torch generators do
not draw JAX's bits), so the codecs are compared on codebooks trained once
in the JAX package, and k-means on one Lloyd step from a shared initial
set."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import kmeans as jkm
from distributed_faiss_tpu.ops import pq as jpq
from distributed_faiss_tpu_torch.ops import kmeans as tkm
from distributed_faiss_tpu_torch.ops import pq as tpq


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def trained():
    """(x, q, codebooks): 900 x 32 clustered rows, 6 queries, and m=8
    codebooks of 256 centroids trained by the JAX package."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 16, 900)] + rng.standard_normal((900, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    codebooks = N(jpq.pq_train(x[:600], 8, iters=4))
    return x, q, codebooks


@pytest.mark.parametrize("m", [1, 4, 8, 32])
def test_split(m):
    x = np.random.default_rng(m).standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_array_equal(tpq._split(T(x), m).numpy(), N(jpq._split(x, m)))


def test_split_refuses_indivisible_dim():
    with pytest.raises(ValueError, match="not divisible"):
        tpq._split(torch.zeros((2, 10)), 4)


@pytest.mark.parametrize("block", [8192, 128])
def test_pq_encode_identical_but_near_ties(trained, block):
    """Identical codes except where two codewords lie within 1e-5 relative
    of each other in the JAX package's distance (an fp32 summation order
    can flip such an argmin); those entries are counted and stay rare.
    block=128 runs the row-blocked path with a ragged tail."""
    x, _, cb = trained
    want = N(jpq.pq_encode(x, cb, block=block))
    got = tpq.pq_encode(T(x), T(cb), block=block).numpy()
    assert got.shape == want.shape == (900, 8) and got.dtype == np.uint8
    diff = got != want
    if diff.any():
        xs = x.reshape(900, 8, 4).astype(np.float64)
        cb64 = cb.astype(np.float64)
        rows, subs = np.nonzero(diff)
        dj = ((xs[rows, subs] - cb64[subs, want[rows, subs]]) ** 2).sum(1)
        dp = ((xs[rows, subs] - cb64[subs, got[rows, subs]]) ** 2).sum(1)
        assert (np.abs(dp - dj) <= 1e-5 * np.maximum(dj, 1e-12)).all()
    assert diff.sum() <= diff.size // 1000


def test_pq_decode_exact(trained):
    x, _, cb = trained
    codes = N(jpq.pq_encode(x[:50], cb))
    np.testing.assert_array_equal(tpq.pq_decode(T(codes), T(cb)).numpy(),
                                  N(jpq.pq_decode(codes, cb)))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_lut(trained, metric):
    _, q, cb = trained
    want = N(jpq.adc_lut(q, cb, metric=metric))
    got = tpq.adc_lut(T(q), T(cb), metric=metric).numpy()
    assert got.shape == want.shape == (6, 8, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_adc_scan_is_the_plain_gather_sum(trained):
    """pq.adc_scan (the JAX package's XLA path) against the port's."""
    x, q, cb = trained
    lut = N(jpq.adc_lut(q[:3], cb))
    codes = np.stack([N(jpq.pq_encode(x[i * 100:(i + 1) * 100], cb)) for i in range(3)])
    np.testing.assert_allclose(tpq.adc_scan(T(lut), T(codes)).numpy(),
                               N(jpq.adc_scan(lut, codes)), rtol=1e-4, atol=1e-4)


def test_batched_lloyd_step_from_shared_init():
    """One assignment + accumulation pass of m problems from the same
    initial centroids: the port's batched step against the JAX package's
    per-problem step (the JAX package vmaps that step over m)."""
    rng = np.random.default_rng(3)
    m, n, d, k, chunk = 5, 96, 4, 7, 32
    xs = rng.standard_normal((m, n, d)).astype(np.float32)
    w = np.ones((n,), np.float32)
    w[90:] = 0.0  # zero-weight pad rows
    cent = np.stack([xs[i, rng.permutation(n)[:k]] for i in range(m)])
    xc, wc = xs.reshape(m, -1, chunk, d), w.reshape(-1, chunk)
    ts, tc = tkm.accumulate_clusters_batched(T(xc), T(wc), T(cent), k)
    assert ts.shape == (m, k, d) and tc.shape == (m, k)
    for i in range(m):
        js, jc = jkm.accumulate_clusters(xc[i], wc, cent[i], k)
        np.testing.assert_array_equal(tc[i].numpy(), N(jc))
        np.testing.assert_allclose(ts[i].numpy(), N(js), rtol=1e-5, atol=1e-5)


def _inertia(x, cent):
    d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    return d2.min(1).sum()


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_batched_inertia_bound(init):
    """End to end the seeds differ between packages. With k-means++
    seeding (the default at k <= 16384) every subspace reaches an inertia
    close to the generating centers' on well-separated blobs; uniform
    seeding can start two seeds in one blob, so it is held to a looser
    bound. A fixed seed repeats either way."""
    rng = np.random.default_rng(5)
    m, k, d = 3, 6, 4
    centers = rng.standard_normal((m, k, d)).astype(np.float32) * 10.0
    xs = np.stack([centers[i, rng.integers(0, k, 600)] for i in range(m)])
    xs = xs + rng.standard_normal(xs.shape).astype(np.float32)
    got = tkm.kmeans_batched(T(xs), k, iters=10, init=init)
    assert got.shape == (m, k, d) and got.dtype == torch.float32
    for i in range(m):
        bound = 1.2 if init == "kmeans++" else 10.0
        assert _inertia(xs[i], got[i].numpy()) <= bound * _inertia(xs[i], centers[i])
    assert torch.equal(got, tkm.kmeans_batched(T(xs), k, iters=10, init=init))
    with pytest.raises(ValueError, match="training points"):
        tkm.kmeans_batched(T(xs[:, :5]), k)


def test_kmeans_batched_seeds_coincident_points():
    """A problem whose points are fewer distinct values than k still seeds
    (uniform draws once every point coincides with a seed)."""
    xs = np.zeros((2, 40, 3), np.float32)
    xs[1, :20] = 1.0
    cent = tkm.kmeans_batched(T(xs), 4, iters=2)
    assert torch.isfinite(cent).all()
    assert set(np.unique(cent[1].numpy())) <= {0.0, 1.0}


def test_pq_train_shapes_and_codec_round_trip(trained):
    """The port's trained codebooks encode and decode with a distortion
    close to the JAX package's codebooks'."""
    x, _, jcb = trained
    tcb = tpq.pq_train(T(x[:600]), 8, iters=4)
    assert tcb.shape == (8, 256, 4)
    xt = T(x[600:])

    def err(cb):
        return float(((tpq.pq_decode(tpq.pq_encode(xt, cb), cb) - xt) ** 2).sum(1).mean())

    assert err(tcb) <= 1.25 * err(T(jcb))
