"""The port's ops (distributed_faiss_tpu_torch/ops) against the JAX package's
on the same numpy inputs: distances, segmented top-k, the merge, the sq8
and fp16 codecs, and Lloyd k-means."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import distance as jdist
from distributed_faiss_tpu.ops import kmeans as jkm
from distributed_faiss_tpu.ops import sq as jsq
from distributed_faiss_tpu_torch.ops import distance as tdist
from distributed_faiss_tpu_torch.ops import kmeans as tkm
from distributed_faiss_tpu_torch.ops import sq as tsq


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_pairwise_scores(rng, metric):
    q = rng.standard_normal((7, 32)).astype(np.float32)
    x = rng.standard_normal((50, 32)).astype(np.float32)
    want = N(jdist.pairwise_scores(q, x, metric))
    got = tdist.pairwise_scores(T(q), T(x), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("width,k", [(300, 10), (5000, 10), (6000, 37)])
def test_segmented_topk_rows(rng, width, k):
    """Both the single-pass (narrow) and the two-stage (wide, non-aligned)
    reductions select the same values and ids as the JAX package."""
    s = rng.standard_normal((4, width)).astype(np.float32)
    ids = rng.permutation(4 * width).reshape(4, width).astype(np.int32)
    jv, ji = jdist.segmented_topk_rows(s, k, ids)
    tv, ti = tdist.segmented_topk_rows(T(s), k, T(ids))
    np.testing.assert_array_equal(tv.numpy(), N(jv))
    np.testing.assert_array_equal(ti.numpy(), N(ji))


def test_segmented_topk_pad_ids_are_minus_one(rng):
    """A wide, non-aligned row with fewer finite entries than k: the finite
    entries match the JAX package's, and a -inf slot carries either the id
    of a masked column inside the width or -1 for a pad column past it —
    never an id from past the width."""
    w, k = 4097, 8
    s = np.full((2, w), -np.inf, np.float32)
    s[:, :3] = rng.standard_normal((2, 3)).astype(np.float32)
    gids = np.arange(w, dtype=np.int32) + 1000
    jv, ji = jdist.segmented_topk(s, k, gids)
    tv, ti = tdist.segmented_topk(T(s), k, T(gids))
    np.testing.assert_array_equal(tv.numpy(), N(jv))
    np.testing.assert_array_equal(ti.numpy()[:, :3], N(ji)[:, :3])
    rest = ti.numpy()[:, 3:]
    assert ((rest == -1) | ((rest >= 1000) & (rest < 1000 + w))).all()
    _, pos = tdist.segmented_argtopk(T(s), k)
    assert ((pos.numpy() >= -1) & (pos.numpy() < w)).all()


def test_merge_topk(rng):
    va = np.sort(rng.standard_normal((3, 5)).astype(np.float32), axis=1)[:, ::-1].copy()
    vb = np.sort(rng.standard_normal((3, 4)).astype(np.float32), axis=1)[:, ::-1].copy()
    vb[0, 2:] = -np.inf
    ia = rng.integers(0, 100, (3, 5)).astype(np.int32)
    ib = rng.integers(100, 200, (3, 4)).astype(np.int32)
    jv, ji = jdist.merge_topk(va, ia, vb, ib, 6)
    tv, ti = tdist.merge_topk(T(va), T(ia), T(vb), T(ib), 6)
    np.testing.assert_array_equal(tv.numpy(), N(jv))
    np.testing.assert_array_equal(ti.numpy(), N(ji))
    # too few finite candidates: -inf slots carry id -1 in the port
    tv, ti = tdist.merge_topk(T(va[:, :1]), T(ia[:, :1]), T(vb[:, 2:]), T(ib[:, 2:]), 3)
    assert np.isneginf(tv.numpy()[0, 1:]).all() and (ti.numpy()[0, 1:] == -1).all()
    assert ti.numpy()[0, 0] == ia[0, 0]


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("codec", ["raw", "sq8"])
def test_knn(rng, metric, codec):
    """Exact chunked scan of a capacity-padded corpus: same ids, scores
    within fp32 summation order."""
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if codec == "sq8":
        p = jsq.sq8_train(x)
        x = N(jsq.sq8_encode(x, p["vmin"], p["span"]))
        kw_j = dict(codec="sq8", vmin=p["vmin"], span=p["span"])
        kw_t = dict(codec="sq8", vmin=T(p["vmin"]), span=T(p["span"]))
    jv, ji = jdist.knn(q, x, 9, metric=metric, ntotal=250, chunk=64, **kw_j)
    tv, ti = tdist.knn(T(q), T(x), 9, metric=metric, ntotal=250, chunk=64, **kw_t)
    np.testing.assert_array_equal(ti.numpy(), N(ji))
    np.testing.assert_allclose(tv.numpy(), N(jv), rtol=1e-5, atol=1e-4)
    assert ti.numpy().max() < 250


def test_sq8_codec_bit_exact(rng):
    x = (rng.standard_normal((200, 24)) * 3).astype(np.float32)
    # values exactly half a grid step from a code exercise round-half-even
    jp = jsq.sq8_train(x)
    tp = tsq.sq8_train(T(x))
    np.testing.assert_array_equal(tp["vmin"].numpy(), N(jp["vmin"]))
    np.testing.assert_array_equal(tp["span"].numpy(), N(jp["span"]))
    step = N(jp["span"]) / 255.0
    halves = (N(jp["vmin"]) + (np.arange(24) % 200 + 0.5) * step).astype(np.float32)
    xs = np.concatenate([x, halves[None, :]])
    jc = N(jsq.sq8_encode(xs, jp["vmin"], jp["span"]))
    tc = tsq.sq8_encode(T(xs), tp["vmin"], tp["span"]).numpy()
    np.testing.assert_array_equal(tc, jc)
    jd = N(jsq.sq8_decode(jc, jp["vmin"], jp["span"]))
    td = tsq.sq8_decode(T(tc), tp["vmin"], tp["span"]).numpy()
    np.testing.assert_array_equal(td, jd)


def test_fp16_codec_bit_exact(rng):
    x = (rng.standard_normal((100, 16)) * 1e3).astype(np.float32)
    je = N(jsq.fp16_encode(x))
    te = tsq.fp16_encode(T(x)).numpy()
    np.testing.assert_array_equal(te.view(np.uint16), je.view(np.uint16))
    np.testing.assert_array_equal(tsq.fp16_decode(T(te)).numpy(), N(jsq.fp16_decode(je)))


def test_lloyd_step_from_shared_init(rng):
    """One assignment + accumulation pass from the same initial centroids:
    same sums and counts (the port scatter-adds where the JAX package runs
    a one-hot matmul; both are fp32 sums of the same terms)."""
    k, chunk = 6, 32
    x = rng.standard_normal((96, 8)).astype(np.float32)
    w = np.ones((96,), np.float32)
    w[90:] = 0.0  # zero-weight pad rows
    cent = x[rng.permutation(96)[:k]]
    xc, wc = x.reshape(-1, chunk, 8), w.reshape(-1, chunk)
    js, jc = jkm.accumulate_clusters(xc, wc, cent, k)
    ts, tc = tkm.accumulate_clusters(T(xc), T(wc), T(cent), k)
    np.testing.assert_array_equal(tc.numpy(), N(jc))
    np.testing.assert_allclose(ts.numpy(), N(js), rtol=1e-5, atol=1e-5)
    new_j = N(js) / np.maximum(N(jc), 1.0)[:, None]
    new_t = (ts / torch.clamp_min(tc, 1.0)[:, None]).numpy()
    np.testing.assert_allclose(new_t, new_j, rtol=1e-5, atol=1e-5)


def _inertia(x, cent):
    d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    return d2.min(1).sum()


def test_kmeans_inertia_bound():
    """End to end the two packages draw different seeds (torch.Generator vs
    PRNGKey), so their centroids differ; with the default (k-means++)
    seeding both reach an inertia close to the generating centers' on
    well-separated blobs, except on draws where k-means++ puts two seeds in
    one blob, which Lloyd steps cannot undo. On this data that happens for
    the last seed with probability about 0.2 (7 covered blobs of ~100
    points at ~32 squared distance from their seed, against ~100 uncovered
    points at ~500-1400), so over 20 draws sound seeding stays within 5%
    of the reference on at least 12 (it misses 9 or more with probability
    about 1%). On these 20 draws the port misses 3 and the JAX package 7
    (ROADMAP.md). Each draw comes from a generator of its own, not from the
    run-wide ``rng`` fixture."""
    k, d = 8, 16
    misses = {"port": [], "jax": []}
    for seed in range(20):
        rng = np.random.default_rng(seed)
        centers = rng.standard_normal((k, d)).astype(np.float32) * 8.0
        x = (centers[rng.integers(0, k, 800)]
             + rng.standard_normal((800, d)).astype(np.float32))
        ref = _inertia(x, centers)
        t_cent = tkm.kmeans(T(x), k, iters=10).numpy()
        j_cent = N(jkm.kmeans(x, k, iters=10))
        assert t_cent.shape == (k, d) and t_cent.dtype == np.float32
        if _inertia(x, t_cent) > 1.05 * ref:
            misses["port"].append(seed)
        if _inertia(x, j_cent) > 1.05 * ref:
            misses["jax"].append(seed)
    assert len(misses["port"]) <= 8 and len(misses["jax"]) <= 8, misses


def test_kmeans_seeded_generator_is_deterministic(rng):
    x = rng.standard_normal((300, 8)).astype(np.float32)
    a = tkm.kmeans(T(x), 5, iters=3, seed=7)
    b = tkm.kmeans(T(x), 5, iters=3, seed=7)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tkm.kmeans(T(x[:3]), 5)


def test_auto_chunk_matches():
    for k in (1, 100, 65536, 262144):
        assert tkm.auto_chunk(k) == jkm.auto_chunk(k)
