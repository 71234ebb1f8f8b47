"""The multi-block search on the port against the JAX package's fused
entries (the port of tests/test_fused_blocks.py).

``MAX_QUERY_BLOCK`` is 8 in both packages, so 27-37 queries span 4-5
query blocks and the JAX models take their one-launch ``lax.map`` entries
(``_flat_search_fused``, ``_ivf_flat_search_fused``,
``_ivf_pq_search_fused``, the mesh's masked fused entries). The port's
models get the JAX model's trained state (k-means and PQ training differ
between the packages) and add the same rows; then its window program
(op by op on the CPU, and through the program cache's recording
stand-in) must give the JAX ids, scores within 1e-3, and the port's own
per-block loop bit for bit. The JAX side runs its Pallas kernels in
interpret mode where ``use_pallas`` asks for them."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.models import base as jbase
from distributed_faiss_tpu.models.flat import FlatIndex as JFlat
from distributed_faiss_tpu.models.ivf import IVFFlatIndex as JIVFFlat
from distributed_faiss_tpu.models.ivf import IVFPQIndex as JIVFPQ
from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu_torch.models import base as tbase
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils import programs

D, K, S = 32, 5, 8


@pytest.fixture
def small_blocks(monkeypatch):
    # pick_query_block reads the module global at call time: 8-query blocks
    monkeypatch.setattr(jbase, "MAX_QUERY_BLOCK", 8)
    monkeypatch.setattr(tbase, "MAX_QUERY_BLOCK", 8)


def make_data(seed, n, nq, d=D, noise=1.0):
    """Clustered rows (tie-free scores) and queries near them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 12, n)] + rng.standard_normal((n, d)).astype(np.float32) * noise
    q = centers[rng.integers(0, 12, nq)] + rng.standard_normal((nq, d)).astype(np.float32) * noise
    return x, q


def brute_ids(q, x, k, metric):
    s = q @ x.T if metric == "dot" else -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(-s, axis=1)[:, :k]


def carry(j, t, x):
    """The JAX model's trained state into the port's model, then the same
    rows added by the port."""
    t.centroids = torch.as_tensor(np.array(j.centroids))
    if hasattr(j, "codebooks"):
        t.codebooks = torch.as_tensor(np.array(j.codebooks))
    if getattr(j, "sq_params", None) is not None:
        t.sq_params = {n: torch.as_tensor(np.array(v)) for n, v in j.sq_params.items()}
    t.lists = t._make_lists()
    t.add(x)
    t.set_nprobe(j.nprobe)
    return t


def per_block(monkeypatch, model, q, k):
    """The port's search with the fused entry taken away: one program a
    query block."""
    orig = tbase.blocked_search

    def blocks_only(*a, fused_fn=None, **kw):
        return orig(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(tbase, "blocked_search", blocks_only)
        return model.search(q, k)


def build(case):
    """(JAX model, port model, queries, metric, exact) of one case."""
    if case.startswith("flat-"):
        metric, codec = case.split("-")[1:]
        x, q = make_data(1, 300, 27)
        j = JFlat(D, metric=metric, codec=codec)
        j.train(x)
        j.add(x)
        return j, tfactory.index_from_state_dict(j.state_dict(), device="cpu"), q, metric, x
    if case.startswith("ivf_flat-"):
        metric = case.split("-")[1]
        x, q = make_data(2, 400, 37)
        j = JIVFFlat(D, 8, metric=metric)
        j.train(x)
        j.add(x)
        j.set_nprobe(8)  # full probe: exact
        return j, carry(j, IVFFlatIndex(D, 8, metric, device="cpu"), x), q, metric, x
    if case.startswith("ivf_pq-") or case.startswith("flat_pq-"):
        m = int(case.split("-")[1])
        nlist = 16 if case.startswith("ivf_pq") else 1
        x, q = make_data(3, 1500, 29, noise=0.3)
        j = JIVFPQ(D, nlist, m=m, metric="l2", refine_k_factor=8)
        j.train(x)
        j.add(x)
        j.set_nprobe(nlist)
        t = carry(j, IVFPQIndex(D, nlist, m=m, refine_k_factor=8, device="cpu"), x)
        return j, t, q, "l2", None
    raise ValueError(case)


CASES = ["flat-dot-f32", "flat-l2-f32", "flat-l2-sq8", "ivf_flat-l2", "ivf_flat-dot",
         "ivf_pq-8", "ivf_pq-4", "flat_pq-8"]


@pytest.mark.parametrize("case", CASES)
def test_fused_window_matches_jax_and_the_block_loop(case, small_blocks, monkeypatch):
    j, t, q, metric, x = build(case)
    want = j.search(q, K)
    got = t.search(q, K)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)
    if x is not None and not case.endswith("sq8"):
        np.testing.assert_array_equal(got[1], brute_ids(q, x, K, metric))
    loop = per_block(monkeypatch, t, q, K)
    np.testing.assert_array_equal(got[1], loop[1])
    np.testing.assert_array_equal(got[0], loop[0])
    # the same window through the program cache: one capture, one replay
    t.programs.backend = programs.RecordingGraphs()
    rec = t.search(q, K)
    assert t.programs.captures == 1 and t.programs.replays == 1
    np.testing.assert_array_equal(rec[1], got[1])
    np.testing.assert_array_equal(rec[0], got[0])


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(S)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(S, device="cpu", virtual=True)


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq-8", "ivf_pq-4"])
def test_fused_masked_mesh_matches_jax(jm, tm, kind, small_blocks, monkeypatch):
    """The masked sharded entries on 8 shards a side: one counted launch,
    the JAX fused entry's ids, the port's per-block loop bit for bit."""
    x, q = make_data(4, 800, 21, noise=0.3)
    if kind == "flat":
        j = jmesh.ShardedFlatIndex(D, "l2", mesh=jm)
        j.add(x)
        t = tmesh.ShardedFlatIndex(D, "l2", mesh=tm)
        t.add(x)
    elif kind == "ivf_flat":
        j = jmesh.ShardedIVFFlatIndex(D, 8, "l2", mesh=jm, kmeans_iters=4)
        j.train(x)
        j.add(x)
        j.set_nprobe(8)
        t = carry(j, tmesh.ShardedIVFFlatIndex(D, 8, "l2", mesh=tm), x)
    else:
        m = int(kind.split("-")[1])
        j = jmesh.ShardedIVFPQIndex(D, 8, m=m, metric="l2", refine_k_factor=8, mesh=jm,
                                    kmeans_iters=4)
        j.train(x)
        j.add(x)
        j.set_nprobe(8)
        t = carry(j, tmesh.ShardedIVFPQIndex(D, 8, m=m, refine_k_factor=8, mesh=tm), x)
    want = j.search(q, K)
    got = t.search(q, K)
    assert t.launches == 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)
    if kind in ("flat", "ivf_flat"):
        np.testing.assert_array_equal(got[1], brute_ids(q, x, K, "l2"))
    loop = per_block(monkeypatch, t, q, K)
    np.testing.assert_array_equal(got[1], loop[1])
    np.testing.assert_array_equal(got[0], loop[0])
    t.programs.backend = programs.RecordingGraphs()
    rec = t.search(q, K)
    assert t.programs.captures == 1
    np.testing.assert_array_equal(rec[1], got[1])
    np.testing.assert_array_equal(rec[0], got[0])


@pytest.mark.parametrize("nq,fused", [(8, 0), (9, 1)])
def test_fused_engages_only_past_one_block(nq, fused, small_blocks, monkeypatch):
    """A batch of one block stays on the per-block program."""
    x, _ = make_data(5, 200, 1, d=8)
    idx = IVFFlatIndex(8, 4, "l2", device="cpu")
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(4)
    calls = {"fused": 0}
    orig = tbase.blocked_search

    def spy(q, k, metric, fn, device, block=256, fused_fn=None, programs=None):
        if fused_fn is not None and np.asarray(q).shape[0] > block:
            calls["fused"] += 1
        return orig(q, k, metric, fn, device, block=block, fused_fn=fused_fn,
                    programs=programs)

    monkeypatch.setattr(tbase, "blocked_search", spy)
    idx.search(np.random.default_rng(6).standard_normal((nq, 8)).astype(np.float32), 3)
    assert calls["fused"] == fused


def test_padded_rows_never_change_a_real_row(small_blocks):
    """Each row's answer alone equals its answer inside a padded window."""
    x, q = make_data(7, 400, 29)
    idx = IVFFlatIndex(D, 8, "l2", device="cpu")
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(3)
    d, i = idx.search(q, K)
    for r in (0, 13, 28):
        dr, ir = idx.search(q[r:r + 1], K)
        np.testing.assert_array_equal(ir[0], i[r])
        np.testing.assert_allclose(dr[0], d[r], rtol=1e-6, atol=1e-6)
