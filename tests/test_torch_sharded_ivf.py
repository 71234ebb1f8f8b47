"""The port's sharded IVF models against the JAX package's, on eight virtual
shards a side: IvfTpuIndex, ShardedIVFFlatIndex and ShardedIVFPQIndex in
masked mode (K1; K3 over the lists; K2 over the gathered codes, through
their plain versions on the CPU), routed mode, refine, snapshots. k-means
from a seed differs between the packages (threefry against torch), so the
port's models take the JAX model's centroids and codebooks and add the
same rows themselves: the lists they build must be the JAX lists."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.parallel import mesh as tmesh

S, K = 8, 10


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(S)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(S, device="cpu", virtual=True)


def make_data(seed, n, d, nq, nclusters=16):
    """Clustered rows (tie-free scores) and queries near them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nclusters, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nclusters, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, nclusters, nq)] + rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def brute_ids(q, x, k, metric):
    s = q @ x.T if metric == "dot" else -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(-s, axis=1)[:, :k]


def assert_same(port, ref, tol=1e-3):
    (dp, ip), (dr, ir) = port, ref
    np.testing.assert_array_equal(ip, ir)
    np.testing.assert_array_equal(np.isinf(dp), np.isinf(dr))
    f = np.isfinite(dr)
    np.testing.assert_allclose(dp[f], dr[f], rtol=tol, atol=tol)


def carry(jidx, tidx, x):
    """The JAX model's trained state into the port's model, then the same
    rows added by the port (its own assignment and list layout)."""
    tidx.centroids = torch.as_tensor(np.asarray(jidx.centroids))
    if hasattr(jidx, "codebooks"):
        tidx.codebooks = torch.as_tensor(np.asarray(jidx.codebooks))
    tidx.lists = tidx._make_lists()
    tidx.add(x)
    tidx.set_nprobe(jidx.nprobe)
    return tidx


def assert_same_layout(j, t):
    np.testing.assert_array_equal(torch.cat(t.lists.ids).numpy(), np.asarray(j.lists.ids))
    np.testing.assert_array_equal(t._host_assign_array(), j._host_assign_array())
    np.testing.assert_array_equal(t._host_pos_array(), j._host_pos_array())


# ---------------------------------------------------------------- IVF-Flat


FLAT_CASES = [("l2", 8, {}), ("dot", 8, {}), ("l2", 3, {}),
              ("l2", 3, {"refine_k_factor": 4, "scan_bf16": True})]


@pytest.fixture(scope="module")
def flat_data():
    return make_data(20, 1500, 16, 9)


@pytest.mark.parametrize("metric,nprobe,knobs", FLAT_CASES,
                         ids=["full-l2", "full-dot", "partial", "refine-bf16"])
def test_sharded_ivf_flat_masked_matches_jax(jm, tm, flat_data, metric, nprobe, knobs):
    x, q = flat_data
    j = jmesh.ShardedIVFFlatIndex(16, 8, metric, mesh=jm, kmeans_iters=4, **knobs)
    j.train(x[:800])
    j.add(x)
    j.set_nprobe(nprobe)
    t = carry(j, tmesh.ShardedIVFFlatIndex(16, 8, metric, mesh=tm, **knobs), x)
    assert_same_layout(j, t)
    got = t.search(q, K)
    assert_same(got, j.search(q, K))
    if nprobe == 8:  # full probe: the exact answer
        np.testing.assert_array_equal(got[1], brute_ids(q, x, K, metric))
    assert t.launches == 1
    # routed: the same trained state, the same answer
    r = tmesh.ShardedIVFFlatIndex(16, 8, metric, mesh=tm, probe_routing=True, **knobs)
    r.centroids, r.lists, r.norm_lists, r.raw_lists = t.centroids, t.lists, t.norm_lists, \
        t.raw_lists
    r._host_assign, r._host_pos, r._n = t._host_assign, t._host_pos, t._n
    r.set_nprobe(nprobe)
    assert_same(r.search(q, K), got, tol=1e-4)
    assert r.launches == 1


def test_routed_flat_matches_jax_routed(jm, tm, flat_data):
    x, q = flat_data
    j = jmesh.ShardedIVFFlatIndex(16, 16, "l2", mesh=jm, kmeans_iters=4, probe_routing=True)
    j.train(x)
    j.add(x)
    j.set_nprobe(6)
    t = carry(j, tmesh.ShardedIVFFlatIndex(16, 16, "l2", mesh=tm, probe_routing=True), x)
    assert_same(t.search(q, K), j.search(q, K))


def test_routed_handles_skewed_ownership(jm, tm):
    """Every row in one list, and the lists every query probes all on
    shard 0: one shard owns every pair. The port's routed index runs the
    JAX routed index's blocks and relaunches (each drop doubles the pair
    bucket), ends at the same ``_routed_slack``, and both answer like
    brute force on the tie-free queries."""
    rng = np.random.default_rng(21)
    d, nlist = 16, 64
    base = rng.standard_normal(d).astype(np.float32) * 5.0
    cents = base + 60.0 * rng.standard_normal((nlist, d)).astype(np.float32)
    cents[::S] = base + 3.0 * rng.standard_normal((nlist // S, d)).astype(np.float32)
    cents[0] = base
    x = base + 0.5 * rng.standard_normal((1024, d)).astype(np.float32)
    q = base + 0.5 * rng.standard_normal((500, d)).astype(np.float32)
    j = jmesh.ShardedIVFFlatIndex(d, nlist, "l2", mesh=jm, probe_routing=True)
    j.centroids = jmesh._replicated(jm, cents)
    j.lists = j._make_lists()
    j.add(x)
    j.set_nprobe(8)
    t = tmesh.ShardedIVFFlatIndex(d, nlist, "l2", mesh=tm, probe_routing=True)
    t.centroids = torch.as_tensor(cents)
    t.lists = t._make_lists()
    t.add(x)
    t.set_nprobe(8)
    assert t.lists.sizes_host[0] == 1024
    got, want = t.search(q, K), j.search(q, K)
    assert (t.launches, t._routed_slack) == (j.launches, j._routed_slack) == (3, 8.0)
    dist = ((q[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    top = np.sort(dist, axis=1)[:, :K + 1]
    ok = (np.diff(top, axis=1) > 1e-5 * top.max(axis=1, keepdims=True)).all(axis=1)
    assert ok.mean() > 0.75
    brute = np.argsort(dist, axis=1)[:, :K]
    np.testing.assert_array_equal(got[1][ok], brute[ok])
    np.testing.assert_array_equal(want[1][ok], brute[ok])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)


def test_ivf_tpu_matches_single_device_ivf_flat(tm, flat_data):
    """IvfTpuIndex trains sharded and scans as the single-device IVF-Flat;
    with the JAX IvfTpuIndex's centroids it serves the JAX ids."""
    x, q = flat_data
    j = jmesh.IvfTpuIndex(16, 8, "l2", "f32", kmeans_iters=4)
    j.train(x)
    j.add(x)
    j.set_nprobe(3)
    t = carry(j, tmesh.IvfTpuIndex(16, 8, "l2", "f32", mesh=tm), x)
    assert_same(t.search(q, K), j.search(q, K))
    assert t.state_dict()["kind"] == "ivf_flat"
    trained = tmesh.IvfTpuIndex(16, 8, "l2", "f32", mesh=tm, kmeans_iters=4)
    trained.train(x)
    assert trained.get_centroids().shape == (8, 16)
    assert trained.centroids.device == torch.device("cpu")


def test_masked_sharded_ids_equal_ivf_tpu_ids(tm, flat_data):
    """ivf_tpu with shard_lists (masked) at the same nprobe and centroids
    serves the unsharded IvfTpuIndex's ids (the equality phase h.2 checks
    on the card)."""
    x, q = flat_data
    base = tmesh.IvfTpuIndex(16, 16, "l2", "f32", mesh=tm, kmeans_iters=4)
    base.train(x)
    base.add(x)
    base.set_nprobe(5)
    sharded = tmesh.ShardedIVFFlatIndex(16, 16, "l2", mesh=tm)
    sharded.centroids = base.centroids
    sharded.lists = sharded._make_lists()
    sharded.add(x)
    sharded.set_nprobe(5)
    assert_same(sharded.search(q, K), base.search(q, K), tol=1e-4)


def test_sharded_ivf_flat_snapshots_cross_packages(jm, flat_data, monkeypatch):
    """A JAX sharded_ivf_flat snapshot (8 shards, refine rows, stored norms)
    restores on a 3-shard port mesh with the JAX ids, and the port's
    snapshot restores in the JAX package; both carry the same arrays."""
    x, q = flat_data
    j = jmesh.ShardedIVFFlatIndex(16, 8, "l2", mesh=jm, kmeans_iters=4, refine_k_factor=4,
                                  scan_bf16=True)
    j.train(x)
    j.add(x)
    j.set_nprobe(3)
    js = j.state_dict()
    monkeypatch.setenv("DFT_MESH_DEVICES", "3")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    t = tfactory.index_from_state_dict(js, device="cpu")
    assert isinstance(t, tmesh.ShardedIVFFlatIndex) and t.mesh.size == 3
    assert_same(t.search(q, K), j.search(q, K))
    ts = t.state_dict()
    assert set(ts) == set(js)
    for key in ("rows", "assign", "list_norms", "refine_rows", "centroids"):
        np.testing.assert_array_equal(ts[key], np.asarray(js[key]))
    back = jfactory.index_from_state_dict(ts)
    assert_same(back.search(q, K), j.search(q, K), tol=1e-5)
    rec = t.reconstruct_batch(np.array([3, 400, 1499]))
    np.testing.assert_array_equal(rec, x[[3, 400, 1499]])


# ------------------------------------------------------------------ IVF-PQ


@pytest.fixture(scope="module")
def pq_data():
    return make_data(22, 1500, 32, 9)


PQ_CASES = [("l2", 8), ("dot", 8), ("l2", 4), ("dot", 4)]


@pytest.fixture(scope="module")
def jax_pq(jm, pq_data):
    """JAX sharded IVF-PQ models per (metric, m), refine 8, trained once."""
    x, _ = pq_data
    out = {}
    for metric, m in PQ_CASES:
        j = jmesh.ShardedIVFPQIndex(32, 8, m=m, metric=metric, mesh=jm, kmeans_iters=4,
                                    pq_iters=4, refine_k_factor=8)
        j.train(x)
        j.add(x)
        j.set_nprobe(4)
        out[metric, m] = j
    return out


@pytest.mark.parametrize("metric,m", PQ_CASES,
                         ids=["l2-K3", "dot-K3", "l2-K2", "dot-K2"])
def test_sharded_ivf_pq_masked_matches_jax(tm, pq_data, jax_pq, metric, m):
    """m % 8 == 0 runs K3 over the lists, m % 8 != 0 K2 over the gathered
    codes (their plain versions here); refine rescoring exact before the
    merge; routed equals masked."""
    x, q = pq_data
    j = jax_pq[metric, m]
    t = carry(j, tmesh.ShardedIVFPQIndex(32, 8, m=m, metric=metric, mesh=tm,
                                         refine_k_factor=8), x)
    assert_same_layout(j, t)
    np.testing.assert_array_equal(torch.cat(t.raw_lists.data).numpy(),
                                  np.asarray(j.raw_lists.data))
    got = t.search(q, 5)
    assert_same(got, j.search(q, 5))
    x16 = x.astype(np.float16).astype(np.float32)
    for qi in range(q.shape[0]):  # refined scores are exact on the fp16 rows
        exact = (((q[qi][None, :] - x16[got[1][qi]]) ** 2).sum(-1) if metric == "l2"
                 else x16[got[1][qi]] @ q[qi])
        np.testing.assert_allclose(got[0][qi], exact, rtol=1e-3, atol=1e-3)
    r = tmesh.ShardedIVFPQIndex(32, 8, m=m, metric=metric, mesh=tm, refine_k_factor=8,
                                probe_routing=True)
    r.centroids, r.codebooks, r.lists, r.raw_lists = t.centroids, t.codebooks, t.lists, \
        t.raw_lists
    r._host_assign, r._host_pos, r._n = t._host_assign, t._host_pos, t._n
    r.set_nprobe(4)
    assert_same(r.search(q, 5), got, tol=1e-4)


def test_sharded_ivf_pq_unrefined_matches_jax(jm, tm, pq_data):
    x, q = pq_data
    j = jmesh.ShardedIVFPQIndex(32, 8, m=8, metric="l2", mesh=jm, kmeans_iters=4, pq_iters=4)
    j.train(x)
    j.add(x)
    j.set_nprobe(3)
    t = carry(j, tmesh.ShardedIVFPQIndex(32, 8, m=8, metric="l2", mesh=tm), x)
    assert_same(t.search(q, K), j.search(q, K), tol=1e-4)


def test_sharded_ivf_pq_snapshots_cross_packages(pq_data, jax_pq, monkeypatch):
    x, q = pq_data
    j = jax_pq["l2", 8]
    js = j.state_dict()
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    t = tfactory.index_from_state_dict(js, device="cpu")
    assert isinstance(t, tmesh.ShardedIVFPQIndex) and t.mesh.size == 4
    assert_same(t.search(q, 5), j.search(q, 5))
    ts = t.state_dict()
    assert set(ts) == set(js) and ts["kind"] == "sharded_ivf_pq"
    for key in ("rows", "assign", "refine_rows", "codebooks"):
        np.testing.assert_array_equal(ts[key], np.asarray(js[key]))
    back = jfactory.index_from_state_dict(ts)
    assert_same(back.search(q, 5), j.search(q, 5), tol=1e-5)
    no_rows = dict(js)
    del no_rows["refine_rows"]
    with pytest.raises(ValueError, match="refine_rows"):
        tfactory.index_from_state_dict(no_rows, device="cpu")


# --------------------------------------------------------------- deletes


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_remove_rows_on_sharded_lists_matches_jax(tm, flat_data, pq_data, jax_pq, kind):
    """The same deletes on both packages' sharded IVF models: the same
    ids, no deleted row served (the -1 cell lands on the owning shard)."""
    if kind == "flat":
        x, q = flat_data
        j = jmesh.ShardedIVFFlatIndex(16, 8, "l2", kmeans_iters=4)
        j.train(x)
        j.add(x)
        j.set_nprobe(3)
        t = carry(j, tmesh.ShardedIVFFlatIndex(16, 8, "l2", mesh=tm), x)
    else:
        x, q = pq_data
        j = jfactory.index_from_state_dict(jax_pq["l2", 4].state_dict())  # a private copy
        t = carry(j, tmesh.ShardedIVFPQIndex(32, 8, m=4, metric="l2", mesh=tm,
                                             refine_k_factor=8), x)
    _, first = j.search(q, 3)
    dead = np.union1d(first.ravel(), np.arange(0, x.shape[0], 9))
    for idx in (j, t):
        idx.remove_rows(dead)
    got = t.search(q, 5)
    assert_same(got, j.search(q, 5))
    assert not np.isin(got[1], dead).any()
    np.testing.assert_array_equal(torch.cat(t.lists.ids).numpy(), np.asarray(j.lists.ids))
