"""The port's mesh (distributed_faiss_tpu_torch/parallel/mesh.py) against the
JAX package's: MeshCfg, make_mesh, sharded_knn, the sharded Lloyd step,
ShardedPaddedLists and ShardedFlatIndex on the same numpy inputs. The JAX
side runs on the suite's virtual 8-device CPU mesh, the port side on
``make_mesh(8, device="cpu", virtual=True)``: eight shards on one CPU."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu.utils.config import MeshCfg as JMeshCfg
from distributed_faiss_tpu_torch.models import base as tbase
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils.config import MeshCfg

S = 8
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(S)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(S, device="cpu", virtual=True)


def _jsharded(jm, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jm, P("shard", *[None] * (x.ndim - 1))))


def brute_ids(q, x, k, metric):
    s = q @ x.T if metric == "dot" else -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(-s, axis=1)[:, :k]


# ------------------------------------------------------------ config, mesh


ENV_CASES = [{}, {"DFT_MESH_DEVICES": "4", "DFT_MESH_MODE": "routed"},
             {"DFT_MESH_DEVICES": "0", "DFT_MESH_MODE": "masked"}]
BAD_ENV = [({"DFT_MESH_MODE": "zigzag"}, "mode"), ({"DFT_MESH_DEVICES": "-1"}, "devices")]


@pytest.mark.parametrize("env", ENV_CASES)
def test_mesh_cfg_parses_like_jax(env):
    got, want = MeshCfg.from_env(env), JMeshCfg.from_env(env)
    assert (got.devices, got.mode) == (want.devices, want.mode)
    assert got.virtual is False


@pytest.mark.parametrize("env,match", BAD_ENV)
def test_mesh_cfg_refuses_like_jax(env, match):
    with pytest.raises(ValueError, match=match) as want:
        JMeshCfg.from_env(env)
    with pytest.raises(ValueError, match=match) as got:
        MeshCfg.from_env(env)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="unknown"):
        MeshCfg(chips=8)
    assert MeshCfg.from_env({"DFT_MESH_VIRTUAL": "1"}).virtual is True


def test_make_mesh_raises_past_visible_devices_unless_virtual(monkeypatch):
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        jmesh.make_mesh(9)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        tmesh.make_mesh(2, device="cpu")
    m = tmesh.make_mesh(3, device="cpu", virtual=True)
    assert m.shape[tmesh.AXIS] == 3 and m.devices == [torch.device("cpu")] * 3
    assert tmesh.make_mesh(0, device="cpu").shape["shard"] == 1  # every visible device
    monkeypatch.setenv("DFT_MESH_DEVICES", "5")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    assert tmesh.make_mesh(device="cpu").shape["shard"] == 5  # the host's MeshCfg
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "0")
    with pytest.raises(ValueError, match="requested 5"):
        tmesh.make_mesh(device="cpu")


def test_collectives_stack_and_sum(tm):
    parts = [torch.full((2, 3), float(s)) for s in range(S)]
    assert tuple(tmesh.all_gather(tm, parts).shape) == (S, 2, 3)
    assert torch.equal(tmesh.psum(tm, parts), torch.full((2, 3), float(sum(range(S)))))


def test_mesh_module_is_one_process():
    """The mesh imports neither jax, nor the JAX package, nor
    torch.distributed: it is one process, as the JAX mesh is."""
    src = (REPO / "distributed_faiss_tpu_torch" / "parallel" / "mesh.py").read_text()
    assert not re.search(r"^\s*(from|import) (jax|distributed_faiss_tpu\b|torch\.distributed)",
                         src, re.M)


# ------------------------------------------------------------- sharded knn


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_knn_matches_jax(jm, tm, metric, masked):
    rng = np.random.default_rng(5)
    per = 64
    x = rng.standard_normal((S * per, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    ntot = np.full(S, per, np.int32)
    ntot[-1] = 40  # the last shard partly filled
    live = np.ones(S * per, bool)
    if masked:
        live[rng.choice(S * per, 100, replace=False)] = False
    jv, ji = jmesh._sharded_knn_jit(
        jnp.asarray(q), _jsharded(jm, x), _jsharded(jm, ntot), jm, 10, metric, 16,
        live=_jsharded(jm, live) if masked else None)
    tv, ti = tmesh.sharded_knn(tm, q, tmesh.shard_rows(tm, x), ntot, 10, metric, chunk=16,
                               live=tmesh.shard_rows(tm, live) if masked else None)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    ok = live & (np.arange(S * per) % per < np.repeat(ntot, per))
    want = np.flatnonzero(ok)[brute_ids(q, x[ok], 10, metric)]
    np.testing.assert_array_equal(ti.numpy(), want)


def test_knn_chunk_is_the_jax_rule():
    for cap in (8, 24, 64, 96, 4096, 65536 * 4):
        assert tmesh._knn_chunk(cap) == jmesh._knn_chunk(cap)


# ------------------------------------------------------------------ kmeans


def test_lloyd_step_matches_jax(jm, tm):
    """One sharded Lloyd step from the same initial centroids."""
    rng = np.random.default_rng(6)
    k, chunk, per, d = 12, 32, 64, 8
    x = rng.standard_normal((S * per, d)).astype(np.float32)
    w = np.ones(S * per, np.float32)
    w[-50:] = 0.0  # padding rows
    cent = x[rng.choice(S * per - 50, k, replace=False)]
    want = jmesh._kmeans_step_jit(_jsharded(jm, x), _jsharded(jm, w), jnp.asarray(cent), jm, k,
                                  chunk)
    xs = [b.reshape(per // chunk, chunk, d) for b in tmesh.shard_rows(tm, x)]
    ws = [b.reshape(per // chunk, chunk) for b in tmesh.shard_rows(tm, w)]
    got = tmesh.kmeans_step(tm, xs, ws, torch.as_tensor(cent), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sharded_kmeans_recovers_blobs(tm):
    rng = np.random.default_rng(7)
    centers = np.array([[0, 0], [12, 12], [-12, 12], [0, -12]], dtype=np.float32)
    x = np.concatenate([c + rng.standard_normal((200, 2)).astype(np.float32) * 0.4
                        for c in centers])
    rng.shuffle(x)
    cent = tmesh.sharded_kmeans(tm, x, 4, iters=15, chunk=128).numpy()
    d = np.linalg.norm(centers[:, None, :] - cent[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 0.5


def test_sharded_kmeans_pads_and_takes_a_tensor(tm):
    """Rows that are no shard multiple, given as a tensor: zero-weight
    padding never pulls a centroid, and the JAX init subsample's rule
    holds (k-means++ up to 16384 centroids)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1001, 4)).astype(np.float32) + 5.0
    cent = tmesh.sharded_kmeans(tm, torch.as_tensor(x), 8, iters=5)
    assert cent.shape == (8, 4) and bool((cent > 2.0).all())


# --------------------------------------------------------- sharded lists


def _lists_pair(jm, tm, nlist, d, min_cap):
    return (jmesh.ShardedPaddedLists(nlist, (d,), np.float32, jm, min_cap=min_cap),
            tmesh.ShardedPaddedLists(nlist, (d,), torch.float32, tm, min_cap=min_cap))


def assert_same_lists(j, t):
    assert (t.cap, t.nlist_local, t.nlist_pad) == (j.cap, j.nlist_local, j.nlist_pad)
    np.testing.assert_array_equal(t.sizes_host, j.sizes_host)
    np.testing.assert_array_equal(torch.cat(t.sizes).numpy(), np.asarray(j.sizes))
    np.testing.assert_array_equal(torch.cat(t.ids).numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(torch.cat(t.data).numpy(), np.asarray(j.data))
    for s in range(S):
        assert t.ids[s].shape == (j.nlist_local, j.cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_lists_fuzz_schedule_matches_jax(jm, tm, seed):
    """The append schedule of tests/test_padded_lists_fuzz.py on both
    packages' sharded lists: the same sizes, ids, rows, capacity and slots
    after every batch, and the same within-list positions returned."""
    rng = np.random.default_rng(seed)
    nlist, d = int(rng.integers(2, 20)), 3
    j, t = _lists_pair(jm, tm, nlist, d, 4)
    next_gid = 0
    for _ in range(12):
        n = int(rng.integers(1, 200))
        li = rng.integers(0, nlist, n)
        rows = rng.standard_normal((n, d)).astype(np.float32)
        gids = np.arange(next_gid, next_gid + n, dtype=np.int64)
        next_gid += n
        np.testing.assert_array_equal(t.append(li, rows, gids), j.append(li, rows, gids))
        assert_same_lists(j, t)
    for l in range(nlist):
        assert t.slot_of(l) == j.slot_of(l)
    assert t.ntotal == j.ntotal == next_gid


def test_sharded_lists_growth_and_mask_cells_match_jax(jm, tm):
    rng = np.random.default_rng(9)
    j, t = _lists_pair(jm, tm, 10, 2, 8)
    for b in range(4):  # hammer one list to force growth
        li = np.zeros(16, np.int64)
        li[::3] = 7
        rows = rng.standard_normal((16, 2)).astype(np.float32)
        gids = np.arange(b * 16, b * 16 + 16, dtype=np.int64)
        j.append(li, rows, gids)
        t.append(li, rows, gids)
    assert t.cap >= 64
    cells = np.array([t.slot_of(0) * t.cap + 3, t.slot_of(7) * t.cap + 1,
                      t.slot_of(9) * t.cap], np.int64)
    j.mask_cells(cells)
    t.mask_cells(cells)
    assert_same_lists(j, t)
    with pytest.raises(IndexError):
        t.mask_cells([t.nlist_pad * t.cap])
    a, p = np.array([0, 7, 7]), np.array([3, 0, 2])
    np.testing.assert_array_equal(tbase.gather_list_rows(t, a, p),
                                  np.asarray(jax.device_get(j.data))[t.slot_of(a), p])


def test_sharded_lists_int32_cell_space_guard(jm, tm):
    with pytest.raises(ValueError, match="int32") as want:
        jmesh.ShardedPaddedLists(2**26, (4,), np.float32, jm, min_cap=64)
    with pytest.raises(ValueError, match="int32") as got:
        tmesh.ShardedPaddedLists(2**26, (4,), torch.float32, tm, min_cap=64)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    lists = tmesh.ShardedPaddedLists(8, (2,), torch.float32, tm, min_cap=8)
    with pytest.raises(ValueError, match="int32"):
        lists._grow(2**28 + 1)
    assert lists.cap == 8
    lists.append(np.zeros(4, np.int64), np.ones((4, 2), np.float32), np.arange(4))
    assert lists.ntotal == 4


# ------------------------------------------------------------ sharded flat


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_sharded_flat_matches_jax(jm, tm, metric):
    """Two adds, a search, deletes (synced and still pending), growth, a
    reconstruct and the snapshot, against the JAX ShardedFlatIndex."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1300, 16)).astype(np.float32)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    j = jmesh.ShardedFlatIndex(16, metric, mesh=jm)
    t = tmesh.ShardedFlatIndex(16, metric, mesh=tm)
    for idx in (j, t):
        idx.add(x[:500])
        idx.add(x[500:900])
    (jd, ji), (td, ti) = j.search(q, 8), t.search(q, 8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ti, brute_ids(q, x[:900], 8, metric))
    dead = np.union1d(ti[:, 0], np.arange(0, 900, 11))
    for idx in (j, t):
        idx.remove_rows(dead)
        idx.add(x[900:])  # grows the capacity past the first sync's
        idx.remove_rows(np.array([950, 1299]))  # still host-pending
    assert t._cap_local == j._cap_local
    (jd, ji), (td, ti) = j.search(q, 8), t.search(q, 8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    assert not np.isin(ti, np.concatenate([dead, [950, 1299]])).any()
    np.testing.assert_array_equal(t.reconstruct_batch(ti[0]), x[ti[0]])
    ts, js = t.state_dict(), j.state_dict()
    assert set(ts) == set(js) and ts["kind"] == "sharded_flat"
    np.testing.assert_array_equal(ts["rows"], np.asarray(js["rows"]))
    assert t.launches == 2


def test_search_loops_blocks_in_one_launch(tm):
    """A batch over several query blocks is one counted launch, and equals
    the per-block searches it merges."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3000, 8)).astype(np.float32)
    q = rng.standard_normal((2100, 8)).astype(np.float32)
    t = tmesh.ShardedFlatIndex(8, "l2", mesh=tm)
    t.add(x)
    d, i = t.search(q, 5)
    assert t.launches == 1
    block = tbase.pick_query_block(65536 * 4)
    assert q.shape[0] > block
    parts = [t.search(q[s:s + block], 5) for s in range(0, q.shape[0], block)]
    np.testing.assert_array_equal(i, np.concatenate([p[1] for p in parts]))
    np.testing.assert_array_equal(d, np.concatenate([p[0] for p in parts]))
    assert t.launches == 1 + len(parts)


def test_sharded_flat_snapshots_cross_packages(jm, tm, monkeypatch):
    """A JAX snapshot restores on the port's host mesh (of another size)
    and serves the JAX ids; the port's restores in the JAX package."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    j = jmesh.ShardedFlatIndex(8, "l2", mesh=jm)
    j.add(x)
    monkeypatch.setenv("DFT_MESH_DEVICES", "3")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    t = tfactory.index_from_state_dict(j.state_dict(), device="cpu")
    assert isinstance(t, tmesh.ShardedFlatIndex) and t.nshards == 3
    np.testing.assert_array_equal(t.search(q, 4)[1], j.search(q, 4)[1])
    from distributed_faiss_tpu.models import factory as jfactory

    back = jfactory.index_from_state_dict(t.state_dict())
    np.testing.assert_array_equal(back.search(q, 4)[1], j.search(q, 4)[1])
