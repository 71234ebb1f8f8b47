"""The mesh's probe-routed search as captured programs (parallel/mesh.py)
against the JAX package's routed entries, on eight virtual shards a side:
the pair bucket and block size are the JAX package's arithmetic; at a
bucket forced small enough to drop pairs, the port's entries return the
JAX entries' (scores, ids, dropped) on the same carried state; padded
query rows own no pair; on the recording backend a routed block is a
program replayed bit for bit as ``programs.eager()`` runs it, a relaunch
at a grown bucket is a new program, and a steady search captures
nothing. Tolerances: ids exactly on tie-free data, scores within 1e-3."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu_torch.ops import distance as tdistance
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils import compilecheck, programs

S, K = 8, 10


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(S)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(S, device="cpu", virtual=True)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs several workers on a few
    cores, where many threads each slow these tests down by an order of
    magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tally():
    compilecheck.reset()
    compilecheck.install()
    yield
    compilecheck.uninstall()
    compilecheck.reset()


def make_data(seed, n, d, nq, nclusters=16):
    """Clustered rows (tie-free scores) and queries near them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nclusters, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nclusters, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, nclusters, nq)] + rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def carry(jidx, tidx, x):
    """The JAX model's trained state into the port's model, the same rows
    added by the port."""
    tidx.centroids = torch.as_tensor(np.array(jidx.centroids))
    if hasattr(jidx, "codebooks"):
        tidx.codebooks = torch.as_tensor(np.array(jidx.codebooks))
    tidx.lists = tidx._make_lists()
    tidx.add(x)
    tidx.set_nprobe(jidx.nprobe)
    return tidx


def skewed(seed, n, nq, d=16, nlist=64):
    """Every row in list 0; the centroids of shard 0's lists (l % S == 0)
    near it and every other centroid far away, so each query's nprobe <= 8
    nearest lists are all shard 0's: one shard owns every pair."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32) * 5.0
    cents = base + 60.0 * rng.standard_normal((nlist, d)).astype(np.float32)
    own = np.arange(0, nlist, S)
    cents[own] = base + 3.0 * rng.standard_normal((own.size, d)).astype(np.float32)
    cents[0] = base
    x = base + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    q = base + 0.5 * rng.standard_normal((nq, d)).astype(np.float32)
    return cents, x, q


def brute(q, x, k):
    """Exact (fp64) top-k+1 distances and top-k ids."""
    dist = ((q[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1)
    return np.take_along_axis(dist, order[:, :k + 1], axis=1), order[:, :k]


def tie_free(scores, rel=1e-5):
    """Rows whose sorted finite scores are all more than ``rel`` of the
    row's scale apart (fp32 rounding moves a score by less), so their
    top-k ids are defined."""
    s = np.where(np.isfinite(scores), scores, np.nan)
    with np.errstate(invalid="ignore"):
        scale = np.nan_to_num(np.nanmax(np.abs(s), axis=1), nan=1.0)
        gaps = np.abs(np.diff(s, axis=1))
        return np.all(np.isnan(gaps) | (gaps > rel * scale[:, None]), axis=1)


def assert_ids_on_tie_free(got_ids, want_ids, scores, min_share=0.75):
    ok = tie_free(scores)
    assert ok.mean() >= min_share, f"only {ok.mean():.3f} of the rows are tie-free"
    np.testing.assert_array_equal(got_ids[ok], want_ids[ok])


# ------------------------------------------------------------------ sizing


GROUPS = (8, 64, 512, 1024)  # the models' pair groups: 8 .. 512 (PQ), .. 1024 (flat)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_pair_bucket_and_block_size_equal_jax(shards):
    for nprobe in (1, 8, 32, 64):
        for slack in (2.0, 4.0, 8.0):
            for group in GROUPS:
                for nq in range(1, 4097):
                    assert tmesh.routed_pair_bucket(nq, nprobe, shards, group, slack) == \
                        jmesh.routed_pair_bucket(nq, nprobe, shards, group, slack)
                for local_k in (10, 80, 100, 1000):
                    assert tmesh._routed_block_size(nprobe, shards, group, slack, local_k) == \
                        jmesh._routed_block_size(nprobe, shards, group, slack, local_k)


# ---------------------------------------------------- entries against JAX


ENTRY_CASES = [
    ("flat", dict(metric="l2")),
    ("flat", dict(metric="dot")),
    ("flat", dict(metric="l2", refine_k_factor=4, scan_bf16=True)),
    ("pq", dict(metric="l2", m=8, refine_k_factor=8)),   # K3 over the lists
    ("pq", dict(metric="dot", m=4, refine_k_factor=8)),  # K2 over gathered codes
    ("pq", dict(metric="l2", m=8)),
]


@pytest.fixture(scope="module")
def entry_data():
    return make_data(31, 1500, 32, 60)


def _models(jm, tm, x, kind, kw):
    knobs = dict(kw)
    metric = knobs.pop("metric")
    if kind == "flat":
        j = jmesh.ShardedIVFFlatIndex(32, 16, metric, mesh=jm, kmeans_iters=4, **knobs)
        make_t = lambda: tmesh.ShardedIVFFlatIndex(32, 16, metric, mesh=tm, **knobs)
    else:
        j = jmesh.ShardedIVFPQIndex(32, 16, metric=metric, mesh=jm, kmeans_iters=4, pq_iters=4,
                                    **knobs)
        make_t = lambda: tmesh.ShardedIVFPQIndex(32, 16, metric=metric, mesh=tm, **knobs)
    j.train(x)
    j.add(x)
    j.set_nprobe(4)
    return j, carry(j, make_t(), x)


@pytest.mark.parametrize("kind,kw", ENTRY_CASES,
                         ids=["flat-l2", "flat-dot", "flat-refine-bf16", "pq-K3-refine",
                              "pq-K2-refine", "pq-K3"])
def test_routed_entries_equal_jax_at_a_dropping_bucket(jm, tm, entry_data, kind, kw):
    """A 60-row block padded to 64, nprobe 4 over 16 lists: about 30 owned
    pairs a shard against a bucket of 16, so pairs drop; both packages keep
    the first owned pairs in query order and drop the same ones."""
    x, q = entry_data
    j, t = _models(jm, tm, x, kind, kw)
    block = tdistance.pad_rows(q, 64)
    n, nprobe, group, bucket = q.shape[0], 4, 8, 16
    refining = bool(kw.get("refine_k_factor"))
    adc_k = K * kw["refine_k_factor"] if refining else 0
    jq, jn = jmesh._replicated(jm, block), jmesh._replicated(jm, np.int32(n))
    tq = torch.as_tensor(block)
    if kind == "flat":
        jv, ji, jd = jmesh._sharded_ivf_flat_search_routed(
            jmesh._replicated(jm, j.centroids), j.lists.data, j.lists.ids, j.lists.sizes, jq, jn,
            jm, K, nprobe, bucket, group, j.metric, list_norms=j._scan_norms(),
            scan_bf16=j.scan_bf16, adc_k=adc_k, raw_data=j.raw_lists.data if refining else None)
        tv, ti, td = tmesh._sharded_ivf_flat_search_routed(
            tm, t.centroids, t.lists, tq, n, K, nprobe, bucket, group, t.metric,
            list_norms=t._scan_norms(), scan_bf16=t.scan_bf16, adc_k=adc_k,
            raw_data=tmesh._refine_data(t))
    else:
        jv, ji, jd = jmesh._sharded_ivf_pq_search_routed(
            jmesh._replicated(jm, j.centroids), jmesh._replicated(jm, j.codebooks), j.lists.data,
            j.lists.ids, j.lists.sizes, jq, jn, jm, K, nprobe, bucket, group, j.metric,
            adc_k=adc_k, raw_data=j.raw_lists.data if refining else None)
        tv, ti, td = tmesh._sharded_ivf_pq_search_routed(
            tm, t.centroids, t.codebooks, t.lists, tq, n, K, nprobe, bucket, group, t.metric,
            lut_bf16=t.lut_bf16, adc_k=adc_k, raw_data=tmesh._refine_data(t))
    assert int(td) == int(jd) > 0
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert_ids_on_tie_free(ti.numpy(), ji, jv)
    np.testing.assert_array_equal(np.isinf(tv.numpy()), np.isinf(jv))
    f = np.isfinite(jv)
    np.testing.assert_allclose(tv.numpy()[f], jv[f], rtol=1e-3, atol=1e-3)
    assert (ji[n:] == -1).all()  # padded rows own no pair: nothing comes back for them


def test_padded_rows_own_no_pair():
    """Probes of the padded rows all fall on shard 0; only the real rows'
    pairs are owned, compacted in query order, and dropped past the
    bucket."""
    nq, nq_real, nprobe, bucket, group, cap = 8, 3, 2, 8, 4, 16
    probes = torch.zeros((nq, nprobe), dtype=torch.int32)  # list 0: shard 0's
    seen = []

    def score(qi, li, slot, valid):
        seen.append(qi[valid].tolist())
        return torch.where(valid[:, None], -qi[:, None].float() - torch.arange(cap) * 0.01,
                           torch.full((qi.shape[0], cap), tdistance.NEG_INF))

    vals, cells, dropped = tmesh._routed_pairs_local(
        probes, torch.tensor([nq_real]), 0, S, bucket, group, K, cap, score)
    assert int(dropped) == 0
    assert sum(seen, []) == [0, 0, 1, 1, 2, 2]
    assert torch.isneginf(vals[nq_real:]).all() and (cells[nq_real:] == -1).all()
    assert torch.isfinite(vals[:nq_real]).all()
    # the same real rows with a smaller bucket: the first owned pairs stay
    seen.clear()
    _, _, dropped = tmesh._routed_pairs_local(probes, torch.tensor([nq_real]), 0, S, 4, group,
                                              K, cap, score)
    assert int(dropped) == 2 and sum(seen, []) == [0, 0, 1, 1]


# ------------------------------------------------------------- programs


def _routed_flat(tm, x, nlist=16, nprobe=4, **kw):
    t = tmesh.ShardedIVFFlatIndex(x.shape[1], nlist, "l2", mesh=tm, kmeans_iters=4,
                                  probe_routing=True, **kw)
    t.train(x)
    t.add(x)
    t.set_nprobe(nprobe)
    return t


def _routed_pq(tm, x, m):
    t = tmesh.ShardedIVFPQIndex(x.shape[1], 16, m=m, mesh=tm, kmeans_iters=4, pq_iters=4,
                                probe_routing=True, refine_k_factor=4)
    t.train(x)
    t.add(x)
    t.set_nprobe(4)
    return t


@pytest.mark.parametrize("make", ["flat", "flat-refine", "pq-K3", "pq-K2"])
def test_routed_replays_equal_eager_bit_for_bit(tm, entry_data, make):
    x, q = entry_data
    t = {"flat": lambda: _routed_flat(tm, x),
         "flat-refine": lambda: _routed_flat(tm, x, refine_k_factor=4),
         "pq-K3": lambda: _routed_pq(tm, x, 8),
         "pq-K2": lambda: _routed_pq(tm, x, 4)}[make]()
    with programs.eager():
        want = t.search(q, K)
    assert t.programs.captures == 0
    t.programs.backend = programs.RecordingGraphs()
    for _ in range(2):
        got = t.search(q, K)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (t.programs.captures, t.programs.replays) == (1, 2)


def test_relaunch_is_a_new_program_and_a_steady_search_captures_nothing(tm, tally):
    """One shard owns every pair: the first search drops at the starting
    bucket and relaunches twice, each at a doubled bucket (a program
    each); the grown slack stays on the index, so the next search runs
    the last program alone, captured already."""
    cents, x, q = skewed(41, 1024, 500)
    t = tmesh.ShardedIVFFlatIndex(16, 64, "l2", mesh=tm, probe_routing=True)
    t.centroids = torch.as_tensor(cents)
    t.lists = t._make_lists()
    t.add(x)
    t.set_nprobe(8)
    t.programs.backend = programs.RecordingGraphs()
    got = t.search(q, K)
    dist, ids = brute(q, x, K)
    assert_ids_on_tie_free(got[1], ids, dist)
    assert (t.launches, t._routed_slack) == (3, 8.0)
    assert (t.programs.captures, t.programs.replays) == (3, 3)
    assert compilecheck.by_entry() == {"sharded_ivf_flat.routed": 3}
    snap = compilecheck.snapshot()
    again = t.search(q, K)
    np.testing.assert_array_equal(again[1], got[1])
    assert compilecheck.new_since(snap) == {}
    assert (t.launches, t.programs.captures, t.programs.replays) == (4, 3, 4)
    assert compilecheck.unregistered() == []
