"""The centroid tiers of 65,536 lists and up in the port, against the JAX
package (the port's counterpart of tests/test_mesh_scale.py).

``engine.infer_n_centroids`` gives 65,536 lists to every shard of 1e6 to
1e7 rows, and the repo's ingest configuration (``scripts/idx_cfg.json``,
``IVF{centroids},SQ8`` at 65,536 centroids) asks for that tier outright.
The list count is never shrunk here; the geometry is: d = 8 and just
over 65,536 rows (73,728), so one Lloyd step and one add take seconds on
the CPU. The JAX side runs on the suite's 8 virtual CPU devices, the
port's mesh on ``make_mesh(8, device="cpu", virtual=True)``.

The 262,144-list tier (``infer_n_centroids`` of 1e7 rows and up, the
cfg of chip_smoke.py's phase m): the cfg read and built alike, the
inferred count, and a JAX index at 262,144 lists (seeds only, over just
over 262,144 rows of d = 8, 16,384 of them added) carried into the port,
served and grown by appends as the JAX package grows it.

Tolerances: ids exactly on the tie-free queries (their top-11 distances
all apart by more than 1e-5 of the row's scale), distances within rtol /
atol 1e-3 (what the JAX package holds its own kernel to); centroids after
a Lloyd step within 1e-5 (the same fp32 sums in another order).

The ``slow`` cases carry the JAX tests' sizes and marks over: sharded
k-means at 65,536, 262,144 and 1,048,576 centroids with the JAX tests'
invariants, and a sharded IVF search at 65,536 lists.
"""

import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_faiss_tpu import engine as jengine
from distributed_faiss_tpu.models import factory as jfactory
from distributed_faiss_tpu.models.ivf import IVFFlatIndex as JIVF
from distributed_faiss_tpu.parallel import mesh as jmesh
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu_torch import engine as tengine
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.models import factory as tfactory
from distributed_faiss_tpu_torch.models.flat import FlatIndex as TFlat
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex as TIVF
from distributed_faiss_tpu_torch.ops import kmeans as tkmeans
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils.config import IndexCfg

REPO = pathlib.Path(__file__).resolve().parents[1]
IDX_CFG = REPO / "scripts" / "idx_cfg.json"
K_TIER = 65_536
N_TIER, D_TIER = K_TIER + 8_192, 8
S = 8
TIE_REL = 1e-5


@pytest.fixture(scope="module")
def tier_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_TIER, D_TIER)).astype(np.float32)
    # near-duplicate queries: each row's own list is probed
    q = x[:64] + 0.01 * rng.standard_normal((64, D_TIER)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_tier_index(tier_data):
    """The JAX package's IVF-SQ8 index at the tier: one Lloyd step (the
    random-seed branch), every row added, nprobe 64."""
    x, _q = tier_data
    ref = JIVF(D_TIER, K_TIER, "l2", codec="sq8", kmeans_iters=1)
    ref.train(x)
    ref.add(x)
    ref.set_nprobe(64)
    return ref


@pytest.fixture(scope="module")
def jm():
    return jmesh.make_mesh(S)


@pytest.fixture(scope="module")
def tm():
    return tmesh.make_mesh(S, device="cpu", virtual=True)


def _jsharded(jm, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jm, P("shard", *[None] * (x.ndim - 1))))


def tie_free(D: np.ndarray) -> np.ndarray:
    """Rows of an (nq, 11) ascending distance block whose distances are all
    apart: the top-10 ids are defined there."""
    scale = np.maximum(np.abs(D).max(axis=1), 1e-30)
    return np.isfinite(D).all(axis=1) & (np.diff(D, axis=1) > TIE_REL * scale[:, None]).all(1)


def assert_same_top10(port, ref, min_tie_free=0.9):
    (dp, ip), (dr, ir) = port, ref
    ok = tie_free(dr) & tie_free(dp)
    assert ok.mean() >= min_tie_free, ok.mean()
    np.testing.assert_array_equal(ip[ok, :10], ir[ok, :10])
    np.testing.assert_allclose(dp[ok, :10], dr[ok, :10], rtol=1e-3, atol=1e-3)


def bbox_invariants(cent: np.ndarray, x: np.ndarray, k: int, min_median: float):
    """The JAX tests' checks of a seeded-from-data k-means: finite, inside
    the data's bounding box, and not collapsed onto one point."""
    assert cent.shape == (k, x.shape[1])
    assert np.isfinite(cent).all()
    lo, hi = x.min(0) - 1e-3, x.max(0) + 1e-3
    assert (cent >= lo).all() and (cent <= hi).all()
    sample = cent[np.random.default_rng(1).permutation(k)[:4096]]
    assert np.median(np.linalg.norm(sample[:-1] - sample[1:], axis=1)) > min_median


# ----------------------------------------------------------------- the tiers


@pytest.mark.parametrize("rows", [0, 1, 4, 100, 999_999, 1_000_000, 9_999_999, 10_000_000,
                                  99_999_999, 100_000_000, 4_000_000_000])
def test_infer_n_centroids_matches_jax_at_every_threshold(rows):
    assert tengine.infer_n_centroids(rows) == jengine.infer_n_centroids(rows)


def test_the_ingest_cfg_reads_alike_and_builds_ivf_sq8_at_the_tier():
    """scripts/idx_cfg.json: the same fields in both packages; the engine
    keeps its 65,536 centroids (infer_centroids false) and the factory
    builds IVF-Flat over sq8 lists, no refine, 10 Lloyd iterations."""
    raw = json.loads(IDX_CFG.read_text())
    t, j = IndexCfg.from_json(str(IDX_CFG)), JCfg.from_json(str(IDX_CFG))
    assert vars(t) == vars(j)
    assert (t.index_builder_type, t.faiss_factory, t.infer_centroids) == (
        None, "IVF{centroids},SQ8", False)
    assert (t.dim, t.centroids, t.train_num, t.nprobe, t.buffer_bsz) == (
        raw["dim"], K_TIER, 1_000_000, 32, 50_000)
    eng = tengine.Index(t, device="cpu")
    try:
        model = eng._init_index(3_000_000)  # 65,536 by the tiers too
    finally:
        eng.retire()
    ref = jfactory.build_index(JCfg.from_json(str(IDX_CFG)))
    assert isinstance(model, TIVF)
    assert (model.nlist, model.codec, model.refine_k_factor, model.kmeans_iters) == (
        ref.nlist, ref.codec, ref.refine_k_factor, ref.kmeans_iters) == (K_TIER, "sq8", 0, 10)
    assert model.lists is None  # nothing allocated before train


def test_ivf_sq8_at_65536_lists_serves_the_jax_ids(tier_data, jax_tier_index):
    """The JAX package's tier index carried over: the same top-10 ids and
    distances at nprobe 64, and back again."""
    x, q = tier_data
    ref = jax_tier_index
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(port, TIVF)
    assert (port.nlist, port.codec, port.ntotal, port.nprobe) == (K_TIER, "sq8", N_TIER, 64)
    assert port.lists.cap == 64 and port.lists.data.shape == (K_TIER, 64, D_TIER)
    np.testing.assert_array_equal(port.lists.sizes_host, ref.lists.sizes_host)
    want = ref.search(q, 11)
    assert_same_top10(port.search(q, 11), want)
    # the nearest row of a near-duplicate query is the row itself
    assert (want[1][:, 0] == np.arange(q.shape[0])).mean() >= 0.9
    back = jfactory.index_from_state_dict(interop.to_state_dict(port))
    assert_same_top10(back.search(q, 11), want)


def test_search_plan_at_the_tier_is_the_jax_plan(jax_tier_index):
    """Query block and probe group size at the tier, for the CPU shape and
    the card's d = 768 at caps 64-512: the port's ``pick_query_block`` and
    ``probe_group_size`` are the JAX package's. The search's query block
    is the JAX package's; its group is the JAX package's for the (nb, g,
    cap) score path (``_score_plan``: the mesh's, and k past 256), and every probe
    with K1's in-kernel select (k and the refine's k * 8 up to 256), whose
    group holds (nb, g, k) candidates of 8 bytes."""
    from distributed_faiss_tpu.models import base as jbase
    from distributed_faiss_tpu.models import ivf as jivf
    from distributed_faiss_tpu_torch.models import base as tbase
    from distributed_faiss_tpu_torch.models import ivf as tivf

    for cap, d in [(64, D_TIER), (64, 768), (128, 768), (256, 768), (512, 768)]:
        block = tbase.pick_query_block(cap * d * 4)
        assert block == jbase.pick_query_block(cap * d * 4)
        for nprobe in (1, 32, 64):
            nbytes = block * cap * d * 4
            assert tivf.probe_group_size(nprobe, nbytes) == jivf.probe_group_size(nprobe,
                                                                                  nbytes)
    port = interop.from_jax_state(jax_tier_index.state_dict(), device="cpu")
    port.set_nprobe(32)
    cap = port.lists.cap
    block = jbase.pick_query_block(cap * D_TIER * 4)
    jax_plan = (32, block, jivf.probe_group_size(32, block * cap * D_TIER * 4))
    assert port._score_plan() == port._search_plan(300) == jax_plan
    for k in (1, 10, 80, 256):
        assert port._search_plan(k) == (32, block, tivf.probe_group_size(
            32, block * k * 8)) == (32, block, 32)


def test_kmeans_random_seeding_branch_at_the_tier():
    """k > 16,384: uniform seeds without replacement (no k-means++), and
    the auto chunk keeps a (chunk, k) fp32 block at 512 MiB."""
    assert not tkmeans._use_pp(K_TIER, "auto") and tkmeans._use_pp(16_384, "auto")
    chunk = tkmeans.auto_chunk(K_TIER)
    assert chunk == 2048 and chunk * K_TIER * 4 == 512 * 1024 * 1024
    for k in (K_TIER, 262_144, 1_048_576):
        assert tkmeans.auto_chunk(k) * k * 4 <= 2 ** 31
    x = torch.arange(300 * 2, dtype=torch.float32).reshape(300, 2)
    gen = torch.Generator()
    gen.manual_seed(0)
    seeds = tkmeans._init_random(x, 300, 200, gen)
    assert len({tuple(r) for r in seeds.tolist()}) == 200  # distinct data rows


@pytest.mark.parametrize("iters", [0, 1])
def test_sharded_kmeans_at_the_tier_matches_jax(jm, tm, iters):
    """The random branch draws the JAX package's seeds (numpy, from the
    same seed), so the seeds are equal; one sharded Lloyd step keeps them
    within 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N_TIER, D_TIER)).astype(np.float32)
    want = np.asarray(jmesh.sharded_kmeans(jm, x, K_TIER, iters=iters))
    got = tmesh.sharded_kmeans(tm, x, K_TIER, iters=iters).numpy()
    if iters == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    bbox_invariants(got, x, K_TIER, 1e-3)


def test_int32_guard_refuses_a_million_lists_before_any_allocation(jm, tm, monkeypatch):
    """1,048,576 lists at cap 4096 overflow int32 cell addresses: refused
    with the JAX package's message, before a byte is allocated."""
    with pytest.raises(ValueError, match="int32") as want:
        jmesh.ShardedPaddedLists(1_048_576, (2,), np.float32, jm, min_cap=4096)
    allocated = []

    def refuse(*a, **kw):
        allocated.append(a)
        raise AssertionError("allocated before the int32 guard")

    monkeypatch.setattr(torch, "zeros", refuse)
    monkeypatch.setattr(torch, "full", refuse)
    with pytest.raises(ValueError, match="int32") as got:
        tmesh.ShardedPaddedLists(1_048_576, (2,), torch.float32, tm, min_cap=4096)
    assert not allocated
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


# ------------------------------------------------- the 262,144-list tier

K_BIG = 262_144
N_BIG, N_BIG_ADD = K_BIG + 8_192, 16_384


def _big_cfg(tmp_path) -> pathlib.Path:
    """scripts/idx_cfg.json with one field changed, ``centroids`` 262,144
    (``infer_n_centroids`` of a 1e7-row shard), as chip_smoke.py's phase
    m writes it; the repo's file is read, never written."""
    raw = json.loads(IDX_CFG.read_text())
    raw["centroids"] = K_BIG
    path = tmp_path / "idx_cfg_262144.json"
    path.write_text(json.dumps(raw))
    return path


def _init_both(tcfg, jcfg, rows: int):
    """The model each package's engine builds for a shard of ``rows``."""
    eng, jeng = tengine.Index(tcfg, device="cpu"), jengine.Index(jcfg)
    try:
        return eng._init_index(rows), jeng._init_index(rows)
    finally:
        eng.retire()
        jeng.retire()


@pytest.fixture(scope="module")
def big_tier():
    """A JAX IVF-SQ8 index at 262,144 lists: seeds only (no Lloyd step)
    over N_BIG rows of d = 8, then the first N_BIG_ADD rows added, nprobe
    512; with near-duplicate queries of the added rows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N_BIG, D_TIER)).astype(np.float32)
    ref = JIVF(D_TIER, K_BIG, "l2", codec="sq8", kmeans_iters=0)
    ref.train(x)
    ref.add(x[:N_BIG_ADD])
    ref.set_nprobe(512)  # a list holds 1/16 row on average: 32 rows probed
    q = x[:64] + 0.01 * rng.standard_normal((64, D_TIER)).astype(np.float32)
    return ref, q


def test_the_phase_m_cfg_reads_alike_and_builds_ivf_sq8_at_262144(tmp_path):
    """The ingest cfg at 262,144 centroids: the same fields in both
    packages, and both engines build IVF-Flat over sq8 at 262,144 lists,
    no refine, 10 Lloyd iterations, nothing allocated before train."""
    path = _big_cfg(tmp_path)
    t, j = IndexCfg.from_json(str(path)), JCfg.from_json(str(path))
    assert vars(t) == vars(j)
    assert (t.faiss_factory, t.centroids, t.infer_centroids, t.train_num, t.nprobe,
            t.buffer_bsz) == ("IVF{centroids},SQ8", K_BIG, False, 1_000_000, 32, 50_000)
    model, ref = _init_both(t, j, 10_000_000)
    assert isinstance(model, TIVF) and isinstance(ref, JIVF)
    assert (model.nlist, model.codec, model.refine_k_factor, model.kmeans_iters) == (
        ref.nlist, ref.codec, ref.refine_k_factor, ref.kmeans_iters) == (K_BIG, "sq8", 0, 10)
    assert model.lists is None and ref.lists is None


def test_inferred_centroids_at_ten_million_rows_are_262144_in_both():
    """``infer_centroids`` true: a 10,000,000-row shard gets 262,144 lists
    from both engines, whatever the cfg's own count."""
    t, j = IndexCfg.from_json(str(IDX_CFG)), JCfg.from_json(str(IDX_CFG))
    t.infer_centroids = j.infer_centroids = True
    model, ref = _init_both(t, j, 10_000_000)
    assert model.nlist == ref.nlist == t.centroids == j.centroids == K_BIG


def test_ivf_sq8_at_262144_lists_serves_the_jax_ids(big_tier):
    """The JAX package's 262,144-list index carried over: the same top-10
    ids and distances at nprobe 512, the same sizes, and the JAX plan."""
    from distributed_faiss_tpu.models import base as jbase
    from distributed_faiss_tpu.models import ivf as jivf

    ref, q = big_tier
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert (port.nlist, port.codec, port.ntotal, port.nprobe) == (K_BIG, "sq8", N_BIG_ADD, 512)
    assert port.lists.cap == ref.lists.cap == 64
    np.testing.assert_array_equal(port.lists.sizes_host, ref.lists.sizes_host)
    want = ref.search(q, 11)
    assert_same_top10(port.search(q, 11), want)
    assert (want[1][:, 0] == np.arange(q.shape[0])).mean() >= 0.9
    port.set_nprobe(32)
    block = jbase.pick_query_block(64 * D_TIER * 4)
    assert port._score_plan() == (32, block, jivf.probe_group_size(32, block * 64 * D_TIER * 4))
    assert port._search_plan(11) == (32, block, 32)  # K1's select: one group


def test_appends_at_262144_lists_grow_the_lists_as_jax_does(big_tier, monkeypatch):
    """Two batches that feed one list near-duplicates of its centroid grow
    the padded layout 64 -> 128 -> 256 (``PaddedLists._grow`` once each,
    copying the old planes in pieces of a few thousand lists);
    after each batch the cap, the sizes, the ids plane and the data equal the
    JAX package's, and the stored norms within 1e-6, appending the same
    rows to a copy of the same index."""
    from distributed_faiss_tpu_torch.models import base as tbase

    ref0, _q = big_tier
    ref = jfactory.index_from_state_dict(ref0.state_dict())
    port = interop.from_jax_state(ref0.state_dict(), device="cpu")
    # the old planes copied in a few dozen pieces of lists, not one
    monkeypatch.setattr(tbase, "GROW_CHUNK_BYTES", 4096 * 64 * (D_TIER + 4))
    rng = np.random.default_rng(4)
    sizes = np.asarray(ref.lists.sizes_host)
    c = int(np.argmax(sizes))
    cent = np.asarray(ref.centroids)[c]
    caps = []
    # batches of one size: the JAX package compiles one assignment
    for n_dup, n_other in ((100, 0), (60, 40)):
        dups = cent + 1e-4 * rng.standard_normal((n_dup, D_TIER)).astype(np.float32)
        other = rng.standard_normal((n_other, D_TIER)).astype(np.float32)
        batch = np.concatenate([dups, other])
        ref.add(batch)
        port.add(batch)
        caps.append(port.lists.cap)
        assert port.lists.cap == ref.lists.cap
        assert port.ntotal == ref.ntotal
        np.testing.assert_array_equal(port.lists.sizes_host, ref.lists.sizes_host)
        # whole planes of up to 537 MB: counted mismatches, not a diff
        for plane in ("ids", "data"):
            got, want = getattr(port.lists, plane).numpy(), np.asarray(getattr(ref.lists, plane))
            assert got.shape == want.shape and (got != want).sum() == 0, plane
        # the same fp32 squares summed in another order
        got, want = port.norm_lists.data.numpy(), np.asarray(ref.norm_lists.data)
        assert (np.abs(got - want) > 1e-6 * np.abs(want)).sum() == 0
    assert caps == [128, 256]
    assert port.lists.sizes_host[c] >= sizes[c] + 160


def test_a_grow_that_cannot_allocate_leaves_the_lists_as_they_were(big_tier, monkeypatch):
    """``PaddedLists._grow`` whose doubled planes cannot be made (the card
    out of memory) raises and leaves the cap, sizes, ids and data as they
    were, and the index serves the JAX ids; the next grow succeeds."""
    ref, q = big_tier
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    lists = port.lists
    sizes, ids, data = lists.sizes_host.copy(), lists.ids.clone(), lists.data.clone()

    def out_of_memory(*a, **k):
        raise RuntimeError("CUDA out of memory")

    with monkeypatch.context() as m:
        m.setattr(torch, "full", out_of_memory)  # after the data plane is made
        with pytest.raises(RuntimeError, match="out of memory"):
            lists._grow(128)
    assert lists.cap == 64
    np.testing.assert_array_equal(lists.sizes_host, sizes)
    assert torch.equal(lists.ids, ids) and torch.equal(lists.data, data)
    assert_same_top10(port.search(q, 11), ref.search(q, 11))
    lists._grow(128)
    assert lists.cap == 128
    assert torch.equal(lists.ids[:, :64], ids) and torch.equal(lists.data[:, :64], data)
    assert (lists.ids[:, 64:] == -1).all() and (lists.data[:, 64:] == 0).all()


def test_a_grow_waits_on_the_host_only_where_the_card_lacks_room(monkeypatch):
    """The old planes stay where they are on the CPU; on a card they wait on
    the host only when the driver's free memory cannot hold the doubled
    planes and GROW_HEADROOM_BYTES beside them. The tier's step from cap
    128 to 256 (51.8 GB) fits an 80 GB card beside the 25.9 GB of cap-128
    planes alone, not with 10 GB more in use; a grow of the ivfsq cell's
    1024 lists always fits."""
    from distributed_faiss_tpu_torch.models import base as tbase

    lists = tbase.PaddedLists(4, (3,), torch.uint8, "cpu")
    assert lists._grow_waits_on(1 << 50) == torch.device("cpu")
    lists.device = torch.device("cuda")
    card, gb = 85_017_493_504, 10**9
    tier_256 = K_BIG * 256 * (768 + 4)
    for free, new_bytes, want in ((card - 27 * gb, tier_256, "cuda"),
                                  (card - 37 * gb, tier_256, "cpu"),
                                  (card - 37 * gb, 1024 * 1024 * (128 + 4), "cuda"),
                                  (tier_256 + tbase.GROW_HEADROOM_BYTES - 1, tier_256, "cpu"),
                                  (tier_256 + tbase.GROW_HEADROOM_BYTES, tier_256, "cuda")):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, card))
        assert lists._grow_waits_on(new_bytes).type == want, (free, new_bytes)


# ------------------------------------------------- load_data at the tier


def _serve(tmp_path):
    from distributed_faiss_tpu_torch.parallel.server import IndexServer

    srv = IndexServer(0, str(tmp_path / "store"), device="cpu")
    port = srv.bind(0)
    threading.Thread(target=srv.start_blocking, name="test-tier-server", daemon=True).start()
    disc = tmp_path / "discovery.txt"
    disc.write_text(f"1\nlocalhost,{port}\n")
    return srv, str(disc)


def test_load_data_with_the_ingest_cfg_serves_the_tier(tier_data, tmp_path, monkeypatch):
    """The port's scripts/load_data.py with ``--cfg scripts/idx_cfg.json``
    into a port server: a 73,728 x 8 fp16 memmap in 50,000-row batches,
    training on every row at ``sync_train`` (train_num 1,000,000 is past
    the rows), the 65,536-list sq8 model, the smoke search and the save.
    Its served ids are the JAX package's over the same state, and a save
    -> drop -> load serves them again. One Lloyd step instead of the
    config's ten keeps the CPU run in seconds."""
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.scripts import load_data

    monkeypatch.setattr(tfactory, "_kmeans_iters", lambda cfg: 1)
    x, q = tier_data
    path = tmp_path / "rows.mmap"
    mm = np.memmap(path, dtype=np.float16, mode="w+", shape=x.shape)
    mm[:] = x.astype(np.float16)
    mm.flush()
    srv, disc = _serve(tmp_path)
    client = None
    try:
        assert load_data.main(["--data", str(path), "--dtype", "fp16", "--dim", str(D_TIER),
                               "--bs", "50000", "--discovery", disc, "--index-id", "tier",
                               "--cfg", str(IDX_CFG), "--device", "cpu"]) == 0
        eng = srv.indexes["tier"]
        model = eng.model
        assert isinstance(model, TIVF)
        assert (model.nlist, model.codec, model.ntotal, model.nprobe) == (
            K_TIER, "sq8", N_TIER, 32)
        assert eng.cfg.centroids == K_TIER and eng.cfg.dim == D_TIER
        assert eng.current_generation() >= 1
        client = IndexClient(disc, cfg_path=str(IDX_CFG))
        assert client.get_ntotal("tier") == N_TIER
        D, meta = client.search(q, 11, "tier")
        ids = np.array([[-1 if m is None else m for m in row] for row in meta])
        ref = jfactory.index_from_state_dict(interop.to_state_dict(model))
        want = ref.search(q, 11)
        assert_same_top10((D, ids), want)
        client.drop_index("tier")
        assert client.load_index("tier")
        client.set_nprobe("tier", 32)
        D2, meta2 = client.search(q, 11, "tier")
        assert meta2 == meta
        np.testing.assert_array_equal(D2, D)
    finally:
        if client is not None:
            client.close()
        srv.stop()


# ------------------------------------------- the JAX tests' slow tiers


@pytest.mark.slow
def test_sharded_kmeans_65536_tier(tm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_TIER, D_TIER)).astype(np.float32)
    cent = tmesh.sharded_kmeans(tm, x, K_TIER, iters=1).numpy()
    bbox_invariants(cent, x, K_TIER, 1e-3)


@pytest.mark.slow
def test_sharded_ivf_search_at_65536_lists(tm):
    """Sharded IVF-Flat at the tier (random seeds, one Lloyd step, the
    chunked coarse assignment, the probe scan and the shards' merge):
    the unsharded index's ids on the same centroids, and the exact scan's
    nearest row."""
    from distributed_faiss_tpu_torch.parallel.mesh import ShardedIVFFlatIndex

    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_TIER, D_TIER)).astype(np.float32)
    q = x[:8] + 0.01 * rng.standard_normal((8, D_TIER)).astype(np.float32)
    idx = ShardedIVFFlatIndex(D_TIER, K_TIER, "l2", mesh=tm, kmeans_iters=1, device="cpu")
    idx.train(x)
    idx.add(x)
    assert idx.ntotal == N_TIER
    idx.set_nprobe(64)
    got = idx.search(q, 11)
    one = TIVF(D_TIER, K_TIER, "l2", device="cpu")
    one.centroids = idx.centroids.clone()
    one.lists = one._make_lists()
    one.add(x)
    one.set_nprobe(64)
    assert_same_top10(got, one.search(q, 11))
    exact = TFlat(D_TIER, "l2", device="cpu")
    exact.add(x)
    _, gt = exact.search(q, 10)
    overlap = np.mean([len(set(got[1][i, :10]) & set(gt[i])) / 10 for i in range(len(q))])
    assert overlap >= 0.5, overlap
    assert all(gt[i][0] in got[1][i] for i in range(len(q)))


@pytest.mark.slow
@pytest.mark.scale
def test_sharded_kmeans_262144_tier(tm):
    k = 262_144
    rng = np.random.default_rng(0)
    x = rng.standard_normal((k + 4_096, 2)).astype(np.float32)
    cent = tmesh.sharded_kmeans(tm, x, k, iters=1).numpy()
    bbox_invariants(cent, x, k, 1e-4)


@pytest.mark.slow
@pytest.mark.scale
def test_sharded_kmeans_and_routed_search_1048576_tier(jm, tm):
    """The million-list tier: the int32 guard, the seeds (equal to the JAX
    package's), one sharded Lloyd step on a row batch against all 1M
    centroids (all but a few tied rows within 1e-5 of the JAX step), and a
    routed search over the million-list layout."""
    k = 1_048_576
    rng = np.random.default_rng(0)
    x = rng.standard_normal((k + 4_096, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="int32"):
        tmesh.ShardedPaddedLists(k, (2,), torch.float32, tm, min_cap=4096)
    cent = tmesh.sharded_kmeans(tm, x, k, iters=0)
    np.testing.assert_array_equal(cent.numpy(), np.asarray(jmesh.sharded_kmeans(jm, x, k,
                                                                               iters=0)))
    bbox_invariants(cent.numpy(), x, k, 1e-4)
    chunk = tkmeans.auto_chunk(k)
    nb = chunk * S
    xb, wb = x[:nb], np.ones(nb, np.float32)
    xs = [b.reshape(-1, chunk, 2) for b in tmesh.shard_rows(tm, xb)]
    ws = [b.reshape(-1, chunk) for b in tmesh.shard_rows(tm, wb)]
    stepped = tmesh.kmeans_step(tm, xs, ws, cent, k).numpy()
    want = np.asarray(jmesh._kmeans_step_jit(_jsharded(jm, xb), _jsharded(jm, wb),
                                             jnp.asarray(cent.numpy()), jm, k, chunk))
    # a million centroids in 2-d: a few rows sit on fp32 distance ties
    # between two centroids, which the two packages may break apart
    same = np.abs(stepped - want).max(1) <= 1e-5
    assert same.mean() >= 0.9999, (~same).sum()
    moved = np.abs(stepped - cent.numpy()).max(1) > 0
    assert 0 < moved.sum() <= nb
    idx = tmesh.ShardedIVFFlatIndex(2, k, "l2", mesh=tm, probe_routing=True, device="cpu")
    idx.centroids = cent
    idx.lists = idx._make_lists()
    idx.add(x[:4096])
    assert idx.ntotal == 4096
    idx.set_nprobe(16)
    q = x[:8] + 1e-3 * rng.standard_normal((8, 2)).astype(np.float32)
    _D, ids = idx.search(q, 5)
    assert ids.shape == (8, 5) and (ids[:, 0] >= 0).all()
    assert sum(i in ids[i] for i in range(8)) >= 6
