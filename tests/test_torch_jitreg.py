"""The port's program registry (utils/jitreg.py) against the JAX package's
(distributed_faiss_tpu/utils/jitreg.py): the same bucket enumerations
from the port's own pow2 helpers, each port row standing for a JAX row at
that row's budget, every JAX row accounted for; and on the recording
capture backend, every program the port's search paths capture is a
registered row (compilecheck ``by_entry`` / ``unregistered``), within its
budget over windows of 1..8192 rows."""

import importlib

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.utils import jitreg as jjitreg
from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.parallel import mesh as tmesh
from distributed_faiss_tpu_torch.utils import compilecheck, jitreg, programs

D, K = 8, 5


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


def jax_rows() -> dict:
    return {r["qualname"]: r for r in jjitreg.rows()}


# ------------------------------------------------------------- the registry


@pytest.mark.parametrize("name", ["buckets_query_blocks", "buckets_fused_nblocks",
                                  "buckets_blocked_search"])
def test_enumerators_equal_jax(name):
    assert jitreg.MAX_SERVING_WINDOW_ROWS == jjitreg.MAX_SERVING_WINDOW_ROWS
    assert getattr(jitreg, name)() == getattr(jjitreg, name)()


def test_each_row_stands_for_a_jax_row_at_its_budget():
    jrows = jax_rows()
    names = jitreg.registered_qualnames()
    assert len(set(names)) == len(names)
    for row in jitreg.rows():
        jrow = jrows[row["jax"]]
        assert (row["buckets"], row["budget"], row["hot"]) == \
            (jrow["buckets"], jrow["budget"], jrow["hot"]), row["name"]
        assert jitreg.enumerate_buckets(row) == jjitreg.enumerate_buckets(jrow)
        assert len(jitreg.enumerate_buckets(row)) <= row["budget"]
        module = importlib.import_module(row["path"][:-3].replace("/", "."))
        assert callable(getattr(module, row["qualname"])), row
        assert jitreg.row_of(row["name"]) is row
    assert jitreg.row_of("no.such") is None


def test_every_jax_row_is_accounted_for():
    """A JAX row is either stood for by a port row, or ``INSIDE`` names
    where its work runs: a hot row inside a registered program."""
    jrows = jax_rows()
    standing = {row["jax"] for row in jitreg.rows()}
    assert not standing & set(jitreg.INSIDE)
    assert set(jitreg.INSIDE) <= set(jrows)
    names = set(jitreg.registered_qualnames())
    for qualname, jrow in jrows.items():
        if qualname in standing:
            continue
        assert qualname in jitreg.INSIDE, qualname
        if jrow["hot"]:
            assert jitreg.INSIDE[qualname] in names, qualname


def test_compilecheck_tallies_captures_by_entry(tally):
    for name in ("capture:flat.block", "capture:flat.block", "capture:sharded_ivf_pq.routed",
                 "capture:made_up.block", "nvcc:flat_scan"):
        compilecheck.record(name)
    assert compilecheck.by_entry() == {"flat.block": 2, "sharded_ivf_pq.routed": 1}
    assert compilecheck.unregistered() == ["made_up.block"]
    snap = compilecheck.snapshot()
    compilecheck.record("capture:flat.fused")
    assert compilecheck.by_entry(snap) == {"flat.fused": 1}


# --------------------------------------------------------- the search paths


def make_data(seed, n, nq):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, D)).astype(np.float32)
    q = centers[rng.integers(0, 8, nq)] + rng.standard_normal((nq, D)).astype(np.float32)
    return x, q


def build(kind: str, x):
    mesh = tmesh.make_mesh(4, device="cpu", virtual=True)
    if kind == "flat":
        idx = FlatIndex(D, "l2", device="cpu")
    elif kind == "ivf_flat":
        idx = IVFFlatIndex(D, 8, "l2", device="cpu")
    elif kind == "ivf_pq":
        idx = IVFPQIndex(D, 8, m=4, refine_k_factor=2, device="cpu")
    elif kind == "pq_shared":
        idx = IVFPQIndex(D, 1, m=4, device="cpu")
    elif kind == "sharded_flat":
        idx = tmesh.ShardedFlatIndex(D, "l2", mesh=mesh)
    elif kind.startswith("sharded_ivf_flat"):
        idx = tmesh.ShardedIVFFlatIndex(D, 8, "l2", mesh=mesh, kmeans_iters=4,
                                        probe_routing=kind.endswith("routed"))
    else:
        idx = tmesh.ShardedIVFPQIndex(D, 8, m=4, mesh=mesh, kmeans_iters=4, pq_iters=4,
                                      probe_routing=kind.endswith("routed"))
    idx.train(x)
    idx.add(x)
    if hasattr(idx, "set_nprobe"):
        idx.set_nprobe(4)
    idx.programs.backend = programs.RecordingGraphs()
    return idx


KINDS = ["flat", "ivf_flat", "ivf_pq", "pq_shared", "sharded_flat", "sharded_ivf_flat",
         "sharded_ivf_pq", "sharded_ivf_flat.routed", "sharded_ivf_pq.routed"]


def test_search_paths_capture_only_registered_names(tally):
    """One block and one multi-block window on every model (the routed
    mesh runs blocks only): each program name is a registered row, and
    together they are every row."""
    x, q = make_data(1, 600, 1100)
    for kind in KINDS:
        idx = build(kind, x)
        idx.search(q[:100], K)
        idx.search(q, K)
    assert compilecheck.unregistered() == []
    want = set(jitreg.registered_qualnames()) - {"blocked_search"}
    assert set(compilecheck.by_entry()) == want


# every bucket boundary of windows of 1..8192 rows: a window of p + 1 rows
# is the first of its bucket
WINDOWS = sorted({1} | {p + 1 for p in (2 ** i for i in range(13))} | {8192})


@pytest.mark.parametrize("kind", KINDS)
def test_captures_per_entry_stay_within_budget(tally, kind):
    x, q = make_data(2, 600, 8192)
    idx = build(kind, x)
    for n in WINDOWS:
        idx.search(q[:n], K)
    captured = compilecheck.by_entry()
    assert captured and compilecheck.unregistered() == []
    for name, n in captured.items():
        row = jitreg.row_of(name)
        assert n <= row["budget"], (name, n, row["budget"])
        assert n <= len(jitreg.enumerate_buckets(row))
    loop_row = jitreg.row_of("blocked_search")
    assert sum(captured.values()) <= loop_row["budget"]
    assert idx.programs.evictions == 0  # each capture is a distinct key
