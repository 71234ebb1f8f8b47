"""The port's IVF-Flat list scan (distributed_faiss_tpu_torch/ops/flat_scan.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs.

On the CPU the wrapper runs its plain PyTorch version, so these tests hold
that version to the TPU kernel's function. The CUDA kernel itself runs only
on the card, where chip_smoke.py and tests/test_torch_cuda.py compare it
with the plain version.

The select epilogue's plain version (``flat_list_scan_select_plain``) and
the merge of its candidates (``ops/topk.py`` ``topk_select_plain``) are
held to the scores plus a per-pair ``torch.topk``, and the IVF-Flat search
that takes them (k <= 256) and the one that does not (k > 256) to the JAX
package's top-10.
"""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.models.ivf import IVFFlatIndex as JIVF
from distributed_faiss_tpu.ops import flat_pallas
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.ops import flat_scan, topk

CODEC_NP = {"f32": np.float32, "f16": np.float16}

# (codec, metric, stored norms, scan_bf16): every variant of the kernel
VARIANTS = [(codec, metric, stored, False)
            for codec in ("f32", "f16", "sq8")
            for metric, stored in (("l2", True), ("l2", False), ("dot", False))]
VARIANTS += [(codec, "l2", True, True) for codec in ("f32", "f16", "sq8")]


def _vid(v):
    codec, metric, stored, bf16 = v
    return f"{codec}-{metric}{'-stored' if stored else ''}{'-bf16' if bf16 else ''}"


def make_problem(rng, codec, metric, stored):
    """The shapes of tests/test_flat_pallas.py's ``problem`` fixture."""
    nq, d, nlist, cap, g = 5, 24, 12, 128, 3
    q = rng.standard_normal((nq, d)).astype(np.float32)
    vmin = span = None
    if codec == "sq8":
        data = rng.integers(0, 256, (nlist, cap, d)).astype(np.uint8)
        vmin = rng.standard_normal(d).astype(np.float32)
        span = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
        decoded = torch.as_tensor(vmin) + torch.as_tensor(data).float() * (
            torch.as_tensor(span) / 255.0)
    else:
        data = rng.standard_normal((nlist, cap, d)).astype(CODEC_NP[codec])
        decoded = torch.as_tensor(data).float()
    norms = None
    if metric == "l2" and stored:
        norms = (decoded * decoded).sum(-1).numpy()
    ids = rng.integers(-1, 60, (nlist, cap)).astype(np.int32)
    sizes = rng.integers(0, cap + 1, (nlist,)).astype(np.int32)
    li = rng.integers(0, nlist, (nq, g)).astype(np.int32)
    return q, data, ids, sizes, li, norms, vmin, span


def run_jax(q, data, ids, sizes, li, norms, vmin, span, metric, codec, scan_bf16):
    import jax.numpy as jnp

    opt = (lambda a: None if a is None else jnp.asarray(a))
    return np.asarray(flat_pallas.flat_list_scan_pallas(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray(ids), jnp.asarray(li),
        jnp.asarray(sizes[li]), opt(norms), opt(vmin), opt(span),
        metric=metric, codec=codec, scan_bf16=scan_bf16, tile=64, interpret=True))


def torch_args(q, data, ids, sizes, li, norms, vmin, span):
    opt = (lambda a: None if a is None else torch.as_tensor(a))
    return (torch.as_tensor(q), torch.as_tensor(data), torch.as_tensor(ids),
            torch.as_tensor(li), torch.as_tensor(sizes[li]), opt(norms), opt(vmin),
            opt(span))


def assert_scores_match(got, want, rtol, atol):
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), "-inf masks differ"
    assert not np.isnan(got).any()
    f = np.isfinite(want)
    np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=atol)


@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
def test_plain_matches_pallas_interpret(rng, variant):
    """The plain version computes the Pallas kernel's function: identical
    -inf masks, finite scores within rtol/atol 1e-4 (the tolerance of
    tests/test_flat_pallas.py), 5e-2/5e-1 under scan_bf16."""
    codec, metric, stored, bf16 = variant
    prob = make_problem(rng, codec, metric, stored)
    want = run_jax(*prob, metric=metric, codec=codec, scan_bf16=bf16)
    got = flat_scan.flat_list_scan_plain(*torch_args(*prob), metric=metric, codec=codec,
                                         scan_bf16=bf16).numpy()
    assert got.shape == want.shape == (5, 3, 128)
    rtol, atol = (5e-2, 5e-1) if bf16 else (1e-4, 1e-4)
    assert_scores_match(got, want, rtol, atol)


def test_stored_and_recomputed_norms_agree(rng):
    """Stored norms are the decoded rows' exact fp32 norms, so the two l2
    modes give the same scores."""
    prob = make_problem(rng, "sq8", "l2", True)
    args = torch_args(*prob)
    stored = flat_scan.flat_list_scan_plain(*args, metric="l2", codec="sq8")
    recomputed = flat_scan.flat_list_scan_plain(*args[:5], None, *args[6:], metric="l2",
                                                codec="sq8")
    assert_scores_match(stored.numpy(), recomputed.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("variant", VARIANTS[:3], ids=_vid)
def test_wrapper_sends_cpu_tensors_to_plain_version(rng, variant):
    """On CPU tensors the wrapper is the plain version, and it counts no
    kernel launch."""
    codec, metric, stored, bf16 = variant
    args = torch_args(*make_problem(rng, codec, metric, stored))
    before = flat_scan.flat_list_scan.launches
    got = flat_scan.flat_list_scan(*args, metric=metric, codec=codec)
    want = flat_scan.flat_list_scan_plain(*args, metric=metric, codec=codec)
    assert torch.equal(got, want)
    assert flat_scan.flat_list_scan.launches == before


def test_wrapper_never_falls_back_off_cpu(rng):
    """A tensor that lies neither on the CPU nor on a CUDA device raises:
    the plain version is reached only through a CPU tensor."""
    args = [a.to("meta") if a is not None else None
            for a in torch_args(*make_problem(rng, "f16", "l2", True))]
    with pytest.raises(RuntimeError, match="unsupported device"):
        flat_scan.flat_list_scan(*args, metric="l2", codec="f16")


# ------------------------------------------------------------ the select


def select_problem(seed, codec, metric, stored, nq=5, d=24, nlist=12, cap=300, g=4):
    """Select inputs: unique ids with about 10% tombstoned (-1), list 0 full,
    list 1 empty, list 2 with 5 rows (fewer than most k), the rest ragged;
    each query probes g distinct lists, query 0 lists 0-3."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    vmin = span = None
    if codec == "sq8":
        data = rng.integers(0, 256, (nlist, cap, d)).astype(np.uint8)
        vmin = rng.standard_normal(d).astype(np.float32)
        span = (np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32)
        decoded = torch.as_tensor(vmin) + torch.as_tensor(data).float() * (
            torch.as_tensor(span) / 255.0)
    else:
        data = rng.standard_normal((nlist, cap, d)).astype(CODEC_NP[codec])
        decoded = torch.as_tensor(data).float()
    norms = (decoded * decoded).sum(-1).numpy() if metric == "l2" and stored else None
    ids = rng.permutation(nlist * cap).astype(np.int32).reshape(nlist, cap)
    ids[rng.random((nlist, cap)) < 0.1] = -1
    sizes = rng.integers(0, cap + 1, (nlist,)).astype(np.int32)
    sizes[:3] = (cap, 0, 5)
    li = np.stack([rng.choice(nlist, g, replace=False) for _ in range(nq)]).astype(np.int32)
    li[0] = (0, 1, 2, 3)
    return q, data, ids, sizes, li, norms, vmin, span


def topk_reference(vals, ids, k):
    """Each row's best k by ``torch.topk``, padded to k with (-inf, -1) and
    with id -1 wherever the score is -inf."""
    w = vals.shape[-1]
    best, pos = torch.topk(vals, min(k, w), dim=-1)
    out = torch.gather(ids, -1, pos)
    if w < k:
        pad = list(vals.shape[:-1]) + [k - w]
        best = torch.cat([best, best.new_full(pad, float("-inf"))], -1)
        out = torch.cat([out, out.new_full(pad, -1)], -1)
    return best, torch.where(torch.isneginf(best), torch.full_like(out, -1), out)


def assert_same_topk(got, want):
    """Same scores (within 1e-5: the plain select scores one probe at a
    time), -1 at every -inf slot, and the same ids at every finite slot
    whose score is apart from its neighbours' (fp16 rows at d = 24 tie
    now and then, and ``torch.topk`` orders a tie as it likes)."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape and gi.dtype == torch.int32
    assert torch.equal(torch.isneginf(gv), torch.isneginf(wv)), "-inf slots differ"
    f = torch.isfinite(wv)
    torch.testing.assert_close(gv[f], wv[f], rtol=1e-5, atol=1e-5)
    assert (gi[~f] == -1).all() and (wi[~f] == -1).all()
    gap = (wv[..., :-1] - wv[..., 1:]) > 2e-5 * wv.abs().clamp(min=1.0)[..., 1:]
    apart = torch.ones_like(f)
    apart[..., 1:] &= gap
    apart[..., :-1] &= gap
    assert apart[f].float().mean() > 0.9
    assert torch.equal(gi[f & apart], wi[f & apart])


SELECT_VARIANTS = [v for v in VARIANTS if v[2] or v[1] == "dot"]  # stored norms, or dot


@pytest.mark.parametrize("k", [1, 10, 80, 256])
@pytest.mark.parametrize("variant", SELECT_VARIANTS, ids=_vid)
def test_select_plain_is_the_scores_top_k(variant, k):
    """``flat_list_scan_select`` on the CPU (its plain version): each
    pair's best k of ``flat_list_scan_plain``'s scores by ``torch.topk``,
    ids from the lists, (-inf, -1) past a pair's valid rows: the empty
    list, the 5-row list, the tombstones."""
    codec, metric, stored, bf16 = variant
    args = torch_args(*select_problem(k, codec, metric, stored))
    kw = dict(metric=metric, codec=codec, scan_bf16=bf16)
    got = flat_scan.flat_list_scan_select(*args, k=k, **kw)
    scores = flat_scan.flat_list_scan_plain(*args, **kw)
    list_ids, li = args[2], args[3]
    want = topk_reference(scores, list_ids[li.long()], k)
    assert_same_topk(got, want)
    assert (got[1][0, 1] == -1).all()  # the empty list
    assert (got[1][0, 2, 5:] == -1).all()  # the 5-row list


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("k", [1, 10, 80, 256])
def test_topk_select_plain_is_the_candidates_top_k(k, carry):
    """``topk_select`` on the CPU (its plain version) over the select's
    (nq, g * k) candidates, alone and merged with a carry from another
    group: ``torch.topk`` of the concatenation, in order, (-inf, -1)
    past the valid candidates."""
    args = torch_args(*select_problem(100 + k, "f16", "l2", True))
    vals, ids = flat_scan.flat_list_scan_select(*args, k=k, metric="l2", codec="f16")
    nq = vals.shape[0]
    vals, ids = vals.reshape(nq, -1), ids.reshape(nq, -1)
    before = None
    if carry:
        other = torch_args(*select_problem(200 + k, "f16", "l2", True))
        cv, ci = flat_scan.flat_list_scan_select(*other, k=k, metric="l2", codec="f16")
        before = topk.topk_select(cv.reshape(nq, -1), ci.reshape(nq, -1) + 10**6, k)
    got = topk.topk_select(vals, ids, k, before)
    if carry:
        vals, ids = torch.cat([before[0], vals], 1), torch.cat([before[1], ids], 1)
    assert_same_topk(got, topk_reference(vals, ids, k))
    assert (got[0][:, 1:] <= got[0][:, :-1]).all()  # best first


def test_topk_select_orders_ties_by_id():
    """Equal scores come back by the lower id, as the kernel orders them,
    and -inf slots as -1 whatever id they held."""
    vals = torch.tensor([[1.0, 2.0, 2.0, float("-inf"), 2.0]])
    ids = torch.tensor([[7, 9, 3, 4, 5]], dtype=torch.int32)
    got_v, got_i = topk.topk_select(vals, ids, 6)
    assert got_i.tolist() == [[3, 5, 9, 7, -1, -1]]
    assert got_v[0, :4].tolist() == [2.0, 2.0, 2.0, 1.0]


@pytest.mark.parametrize("k", [10, 300])
@pytest.mark.parametrize("codec", ["f32", "f16", "sq8"])
def test_ivf_flat_search_either_side_of_the_select_matches_jax(codec, k, monkeypatch):
    """An IVF-Flat search at k <= 256 (K1's select and ``topk_select``, one
    probe group) and at k > 256 (the (nq, g, cap) scores and the per-group
    top-k) gives the JAX package's top-10 on tie-free rows."""
    rng = np.random.default_rng(7)
    d, nlist, n = 16, 16, 3000
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nlist, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, nlist, 40)] + rng.standard_normal((40, d)).astype(np.float32)
    ref = JIVF(d, nlist, "l2", codec=codec, kmeans_iters=4)
    ref.train(x[:1500])
    ref.add(x)
    ref.set_nprobe(6)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    nprobe, _, g = port._search_plan(k)
    assert g == (nprobe if k <= topk.SELECT_MAX_K else port._score_plan()[2])
    calls = []
    for name in ("flat_list_scan", "flat_list_scan_select"):
        fn = getattr(flat_scan, name)
        monkeypatch.setattr(flat_scan, name,
                            lambda *a, _fn=fn, _name=name, **kw: calls.append(_name)
                            or _fn(*a, **kw))
    dp, ip = port.search(q, k)
    assert set(calls) == {"flat_list_scan_select" if k <= 256 else "flat_list_scan"}
    dr, ir = ref.search(q, 11)
    scale = np.maximum(np.abs(dr).max(axis=1), 1e-30)
    ok = (np.diff(dr, axis=1) > 1e-5 * scale[:, None]).all(1)
    assert ok.mean() >= 0.9
    np.testing.assert_array_equal(ip[ok, :10], ir[ok, :10])
    np.testing.assert_allclose(dp[ok, :10], dr[ok, :10], rtol=1e-3, atol=1e-3)


def test_select_path_carries_across_probe_groups():
    """When the plan splits the probes into groups (k * nb large enough),
    ``topk_select`` merges each group's candidates into the carry: the same
    result as one group of every probe."""
    from distributed_faiss_tpu_torch.models import ivf as tivf

    rng = np.random.default_rng(8)
    d, nlist = 16, 16
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nlist, 2000)] + rng.standard_normal((2000, d)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((24, d)).astype(np.float32))
    ref = JIVF(d, nlist, "l2", codec="f16", kmeans_iters=4)
    ref.train(x)
    ref.add(x)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    args = (port.centroids, port.lists.data, port.lists.ids, port.lists.sizes, q, 40, 8)
    kw = dict(list_norms=port._scan_norms())
    one = tivf._ivf_flat_search(*args, 8, "l2", "f16", **kw)
    four = tivf._ivf_flat_search(*args, 2, "l2", "f16", **kw)
    assert torch.equal(one[0], four[0]) and torch.equal(one[1], four[1])
    assert (one[1] >= 0).all()
