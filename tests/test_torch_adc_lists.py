"""K3 over the probed lists (``adc_scan_lists`` in
distributed_faiss_tpu_torch/ops/adc_scan.py) against the JAX package's
composition around its nibble kernel, on the same numpy inputs: the probed
lists' codes ``list_codes[li]``, ``adc_pallas.adc_scan_pallas_nibble`` in
interpret mode, then the ``pos < size & id >= 0`` mask of
distributed_faiss_tpu/models/ivf.py:252-253.

On the CPU the wrapper runs its plain version (gather + ``adc_scan_plain``
+ ``mask_lists``), so these tests hold that version to the JAX function.
The CUDA kernel runs only on the card, where chip_smoke.py and
tests/test_torch_cuda.py compare it with the plain version. Identical -inf
masks; finite scores within rtol/atol 1e-4 (tests/test_adc_pallas.py:46),
bf16 tables included: both sides get the same bf16 table and sum its
values in fp32."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import adc_pallas
from distributed_faiss_tpu_torch.models.ivf import IVFPQIndex
from distributed_faiss_tpu_torch.ops import adc_scan

# list sizes of a capacity of 300: empty, one row, full, ragged
SIZES = np.array([0, 1, 300, 137, 299, 64], np.int32)
CAP = 300


def make_problem(seed, nq, g, m):
    """lut (nq*g, m, 256) f32, list codes, ids (about 10% -1), and li with
    a list probed twice by the first query when g > 1."""
    rng = np.random.default_rng(seed)
    nlist = len(SIZES)
    lut = rng.standard_normal((nq * g, m, 256)).astype(np.float32)
    list_codes = rng.integers(0, 256, (nlist, CAP, m)).astype(np.uint8)
    list_ids = rng.integers(0, 1 << 20, (nlist, CAP)).astype(np.int32)
    list_ids[rng.random((nlist, CAP)) < 0.1] = -1
    li = rng.integers(0, nlist, (nq, g)).astype(np.int32)
    li[1, 0] = 2  # a full list
    if g > 1:
        li[0, :2] = 3  # repeated within a query
    return lut, list_codes, li, list_ids


def jax_composition(lut, list_codes, li, list_ids):
    import jax.numpy as jnp

    nq, g = li.shape
    m = list_codes.shape[2]
    codes = jnp.asarray(list_codes)[jnp.asarray(li)].reshape(nq * g, CAP, m)
    s = adc_pallas.adc_scan_pallas_nibble(lut, codes, tile=128, interpret=True)
    s = s.reshape(nq, g, CAP)
    ids = jnp.asarray(list_ids)[li]
    sizes = jnp.asarray(SIZES)[li]
    valid = (jnp.arange(CAP)[None, None, :] < sizes[:, :, None]) & (ids >= 0)
    return np.asarray(jnp.where(valid, s, -jnp.inf))


def torch_args(lut, list_codes, li, list_ids):
    return (torch.as_tensor(np.asarray(lut)) if not isinstance(lut, torch.Tensor) else lut,
            torch.as_tensor(list_codes), torch.as_tensor(li),
            torch.as_tensor(SIZES[li]), torch.as_tensor(list_ids))


def assert_scores_match(got, want):
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), "-inf masks differ"
    assert not np.isnan(got).any()
    f = np.isfinite(want)
    np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("g", [1, 3])
def test_lists_plain_matches_jax_composition(g, m, lut_dtype):
    """Sizes 0, 1, cap and ragged, -1 ids, repeated lists in li."""
    import jax.numpy as jnp

    lut, list_codes, li, list_ids = make_problem(10 * g + m, 4, g, m)
    if lut_dtype == "bf16":
        jlut = jnp.asarray(lut).astype(jnp.bfloat16)
        tlut = torch.as_tensor(np.array(jlut.astype(jnp.float32))).bfloat16()
    else:
        jlut, tlut = lut, torch.as_tensor(lut)
    want = jax_composition(jlut, list_codes, li, list_ids)
    got = adc_scan.adc_scan_lists_plain(*torch_args(tlut, list_codes, li, list_ids)).numpy()
    assert got.shape == (4, g, CAP) and got.dtype == np.float32
    assert np.isneginf(got[:, :, CAP - 1][SIZES[li] < CAP]).all()
    assert_scores_match(got, want)


def lists_plain_slice(lut, list_codes, li, sizes_g, list_ids, out):
    """The per-slice launch the card path makes, in plain PyTorch: the
    first slice writes the masked scores of subspaces [s, e), each later
    one adds its live rows' lookups (a masked -inf stays -inf)."""
    def launch(s, e, accumulate):
        part = adc_scan.adc_scan_lists_plain(lut[:, s:e].contiguous(),
                                             list_codes[:, :, s:e].contiguous(), li, sizes_g,
                                             list_ids)
        if accumulate:
            out.copy_(torch.where(torch.isneginf(out), out, out + part))
        else:
            out.copy_(part)

    return launch


def test_sliced_lists_match_jax_composition():
    """m = 256 with an f32 LUT is wider than a block's shared memory on
    the card: driven through ``run_slices`` with the accumulating plain
    version it gives the JAX composition's scores and mask."""
    m = 256
    lut, list_codes, li, list_ids = make_problem(256, 3, 2, m)
    args = torch_args(lut, list_codes, li, list_ids)
    width = adc_scan.slice_width(m, 256, 4, adc_scan.adc_scan_nibble)
    out = torch.full((3, 2, CAP), float("nan"))
    assert adc_scan.run_slices(m, width, lists_plain_slice(*args, out)) == 2
    assert_scores_match(out.numpy(), jax_composition(lut, list_codes, li, list_ids))


def test_lists_wrapper_sends_cpu_tensors_to_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no
    launch, neither its own nor K3's."""
    args = torch_args(*make_problem(1, 3, 2, 8))
    before = (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches)
    got = adc_scan.adc_scan_lists(*args)
    assert torch.equal(got, adc_scan.adc_scan_lists_plain(*args))
    assert (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches) == before


def test_lists_wrapper_never_falls_back_off_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA device raises."""
    args = [t.to("meta") for t in torch_args(*make_problem(2, 3, 2, 8))]
    with pytest.raises(RuntimeError, match="unsupported device"):
        adc_scan.adc_scan_lists(*args)


# (metric, m, knobs): m % 8 == 0 takes K3 over the lists, else K2
ROUTE_CASES = [("l2", 8, {}), ("dot", 8, {}), ("l2", 16, {}), ("dot", 16, {}),
               ("l2", 8, {"use_pallas": True, "adc_lut_bf16": True}),
               ("dot", 16, {"use_pallas": True, "adc_lut_bf16": True}),
               ("l2", 4, {}), ("dot", 4, {}), ("l2", 4, {"use_pallas": True}),
               ("dot", 4, {"use_pallas": True})]


@pytest.mark.parametrize("metric,m,kw", ROUTE_CASES,
                         ids=["-".join([c[0], f"m{c[1]}"] + sorted(c[2])) for c in ROUTE_CASES])
def test_ivf_pq_search_takes_the_lists_entry_in_the_nibble_geometry(monkeypatch, metric, m,
                                                                    kw):
    """The IVF-PQ probe loop scores a group with ``adc_scan_lists`` when
    the geometry is K3's (no gathered codes), and with the gathered codes,
    ``adc_scan`` (K2) and ``mask_lists`` otherwise. Either way a
    JAX-trained index served by the port gives the JAX package's search
    results: the same ids, distances within rtol/atol 1e-4 (with
    use_pallas the JAX side runs its Pallas kernel in interpret mode, and
    with adc_lut_bf16 both sides scan the bf16 LUT)."""
    from distributed_faiss_tpu.models.ivf import IVFPQIndex as JIVFPQ
    from distributed_faiss_tpu_torch import interop

    rng = np.random.default_rng(3)
    d, nlist = 16, 8
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nlist, 500)] + rng.standard_normal((500, d)).astype(np.float32)
    q = centers[rng.integers(0, nlist, 9)] + rng.standard_normal((9, d)).astype(np.float32)
    ref = JIVFPQ(d, nlist, m=m, metric=metric, kmeans_iters=3, pq_iters=3, **kw)
    ref.train(x[:300])
    ref.add(x)
    ref.set_nprobe(4)
    index = interop.from_jax_state(ref.state_dict(), device="cpu")
    assert isinstance(index, IVFPQIndex)
    calls = []
    for name in ("adc_scan_lists", "adc_scan"):
        orig = getattr(adc_scan, name)
        monkeypatch.setattr(adc_scan, name,
                            lambda *a, _n=name, _f=orig: calls.append(_n) or _f(*a))
    dist, ids = index.search(q, 5)
    fused = adc_scan.nibble_supported(m, 256)
    assert set(calls) == {"adc_scan_lists" if fused else "adc_scan"}
    want_dist, want_ids = ref.search(q, 5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(want_dist))
    f = np.isfinite(want_dist)
    np.testing.assert_allclose(dist[f], want_dist[f], rtol=1e-4, atol=1e-4)
