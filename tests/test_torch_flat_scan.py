"""The port's IVF-Flat list scan (distributed_faiss_tpu_torch/ops/flat_scan.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs.

On the CPU the wrapper runs its plain PyTorch version, so these tests hold
that version to the TPU kernel's function. The CUDA kernel itself runs only
on the card, where chip_smoke.py and tests/test_torch_cuda.py compare it
with the plain version.
"""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import flat_pallas
from distributed_faiss_tpu_torch.ops import flat_scan

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
