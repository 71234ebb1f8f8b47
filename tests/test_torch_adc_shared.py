"""The port's shared-list ADC scan (K4's wrapper and plain version in
distributed_faiss_tpu_torch/ops/adc_scan.py) against the JAX package's:
its Pallas kernel ``adc_scan_shared_pallas`` run in interpret mode, as
tests/test_adc_pallas.py runs it, and its XLA path ``pq.adc_scan_shared``,
on the same numpy inputs.

On the CPU the wrapper runs the plain version, so these tests hold that
version to the TPU kernel's function; the CUDA kernel runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py). Tolerance rtol/atol 1e-4
(tests/test_adc_pallas.py:37). A bf16 LUT is compared bf16 against bf16:
the JAX kernel's one-hot products are exact in bf16 and both sides sum the
same bf16 values in fp32."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import adc_pallas
from distributed_faiss_tpu.ops import pq as jpq
from distributed_faiss_tpu_torch.ops import adc_scan


def make_problem(seed, nq, m, L, ksub=256):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((nq, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (L, m)).astype(np.uint8)
    return lut, codes


def plain(lut, codes):
    return adc_scan.adc_scan_shared_plain(torch.as_tensor(lut), torch.as_tensor(codes)).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [4, 12, 64])
@pytest.mark.parametrize("L", [1, 3, 700, 1000])
def test_plain_matches_jax_shared_kernel(L, m, dtype):
    """adc_scan_shared_plain against adc_scan_shared_pallas (interpret mode)
    and pq.adc_scan_shared, the same f32 or bf16 LUT on both sides."""
    import jax.numpy as jnp

    lut, codes = make_problem(L * 100 + m, 3, m, L)
    if dtype == "bf16":
        jlut = jnp.asarray(lut).astype(jnp.bfloat16)
        tlut = torch.as_tensor(np.array(jlut.astype(jnp.float32))).bfloat16()
    else:
        jlut, tlut = jnp.asarray(lut), torch.as_tensor(lut)
    got = adc_scan.adc_scan_shared_plain(tlut, torch.as_tensor(codes)).numpy()
    assert got.shape == (3, L) and got.dtype == np.float32
    want = np.asarray(adc_pallas.adc_scan_shared_pallas(jlut, codes, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    xla = np.asarray(jpq.adc_scan_shared(jnp.asarray(jlut, jnp.float32), codes))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)


def test_plain_chunks_give_the_same_scores(monkeypatch):
    """The plain version's chunking over L changes no score: a budget of a
    few rows a chunk sums the same values in the same order."""
    lut, codes = make_problem(5, 4, 12, 1000)
    whole = plain(lut, codes)
    monkeypatch.setattr(adc_scan, "_SHARED_PLAIN_BYTES", 4 * 4 * 37)
    np.testing.assert_array_equal(plain(lut, codes), whole)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    lut, codes = make_problem(7, 3, 8, 100)
    before = adc_scan.adc_scan_shared.launches
    got = adc_scan.adc_scan_shared(torch.as_tensor(lut), torch.as_tensor(codes))
    assert torch.equal(got, torch.as_tensor(plain(lut, codes)))
    assert adc_scan.adc_scan_shared.launches == before


def test_wrapper_never_falls_back_off_cpu():
    """A tensor on neither the CPU nor a CUDA device raises: the plain
    version is reached only through a CPU tensor."""
    lut, codes = make_problem(8, 2, 8, 16)
    with pytest.raises(RuntimeError, match="unsupported device"):
        adc_scan.adc_scan_shared(torch.as_tensor(lut).to("meta"),
                                 torch.as_tensor(codes).to("meta"))


def test_launch_checks_refuse_bad_inputs():
    """The checks the wrapper runs before a CUDA launch: device, dtype,
    shape, contiguity and ksub are refused by name before any pointer is
    taken (run here on CPU tensors, where they fail before the launch)."""
    lut, codes = (torch.as_tensor(a) for a in make_problem(9, 4, 8, 64))
    before = adc_scan.adc_scan_shared.launches
    cases = [
        ((lut.half(), codes), "must be torch.float32 or torch.bfloat16"),
        ((lut, codes.int()), "must be torch.uint8"),
        ((lut, codes.t().contiguous().t()), "contiguous"),
        ((lut, codes.to("meta")), "is on meta"),
        ((lut, codes[:, :4].contiguous()), "shape"),
        ((lut, codes[None]), "codes 2-d"),
        ((torch.zeros((4, 8, 300)), codes), "ksub must be in 1..256"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            adc_scan._launch_shared(*args)
    assert adc_scan.adc_scan_shared.launches == before


@pytest.mark.parametrize("itemsize,largest", [(4, 112), (2, 149)])
def test_shared_memory_sets_the_largest_m(itemsize, largest):
    """One query's LUT and the 1024-row code tile fit Hopper's 227 KB a
    block up to this m at ksub = 256, and not at m + 1."""
    assert adc_scan.shared_smem_bytes(largest, 256, itemsize) <= adc_scan.MAX_SMEM_BYTES
    assert adc_scan.shared_smem_bytes(largest + 1, 256, itemsize) > adc_scan.MAX_SMEM_BYTES
