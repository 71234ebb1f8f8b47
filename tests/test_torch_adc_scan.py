"""The port's ADC scan (distributed_faiss_tpu_torch/ops/adc_scan.py) against
the JAX package's: its XLA path (ops/pq.py) and its two Pallas kernels run
in interpret mode, on the same numpy inputs.

On the CPU every wrapper runs the plain version, so these tests hold that
version to the TPU kernels' function. The CUDA kernels run only on the
card, where chip_smoke.py and tests/test_torch_cuda.py compare them with
the plain version. A bf16 LUT is compared bf16 against bf16: both packages
get the same bf16 table and sum its values in fp32, so the bar stays
rtol/atol 1e-4 (tests/test_adc_pallas.py:46)."""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.ops import adc_pallas
from distributed_faiss_tpu.ops import pq as jpq
from distributed_faiss_tpu_torch.ops import adc_scan


def make_problem(seed, nq, m, L, ksub=256):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((nq, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (nq, L, m)).astype(np.uint8)
    return lut, codes


def bf16_pair(lut):
    """The same bf16 table for both packages: (jnp bf16 array, torch bf16)."""
    import jax.numpy as jnp

    jlut = jnp.asarray(lut).astype(jnp.bfloat16)
    return jlut, torch.as_tensor(np.array(jlut.astype(jnp.float32))).bfloat16()


def plain(lut, codes):
    return adc_scan.adc_scan_plain(torch.as_tensor(lut), torch.as_tensor(codes)).numpy()


@pytest.mark.parametrize("m,L", [(4, 520), (12, 300), (8, 1), (64, 33)])
def test_plain_matches_xla_path(m, L):
    lut, codes = make_problem(m + L, 5, m, L)
    got = plain(lut, codes)
    assert got.shape == (5, L) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jpq.adc_scan(lut, codes)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,L", [(4, 520), (12, 300)])
def test_plain_matches_onehot_kernel_interpret(m, L):
    """K2's function: adc_scan_pallas in interpret mode (L not a tile
    multiple)."""
    lut, codes = make_problem(m, 4, m, L)
    want = np.asarray(adc_pallas.adc_scan_pallas(lut, codes, tile=128, interpret=True))
    np.testing.assert_allclose(plain(lut, codes), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,L", [(8, 300), (16, 200)])
def test_plain_matches_nibble_kernel_interpret(m, L):
    """K3's function: adc_scan_pallas_nibble in interpret mode."""
    lut, codes = make_problem(m, 3, m, L)
    want = np.asarray(adc_pallas.adc_scan_pallas_nibble(lut, codes, tile=128,
                                                        interpret=True))
    np.testing.assert_allclose(plain(lut, codes), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel,m", [("onehot", 4), ("onehot", 12), ("nibble", 8),
                                      ("nibble", 16)])
def test_bf16_lut_against_the_same_bf16_lut(kernel, m):
    """Both sides sum the same bf16 values in fp32: 1e-4, not the 2e-2 an
    f32 reference would need."""
    lut, codes = make_problem(100 + m, 3, m, 200)
    jlut, tlut = bf16_pair(lut)
    fn = (adc_pallas.adc_scan_pallas if kernel == "onehot"
          else adc_pallas.adc_scan_pallas_nibble)
    want = np.asarray(fn(jlut, codes, tile=128, interpret=True))
    got = adc_scan.adc_scan_plain(tlut, torch.as_tensor(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the bf16 table is what is summed: its fp32 copy gives the same scores
    np.testing.assert_array_equal(got, plain(tlut.float().numpy(), codes))


def test_nibble_supported_matches_jax():
    for m in (1, 4, 8, 12, 16, 24, 64, 96):
        for ksub in (16, 128, 256):
            assert adc_scan.nibble_supported(m, ksub) == adc_pallas.nibble_supported(m, ksub)


@pytest.mark.parametrize("m,ksub", [(4, 256), (8, 256), (12, 256), (16, 256), (64, 256),
                                    (8, 16), (16, 128)])
def test_auto_dispatch_follows_the_geometry(monkeypatch, m, ksub):
    """adc_scan_auto takes the K3 wrapper exactly when nibble_supported,
    else the K2 wrapper (checked through the wrappers it calls: the launch
    counters do not move on the CPU)."""
    calls = []
    for name in ("adc_scan", "adc_scan_nibble"):
        orig = getattr(adc_scan, name)
        monkeypatch.setattr(adc_scan, name,
                            lambda lut, codes, _n=name, _f=orig: calls.append(_n) or _f(lut, codes))
    lut, codes = make_problem(m * ksub, 2, m, 40, ksub)
    got = adc_scan.adc_scan_auto(torch.as_tensor(lut), torch.as_tensor(codes)).numpy()
    assert calls == ["adc_scan_nibble" if adc_pallas.nibble_supported(m, ksub) else "adc_scan"]
    np.testing.assert_array_equal(got, plain(lut, codes))


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_nibble"])
def test_wrapper_sends_cpu_tensors_to_plain_version(wrapper):
    """On CPU tensors a wrapper is the plain version and counts no launch."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = make_problem(7, 3, 8, 100)
    before = fn.launches
    got = fn(torch.as_tensor(lut), torch.as_tensor(codes))
    assert torch.equal(got, torch.as_tensor(plain(lut, codes)))
    assert fn.launches == before


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_nibble", "adc_scan_auto"])
def test_wrapper_never_falls_back_off_cpu(wrapper):
    """A tensor that lies neither on the CPU nor on a CUDA device raises:
    the plain version is reached only through a CPU tensor."""
    lut, codes = make_problem(8, 2, 8, 16)
    with pytest.raises(RuntimeError, match="unsupported device"):
        getattr(adc_scan, wrapper)(torch.as_tensor(lut).to("meta"),
                                   torch.as_tensor(codes).to("meta"))


@pytest.mark.parametrize("nibble,itemsize,largest", [(True, 4, 224), (True, 2, 448),
                                                     (False, 4, 181), (False, 2, 302)])
def test_shared_memory_sets_the_largest_m(nibble, itemsize, largest):
    """The staged LUT (plus K2's code tile) fits Hopper's 227 KB a block up
    to this m at ksub = 256, and not one step of m (8 for K3) above it."""
    step = 8 if nibble else 1
    assert adc_scan.smem_bytes(largest, 256, itemsize, nibble) <= adc_scan.MAX_SMEM_BYTES
    assert adc_scan.smem_bytes(largest + step, 256, itemsize, nibble) > adc_scan.MAX_SMEM_BYTES
