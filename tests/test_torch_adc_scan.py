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


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_nibble"])
def test_wrapper_sends_cpu_tensors_to_plain_version(wrapper):
    """On CPU tensors a wrapper is the plain version and counts no launch."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = make_problem(7, 3, 8, 100)
    before = fn.launches
    got = fn(torch.as_tensor(lut), torch.as_tensor(codes))
    assert torch.equal(got, torch.as_tensor(plain(lut, codes)))
    assert fn.launches == before


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_nibble"])
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


def pair_plain_slice(lut, codes, out):
    """The per-slice launch the card path makes, in plain PyTorch: slice
    [s, e) of the subspaces of every pair, added to ``out`` when
    accumulating."""
    def launch(s, e, accumulate):
        part = adc_scan.adc_scan_plain(lut[:, s:e].contiguous(), codes[:, :, s:e].contiguous())
        if accumulate:
            out.add_(part)
        else:
            out.copy_(part)

    return launch


@pytest.mark.parametrize("wrapper,dtype,m,slices", [
    ("adc_scan_nibble", torch.float32, 256, 2), ("adc_scan_nibble", torch.float32, 232, 2),
    ("adc_scan_nibble", torch.bfloat16, 512, 2), ("adc_scan", torch.float32, 190, 2),
    ("adc_scan", torch.bfloat16, 700, 3)],
    ids=["k3-f32-m256", "k3-f32-m232", "k3-bf16-m512", "k2-f32-m190", "k2-bf16-m700"])
def test_sliced_launches_match_plain(wrapper, dtype, m, slices):
    """Above the shared-memory limit the card path launches K2/K3 once per
    subspace slice, accumulating: driven with the plain per-slice scan it
    gives the whole-m plain version's scores within rtol/atol 1e-4 (the
    sums are grouped by slice)."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = make_problem(m, 3, m, 70)
    lut, codes = torch.as_tensor(lut).to(dtype), torch.as_tensor(codes)
    width = adc_scan.slice_width(m, 256, lut.element_size(), fn)
    if fn is adc_scan.adc_scan_nibble:
        assert width % 8 == 0
    out = torch.full((3, 70), float("nan"))
    assert adc_scan.run_slices(m, width, pair_plain_slice(lut, codes, out)) == slices
    torch.testing.assert_close(out, adc_scan.adc_scan_plain(lut, codes), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wrapper,itemsize,largest", [
    ("adc_scan_nibble", 4, 224), ("adc_scan_nibble", 2, 448), ("adc_scan", 4, 181),
    ("adc_scan", 2, 302)])
def test_slice_width_follows_the_shared_memory_limit(wrapper, itemsize, largest):
    """A slice is the whole m up to the largest m whose block fits, and that
    largest width (a multiple of 8 for K3) above it."""
    fn = getattr(adc_scan, wrapper)
    step = 8 if fn is adc_scan.adc_scan_nibble else 1
    assert adc_scan.slice_width(largest, 256, itemsize, fn) == largest
    assert adc_scan.slice_width(largest + step, 256, itemsize, fn) == largest
    assert adc_scan.slice_width(4096, 256, itemsize, fn) == largest
    assert adc_scan.slice_width(8, 256, itemsize, fn) == 8
