"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same inputs.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a card machine without
jax; ``tests/conftest.py`` imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels at the main path's widths; these cases
add the ragged ones. The flat scan (K1): rows that are no multiple of 16
bytes (element loads instead of 16-byte loads), a capacity that is no
multiple of the kernel's 256-row tile, empty and full lists, and -1 ids.
The ADC scans (K2, K3): list lengths of 1, of one row either side of a
128-row boundary and past the 256-row tile, m that is no power of two,
both LUT dtypes, and a code buffer that starts off a 16-byte boundary.
The shared-list ADC scan (K4): list lengths either side of its 1024-row
tile, query counts either side of its 32-query group, m from 4 to 64 in
both LUT dtypes, a code buffer 3 bytes off alignment, and the
shared-memory edge of m. Then whole indexes on the card against the CPU:
IVF-Flat, IVF-PQ, flat PQ (K4), OPQ in front of flat PQ and PCA in front
of IVF-SQfp16 (K1).
"""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu_torch.models import factory
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan
from distributed_faiss_tpu_torch.utils.config import IndexCfg

pytestmark = pytest.mark.cuda

# (codec, metric, stored norms, scan_bf16): every variant of the flat scan
VARIANTS = [(codec, metric, stored, False)
            for codec in ("f32", "f16", "sq8")
            for metric, stored in (("l2", True), ("l2", False), ("dot", False))]
VARIANTS += [(codec, "l2", True, True) for codec in ("f32", "f16", "sq8")]

# 24: 16-byte loads for f32/f16 rows, element loads for sq8; 50: element
# loads for every codec; 128: the main path's width
WIDTHS = (24, 50, 128)


def _vid(v):
    codec, metric, stored, bf16 = v
    return f"{codec}-{metric}{'-stored' if stored else ''}{'-bf16' if bf16 else ''}"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def flat_scan_inputs(seed, codec, metric, stored, d, nq=7, nlist=12, cap=320, g=3):
    """Flat-scan arguments on the CPU, from a numpy seed. List 0 is full,
    list 1 empty, the rest ragged; about 5% of the ids are -1."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    vmin = span = None
    if codec == "sq8":
        data = torch.as_tensor(rng.integers(0, 256, (nlist, cap, d)).astype(np.uint8))
        vmin = torch.as_tensor(rng.standard_normal(d).astype(np.float32))
        span = torch.as_tensor((np.abs(rng.standard_normal(d)) + 0.5).astype(np.float32))
    else:
        data = torch.as_tensor(rng.standard_normal((nlist, cap, d)).astype(np.float32))
        data = data.to(flat_scan.CODECS[codec][1])
    norms = None
    if metric == "l2" and stored:
        decoded = (vmin + data.float() * (span / 255.0)) if codec == "sq8" else data.float()
        norms = (decoded * decoded).sum(-1)
    ids = rng.integers(0, 1 << 20, (nlist, cap)).astype(np.int32)
    ids[rng.random((nlist, cap)) < 0.05] = -1
    sizes = rng.integers(0, cap + 1, (nlist,)).astype(np.int32)
    sizes[0], sizes[1] = cap, 0
    li = rng.integers(0, nlist, (nq, g)).astype(np.int32)
    li[0, :2] = (0, 1)
    return (q, data, torch.as_tensor(ids), torch.as_tensor(li),
            torch.as_tensor(sizes[li]), norms, vmin, span)


def assert_scores_match(got, want, rtol, atol):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want)), "-inf masks differ"
    assert not torch.isnan(got).any()
    f = torch.isfinite(want)
    torch.testing.assert_close(got[f], want[f], rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("variant", VARIANTS, ids=_vid)
def test_flat_scan_kernel_matches_plain(card, variant, d):
    """Identical -inf masks; scores within rtol/atol 1e-4 (5e-2/5e-1 under
    scan_bf16), the tolerances of tests/test_flat_pallas.py. One launch."""
    codec, metric, stored, bf16 = variant
    args = [None if a is None else a.to(card)
            for a in flat_scan_inputs(d, codec, metric, stored, d)]
    kw = dict(metric=metric, codec=codec, scan_bf16=bf16)
    before = flat_scan.flat_list_scan.launches
    got = flat_scan.flat_list_scan(*args, **kw)
    torch.cuda.synchronize()
    assert flat_scan.flat_list_scan.launches == before + 1
    want = flat_scan.flat_list_scan_plain(*args, **kw)
    rtol, atol = (5e-2, 5e-1) if bf16 else (1e-4, 1e-4)
    assert_scores_match(got, want, rtol, atol)


def test_flat_scan_wrapper_refuses_bad_inputs(card):
    """The wrapper checks device, dtype, shape and contiguity before it
    hands pointers to the kernel, and launches nothing when they fail."""
    q, data, ids, li, sizes_g, norms, vmin, span = [
        None if a is None else a.to(card)
        for a in flat_scan_inputs(0, "f16", "l2", True, 24)]
    sq8 = [None if a is None else a.to(card)
           for a in flat_scan_inputs(0, "sq8", "dot", False, 24)]
    before = flat_scan.flat_list_scan.launches
    cases = [
        ((q, data.float(), ids, li, sizes_g, norms), dict(codec="f16"), "must be torch.float16"),
        ((q, data, ids, li.long(), sizes_g, norms), {}, "must be torch.int32"),
        ((q.t().contiguous().t(), data, ids, li, sizes_g, norms), {}, "contiguous"),
        ((q, data, ids, li, sizes_g, norms.cpu()), {}, "is on cpu"),
        ((q, data, ids, li, sizes_g[:, :1].contiguous(), norms), {}, "shape"),
        ((sq8[0], sq8[1], sq8[2], sq8[3], sq8[4]), dict(codec="sq8", metric="dot"),
         "needs vmin and span"),
    ]
    for args, kw, match in cases:
        kw = {"metric": "l2", "codec": "f16", **kw}
        with pytest.raises(ValueError, match=match):
            flat_scan.flat_list_scan(*args, **kw)
    assert flat_scan.flat_list_scan.launches == before


@pytest.mark.parametrize("codec", ["f32", "f16", "sq8"])
def test_ivf_flat_on_card_matches_cpu(card, codec):
    """The same IVF-Flat state served on the card (through the kernel) and
    on the CPU (through the plain version): same ids, distances within
    1e-3 (the JAX package's own bar, models/ivf.py:590-593)."""
    rng = np.random.default_rng(1)
    d, nlist = 32, 16
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nlist, 3000)] + rng.standard_normal((3000, d)).astype(np.float32)
    q = centers[rng.integers(0, nlist, 40)] + rng.standard_normal((40, d)).astype(np.float32)
    cpu = IVFFlatIndex(d, nlist, "l2", codec, kmeans_iters=4, device="cpu")
    cpu.train(x[:1000])
    cpu.add(x)
    cpu.set_nprobe(4)
    on_card = IVFFlatIndex.from_state_dict(cpu.state_dict(), device=card)
    before = flat_scan.flat_list_scan.launches
    d_card, i_card = on_card.search(q, 10)
    assert flat_scan.flat_list_scan.launches > before
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)


def adc_inputs(seed, P, L, m, lut_dtype, ksub=256):
    rng = np.random.default_rng(seed)
    lut = torch.as_tensor(rng.standard_normal((P, m, ksub)).astype(np.float32)).to(lut_dtype)
    codes = torch.as_tensor(rng.integers(0, ksub, (P, L, m)).astype(np.uint8))
    return lut, codes


# (wrapper, m): K2 at m = 4 and 12 (no power of two), K3 at m = 8 and 64
ADC_CASES = [("adc_scan", 4), ("adc_scan", 12), ("adc_scan_nibble", 8),
             ("adc_scan_nibble", 64)]


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [1, 127, 129, 520])
@pytest.mark.parametrize("wrapper,m", ADC_CASES, ids=[f"{w}-m{m}" for w, m in ADC_CASES])
def test_adc_kernel_matches_plain(card, wrapper, m, L, lut_dtype):
    """Scores within rtol/atol 1e-4 (tests/test_adc_pallas.py:46): both sides
    sum the same LUT values in fp32, bf16 tables included. One launch."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = [t.to(card) for t in adc_inputs(L + m, 7, L, m, lut_dtype)]
    before = fn.launches
    got = fn(lut, codes)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = adc_scan.adc_scan_plain(lut, codes)
    assert got.shape == (7, L)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)


def test_adc_k2_reads_an_unaligned_code_buffer(card):
    """K2 stages each tile's bytes with 16-byte loads for the aligned
    interior and byte loads at the ends: a code buffer that starts 3 bytes
    past a 16-byte boundary scores the same."""
    lut, codes = [t.to(card) for t in adc_inputs(3, 5, 300, 12, torch.float32)]
    raw = torch.zeros(codes.numel() + 3, dtype=torch.uint8, device=card)
    raw[3:] = codes.reshape(-1)
    shifted = raw[3:].view(codes.shape)
    assert shifted.data_ptr() % 16 == 3 and shifted.is_contiguous()
    got = adc_scan.adc_scan(lut, shifted)
    torch.testing.assert_close(got.cpu(), adc_scan.adc_scan_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)


def test_adc_wrappers_refuse_bad_inputs(card):
    """Device, dtype, shape, contiguity, alignment and geometry are checked
    before the kernel gets a pointer; nothing launches when they fail."""
    lut, codes = [t.to(card) for t in adc_inputs(0, 4, 64, 8, torch.float32)]
    before = (adc_scan.adc_scan.launches, adc_scan.adc_scan_nibble.launches)
    k2, k3 = adc_scan.adc_scan, adc_scan.adc_scan_nibble
    raw = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=card)
    cases = [
        (k2, (lut.half(), codes), "must be torch.float32 or torch.bfloat16"),
        (k3, (lut, codes.int()), "must be torch.uint8"),
        (k2, (lut, codes.transpose(1, 2).contiguous().transpose(1, 2)), "contiguous"),
        (k2, (lut, codes.cpu()), "is on cpu"),
        (k3, (lut, codes[:, :, :4].contiguous()), "shape"),
        (k3, (lut[:, :4].contiguous(), codes[:, :, :4].contiguous()), "m % 8 == 0"),
        (k3, (lut, raw[1:].view(codes.shape)), "8-byte aligned"),
    ]
    for fn, args, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(*args)
    assert (adc_scan.adc_scan.launches, adc_scan.adc_scan_nibble.launches) == before


# (wrapper, LUT dtype, largest m whose LUT fits a block's shared memory)
SMEM_EDGES = [("adc_scan_nibble", torch.float32, 224), ("adc_scan_nibble", torch.bfloat16, 448),
              ("adc_scan", torch.float32, 181), ("adc_scan", torch.bfloat16, 302)]


@pytest.mark.parametrize("wrapper,lut_dtype,m", SMEM_EDGES,
                         ids=[f"{w}-{str(t)[6:]}-m{m}" for w, t, m in SMEM_EDGES])
def test_adc_kernel_at_the_shared_memory_limit(card, wrapper, lut_dtype, m):
    """At the largest m whose staged LUT fits Hopper's 227 KB a block the
    kernel launches and agrees with the plain version; one step of m above
    it the wrapper refuses before any launch."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = [t.to(card) for t in adc_inputs(m, 3, 300, m, lut_dtype)]
    got = fn(lut, codes)
    torch.testing.assert_close(got.cpu(), adc_scan.adc_scan_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)
    step = 8 if wrapper == "adc_scan_nibble" else 1
    lut, codes = [t.to(card) for t in adc_inputs(m, 3, 300, m + step, lut_dtype)]
    before = fn.launches
    with pytest.raises(ValueError, match="too large for the shared-memory LUT"):
        fn(lut, codes)
    assert fn.launches == before


@pytest.mark.parametrize("metric,m,kw", [("l2", 8, {"use_pallas": True, "adc_lut_bf16": True,
                                                    "refine_k_factor": 4}),
                                         ("dot", 8, {}), ("l2", 4, {})])
def test_ivf_pq_on_card_matches_cpu(card, metric, m, kw):
    """The same IVF-PQ state served on the card (through K2 or K3) and on
    the CPU (through the plain version): same ids, distances within 1e-3."""
    rng = np.random.default_rng(2)
    d, nlist = 32, 16
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, nlist, 3000)] + rng.standard_normal((3000, d)).astype(np.float32)
    q = centers[rng.integers(0, nlist, 40)] + rng.standard_normal((40, d)).astype(np.float32)
    cpu = IVFPQIndex(d, nlist, m=m, metric=metric, kmeans_iters=4, pq_iters=4,
                     device="cpu", **kw)
    cpu.train(x[:1000])
    cpu.add(x)
    cpu.set_nprobe(4)
    on_card = IVFPQIndex.from_state_dict(cpu.state_dict(), device=card)
    fn = adc_scan.adc_scan_nibble if adc_scan.nibble_supported(m, 256) else adc_scan.adc_scan
    before = fn.launches
    d_card, i_card = on_card.search(q, 10)
    assert fn.launches > before
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)


def shared_inputs(seed, nq, L, m, lut_dtype, ksub=256):
    rng = np.random.default_rng(seed)
    lut = torch.as_tensor(rng.standard_normal((nq, m, ksub)).astype(np.float32)).to(lut_dtype)
    codes = torch.as_tensor(rng.integers(0, ksub, (L, m)).astype(np.uint8))
    return lut, codes


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nq,L", [(1, 1), (5, 1023), (33, 1025), (32, 3000)])
@pytest.mark.parametrize("m", [4, 12, 16, 32, 64])
def test_adc_shared_kernel_matches_plain(card, m, nq, L, lut_dtype):
    """K4 against its plain version: scores within rtol/atol 1e-4
    (tests/test_adc_pallas.py:46); both sum the same LUT values in fp32 in
    subspace order. One launch."""
    lut, codes = [t.to(card) for t in shared_inputs(nq * L + m, nq, L, m, lut_dtype)]
    before = adc_scan.adc_scan_shared.launches
    got = adc_scan.adc_scan_shared(lut, codes)
    torch.cuda.synchronize()
    assert adc_scan.adc_scan_shared.launches == before + 1
    assert got.shape == (nq, L)
    torch.testing.assert_close(got.cpu(), adc_scan.adc_scan_shared_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)


def test_adc_shared_reads_an_unaligned_code_buffer(card):
    """A code buffer 3 bytes past a 16-byte boundary (a chunk codes[s:e] at
    m = 12 starts anywhere) scores the same."""
    lut, codes = [t.to(card) for t in shared_inputs(3, 6, 2100, 12, torch.float32)]
    raw = torch.zeros(codes.numel() + 3, dtype=torch.uint8, device=card)
    raw[3:] = codes.reshape(-1)
    shifted = raw[3:].view(codes.shape)
    assert shifted.data_ptr() % 16 == 3 and shifted.is_contiguous()
    torch.testing.assert_close(adc_scan.adc_scan_shared(lut, shifted).cpu(),
                               adc_scan.adc_scan_shared_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)


def test_adc_shared_refuses_bad_inputs(card):
    """Device, dtype, shape and contiguity are checked before the kernel
    gets a pointer; nothing launches when they fail."""
    lut, codes = [t.to(card) for t in shared_inputs(0, 4, 64, 8, torch.float32)]
    before = adc_scan.adc_scan_shared.launches
    cases = [
        ((lut.half(), codes), "must be torch.float32 or torch.bfloat16"),
        ((lut, codes.int()), "must be torch.uint8"),
        ((lut, codes.t().contiguous().t()), "contiguous"),
        ((lut, codes.cpu()), "is on cpu"),
        ((lut, codes[:, :4].contiguous()), "shape"),
        ((lut, codes[None]), "codes 2-d"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            adc_scan.adc_scan_shared(*args)
    assert adc_scan.adc_scan_shared.launches == before


@pytest.mark.parametrize("lut_dtype,m", [(torch.float32, 112), (torch.bfloat16, 149)],
                         ids=["f32-m112", "bf16-m149"])
def test_adc_shared_kernel_at_the_shared_memory_limit(card, lut_dtype, m):
    """At the largest m whose LUT and code tile fit Hopper's 227 KB a block
    K4 launches and agrees with the plain version; at m + 1 the wrapper
    refuses before any launch."""
    lut, codes = [t.to(card) for t in shared_inputs(m, 3, 1500, m, lut_dtype)]
    torch.testing.assert_close(adc_scan.adc_scan_shared(lut, codes).cpu(),
                               adc_scan.adc_scan_shared_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)
    lut, codes = [t.to(card) for t in shared_inputs(m, 3, 1500, m + 1, lut_dtype)]
    before = adc_scan.adc_scan_shared.launches
    with pytest.raises(ValueError, match="too large for the shared-memory LUT"):
        adc_scan.adc_scan_shared(lut, codes)
    assert adc_scan.adc_scan_shared.launches == before


def correlated_corpus(seed, d=32, n=3000, nq=40):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)).astype(np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32) @ a,
            rng.standard_normal((nq, d)).astype(np.float32) @ a)


@pytest.mark.parametrize("spec,launched", [("PQ16,RFlat", "K4"), ("OPQ8,PQ8", "K4"),
                                           ("PCA16,IVF16,SQfp16", "K1")])
def test_factory_index_on_card_matches_cpu(card, spec, launched):
    """A factory index trained on the CPU, served on the card from its
    state: same ids, distances within 1e-3; the path's kernel launched."""
    x, q = correlated_corpus(4)
    cpu = factory.build_index(IndexCfg(faiss_factory=spec, dim=32, metric="l2",
                                       kmeans_iters=4, opq_iters=2), device="cpu")
    cpu.train(x[:2000])
    cpu.add(x)
    cpu.set_nprobe(4)
    on_card = factory.index_from_state_dict(cpu.state_dict(), device=card)
    fn = adc_scan.adc_scan_shared if launched == "K4" else flat_scan.flat_list_scan
    before = fn.launches
    d_card, i_card = on_card.search(q, 10)
    assert fn.launches > before
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)
