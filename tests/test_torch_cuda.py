"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same inputs.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a card machine without
jax; ``tests/conftest.py`` imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels at the main path's widths; these cases
add the ragged ones. The flat scan (K1): rows that are no multiple of 16
bytes (element loads instead of 16-byte loads), a capacity that is no
multiple of the kernel's 256-row tile, empty and full lists, -1 ids, and
list sizes either side of its row batch, step and tile.
The ADC scans (K2, K3): list lengths of 1, of one row either side of a
128-row boundary and past the 256-row tile, m that is no power of two,
both LUT dtypes, and a code buffer that starts off a 16-byte boundary.
K3 over the probed lists (``adc_scan_lists``): list sizes either side of
its 256-thread row step and its 1024-row block, empty and full lists, a
capacity that is no multiple of 4, -1 ids, lists probed twice, g up to 4,
lists read in 8-byte words, and m in subspace slices.
The shared-list ADC scan (K4): list lengths either side of its 1024-row
tile, query counts either side of its 32-query group, m from 4 to 64 in
both LUT dtypes, code buffers at odd byte offsets. All three ADC scans at
the shared-memory edge of m and above it, where the wrapper launches the
kernel once per subspace slice. Then whole indexes on the card against
the CPU: IVF-Flat, IVF-PQ, flat PQ (K4), OPQ in front of flat PQ, PCA in
front of IVF-SQfp16 (K1), and flat PQ128 and IVF16,PQ256 at d = 768.
Then the host-side surface on the card: an ``hnswsq`` index (host C++
graph, exact rerank on the card) serves the CPU's ids, and an ``ivfsq``
server on the card answers a negotiated (binary wire) client and a
pickle-only client with the same results, its searches launching K1.
Last, tombstoned lists: K1 and K3 over lists in which whole 256-row tiles
are -1, the flat-PQ path (K4) with a chunk of the list that is wholly -1,
and indexes compacted to capacities that are no multiple of 256, each
against the plain versions or the CPU. Then replication: an ``ivfsq`` and
a ``knnlm`` snapshot moved from one card engine to another (served through
K1 and K3 over the lists with the donor's ids), and a delta heal between
two card ranks of one group in one process (equal digests, K1 launched).
Last, the captured search programs (``utils/programs.py``): each kernel's
path, the exact flat scan and a 4-shard masked mesh replayed against
``programs.eager()`` for one block and for a window of blocks, a doctored
host sync refused at capture, a capture while another index serves from
another thread, an add that reallocates the lists, deletes read by a
replay, and a steady scheduler window's syncs under DFT_XFERCHECK=1.
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


# list sizes at the flat scan's edges: empty, one row, either side of a
# warp's 8-row batch (fp16 rows at d = 128) and of a block's 64-row step
# and 256-row tile, one short of the capacity, full
EDGE_SIZES = (0, 1, 7, 8, 9, 63, 64, 65, 255, 256, 257, 600, 601)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("codec", ["f32", "f16", "sq8"])
def test_flat_scan_kernel_at_row_edges(card, codec, d):
    """Lists whose sizes sit at the kernel's row edges, in a capacity of
    601 rows (no multiple of the tile, nor of the 16-byte -inf stores),
    probed 4 at a time: identical -inf masks, scores within rtol/atol
    1e-4."""
    nlist, cap, g = len(EDGE_SIZES), 601, 4
    q, data, ids, _, _, norms, vmin, span = flat_scan_inputs(
        d + len(codec), codec, "l2", True, d, nq=5, nlist=nlist, cap=cap, g=g)
    li = (torch.arange(5 * g, dtype=torch.int32) % nlist).reshape(5, g)
    sizes_g = torch.as_tensor(EDGE_SIZES, dtype=torch.int32)[li.long()]
    args = [None if a is None else a.to(card)
            for a in (q, data, ids, li, sizes_g, norms, vmin, span)]
    before = flat_scan.flat_list_scan.launches
    got = flat_scan.flat_list_scan(*args, metric="l2", codec=codec)
    torch.cuda.synchronize()
    assert flat_scan.flat_list_scan.launches == before + 1
    want = flat_scan.flat_list_scan_plain(*args, metric="l2", codec=codec)
    assert_scores_match(got, want, 1e-4, 1e-4)


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


# list sizes at K3's edges over the lists: empty, one row, either side of
# a block's 256-thread step and of its 1024 rows, one short of the
# capacity (no multiple of 4), full
LIST_EDGE_SIZES = (0, 1, 255, 256, 257, 1023, 1024, 1025, 1500, 1501)


def lists_inputs(seed, nq, g, m, lut_dtype, sizes=LIST_EDGE_SIZES):
    """adc_scan_lists arguments on the CPU: every list probed, the first
    twice by query 0 when g > 1; about 5% of the ids -1."""
    rng = np.random.default_rng(seed)
    nlist, cap = len(sizes), max(sizes)
    lut = torch.as_tensor(rng.standard_normal((nq * g, m, 256)).astype(np.float32))
    list_codes = torch.as_tensor(rng.integers(0, 256, (nlist, cap, m)).astype(np.uint8))
    ids = rng.integers(0, 1 << 20, (nlist, cap)).astype(np.int32)
    ids[rng.random((nlist, cap)) < 0.05] = -1
    li = (np.arange(nq * g) % nlist).astype(np.int32).reshape(nq, g)
    if g > 1:
        li[0, 1] = li[0, 0]
    sizes_g = np.asarray(sizes, np.int32)[li]
    return (lut.to(lut_dtype), list_codes, torch.as_tensor(li), torch.as_tensor(sizes_g),
            torch.as_tensor(ids))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [8, 64])
def test_adc_lists_kernel_matches_plain(card, m, lut_dtype, g):
    """K3 over the probed lists against its plain version (gather + scan +
    mask): identical -inf masks, scores within rtol/atol 1e-4. One launch,
    counted by the entry and by K3."""
    args = [t.to(card) for t in lists_inputs(m + g, 12, g, m, lut_dtype)]
    before = (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches)
    got = adc_scan.adc_scan_lists(*args)
    torch.cuda.synchronize()
    assert (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (12, g, max(LIST_EDGE_SIZES))
    assert_scores_match(got, adc_scan.adc_scan_lists_plain(*args), 1e-4, 1e-4)


@pytest.mark.parametrize("lut_dtype,m,slices", [(torch.float32, 232, 2),
                                                (torch.float32, 256, 2),
                                                (torch.bfloat16, 456, 2)],
                         ids=["f32-m232", "f32-m256", "bf16-m456"])
def test_adc_lists_kernel_in_subspace_slices(card, lut_dtype, m, slices):
    """Above the shared-memory limit the lists entry launches K3 once per
    slice (the 8-subspace tail slices read 8-byte words); the later slices
    add to the live rows only: the plain version's masks and scores."""
    args = [t.to(card) for t in lists_inputs(m, 3, 2, m, lut_dtype, (0, 1, 300, 1025, 1100))]
    before = adc_scan.adc_scan_lists.launches
    got = adc_scan.adc_scan_lists(*args)
    torch.cuda.synchronize()
    assert adc_scan.adc_scan_lists.slices == slices
    assert adc_scan.adc_scan_lists.launches == before + slices
    assert_scores_match(got, adc_scan.adc_scan_lists_plain(*args), 1e-4, 1e-4)


def test_adc_lists_reads_8_byte_aligned_lists(card):
    """Lists that start 8 bytes past a 16-byte boundary are read in 8-byte
    words: the same scores."""
    lut, codes, li, sizes_g, ids = [t.to(card) for t in
                                    lists_inputs(8, 4, 3, 64, torch.float32)]
    raw = torch.zeros(codes.numel() + 8, dtype=torch.uint8, device=card)
    raw[8:] = codes.reshape(-1)
    shifted = raw[8:].view(codes.shape)
    assert shifted.data_ptr() % 16 == 8
    got = adc_scan.adc_scan_lists(lut, shifted, li, sizes_g, ids)
    assert_scores_match(got, adc_scan.adc_scan_lists_plain(lut, codes, li, sizes_g, ids),
                        1e-4, 1e-4)


def test_adc_lists_refuses_bad_inputs(card):
    """Device, dtype, shape, contiguity, alignment and geometry are checked
    before the kernel gets a pointer; nothing launches when they fail."""
    lut, codes, li, sizes_g, ids = [t.to(card) for t in
                                    lists_inputs(0, 4, 2, 8, torch.float32, (0, 5, 64))]
    raw = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=card)
    before = (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches)
    cases = [
        ((lut.half(), codes, li, sizes_g, ids), "must be torch.float32 or torch.bfloat16"),
        ((lut, codes.int(), li, sizes_g, ids), "must be torch.uint8"),
        ((lut, codes, li.long(), sizes_g, ids), "must be torch.int32"),
        ((lut, codes, li, sizes_g, ids.t().contiguous().t()), "contiguous"),
        ((lut, codes, li, sizes_g.cpu(), ids), "is on cpu"),
        ((lut[:4].contiguous(), codes, li, sizes_g, ids), "shape"),
        ((lut[:, :4].contiguous(), codes[:, :, :4].contiguous(), li, sizes_g, ids),
         "m % 8 == 0"),
        ((lut, raw[1:].view(codes.shape), li, sizes_g, ids), "8-byte aligned"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            adc_scan.adc_scan_lists(*args)
    assert (adc_scan.adc_scan_lists.launches, adc_scan.adc_scan_nibble.launches) == before


# (wrapper, LUT dtype, m, slices): the largest m whose LUT fits a block's
# shared memory (one slice) and m above it (several subspace slices)
SMEM_EDGES = [("adc_scan_nibble", torch.float32, 224, 1),
              ("adc_scan_nibble", torch.float32, 232, 2),
              ("adc_scan_nibble", torch.float32, 256, 2),
              ("adc_scan_nibble", torch.bfloat16, 448, 1),
              ("adc_scan_nibble", torch.bfloat16, 456, 2),
              ("adc_scan", torch.float32, 181, 1), ("adc_scan", torch.float32, 190, 2),
              ("adc_scan", torch.bfloat16, 302, 1)]


@pytest.mark.parametrize("wrapper,lut_dtype,m,slices", SMEM_EDGES,
                         ids=[f"{w}-{str(t)[6:]}-m{m}" for w, t, m, _ in SMEM_EDGES])
def test_adc_kernel_at_the_shared_memory_limit(card, wrapper, lut_dtype, m, slices):
    """At the largest m whose staged LUT fits Hopper's 227 KB a block the
    kernel runs once; above it the wrapper launches it once per subspace
    slice, accumulating. Either way the scores agree with the plain
    version within rtol/atol 1e-4."""
    fn = getattr(adc_scan, wrapper)
    lut, codes = [t.to(card) for t in adc_inputs(m, 3, 300, m, lut_dtype)]
    before = fn.launches
    got = fn(lut, codes)
    torch.cuda.synchronize()
    assert fn.slices == slices and fn.launches == before + slices
    torch.testing.assert_close(got.cpu(), adc_scan.adc_scan_plain(lut, codes).cpu(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric,m,kw", [("l2", 8, {"use_pallas": True, "adc_lut_bf16": True,
                                                    "refine_k_factor": 4}),
                                         ("dot", 8, {}), ("l2", 4, {})])
def test_ivf_pq_on_card_matches_cpu(card, metric, m, kw):
    """The same IVF-PQ state served on the card (through K2, or K3 over the
    probed lists) and on the CPU (through the plain versions): same ids,
    distances within 1e-3."""
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


@pytest.mark.parametrize("lut_dtype,m", [(torch.float32, 75), (torch.float32, 76),
                                         (torch.float32, 112), (torch.float32, 113),
                                         (torch.float32, 128), (torch.bfloat16, 112),
                                         (torch.bfloat16, 149), (torch.bfloat16, 150)],
                         ids=["f32-m75", "f32-m76", "f32-m112", "f32-m113", "f32-m128",
                              "bf16-m112", "bf16-m149", "bf16-m150"])
def test_adc_shared_kernel_at_the_shared_memory_limit(card, lut_dtype, m):
    """Up to the widest slice whose two LUT buffers and code tile fit
    Hopper's 227 KB a block (m = 75 f32, 112 bf16) K4 runs once; above it the wrapper launches it once per subspace
    slice, each adding to the scores the previous left. The scores equal
    the plain version's bit for bit (the same fp32 adds in subspace
    order). m = 113 and 128 with an f32 LUT were refused before the
    slices."""
    lut, codes = [t.to(card) for t in shared_inputs(m, 3, 1500, m, lut_dtype)]
    width = adc_scan.slice_width(m, 256, lut.element_size(), adc_scan.adc_scan_shared)
    before = adc_scan.adc_scan_shared.launches
    got = adc_scan.adc_scan_shared(lut, codes)
    torch.cuda.synchronize()
    slices = -(-m // width)
    assert adc_scan.adc_scan_shared.slices == slices
    assert adc_scan.adc_scan_shared.launches == before + slices
    if m in (76, 113, 128, 150):
        assert slices > 1
    assert torch.equal(got.cpu(), adc_scan.adc_scan_shared_plain(lut, codes).cpu())


@pytest.mark.parametrize("offset", [1, 7, 13])
def test_adc_shared_reads_odd_offsets(card, offset):
    """A code buffer at an odd byte offset with m = 12 (rows never 4-byte
    aligned), over two tiles of rows and two query groups: bit-exact."""
    lut, codes = [t.to(card) for t in shared_inputs(offset, 40, 2100, 12, torch.float32)]
    raw = torch.zeros(codes.numel() + offset, dtype=torch.uint8, device=card)
    raw[offset:] = codes.reshape(-1)
    shifted = raw[offset:].view(codes.shape)
    assert shifted.data_ptr() % 16 == offset
    got = adc_scan.adc_scan_shared(lut, shifted)
    assert torch.equal(got.cpu(), adc_scan.adc_scan_shared_plain(lut, codes).cpu())


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


@pytest.mark.parametrize("spec,wrapper", [("PQ128", "adc_scan_shared"),
                                          ("IVF16,PQ256", "adc_scan_nibble")])
def test_wide_pq_index_on_card_matches_cpu(card, spec, wrapper):
    """PQ widths whose f32 LUT is wider than a block's shared memory, at
    d = 768: trained on the CPU, served on the card from its state through
    several subspace slices of the path's kernel: the CPU's ids, distances
    within 1e-3."""
    rng = np.random.default_rng(5)
    d = 768
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 16, 2000)] + rng.standard_normal((2000, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, 30)] + rng.standard_normal((30, d)).astype(np.float32)
    cpu = factory.build_index(IndexCfg(faiss_factory=spec, dim=d, metric="l2",
                                       kmeans_iters=4), device="cpu")
    cpu.train(x[:1000])
    cpu.add(x)
    cpu.set_nprobe(4)
    on_card = factory.index_from_state_dict(cpu.state_dict(), device=card)
    fn = getattr(adc_scan, wrapper)
    before = fn.launches
    d_card, i_card = on_card.search(q, 10)
    assert fn.launches > before and fn.slices > 1
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)


def test_hnswsq_on_card_matches_cpu(card, monkeypatch):
    """The hnswsq builder's index built on the CPU (graph on one thread),
    served on the card from its state: the graph walk is the same host code
    and the exact rerank runs on the card, so the ids are the CPU's and the
    distances within 1e-3. No kernel of the port launches."""
    from distributed_faiss_tpu_torch.models.hnsw import HNSWSQIndex

    monkeypatch.setenv("DFT_HNSW_THREADS", "1")
    x, q = correlated_corpus(6)
    cpu = factory.build_index(IndexCfg(index_builder_type="hnswsq", dim=32, metric="l2",
                                       store_n=16), device="cpu")
    cpu.train(x)
    cpu.add(x)
    cpu.set_nprobe(64)
    on_card = factory.index_from_state_dict(cpu.state_dict(), device=card)
    assert isinstance(on_card, HNSWSQIndex) and on_card._refine.data.is_cuda
    counts = [fn.launches for fn in (flat_scan.flat_list_scan, adc_scan.adc_scan,
                                     adc_scan.adc_scan_nibble, adc_scan.adc_scan_shared)]
    d_card, i_card = on_card.search(q, 10)
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)
    assert counts == [fn.launches for fn in (flat_scan.flat_list_scan, adc_scan.adc_scan,
                                             adc_scan.adc_scan_nibble,
                                             adc_scan.adc_scan_shared)]


def test_negotiated_search_matches_pickle_on_a_card_server(card, tmp_path):
    """An ivfsq index served from the card: a negotiated client (binary
    skeletons after the first reply) and a wire_binary=False client get the
    same ids and distances, and the searches launched K1."""
    import threading
    import time

    from distributed_faiss_tpu_torch.parallel import rpc
    from distributed_faiss_tpu_torch.parallel.server import IndexServer
    from distributed_faiss_tpu_torch.utils.state import IndexState

    x, q = correlated_corpus(7, n=4000)
    srv = IndexServer(0, str(tmp_path), device=card)
    port = srv.bind(0)
    thread = threading.Thread(target=srv.start_blocking, daemon=True)
    thread.start()
    binary = rpc.Client(0, "localhost", port)
    pickled = rpc.Client(1, "localhost", port, wire_binary=False)
    try:
        cfg = IndexCfg(index_builder_type="ivfsq", dim=32, metric="l2", train_num=2000,
                       centroids=16, nprobe=4)
        assert binary.create_index("w", cfg)
        binary.add_index_data("w", x, list(range(x.shape[0])))
        deadline = time.time() + 120
        while not (binary.get_state("w") == IndexState.TRAINED
                   and binary.get_aggregated_ntotal("w") == 0
                   and binary.get_ntotal("w") == x.shape[0]):
            assert time.time() < deadline, "index not built"
            time.sleep(0.1)
        before = flat_scan.flat_list_scan.launches
        first = binary.search("w", q, 10)
        got = binary.search("w", q, 10)
        want = pickled.search("w", q, 10)
        assert flat_scan.flat_list_scan.launches > before
        assert binary.rpc_stats()["peer_wire"] is True
        assert pickled.rpc_stats()["peer_wire"] is False
        assert got[1] == want[1] == first[1]
        np.testing.assert_array_equal(got[0], want[0])
    finally:
        binary.close()
        pickled.close()
        srv.stop()
        thread.join(10)


# (list, first row, last row) of each wholly dead 256-row tile, in lists of
# 1000 rows: the first tile, a middle one, the last partial one, and all of
# list 3
DEAD_TILES = [(0, 0, 256), (1, 256, 512), (2, 768, 1000), (3, 0, 1000)]


def _kill_tiles(ids: torch.Tensor) -> torch.Tensor:
    ids = ids.clone()
    for lst, lo, hi in DEAD_TILES:
        ids[lst, lo:hi] = -1
    return ids


@pytest.mark.parametrize("codec", ["f16", "sq8"])
def test_flat_scan_over_dead_tiles(card, codec):
    """K1 over full lists of 1000 rows in which whole 256-row tiles (and one
    whole list) are tombstones: identical -inf masks, scores within
    rtol/atol 1e-4. The dead tiles are still scanned (the kernel's early
    exit keys on the list size), only masked."""
    q, data, ids, _, _, norms, vmin, span = flat_scan_inputs(
        11, codec, "l2", True, 128, nq=6, nlist=5, cap=1000, g=4)
    ids = _kill_tiles(ids)
    li = torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0], [4, 4, 3, 1], [1, 3, 0, 2], [2, 4, 0, 3],
                       [3, 3, 3, 3]], dtype=torch.int32)
    sizes_g = torch.full(li.shape, 1000, dtype=torch.int32)
    args = [None if a is None else a.to(card)
            for a in (q, data, ids, li, sizes_g, norms, vmin, span)]
    got = flat_scan.flat_list_scan(*args, metric="l2", codec=codec)
    want = flat_scan.flat_list_scan_plain(*args, metric="l2", codec=codec)
    assert_scores_match(got, want, 1e-4, 1e-4)
    assert torch.isneginf(got[5]).all()  # every probe of query 5 is list 3


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adc_lists_over_dead_tiles(card, lut_dtype):
    """K3 over the probed lists when whole 256-row tiles of them are
    tombstones: identical -inf masks, scores within rtol/atol 1e-4."""
    lut, codes, _, _, ids = lists_inputs(12, 6, 4, 64, lut_dtype, sizes=(1000,) * 5)
    ids = _kill_tiles(ids)
    li = torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0], [4, 4, 3, 1], [1, 3, 0, 2], [2, 4, 0, 3],
                       [3, 3, 3, 3]], dtype=torch.int32)
    sizes_g = torch.full(li.shape, 1000, dtype=torch.int32)
    args = [t.to(card) for t in (lut, codes, li, sizes_g, ids)]
    got = adc_scan.adc_scan_lists(*args)
    assert_scores_match(got, adc_scan.adc_scan_lists_plain(*args), 1e-4, 1e-4)
    assert torch.isneginf(got[5]).all()


def _mutated(cpu_index, dead, device):
    """The CPU index's state on ``device`` with the same rows removed from
    both."""
    on = factory.index_from_state_dict(cpu_index.state_dict(), device=device)
    on.set_nprobe(cpu_index.nprobe)
    cpu_index.remove_rows(dead)
    on.remove_rows(dead)
    return on


def test_flat_pq_path_with_a_dead_chunk(card, monkeypatch):
    """Flat PQ on the card with 512-row chunks, one of which is wholly
    deleted, and every 5th row deleted besides: the CPU's ids, distances
    within 1e-3; K4 launched on every chunk, the dead one included."""
    from distributed_faiss_tpu_torch.models import ivf

    monkeypatch.setattr(ivf, "shared_chunk_rows", lambda nb: 512)
    x, q = correlated_corpus(8)
    cpu = factory.build_index(IndexCfg(faiss_factory="PQ8", dim=32, metric="l2"), device="cpu")
    cpu.train(x[:2000])
    cpu.add(x)
    dead = np.union1d(np.arange(512, 1024), np.arange(0, 3000, 5))
    on_card = _mutated(cpu, dead, card)
    on_card.search(q, 10)  # captures the program: its warm-up launches count too
    before = adc_scan.adc_scan_shared.launches
    d_card, i_card = on_card.search(q, 10)  # one replay
    assert adc_scan.adc_scan_shared.launches - before == -(-3000 // 512)
    d_cpu, i_cpu = cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)
    assert not np.intersect1d(i_card, dead).size


@pytest.mark.parametrize("spec", ["IVF16,SQfp16", "IVF16,SQ8", "IVF16,PQ8", "IVF16,PQ4"])
def test_compacted_index_on_card_matches_plain(card, spec):
    """An index with 60% of its rows deleted, compacted: its lists come back
    at a capacity that is no multiple of 256. On the card against the CPU
    (same ids, distances within 1e-3), and the path's kernel on the
    compacted lists against its plain version (identical -inf masks,
    scores within rtol/atol 1e-4)."""
    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.mutation.compaction import compact_state

    x, q = correlated_corpus(9)
    cpu = factory.build_index(IndexCfg(faiss_factory=spec, dim=32, metric="l2",
                                       kmeans_iters=4), device="cpu")
    cpu.train(x[:2000])
    cpu.add(x)
    cpu.set_nprobe(4)
    keep = np.random.default_rng(9).random(3000) >= 0.6
    state = compact_state(cpu.state_dict(), keep)
    small_cpu = factory.index_from_state_dict(state, device="cpu")
    small = factory.index_from_state_dict(state, device=card)
    assert small.lists.cap % 256 != 0 and small.ntotal == keep.sum()
    d_card, i_card = small.search(q, 10)
    d_cpu, i_cpu = small_cpu.search(q, 10)
    np.testing.assert_array_equal(i_card, i_cpu)
    np.testing.assert_allclose(d_card, d_cpu, rtol=1e-3, atol=1e-3)
    qt = torch.as_tensor(q[:32], device=card)
    nprobe, _, g = small._search_plan()
    li = ivf._probe_groups(small.centroids, qt, nprobe, g, "l2")[0].contiguous()
    sizes = small.lists.sizes[li.long()].contiguous()
    if isinstance(small, IVFFlatIndex):
        opts = small._scan_options()
        args = (qt, small.lists.data, small.lists.ids, li, sizes, opts["list_norms"],
                opts.get("vmin"), opts.get("span"))
        kw = dict(metric="l2", codec=small.codec)
        got = flat_scan.flat_list_scan(*args, **kw)
        want = flat_scan.flat_list_scan_plain(*args, **kw)
    else:
        lut, codes = ivf._pq_group_inputs(small.centroids, small.codebooks, small.lists.data,
                                          qt, li, "l2", small.lut_bf16)
        if adc_scan.nibble_supported(small.m, 256):
            args = (lut, small.lists.data, li, sizes, small.lists.ids)
            got = adc_scan.adc_scan_lists(*args)
            want = adc_scan.adc_scan_lists_plain(*args)
        else:
            got = adc_scan.adc_scan(lut, codes)
            want = adc_scan.adc_scan_plain(lut, codes)
    assert_scores_match(got, want, 1e-4, 1e-4)


# ------------------------------------------------------------ replication


def _card_engine(storage, kind, device, **kw):
    from distributed_faiss_tpu_torch.engine import Index

    cfg = IndexCfg(index_builder_type=kind, dim=32, metric="l2", train_num=2000,
                   centroids=16, nprobe=4, index_storage_dir=storage, **kw)
    return Index(cfg, device)


def _wait_drained(e, n, timeout=120.0):
    import time

    from distributed_faiss_tpu_torch.utils.state import IndexState

    deadline = time.time() + timeout
    while not (e.get_state() == IndexState.TRAINED and e.get_idx_data_num() == (0, n)):
        assert time.time() < deadline, "engine never drained"
        time.sleep(0.05)


@pytest.mark.parametrize("kind,kw,wrapper", [
    ("ivfsq", {}, flat_scan.flat_list_scan),
    ("knnlm", {"code_size": 8}, adc_scan.adc_scan_lists)])
def test_snapshot_moves_between_card_engines(card, tmp_path, monkeypatch, kind, kw, wrapper):
    """A card engine exports a snapshot after a few deletes; a fresh card
    engine imports it (a generation committed in its own dir) and serves the
    donor's ids through the same kernel (K1, or K3 over the lists)."""
    from distributed_faiss_tpu_torch.engine import Index

    monkeypatch.setenv("DFT_COMPACT", "0")
    x, q = correlated_corpus(11, n=4000)
    donor = _card_engine(str(tmp_path / "donor"), kind, card, **kw)
    donor.add_batch(x, [(i,) for i in range(x.shape[0])], train_async_if_triggered=False)
    _wait_drained(donor, x.shape[0])
    donor.remove_ids(list(range(0, 4000, 9)))
    got = Index.import_snapshot(donor.export_snapshot(), str(tmp_path / "joined"), device=card)
    try:
        _wait_drained(got, x.shape[0])
        want = donor.search(q, 10)
        before = wrapper.launches
        res = got.search(q, 10)
        assert wrapper.launches > before
        assert res[1] == want[1]
        np.testing.assert_allclose(res[0], want[0], rtol=1e-5, atol=1e-5)
        assert got.replica_digest() == donor.replica_digest()
        assert got.current_generation() >= 1 and str(got.device).startswith("cuda")
    finally:
        got.retire()
        donor.retire()


def test_delta_heal_between_two_card_ranks(card, tmp_path, monkeypatch):
    """Two card ranks of one group in one process: the empty one joins by a
    full transfer, then rows and deletes land on the other only and its
    sweep pulls them as a delta; the digests end equal, no deleted id is
    served, and the healed rank's searches launch K1."""
    import socket
    import threading

    from distributed_faiss_tpu_torch.parallel.server import IndexServer
    from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg

    monkeypatch.setenv("DFT_COMPACT", "0")
    monkeypatch.setenv("DFT_SHARD_GROUP", "0")
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("", 0))
        ports.append(s.getsockname()[1])
        s.close()
    disc = tmp_path / "disc.txt"
    disc.write_text("2\n" + "".join(f"localhost,{p}\n" for p in ports))
    servers = []
    for rank, port in enumerate(ports):
        srv = IndexServer(rank, str(tmp_path / "store"), device=card, discovery_path=str(disc),
                          antientropy_cfg=AntiEntropyCfg(interval_s=600))
        srv.bind(port)
        threading.Thread(target=srv.start_blocking, daemon=True).start()
        servers.append(srv)
    a, b = servers
    try:
        x, q = correlated_corpus(13, n=5000)
        a.create_index("h", IndexCfg(index_builder_type="ivfsq", dim=32, metric="l2",
                                     train_num=2000, centroids=16, nprobe=16))
        a.add_index_data("h", x[:4000], [(i,) for i in range(4000)], False, version=(1, 0, 1))
        _wait_drained(a.indexes["h"], 4000)
        assert any(h.get("full_sync") for h in b._antientropy.sweep_once()["healed"])
        a.add_index_data("h", x[4000:], [(i,) for i in range(4000, 5000)], False,
                         version=(2, 0, 1))
        a.remove_ids("h", list(range(0, 5000, 7)), version=(3, 0, 1))
        _wait_drained(a.indexes["h"], 5000)
        healed = [h for h in b._antientropy.sweep_once()["healed"] if h["index_id"] == "h"]
        assert healed and healed[0]["pulled"] == 1000 - len(range(4004, 5000, 7))
        _wait_drained(b.indexes["h"], 5000 - len(range(4004, 5000, 7)))
        assert b.indexes["h"].replica_digest() == a.indexes["h"].replica_digest()
        before = flat_scan.flat_list_scan.launches
        got = b.search("h", q, 10)
        assert flat_scan.flat_list_scan.launches > before
        served = {m[0] for row in got[1] for m in row if m is not None}
        assert not served & set(range(0, 5000, 7))
        want = a.search("h", q, 10)
        same = sum(set(r1) == set(r2) for r1, r2 in zip(got[1], want[1])) / len(got[1])
        assert same >= 0.95
    finally:
        for srv in servers:
            srv.stop()


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("S", [2, 4])
def test_flat_scan_on_shard_remapped_lists(card, S):
    """K1 on one shard's view of a probe group (``mesh._owned``: local
    slots, size 0 on lists another shard owns) against its plain version:
    identical -inf masks (every non-owned pair wholly -inf), scores within
    1e-4."""
    from distributed_faiss_tpu_torch.parallel import mesh

    q, data, ids, li, _, norms, _, _ = flat_scan_inputs(70 + S, "f32", "l2", True, 128,
                                                         nq=16, nlist=12, cap=300, g=3)
    li = (li * S + 1) % (12 * S)  # global ids over S shards' lists
    sizes_local = torch.as_tensor(np.random.default_rng(S).integers(0, 301, 12).astype(np.int32))
    for s in range(S):
        slot, sizes = mesh._owned(li.to(card), sizes_local.to(card), S, s)
        args = (q.to(card), data.to(card), ids.to(card), slot, sizes, norms.to(card))
        got = flat_scan.flat_list_scan(*args, metric="l2", codec="f32")
        want = flat_scan.flat_list_scan_plain(*args, metric="l2", codec="f32")
        assert_scores_match(got, want, 1e-4, 1e-4)
        assert bool(torch.isneginf(got[(li.to(card) % S) != s]).all())


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
def test_adc_lists_on_shard_remapped_lists(card, lut_dtype):
    """K3 over the lists on each of 4 shards' views of a probe group
    against its plain version (1e-4), non-owned pairs wholly -inf."""
    from distributed_faiss_tpu_torch.parallel import mesh

    rng = np.random.default_rng(77)
    S, nlist_local, cap, m, nq, g = 4, 6, 700, 64, 16, 2
    codes = torch.as_tensor(rng.integers(0, 256, (nlist_local, cap, m)).astype(np.uint8))
    ids = rng.integers(0, 1 << 20, (nlist_local, cap)).astype(np.int32)
    ids[rng.random((nlist_local, cap)) < 0.05] = -1
    sizes_local = torch.as_tensor(rng.integers(0, cap + 1, nlist_local).astype(np.int32))
    li = torch.as_tensor(rng.integers(0, nlist_local * S, (nq, g)).astype(np.int32)).to(card)
    lut = torch.as_tensor(rng.standard_normal((nq * g, m, 256)).astype(np.float32))
    lut = lut.to(lut_dtype).to(card)
    for s in range(S):
        slot, sizes = mesh._owned(li, sizes_local.to(card), S, s)
        args = (lut, codes.to(card), slot, sizes, torch.as_tensor(ids).to(card))
        got = adc_scan.adc_scan_lists(*args)
        want = adc_scan.adc_scan_lists_plain(*args)
        assert_scores_match(got, want, 1e-4, 1e-4)
        assert bool(torch.isneginf(got[(li % S) != s]).all())


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_sharded_ivf_on_the_card_serves_the_cpu_ids(card, kind, monkeypatch):
    """A sharded IVF snapshot restored on 4 virtual shards of the card
    (masked and routed) serves the CPU's ids, launching its kernel on
    every shard."""
    from distributed_faiss_tpu_torch.parallel import mesh

    rng = np.random.default_rng(78)
    d = 64
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 16, 4000)] + rng.standard_normal((4000, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, 40)] + rng.standard_normal((40, d)).astype(np.float32)
    cpu_mesh = mesh.make_mesh(4, device="cpu", virtual=True)
    if kind == "ivf_flat":
        cpu = mesh.ShardedIVFFlatIndex(d, 16, "l2", mesh=cpu_mesh, kmeans_iters=4)
    else:
        cpu = mesh.ShardedIVFPQIndex(d, 16, m=8, mesh=cpu_mesh, kmeans_iters=4, pq_iters=4,
                                     refine_k_factor=4)
    cpu.train(x)
    cpu.add(x)
    cpu.set_nprobe(5)
    want = cpu.search(q, 10)
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    for routing in (False, True):
        state = dict(cpu.state_dict(), probe_routing=routing)
        on_card = type(cpu).from_state_dict(state, device="cuda")
        assert on_card.mesh.size == 4 and on_card.device.type == "cuda"
        got = on_card.search(q, 10)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-3)
        assert (on_card.shard_launches > 0).all()


# ---------------------------------------------------------- the witnesses

def _k1_card_inputs(card, nq=16, g=2, nlist=24, cap=300, d=128):
    q, data, ids, li, sizes, norms = flat_scan_inputs(5, "f16", "l2", True, d, nq=nq,
                                                      nlist=nlist, cap=cap, g=g)[:6]
    return [t.to(card) if t is not None else None for t in (q, data, ids, li, sizes, norms)]


@pytest.mark.parametrize("bad", ["li=nlist", "li=-1", "sizes=cap+1"])
def test_sanitizer_refuses_out_of_bounds_k1_and_k3_before_the_launch(card, monkeypatch, bad):
    """GRAFT_SANITIZE=1: an out-of-range probe never reaches K1 or K3 over
    the lists (no launch counted), and a correct K1 launch right after
    still matches its plain version: the CUDA context is intact."""
    from distributed_faiss_tpu_torch.utils import sanitize

    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    q, data, ids, li, sizes, norms = _k1_card_inputs(card)
    nlist, cap = data.shape[0], data.shape[1]
    lut, codes, li3, sizes3, ids3 = [t.to(card) for t in lists_inputs(6, 16, 2, 8,
                                                                        torch.float32)]
    nlist3, cap3 = codes.shape[0], codes.shape[1]
    edit = {"li=nlist": lambda li, s, n, c: li.fill_(n),
            "li=-1": lambda li, s, n, c: li.fill_(-1),
            "sizes=cap+1": lambda li, s, n, c: s.fill_(c + 1)}[bad]
    before = (flat_scan.flat_list_scan.launches, adc_scan.adc_scan_lists.launches)
    bad_li, bad_sizes = li.clone(), sizes.clone()
    edit(bad_li, bad_sizes, nlist, cap)
    with pytest.raises(sanitize.SanitizeError, match="out of bounds"):
        flat_scan.flat_list_scan(q, data, ids, bad_li, bad_sizes, norms, metric="l2",
                                 codec="f16")
    bad_li3, bad_sizes3 = li3.clone(), sizes3.clone()
    edit(bad_li3, bad_sizes3, nlist3, cap3)
    with pytest.raises(sanitize.SanitizeError, match="out of bounds"):
        adc_scan.adc_scan_lists(lut, codes, bad_li3, bad_sizes3, ids3)
    assert (flat_scan.flat_list_scan.launches, adc_scan.adc_scan_lists.launches) == before
    got = flat_scan.flat_list_scan(q, data, ids, li, sizes, norms, metric="l2", codec="f16")
    torch.cuda.synchronize()
    want = flat_scan.flat_list_scan_plain(q, data, ids, li, sizes, norms, metric="l2",
                                          codec="f16")
    assert_scores_match(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_shared"])
def test_sanitizer_refuses_bad_k2_and_k4_operands_before_the_launch(card, monkeypatch,
                                                                     wrapper):
    """GRAFT_SANITIZE=1: a code past ksub (it would read past a LUT row in
    shared memory) or codes of another width never reach K2 or K4."""
    from distributed_faiss_tpu_torch.utils import sanitize

    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    fn = getattr(adc_scan, wrapper)
    lut = torch.randn(8, 12, 16, device=card)
    codes = torch.randint(0, 16, (8, 40, 12), dtype=torch.uint8, device=card)
    if wrapper == "adc_scan_shared":
        codes = codes[0].contiguous()
    fn(lut, codes)
    torch.cuda.synchronize()
    before = fn.launches
    bad = codes.clone()
    bad.view(-1)[7] = 16
    with pytest.raises(sanitize.SanitizeError, match="out of bounds for ksub 16"):
        fn(lut, bad)
    with pytest.raises(sanitize.SanitizeError, match="codes shape"):
        fn(lut, codes[..., :11].contiguous())
    assert fn.launches == before


def test_doctored_item_under_guarded_raises_on_the_card(card, monkeypatch):
    """DFT_XFERCHECK=1: ``.item()`` on a card tensor inside guarded() raises
    ImplicitTransferError naming the label and this file's line; the same
    call inside explicit() passes and is counted, and so does one on an
    unguarded thread while the guard is armed; the sync debug mode is
    "warn" while armed and back to its old value after."""
    import threading

    from distributed_faiss_tpu_torch.utils import xfercheck

    monkeypatch.setenv("DFT_XFERCHECK", "1")
    xfercheck.reset()
    x = torch.ones(8, device=card)
    mode0 = torch.cuda.get_sync_debug_mode()
    armed, other_done = threading.Event(), threading.Event()
    box = {}

    def unguarded():
        armed.wait(10.0)
        try:
            box["other"] = x.sum().item()
        except BaseException as e:  # pragma: no cover - the failure
            box["other_err"] = e
        other_done.set()

    def guarded():
        try:
            with xfercheck.guarded("doctored"):
                box["mode"] = torch.cuda.get_sync_debug_mode()
                armed.set()
                other_done.wait(10.0)
                with xfercheck.explicit("doctored fetch"):
                    box["explicit"] = x.sum().item()
                x.sum().item()
        except xfercheck.ImplicitTransferError as e:
            box["err"] = str(e)

    ts = [threading.Thread(target=guarded), threading.Thread(target=unguarded)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
        assert not t.is_alive()
    assert box.get("other") == 8.0 and box.get("explicit") == 8.0, box
    assert box["mode"] == 1 and torch.cuda.get_sync_debug_mode() == mode0
    assert "'doctored'" in box["err"] and "test_torch_cuda.py:" in box["err"]
    assert len(xfercheck.drain()) == 1
    assert sum(xfercheck.syncs().values()) == 1
    xfercheck.reset()


# ------------------------------------------------ captured search programs


def _program_index(kind, card):
    """A small index of ``kind`` trained on the CPU, served on the card
    from its state, with the path's kernel wrapper."""
    from distributed_faiss_tpu_torch.parallel import mesh as tmesh

    x, q = correlated_corpus(21, n=3000, nq=40)
    if kind == "mesh":
        cpu = tmesh.ShardedIVFFlatIndex(32, 16, "l2", mesh=tmesh.make_mesh(
            4, device="cpu", virtual=True), kmeans_iters=4)
    elif kind == "flat":
        cpu = factory.build_index(IndexCfg(faiss_factory="Flat", dim=32, metric="l2"),
                                  device="cpu")
    else:
        spec = {"K1": "IVF16,SQfp16", "K2": "IVF16,PQ4", "K3": "IVF16,PQ8,RFlat",
                "K4": "PQ8,RFlat"}[kind]
        cpu = factory.build_index(IndexCfg(faiss_factory=spec, dim=32, metric="l2",
                                           kmeans_iters=4), device="cpu")
    cpu.train(x[:2000])
    cpu.add(x)
    cpu.set_nprobe(4)
    state = cpu.state_dict()
    if kind == "mesh":
        on_card = carry_mesh(state, card)
    else:
        on_card = factory.index_from_state_dict(state, device=card)
    fn = {"K1": flat_scan.flat_list_scan, "mesh": flat_scan.flat_list_scan,
          "K2": adc_scan.adc_scan, "K3": adc_scan.adc_scan_lists,
          "K4": adc_scan.adc_scan_shared, "flat": None}[kind]
    return on_card, fn, x, q


def carry_mesh(state, card):
    """A 4-shard masked IVF-Flat on the card from a CPU index's state."""
    from distributed_faiss_tpu_torch.parallel import mesh as tmesh

    idx = tmesh.ShardedIVFFlatIndex(32, 16, "l2", mesh=tmesh.make_mesh(4, device=card,
                                                                       virtual=True))
    idx.centroids = torch.as_tensor(np.asarray(state["centroids"]), device=card)
    idx.lists = idx._make_lists()
    idx.add(np.asarray(state["rows"], np.float32))
    idx.set_nprobe(4)
    return idx


@pytest.mark.parametrize("kind", ["K1", "K2", "K3", "K4", "flat", "mesh"])
@pytest.mark.parametrize("nq", [20, 29])
def test_graph_replay_matches_eager(card, kind, nq, monkeypatch):
    """Each kernel's path as a captured program (one block, and with 8-query
    blocks a window of 4) against ``programs.eager()``: the same ids, the
    scores within 1e-4, one capture then replays, and each replay adds the
    eager search's launches to the wrapper's count."""
    from distributed_faiss_tpu_torch.models import base
    from distributed_faiss_tpu_torch.utils import programs

    if nq == 29:
        monkeypatch.setattr(base, "MAX_QUERY_BLOCK", 8)
    idx, fn, _, q = _program_index(kind, card)
    q = q[:nq]
    with programs.eager():
        before = fn.launches if fn else 0
        d_eager, i_eager = idx.search(q, 10)
        per_search = (fn.launches - before) if fn else 0
    assert idx.program_stats()["captures"] == 0
    if fn:
        assert per_search > 0
    d1, i1 = idx.search(q, 10)
    before = fn.launches if fn else 0
    d2, i2 = idx.search(q, 10)
    stats = idx.program_stats()
    assert stats["captures"] == 1 and stats["replays"] == 2 and stats["pool_bytes"] > 0
    if fn:
        assert fn.launches - before == per_search
    for d, i in ((d1, i1), (d2, i2)):
        np.testing.assert_array_equal(i, i_eager)
        np.testing.assert_allclose(d, d_eager, rtol=1e-4, atol=1e-4)
    idx.release_programs()
    assert idx.program_stats()["programs"] == 0


def test_a_host_sync_inside_a_program_raises_at_capture(card, monkeypatch):
    """A doctored ``.item()`` in the block program fails its capture, and
    the search raises instead of going on op by op; the context survives
    and the undoctored search then captures and serves."""
    from distributed_faiss_tpu_torch.models import ivf
    from distributed_faiss_tpu_torch.utils import programs

    idx, _, _, q = _program_index("K1", card)
    merge = ivf._merge_group

    def doctored(carry, s, li, list_ids, k):
        s.max().item()
        return merge(carry, s, li, list_ids, k)

    monkeypatch.setattr(ivf, "_merge_group", doctored)
    with pytest.raises(RuntimeError):
        idx.search(q, 10)
    assert idx.program_stats()["replays"] == 0
    monkeypatch.setattr(ivf, "_merge_group", merge)
    with programs.eager():
        want = idx.search(q, 10)
    np.testing.assert_array_equal(idx.search(q, 10)[1], want[1])
    assert idx.program_stats()["replays"] == 1


def test_capture_while_another_index_serves(card):
    """Index B captures program after program (one an nprobe) while index A
    serves from another thread, replaying its own: both answer right."""
    import threading

    a, _, _, qa = _program_index("K3", card)
    b, _, _, qb = _program_index("K1", card)
    want_a = a.search(qa, 10)[1]
    want_b = {}
    from distributed_faiss_tpu_torch.utils import programs
    with programs.eager():
        for nprobe in (1, 2, 4, 8, 16):
            b.set_nprobe(nprobe)
            want_b[nprobe] = b.search(qb, 10)[1]
    stop, errors, served = threading.Event(), [], [0]

    def serve_a():
        try:
            while not stop.is_set():
                np.testing.assert_array_equal(a.search(qa, 10)[1], want_a)
                served[0] += 1
        except BaseException as e:  # pragma: no cover - the failure
            errors.append(e)

    th = threading.Thread(target=serve_a)
    th.start()
    try:
        for nprobe in (1, 2, 4, 8, 16):
            b.set_nprobe(nprobe)
            np.testing.assert_array_equal(b.search(qb, 10)[1], want_b[nprobe])
    finally:
        stop.set()
        th.join(60.0)
    assert not th.is_alive() and not errors, errors
    assert served[0] > 0 and b.program_stats()["captures"] == 5


def test_lists_reallocated_by_an_add_recapture(card):
    """An add that grows the lists changes the program's key: the next
    search captures anew, evicts the stale program and serves the new rows."""
    idx, _, x, q = _program_index("K1", card)
    idx.search(q, 10)
    cap = idx.lists.cap
    rng = np.random.default_rng(22)
    new = np.concatenate([x, x]) + rng.standard_normal((6000, 32)).astype(np.float32) * 0.01
    idx.add(new)
    assert idx.lists.cap > cap
    d, i = idx.search(new[:20], 1)
    stats = idx.program_stats()
    assert stats["captures"] == 2 and stats["evictions"] == 1 and stats["programs"] == 1
    np.testing.assert_array_equal(i[:, 0], 3000 + np.arange(20))


@pytest.mark.parametrize("kind", ["K1", "K3", "K4", "flat"])
def test_a_deleted_id_is_never_served_from_a_replayed_graph(card, kind):
    """Tombstones written in place after the capture: the replay reads them
    (no new capture) and serves none of the deleted ids."""
    idx, _, _, q = _program_index(kind, card)
    if kind == "flat":
        idx.remove_rows(np.asarray([2999]))  # the live mask: allocated once
    _, i = idx.search(q, 10)
    captures = idx.program_stats()["captures"]
    dead = np.unique(i[:, :3])
    idx.remove_rows(dead)
    _, i2 = idx.search(q, 10)
    assert idx.program_stats()["captures"] == captures
    assert not np.isin(i2, dead).any()
    assert (i2 >= 0).all()


def test_steady_scheduler_window_on_the_card(card, monkeypatch):
    """DFT_XFERCHECK=1 with the card's sync debug mode: a warmed window
    through the SearchScheduler captures nothing and syncs only at the
    program's upload and fetch, once each a window."""
    import time

    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.serving.scheduler import SearchScheduler
    from distributed_faiss_tpu_torch.utils import compilecheck, xfercheck
    from distributed_faiss_tpu_torch.utils.config import SchedulerCfg
    from distributed_faiss_tpu_torch.utils.state import IndexState

    monkeypatch.setenv("DFT_COMPACT", "0")
    x, q = correlated_corpus(23)
    eng = Index(IndexCfg(index_builder_type="ivfsq", dim=32, metric="l2", train_num=2000,
                         centroids=16, nprobe=4), device=card)
    sched = None
    compilecheck.reset()
    compilecheck.install()
    try:
        eng.add_batch(x, [(i,) for i in range(x.shape[0])], train_async_if_triggered=False)
        deadline = time.monotonic() + 120
        while not (eng.get_idx_data_num() == (0, x.shape[0])
                   and eng.get_state() == IndexState.TRAINED):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        sched = SearchScheduler(lambda iid, qb, k, emb: eng.search_batched(qb, k, emb),
                                SchedulerCfg(max_batch_rows=16, max_wait_ms=1.0))
        want = sched.submit("i", q[:16], 10, False)[1]
        monkeypatch.setenv("DFT_XFERCHECK", "1")
        xfercheck.reset()
        snap = compilecheck.snapshot()
        for _ in range(4):
            assert sched.submit("i", q[:16], 10, False)[1] == want
        assert not [n for n in compilecheck.new_since(snap) if n.startswith("capture:")]
        assert xfercheck.drain() == []
        sites = xfercheck.syncs()
        assert sorted(s.split(" (")[0] for s in sites) == ["program query upload",
                                                          "program result fetch"], sites
        assert all(n == 4 for n in sites.values()), sites
    finally:
        if sched is not None:
            sched.stop()
        eng.retire()
        compilecheck.uninstall()
        compilecheck.reset()
        xfercheck.reset()


# ------------------------------------------------- routed mesh programs


def _routed_pair(kind, card, monkeypatch, x, nlist=16, nprobe=5, centroids=None):
    """A routed sharded index on 4 CPU shards and its state restored on 4
    virtual shards of the card."""
    from distributed_faiss_tpu_torch.parallel import mesh

    d = x.shape[1]
    cpu_mesh = mesh.make_mesh(4, device="cpu", virtual=True)
    if kind == "ivf_flat":
        cpu = mesh.ShardedIVFFlatIndex(d, nlist, "l2", mesh=cpu_mesh, kmeans_iters=4,
                                       probe_routing=True)
    else:
        cpu = mesh.ShardedIVFPQIndex(d, nlist, m=8 if kind == "ivf_pq" else 4, mesh=cpu_mesh,
                                     kmeans_iters=4, pq_iters=4, refine_k_factor=4,
                                     probe_routing=True)
    if centroids is None:
        cpu.train(x)
    else:
        cpu.centroids = torch.as_tensor(centroids)
        cpu.lists = cpu._make_lists()
    cpu.add(x)
    cpu.set_nprobe(nprobe)
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    on_card = type(cpu).from_state_dict(cpu.state_dict(), device="cuda")
    assert on_card.probe_routing and on_card.mesh.size == 4
    return cpu, on_card


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_pq_k2"])
def test_routed_block_replays_the_eager_answer(card, kind, monkeypatch):
    """A routed block on the card is one captured program: replayed, it
    serves the op-by-op answer, with one upload and one fetch a block under
    DFT_XFERCHECK and no other sync."""
    from distributed_faiss_tpu_torch.utils import programs, xfercheck

    rng = np.random.default_rng(91)
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 16, 4000)] + rng.standard_normal((4000, 64)).astype(np.float32)
    q = centers[rng.integers(0, 16, 40)] + rng.standard_normal((40, 64)).astype(np.float32)
    cpu, idx = _routed_pair(kind, card, monkeypatch, x)
    with programs.eager():
        want = idx.search(q, 10)
    np.testing.assert_array_equal(want[1], cpu.search(q, 10)[1])
    idx.search(q, 10)  # the capture
    monkeypatch.setenv("DFT_XFERCHECK", "1")
    xfercheck.reset()
    try:
        with xfercheck.guarded("routed block"):
            got = idx.search(q, 10)
        assert xfercheck.drain() == []
        sites = xfercheck.syncs()
    finally:
        xfercheck.reset()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    stats = idx.program_stats()
    assert (stats["captures"], stats["replays"]) == (1, 2)
    assert sorted(s.split(" (")[0] for s in sites) == ["program query upload",
                                                      "program result fetch"], sites
    assert all(n == 1 for n in sites.values()), sites
    assert (idx.shard_launches > 0).all()


def test_skewed_routed_index_relaunches_on_the_card(card, monkeypatch):
    """Every row in one list, every probe on shard 0: the first search
    relaunches at grown buckets (a program each) as the CPU index does and
    answers as the exact scan; the next search captures nothing."""
    rng = np.random.default_rng(92)
    d, nlist = 32, 64
    base = rng.standard_normal(d).astype(np.float32)
    cents = base + 60.0 * rng.standard_normal((nlist, d)).astype(np.float32)
    cents[::4] = base + 3.0 * rng.standard_normal((nlist // 4, d)).astype(np.float32)
    cents[0] = base
    x = base + 0.5 * rng.standard_normal((2000, d)).astype(np.float32)
    q = base + 0.5 * rng.standard_normal((300, d)).astype(np.float32)
    cpu, idx = _routed_pair("ivf_flat", card, monkeypatch, x, nlist=nlist, nprobe=8,
                            centroids=cents)
    want = cpu.search(q, 10)
    got = idx.search(q, 10)
    assert idx.launches == cpu.launches > 1 and idx._routed_slack == cpu._routed_slack > 2.0
    captures = idx.program_stats()["captures"]
    assert captures == idx.launches
    np.testing.assert_array_equal(got[1], want[1])
    dist = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    top = np.sort(dist, axis=1)[:, :11]
    ok = (np.diff(top, axis=1) > 1e-5 * top.max(axis=1, keepdims=True)).all(axis=1)
    assert ok.mean() > 0.75
    np.testing.assert_array_equal(got[1][ok], np.argsort(dist, axis=1)[:, :10][ok])
    launches = idx.launches
    np.testing.assert_array_equal(idx.search(q, 10)[1], got[1])
    assert idx.program_stats()["captures"] == captures
    assert idx.launches - launches <= launches


def test_card_captures_are_registered(card, monkeypatch):
    """Every program the search paths capture on the card (one block and
    one window on every model, masked and routed mesh) is a registered
    ``utils/jitreg.py`` row."""
    from distributed_faiss_tpu_torch.utils import compilecheck, jitreg

    x, q = correlated_corpus(93, n=3000, nq=1100)
    compilecheck.reset()
    compilecheck.install()
    try:
        for kind in ("K1", "K3", "K4", "flat", "mesh"):
            idx = _program_index(kind, card)[0]
            idx.search(q[:100], 10)
            idx.search(q, 10)
        for kind in ("ivf_flat", "ivf_pq"):
            idx = _routed_pair(kind, card, monkeypatch, x)[1]
            idx.search(q[:100], 10)
            idx.search(q, 10)
        captured = compilecheck.by_entry()
        assert compilecheck.unregistered() == []
    finally:
        compilecheck.uninstall()
        compilecheck.reset()
    assert {"ivf_flat.block", "ivf_flat.fused", "ivf_pq.block", "pq_shared.block",
            "flat.block", "flat.fused", "sharded_ivf_flat.block", "sharded_ivf_flat.fused",
            "sharded_ivf_flat.routed", "sharded_ivf_pq.routed"} <= set(captured)
    for name, n in captured.items():
        assert n <= jitreg.row_of(name)["budget"], (name, n)


# ------------------------------------------------ the 65,536-list tier


TIER_LISTS = 65_536


@pytest.mark.parametrize("stored", [True, False], ids=["stored", "recomputed"])
def test_flat_scan_sq8_at_d768_over_65536_lists(card, stored):
    """K1's sq8 branch at the tier's width: 65,536 lists of d = 768 uint8
    rows at cap 64 (3.2 GB, so the last lists start past 2**31 bytes),
    sizes from 0 to the cap, about 5% -1 ids, 256 queries x 2 probes with
    the first and the last list among them: identical -inf masks, scores
    within rtol/atol 1e-4 of the plain version."""
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    nlist, cap, d, nq, g = TIER_LISTS, 64, 768, 256, 2
    data = torch.randint(0, 256, (nlist, cap, d), dtype=torch.uint8, device=card, generator=gen)
    ids = torch.arange(nlist * cap, dtype=torch.int32, device=card).reshape(nlist, cap)
    ids[torch.rand((nlist, cap), device=card, generator=gen) < 0.05] = -1
    sizes = torch.randint(0, cap + 1, (nlist,), dtype=torch.int32, device=card, generator=gen)
    sizes[-1] = cap
    vmin = torch.randn(d, device=card, generator=gen)
    span = torch.rand(d, device=card, generator=gen) + 0.5
    # the scan reads the stored norms as they are: any values test it
    norms = (torch.rand((nlist, cap), device=card, generator=gen) * 1e3 if stored else None)
    q = torch.randn((nq, d), device=card, generator=gen)
    li = torch.randint(0, nlist, (nq, g), dtype=torch.int32, device=card, generator=gen)
    li[0, 0], li[1, 0], li[2, 1] = 0, nlist - 1, nlist - 1
    args = (q, data, ids, li, sizes[li.long()].contiguous(), norms, vmin, span)
    before = flat_scan.flat_list_scan.launches
    got = flat_scan.flat_list_scan(*args, metric="l2", codec="sq8")
    torch.cuda.synchronize()
    assert flat_scan.flat_list_scan.launches == before + 1
    want = flat_scan.flat_list_scan_plain(*args, metric="l2", codec="sq8")
    # the last list is full: finite exactly where its ids are live
    assert torch.equal(torch.isfinite(got[1, 0]), ids[nlist - 1] >= 0)
    assert_scores_match(got, want, 1e-4, 1e-4)


def _tier_rows(seed, n=TIER_LISTS + 8_192, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _tier_invariants(cent: np.ndarray, x: np.ndarray):
    """The JAX tier tests' checks: finite, inside the rows' bounding box,
    not collapsed onto one point."""
    assert cent.shape == (TIER_LISTS, x.shape[1]) and np.isfinite(cent).all()
    assert (cent >= x.min(0) - 1e-3).all() and (cent <= x.max(0) + 1e-3).all()
    sample = cent[np.random.default_rng(1).permutation(TIER_LISTS)[:4096]]
    assert np.median(np.linalg.norm(sample[:-1] - sample[1:], axis=1)) > 1e-3


def _mostly_equal(got: np.ndarray, want: np.ndarray):
    """One Lloyd step from the same seeds on the card and on the CPU: the
    same fp32 sums in another order, except where a row sits on a
    distance tie between two centroids and the two argmins part."""
    same = np.abs(got - want).max(1) <= 1e-4
    assert same.mean() >= 0.999, (~same).sum()


def test_kmeans_at_the_65536_tier_on_the_card(card):
    """``ops.kmeans.kmeans`` at 65,536 centroids on the card (the random-
    seed branch, one 2048-row chunk at a time): its Lloyd step from its
    own seeds agrees with the CPU's from the same seeds."""
    from distributed_faiss_tpu_torch.ops import kmeans

    x = _tier_rows(0)
    seeds = kmeans.kmeans(torch.as_tensor(x, device=card), TIER_LISTS, iters=0)
    cent = kmeans.kmeans(torch.as_tensor(x, device=card), TIER_LISTS, iters=1).cpu().numpy()
    _tier_invariants(cent, x)
    chunk = kmeans.auto_chunk(TIER_LISTS)
    assert chunk == 2048
    npad = -(-x.shape[0] // chunk) * chunk
    xp = np.zeros((npad, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    w = (np.arange(npad) < x.shape[0]).astype(np.float32)
    sums, counts = kmeans.accumulate_clusters(
        torch.as_tensor(xp).reshape(-1, chunk, x.shape[1]),
        torch.as_tensor(w).reshape(-1, chunk), seeds.cpu(), TIER_LISTS)
    want = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], seeds.cpu())
    _mostly_equal(cent, want.numpy())


def test_sharded_kmeans_at_the_65536_tier_on_the_card(card):
    """``sharded_kmeans`` at 65,536 centroids on 4 virtual shards of the
    card: the seeds equal the CPU mesh's (numpy draws), and one sharded
    Lloyd step agrees with the CPU's."""
    from distributed_faiss_tpu_torch.parallel import mesh as tmesh

    x = _tier_rows(1)
    on_card = tmesh.make_mesh(4, device="cuda", virtual=True)
    on_cpu = tmesh.make_mesh(4, device="cpu", virtual=True)
    np.testing.assert_array_equal(
        tmesh.sharded_kmeans(on_card, x, TIER_LISTS, iters=0).cpu().numpy(),
        tmesh.sharded_kmeans(on_cpu, x, TIER_LISTS, iters=0).numpy())
    got = tmesh.sharded_kmeans(on_card, x, TIER_LISTS, iters=1).cpu().numpy()
    _tier_invariants(got, x)
    _mostly_equal(got, tmesh.sharded_kmeans(on_cpu, x, TIER_LISTS, iters=1).numpy())


def test_ivf_sq8_at_65536_lists_on_the_card_serves_the_cpu_ids(card):
    """An IVF65536,SQ8 model trained on the CPU (one Lloyd step), moved to
    the card through its state: the card's captured programs serve the
    CPU's top-10 ids on the tie-free queries, launching K1."""
    x = _tier_rows(2)
    rng = np.random.default_rng(3)
    q = x[:64] + 0.01 * rng.standard_normal((64, x.shape[1])).astype(np.float32)
    cpu = IVFFlatIndex(x.shape[1], TIER_LISTS, "l2", "sq8", kmeans_iters=1, device="cpu")
    cpu.train(x)
    cpu.add(x)
    cpu.set_nprobe(64)
    on_card = factory.index_from_state_dict(cpu.state_dict(), device="cuda")
    on_card.set_nprobe(64)
    before = flat_scan.flat_list_scan.launches
    Dg, Ig = on_card.search(q, 11)
    assert flat_scan.flat_list_scan.launches > before
    Dc, Ic = cpu.search(q, 11)
    scale = np.abs(Dc).max(1, keepdims=True)
    ok = (np.diff(Dc, axis=1) > 1e-5 * scale).all(1) & (np.diff(Dg, axis=1) > 1e-5 * scale).all(1)
    assert ok.mean() >= 0.9
    np.testing.assert_array_equal(Ig[ok, :10], Ic[ok, :10])
    np.testing.assert_allclose(Dg[ok, :10], Dc[ok, :10], rtol=1e-3, atol=1e-3)
