"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions on the same inputs.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a card machine without
jax; ``tests/conftest.py`` imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels at the main path's widths; these cases
add the ragged ones: rows that are no multiple of 16 bytes (element loads
instead of 16-byte loads), a capacity that is no multiple of the kernel's
256-row tile, empty and full lists, and -1 ids.
"""

import numpy as np
import pytest
import torch

from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex
from distributed_faiss_tpu_torch.ops import flat_scan

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
