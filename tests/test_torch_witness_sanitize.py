"""GRAFT_SANITIZE=1 in the port (utils/sanitize.py), case for case with
tests/test_sanitize.py, plus the kernel wrappers' pre-launch bounds checks.

The JAX package checks its jitted scans with checkify; the port raises
SanitizeError on a NaN in a search program's float operands or results,
and checks each kernel wrapper's gather bounds and shapes on the host
before any launch. Parity: both packages raise on the same NaN query, and
clean data gives the same ids in both with the knob on and off (the IVF
models carry the JAX centroids into the port, so both scan the same
lists). With the knob off nothing is checked: the wrappers behave as
before, and an out-of-range li reaches the plain version's own IndexError.
The slow case re-runs the port's model and engine suites sanitized.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_faiss_tpu.models.flat import FlatIndex as JFlat
from distributed_faiss_tpu.models.ivf import IVFFlatIndex as JIVFFlat
from distributed_faiss_tpu.models.ivf import IVFPQIndex as JIVFPQ
from distributed_faiss_tpu_torch import interop
from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.ops import adc_scan, flat_scan
from distributed_faiss_tpu_torch.utils import sanitize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("GRAFT_SANITIZE", "1")


def _data(n=400, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((8, d)).astype(np.float32))


def _nan(q):
    qb = q.copy()
    qb[0, 0] = np.nan
    return qb


def test_enabled_reads_env(monkeypatch):
    monkeypatch.delenv("GRAFT_SANITIZE", raising=False)
    assert not sanitize.enabled()
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    assert sanitize.enabled()


def _flat():
    x, q = _data()
    idx = FlatIndex(16, "l2", device="cpu")
    idx.add(x)
    return idx, q


def _ivf_flat():
    x, q = _data()
    idx = IVFFlatIndex(16, 8, "l2", device="cpu")
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(4)
    return idx, q


def _ivf_pq(nlist=8):
    x, q = _data(n=600)
    idx = IVFPQIndex(16, nlist, m=4, device="cpu")
    idx.train(x)
    idx.add(x)
    idx.set_nprobe(4)
    return idx, q


@pytest.mark.parametrize("make", [_flat, _ivf_flat], ids=["flat", "ivf_flat"])
def test_clean_data_matches_unsanitized(sanitized, monkeypatch, make):
    idx, q = make()
    d1, i1 = idx.search(q, 5)
    monkeypatch.setenv("GRAFT_SANITIZE", "0")
    d0, i0 = idx.search(q, 5)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)


@pytest.mark.parametrize("nlist", [8, 1], ids=["ivf_pq", "flat_pq"])
def test_ivf_pq_clean_data_passes(sanitized, nlist):
    idx, q = _ivf_pq(nlist)
    d, i = idx.search(q, 5)
    assert np.isfinite(d).all() and (i >= 0).all()


@pytest.mark.parametrize("make", [_flat, _ivf_flat, _ivf_pq, lambda: _ivf_pq(1)],
                         ids=["flat", "ivf_flat", "ivf_pq", "flat_pq"])
def test_nan_query_raises(sanitized, make):
    idx, q = make()
    with pytest.raises(sanitize.SanitizeError, match="NaN in the operands"):
        idx.search(_nan(q), 5)


def test_nan_result_raises(sanitized):
    def poisoned(x):
        return x * float("nan")

    with pytest.raises(sanitize.SanitizeError, match="NaN in the results of poisoned"):
        sanitize.maybe_checked(poisoned, torch.ones(3))


def test_disabled_is_a_plain_call(monkeypatch):
    monkeypatch.delenv("GRAFT_SANITIZE", raising=False)
    out = sanitize.maybe_checked(lambda x: x * float("nan"), torch.ones(2))
    assert torch.isnan(out).all()


# ------------------------------------------------------------------ parity

def _jax_and_port(kind):
    x, q = _data()
    if kind == "flat":
        ref = JFlat(16, "l2")
        ref.add(x)
    else:
        ref = JIVFFlat(16, 8, "l2")
        ref.train(x)
        ref.add(x)
        ref.set_nprobe(4)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    port.set_nprobe(4)
    return ref, port, q


@pytest.mark.parametrize("kind", ["flat", "ivf_flat"])
def test_both_packages_raise_on_the_same_nan_query(sanitized, kind):
    ref, port, q = _jax_and_port(kind)
    with pytest.raises(Exception, match="(?i)nan"):
        ref.search(_nan(q), 5)
    with pytest.raises(sanitize.SanitizeError, match="NaN"):
        port.search(_nan(q), 5)


@pytest.mark.parametrize("knob", ["1", "0"])
@pytest.mark.parametrize("kind", ["flat", "ivf_flat"])
def test_clean_data_same_ids_in_both_packages(monkeypatch, kind, knob):
    monkeypatch.setenv("GRAFT_SANITIZE", knob)
    ref, port, q = _jax_and_port(kind)
    _, want = ref.search(q, 5)
    _, got = port.search(q, 5)
    np.testing.assert_array_equal(got, want)


def test_jax_ivf_pq_and_port_agree_on_nan(sanitized):
    x, q = _data(n=600)
    ref = JIVFPQ(16, 8, m=4)
    ref.train(x)
    ref.add(x)
    ref.set_nprobe(4)
    port = interop.from_jax_state(ref.state_dict(), device="cpu")
    port.set_nprobe(4)
    with pytest.raises(Exception, match="(?i)nan"):
        ref.search(_nan(q), 5)
    with pytest.raises(sanitize.SanitizeError):
        port.search(_nan(q), 5)


# ------------------------------------------- the wrappers' pre-launch checks

def _k1_inputs(nq=3, g=2, nlist=5, cap=8, d=4):
    g_ = torch.Generator().manual_seed(0)
    q = torch.randn(nq, d, generator=g_)
    data = torch.randn(nlist, cap, d, generator=g_).half()
    ids = torch.arange(nlist * cap, dtype=torch.int32).reshape(nlist, cap)
    li = torch.randint(0, nlist, (nq, g), generator=g_, dtype=torch.int32)
    sizes = torch.full((nq, g), cap, dtype=torch.int32)
    norms = data.float().pow(2).sum(2)
    return q, data, ids, li, sizes, norms


def _k3_inputs(nq=3, g=2, nlist=5, cap=8, m=8):
    g_ = torch.Generator().manual_seed(1)
    lut = torch.randn(nq * g, m, 256, generator=g_)
    codes = torch.randint(0, 256, (nlist, cap, m), generator=g_, dtype=torch.uint8)
    ids = torch.arange(nlist * cap, dtype=torch.int32).reshape(nlist, cap)
    li = torch.randint(0, nlist, (nq, g), generator=g_, dtype=torch.int32)
    sizes = torch.full((nq, g), cap, dtype=torch.int32)
    return lut, codes, li, sizes, ids


def _k1(q, data, ids, li, sizes, norms):
    return flat_scan.flat_list_scan(q, data, ids, li, sizes, norms, metric="l2", codec="f16")


def _k3(lut, codes, li, sizes, ids):
    return adc_scan.adc_scan_lists(lut, codes, li, sizes, ids)


BAD_PROBES = {
    "li = nlist": lambda li, sizes, nlist, cap: (li.fill_(nlist), sizes),
    "li = -1": lambda li, sizes, nlist, cap: (li.fill_(-1), sizes),
    "sizes = cap + 1": lambda li, sizes, nlist, cap: (li, sizes.fill_(cap + 1)),
    "sizes = -1": lambda li, sizes, nlist, cap: (li, sizes.fill_(-1)),
}


@pytest.mark.parametrize("bad", sorted(BAD_PROBES))
def test_k1_probe_out_of_bounds_raises_before_the_scan(sanitized, bad):
    q, data, ids, li, sizes, norms = _k1_inputs()
    li, sizes = BAD_PROBES[bad](li, sizes, 5, 8)
    with pytest.raises(sanitize.SanitizeError, match="out of bounds"):
        _k1(q, data, ids, li, sizes, norms)


@pytest.mark.parametrize("bad", sorted(BAD_PROBES))
def test_k3_lists_probe_out_of_bounds_raises_before_the_scan(sanitized, bad):
    lut, codes, li, sizes, ids = _k3_inputs()
    li, sizes = BAD_PROBES[bad](li, sizes, 5, 8)
    with pytest.raises(sanitize.SanitizeError, match="out of bounds"):
        _k3(lut, codes, li, sizes, ids)


def test_wrappers_refuse_shapes_that_disagree(sanitized):
    q, data, ids, li, sizes, norms = _k1_inputs()
    with pytest.raises(sanitize.SanitizeError, match="sizes_g shape"):
        _k1(q, data, ids, li, sizes[:, :1], norms)
    with pytest.raises(sanitize.SanitizeError, match="list_norms shape"):
        _k1(q, data, ids, li, sizes, norms[:, :3])
    lut, codes, li3, sizes3, ids3 = _k3_inputs()
    with pytest.raises(sanitize.SanitizeError, match="lut shape"):
        _k3(lut[:-1], codes, li3, sizes3, ids3)
    with pytest.raises(sanitize.SanitizeError, match="codes shape"):
        adc_scan.adc_scan(torch.randn(4, 8, 16), torch.zeros(4, 10, 7, dtype=torch.uint8))
    with pytest.raises(sanitize.SanitizeError, match="codes shape"):
        adc_scan.adc_scan_shared(torch.randn(4, 8, 16), torch.zeros(10, 7, dtype=torch.uint8))


@pytest.mark.parametrize("wrapper", ["adc_scan", "adc_scan_shared"])
def test_codes_past_ksub_raise(sanitized, wrapper):
    """ksub = 16: a code of 16 would read past each subspace's LUT row."""
    lut = torch.randn(4, 8, 16)
    codes = torch.randint(0, 16, (4, 10, 8), dtype=torch.uint8)
    if wrapper == "adc_scan_shared":
        codes = codes[0]
    fn = getattr(adc_scan, wrapper)
    fn(lut, codes)  # in bounds: runs
    codes.view(-1)[3] = 16
    with pytest.raises(sanitize.SanitizeError, match="code 16 out of bounds for ksub 16"):
        fn(lut, codes)


def test_clean_operands_give_the_same_scores_sanitized(monkeypatch):
    monkeypatch.setenv("GRAFT_SANITIZE", "1")
    k1 = _k1(*_k1_inputs())
    k3 = _k3(*_k3_inputs())
    monkeypatch.setenv("GRAFT_SANITIZE", "0")
    assert torch.equal(k1, _k1(*_k1_inputs()))
    assert torch.equal(k3, _k3(*_k3_inputs()))


def test_knob_off_checks_nothing(monkeypatch):
    """With the knob off the wrappers never reach the sanitizer: a bad li
    meets the plain version's own indexing error."""
    monkeypatch.delenv("GRAFT_SANITIZE", raising=False)

    def refuse(*a, **k):
        raise AssertionError("sanitizer called with the knob off")

    for name in ("check_probe", "check_codes", "check_shape", "_raise_on_nan"):
        monkeypatch.setattr(sanitize, name, refuse)
    _k1(*_k1_inputs())
    _k3(*_k3_inputs())
    adc_scan.adc_scan(torch.randn(4, 8, 16), torch.zeros(4, 10, 8, dtype=torch.uint8))
    adc_scan.adc_scan_shared(torch.randn(4, 8, 16), torch.zeros(10, 8, dtype=torch.uint8))
    _ivf_flat()[0].search(_data()[1], 5)
    q, data, ids, li, sizes, norms = _k1_inputs()
    with pytest.raises(IndexError):
        _k1(q, data, ids, li.fill_(5), sizes, norms)


# ------------------------------------------------------------------ the tier

@pytest.mark.slow
def test_models_and_engine_suites_under_sanitizer():
    """The port's model, pre-transform, serving, mutation and mesh-serving
    suites with GRAFT_SANITIZE=1: every search program NaN-checked, every
    kernel wrapper's operands bounds-checked. The knob reaches the JAX
    references in the same process too, so the suites whose JAX side runs
    a Pallas kernel in interpret mode (the ops and IVF-PQ files), which
    the JAX package's checkify cannot trace, stay out; the cases above
    sanitize IVF-PQ and flat PQ directly."""
    env = dict(os.environ, GRAFT_SANITIZE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_models.py",
         "tests/test_torch_pretransform.py", "tests/test_torch_serving.py",
         "tests/test_torch_mutation.py", "tests/test_torch_mesh_serving.py",
         "-q", "-m", "not slow", "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=2400)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
