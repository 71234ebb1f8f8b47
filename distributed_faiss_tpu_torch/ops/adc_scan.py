"""PQ asymmetric-distance (ADC) scans: the CUDA kernels' wrappers and their
plain PyTorch versions (counterpart of distributed_faiss_tpu/ops/adc_pallas.py).

Over per-pair code lists (the IVF probe path) all three compute
``out[p, c] = sum_m lut[p, m, codes[p, c, m]]`` with an fp32 sum, for lut
(P, m, ksub) fp32 or bf16 and codes (P, L, m) uint8:

- ``adc_scan_plain``: the gather-sum in PyTorch. A bf16 LUT is summed as
  the fp32 values it represents, so it sums exactly the entries a kernel
  sums.
- ``adc_scan`` (K2, the port of ``adc_scan_pallas``): any m, ksub <= 256.
- ``adc_scan_nibble`` (K3, the port of ``adc_scan_pallas_nibble``): the
  geometry ``nibble_supported`` accepts (ksub = 256, m % 8 == 0). The name
  is the TPU kernel's; the CUDA kernel needs no 4-bit split, it gathers
  from a shared-memory LUT and reads the codes as 8-byte words.
- ``adc_scan_auto``: K3 when ``nibble_supported``, else K2, fixed by the
  geometry: on the card nothing demotes.

Over one code list shared by every query (flat PQ),
``out[q, c] = sum_m lut[q, m, codes[c, m]]`` for lut (nq, m, ksub) and codes
(L, m) at any byte offset:

- ``adc_scan_shared_plain``: the same sum in PyTorch, over chunks of L and
  one subspace at a time, so its transient stays near two 256 MiB fp32
  blocks whatever L is;
- ``adc_scan_shared`` (K4, the port of ``adc_scan_shared_pallas``).

For tensors on the CPU each wrapper runs the plain version; for CUDA
tensors it launches its hand-written kernel in ``csrc/adc_scan.cu`` or
raises: there is no fallback. Each kernel stages a whole LUT in shared
memory, so on the card m is bounded by Hopper's 227 KB a block
(``smem_bytes``, ``shared_smem_bytes``): at ksub = 256, K3 takes m <= 224
with an f32 LUT and m <= 448 with a bf16 one, K2 m <= 181 and m <= 302,
K4 (whose block also holds a 1024-row code tile) m <= 112 and m <= 149; a
larger m raises. Each launch adds one to the wrapper's ``launches``. The
JAX package's ``USE_NIBBLE`` switch and demotion state are not ported.
"""

import ctypes
import threading

import torch

from distributed_faiss_tpu_torch.ops import cuda_build

LUT_DTYPES = (torch.float32, torch.bfloat16)

# Hopper's opt-in shared memory per block (the kernels are built for sm_90a
# only), K2's tile of staged code rows (kTileRows in csrc/adc_scan.cu) and
# K4's, staged as a column of 32-bit words per 4 subspaces with one pad
# word (kSharedTile, kSharedStride)
MAX_SMEM_BYTES = 227 * 1024
_K2_TILE_ROWS = 256
_K4_TILE_STRIDE = 1024 + 1

# the plain shared scan's chunk of L: one (nq, chunk) fp32 block of at most
# this many bytes
_SHARED_PLAIN_BYTES = 256 * 1024 * 1024

_counter_lock = threading.Lock()


def nibble_supported(m: int, ksub: int) -> bool:
    """The geometry the TPU's nibble kernel (and so K3) takes."""
    return ksub == 256 and m % 8 == 0


def smem_bytes(m: int, ksub: int, itemsize: int, nibble: bool) -> int:
    """Dynamic shared memory of one block, as ``csrc/adc_scan.cu`` sizes it:
    the pair's LUT, and for K2 a 16-byte aligned tile of code rows."""
    lut = m * ksub * itemsize
    if nibble:
        return lut
    return ((lut + 15) & ~15) + _K2_TILE_ROWS * m + 16


def shared_smem_bytes(m: int, ksub: int, itemsize: int) -> int:
    """K4's dynamic shared memory a block, as ``csrc/adc_scan.cu`` sizes it:
    the LUT of one query, 16-byte aligned, then the transposed code tile."""
    return ((m * ksub * itemsize + 15) & ~15) + ((m + 3) // 4) * _K4_TILE_STRIDE * 4


def adc_scan_plain(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch: one gather of the (P, L, m)
    LUT entries the codes select, summed over m in fp32."""
    P, m, ksub = lut.shape
    L = codes.shape[1]
    flat = lut.float().reshape(P, m * ksub)
    idx = codes.long() + torch.arange(m, device=codes.device) * ksub  # (P, L, m)
    return torch.gather(flat, 1, idx.reshape(P, L * m)).reshape(P, L, m).sum(2)


def adc_scan_shared_plain(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: per chunk of L rows, the m lookups of
    each (query, row) summed in fp32 one subspace at a time, in subspace
    order."""
    nq, m, ksub = lut.shape
    L = codes.shape[0]
    flat = lut.float().reshape(nq, m * ksub)
    out = torch.empty((nq, L), dtype=torch.float32, device=lut.device)
    step = max(1, _SHARED_PLAIN_BYTES // (4 * max(1, nq)))
    for s in range(0, L, step):
        chunk = codes[s:s + step].long()
        acc = torch.zeros((nq, chunk.shape[0]), dtype=torch.float32, device=lut.device)
        for j in range(m):
            acc += flat[:, j * ksub + chunk[:, j]]
        out[:, s:s + chunk.shape[0]] = acc
    return out


def _dispatch(wrapper, lut, codes):
    if lut.device.type == "cpu":
        return adc_scan_plain(lut, codes)
    if lut.device.type != "cuda":
        raise RuntimeError(f"{wrapper.__name__}: unsupported device {lut.device}")
    return _launch(wrapper, lut, codes)


def adc_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K2: ADC scores (P, L) fp32 for any m and ksub <= 256."""
    return _dispatch(adc_scan, lut, codes)


def adc_scan_nibble(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K3: ADC scores (P, L) fp32 for ksub = 256 and m % 8 == 0."""
    return _dispatch(adc_scan_nibble, lut, codes)


def adc_scan_shared(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K4: ADC scores (nq, L) fp32 of one (L, m) code list shared by the nq
    queries, for any m the shared memory allows and ksub <= 256."""
    if lut.device.type == "cpu":
        return adc_scan_shared_plain(lut, codes)
    if lut.device.type != "cuda":
        raise RuntimeError(f"adc_scan_shared: unsupported device {lut.device}")
    return _launch_shared(lut, codes)


adc_scan.launches = 0
adc_scan_nibble.launches = 0
adc_scan_shared.launches = 0


def adc_scan_auto(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """K3 where its geometry allows, else K2 (adc_pallas.adc_scan_auto)."""
    if nibble_supported(lut.shape[1], lut.shape[2]):
        return adc_scan_nibble(lut, codes)
    return adc_scan(lut, codes)


def _check(name, what, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, lut on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {what} must be "
                         f"{' or '.join(str(d) for d in dtypes)}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


_entries = {}


def _entry(symbol: str, n_ints: int):
    """The C entry ``symbol`` of the built library, typed once: three
    device pointers, ``n_ints`` ints, the stream; returns the CUDA error."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(cuda_build.load("adc_scan"), symbol)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def _launch(wrapper, lut, codes):
    name = wrapper.__name__
    if lut.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"{name}: lut and codes must be 3-d, got {lut.dim()} and "
                         f"{codes.dim()}")
    P, m, ksub = lut.shape
    L = codes.shape[1]
    dev = lut.device
    _check(name, "lut", lut, LUT_DTYPES, (P, m, ksub), dev)
    _check(name, "codes", codes, (torch.uint8,), (P, L, m), dev)
    nibble = wrapper is adc_scan_nibble
    if nibble and not nibble_supported(m, ksub):
        raise ValueError(f"{name}: needs ksub == 256 and m % 8 == 0, got m={m} ksub={ksub}")
    if not nibble and not 1 <= ksub <= 256:
        raise ValueError(f"{name}: ksub must be in 1..256 (uint8 codes), got {ksub}")
    if nibble and codes.data_ptr() % 8:
        raise ValueError(f"{name}: codes must be 8-byte aligned")
    smem = smem_bytes(m, ksub, lut.element_size(), nibble)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: m={m} is too large for the shared-memory LUT: "
                         f"{smem} bytes a block, above {MAX_SMEM_BYTES}")
    out = torch.empty((P, L), dtype=torch.float32, device=dev)
    if P == 0 or L == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (lut.data_ptr(), codes.data_ptr(), out.data_ptr())
    bf16 = int(lut.dtype == torch.bfloat16)
    if nibble:
        err = _entry("dft_adc_scan_nibble", 4)(*ptrs, P, L, m, bf16, stream)
    else:
        err = _entry("dft_adc_scan", 5)(*ptrs, P, L, m, ksub, bf16, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _counter_lock:
        wrapper.launches += 1
    return out


def _launch_shared(lut, codes):
    name = "adc_scan_shared"
    if lut.dim() != 3 or codes.dim() != 2:
        raise ValueError(f"{name}: lut must be 3-d and codes 2-d, got {lut.dim()} and "
                         f"{codes.dim()}")
    nq, m, ksub = lut.shape
    L = codes.shape[0]
    dev = lut.device
    _check(name, "lut", lut, LUT_DTYPES, (nq, m, ksub), dev)
    _check(name, "codes", codes, (torch.uint8,), (L, m), dev)
    if not 1 <= ksub <= 256:
        raise ValueError(f"{name}: ksub must be in 1..256 (uint8 codes), got {ksub}")
    smem = shared_smem_bytes(m, ksub, lut.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: m={m} is too large for the shared-memory LUT and "
                         f"code tile: {smem} bytes a block, above {MAX_SMEM_BYTES}")
    out = torch.empty((nq, L), dtype=torch.float32, device=dev)
    if nq == 0 or L == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("dft_adc_scan_shared", 5)(lut.data_ptr(), codes.data_ptr(), out.data_ptr(),
                                           nq, L, m, ksub, int(lut.dtype == torch.bfloat16),
                                           stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _counter_lock:
        adc_scan_shared.launches += 1
    return out
