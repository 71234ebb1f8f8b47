"""PQ asymmetric-distance (ADC) scans: the CUDA kernels' wrappers and their
plain PyTorch versions (counterpart of distributed_faiss_tpu/ops/adc_pallas.py).

Over per-pair code lists (the IVF probe path) K2 and K3 compute
``out[p, c] = sum_m lut[p, m, codes[p, c, m]]`` with an fp32 sum, for lut
(P, m, ksub) fp32 or bf16 and codes (P, L, m) uint8:

- ``adc_scan_plain``: the gather-sum in PyTorch. A bf16 LUT is summed as
  the fp32 values it represents, so it sums exactly the entries a kernel
  sums.
- ``adc_scan`` (K2, the port of ``adc_scan_pallas``): any m, ksub <= 256.
- ``adc_scan_nibble`` (K3, the port of ``adc_scan_pallas_nibble``): the
  geometry ``nibble_supported`` accepts (ksub = 256, m % 8 == 0). The name
  is the TPU kernel's; the CUDA kernel needs no 4-bit split, it gathers
  from a shared-memory LUT and reads the codes as 8- or 16-byte words.

K3 also scores a probe group straight from the index's lists, the
function the JAX package's probe body computes around its nibble kernel
(models/ivf.py:225-253): ``list_codes[li]``, the scan, then the
``pos < size & id >= 0`` mask. ``adc_scan_lists(lut, list_codes, li,
sizes_g, list_ids)`` returns those (nq, g, cap) scores with -inf at masked
slots; the kernel reads each probed list's live rows itself and stops at
its size, so the (nq*g, cap, m) gathered block is never built.
``adc_scan_lists_plain`` is the gather + ``adc_scan_plain`` + ``mask_lists``
it replaces. Both K3 entries launch the same kernel, and K3's counter
(``adc_scan_nibble.launches``) counts launches from either;
``adc_scan_lists.launches`` counts the fused entry's alone.

Over one code list shared by every query (flat PQ),
``out[q, c] = sum_m lut[q, m, codes[c, m]]`` for lut (nq, m, ksub) and codes
(L, m) at any byte offset:

- ``adc_scan_shared_plain``: the same sum in PyTorch, over chunks of L and
  one subspace at a time, so its transient stays near two 256 MiB fp32
  blocks whatever L is;
- ``adc_scan_shared`` (K4, the port of ``adc_scan_shared_pallas``).

For tensors on the CPU each wrapper runs the plain version; for CUDA
tensors it launches its hand-written kernel in ``csrc/adc_scan.cu`` or
raises: there is no fallback. Each kernel stages a LUT in shared memory,
and Hopper gives a block 227 KB (``smem_bytes``, ``shared_smem_bytes``),
so a wide m is scored in subspace slices: ``slice_width`` picks the widest
slice that fits (at ksub = 256, K3 224 subspaces with an f32 LUT and 448
with a bf16 one, K2 181 and 302, K4 75 and 112) and ``run_slices``
launches the kernel once per slice, the first starting each score from 0
(K3 over the lists: writing the -inf mask) and the rest adding to the live
scores, so every m the JAX package serves is served here. Each launch adds
one to the wrapper's ``launches``; ``slices`` holds the number of slices
of its latest call on the card. The JAX package's ``USE_NIBBLE`` switch
and demotion state are not ported. Under GRAFT_SANITIZE=1 each wrapper
checks its operands' shapes and gather bounds on the host before any
launch (``utils/sanitize.py``).
"""

import ctypes
import functools

import torch

from distributed_faiss_tpu_torch.ops import cuda_build
from distributed_faiss_tpu_torch.ops.distance import NEG_INF
from distributed_faiss_tpu_torch.utils import lockdep, sanitize

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

_counter_lock = lockdep.lock("adc_scan._counter_lock")


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
    two buffers of one query's LUT, each 16-byte aligned (one is scanned
    while the next query's is copied in), then the transposed code tile."""
    return 2 * ((m * ksub * itemsize + 15) & ~15) + ((m + 3) // 4) * _K4_TILE_STRIDE * 4


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


def _sanitize(name, lut, codes, shape) -> None:
    """GRAFT_SANITIZE=1: a 3-d LUT, codes of ``shape`` (from the LUT's), each
    code below ksub, before any launch."""
    if lut.dim() != 3:
        raise sanitize.SanitizeError(f"sanitize: {name}: lut must be 3-d, got "
                                     f"{tuple(lut.shape)}")
    sanitize.check_shape(name, "codes", codes, shape)
    sanitize.check_codes(name, codes, lut.shape[2])


def _dispatch(wrapper, lut, codes):
    if sanitize.enabled():
        P, m = (lut.shape[0], lut.shape[1]) if lut.dim() == 3 else (-1, -1)
        L = codes.shape[1] if codes.dim() == 3 else -1
        _sanitize(wrapper.__name__, lut, codes, (P, L, m))
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
    queries, for any m and ksub <= 256."""
    if sanitize.enabled():
        _sanitize("adc_scan_shared", lut, codes,
                  (codes.shape[0], lut.shape[1] if lut.dim() == 3 else -1))
    if lut.device.type == "cpu":
        return adc_scan_shared_plain(lut, codes)
    if lut.device.type != "cuda":
        raise RuntimeError(f"adc_scan_shared: unsupported device {lut.device}")
    return _launch_shared(lut, codes)


def mask_lists(s: torch.Tensor, li: torch.Tensor, sizes_g: torch.Tensor,
               list_ids: torch.Tensor) -> torch.Tensor:
    """A probe group's (nq, g, cap) scores with -inf where the slot holds
    no row: pos >= the probed list's size, or id < 0 (the JAX package's
    mask, models/ivf.py:252-253)."""
    pos = torch.arange(s.shape[2], device=s.device)
    valid = (pos[None, None, :] < sizes_g[:, :, None]) & (list_ids[li.long()] >= 0)
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def adc_scan_lists_plain(lut: torch.Tensor, list_codes: torch.Tensor, li: torch.Tensor,
                         sizes_g: torch.Tensor, list_ids: torch.Tensor) -> torch.Tensor:
    """The fused K3's function in plain PyTorch: the probed lists' code
    rows gathered into an (nq*g, cap, m) block, ``adc_scan_plain``, then
    ``mask_lists``."""
    nq, g = li.shape
    _, cap, m = list_codes.shape
    codes = list_codes[li.long()].reshape(nq * g, cap, m)
    return mask_lists(adc_scan_plain(lut, codes).reshape(nq, g, cap), li, sizes_g, list_ids)


def adc_scan_lists(lut: torch.Tensor, list_codes: torch.Tensor, li: torch.Tensor,
                   sizes_g: torch.Tensor, list_ids: torch.Tensor) -> torch.Tensor:
    """K3 over the probed lists themselves: masked ADC scores (nq, g, cap)
    fp32 of one probe group.

    lut: (nq*g, m, 256) fp32 or bf16, one per (query, probe) pair, m % 8
    == 0; list_codes: (nlist, cap, m) uint8, the index's own lists;
    li, sizes_g: (nq, g) int32 probed lists and their fill counts;
    list_ids: (nlist, cap) int32. Slots at pos >= size or with id < 0 are
    -inf."""
    if sanitize.enabled():
        name = "adc_scan_lists"
        if list_codes.dim() != 3 or li.dim() != 2:
            raise sanitize.SanitizeError(f"sanitize: {name}: list_codes must be 3-d and li "
                                         f"2-d, got {tuple(list_codes.shape)} and "
                                         f"{tuple(li.shape)}")
        nlist, cap, m = list_codes.shape
        sanitize.check_shape(name, "lut", lut, (li.numel(), m, 256))
        sanitize.check_shape(name, "list_ids", list_ids, (nlist, cap))
        sanitize.check_probe(name, li, sizes_g, nlist, cap)
    if lut.device.type == "cpu":
        return adc_scan_lists_plain(lut, list_codes, li, sizes_g, list_ids)
    if lut.device.type != "cuda":
        raise RuntimeError(f"adc_scan_lists: unsupported device {lut.device}")
    return _launch_lists(lut, list_codes, li, sizes_g, list_ids)


adc_scan.launches = 0
adc_scan_nibble.launches = 0
adc_scan_lists.launches = 0
adc_scan_shared.launches = 0
adc_scan.slices = 0
adc_scan_nibble.slices = 0
adc_scan_lists.slices = 0
adc_scan_shared.slices = 0


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


def _entry(symbol: str, n_ptrs: int, n_ints: int):
    """The C entry ``symbol`` of the built library, typed once: ``n_ptrs``
    device pointers, ``n_ints`` ints, the stream; returns the CUDA error."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(cuda_build.load("adc_scan"), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def slice_width(m: int, ksub: int, itemsize: int, kernel) -> int:
    """The widest subspace slice, at most m, whose block fits
    ``MAX_SMEM_BYTES`` for ``kernel`` (one of the three wrappers); a
    multiple of 8 for K3, whose 8-byte code words must stay aligned. At
    ksub <= 256 a slice of one subspace (K3: 8) always fits."""
    if kernel is adc_scan_shared:
        block = functools.partial(shared_smem_bytes, ksub=ksub, itemsize=itemsize)
    else:
        block = functools.partial(smem_bytes, ksub=ksub, itemsize=itemsize,
                                  nibble=kernel is adc_scan_nibble)
    step = 8 if kernel is adc_scan_nibble else 1
    width = m
    while width > step and block(width) > MAX_SMEM_BYTES:
        width -= step
    return width


def run_slices(m: int, width: int, launch) -> int:
    """Score m subspaces as slices [s, e) of at most ``width``, in order:
    ``launch(s, e, accumulate)`` with accumulate False for the first slice
    (each score starts from 0) and True for the rest (each adds its
    lookups to the score the previous slices left). Returns the number of
    slices."""
    n = 0
    for s in range(0, m, width):
        launch(s, min(m, s + width), s > 0)
        n += 1
    return n


def _count_launch(err, *wrappers):
    """Raise on a failed launch, else add one to each wrapper's count."""
    if err != 0:
        raise RuntimeError(f"{wrappers[0].__name__} kernel launch failed: CUDA error {err}")
    with _counter_lock:
        for wrapper in wrappers:
            wrapper.launches += 1


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
    width = slice_width(m, ksub, lut.element_size(), wrapper)
    out = torch.empty((P, L), dtype=torch.float32, device=dev)
    if P == 0 or L == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(lut.dtype == torch.bfloat16)
    entry = _entry("dft_adc_scan_nibble" if nibble else "dft_adc_scan", 3, 6)

    def launch(s, e, accumulate):
        part = lut if e - s == m else lut[:, s:e].contiguous()
        if nibble:
            # a view of the slice: its rows keep the list's pitch of m bytes
            err = entry(part.data_ptr(), codes.data_ptr() + s, out.data_ptr(), P, L, e - s,
                        m, bf16, int(accumulate), stream)
        else:
            # K2 stages contiguous rows: the slice is copied (its codes are
            # already a gathered copy of the probed lists)
            rows = codes if e - s == m else codes[:, :, s:e].contiguous()
            err = entry(part.data_ptr(), rows.data_ptr(), out.data_ptr(), P, L, e - s, ksub,
                        bf16, int(accumulate), stream)
        _count_launch(err, wrapper)

    wrapper.slices = run_slices(m, width, launch)
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
    width = slice_width(m, ksub, lut.element_size(), adc_scan_shared)
    out = torch.empty((nq, L), dtype=torch.float32, device=dev)
    if nq == 0 or L == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(lut.dtype == torch.bfloat16)
    entry = _entry("dft_adc_scan_shared", 3, 7)

    def launch(s, e, accumulate):
        # the slice of the code list is a view: rows keep their pitch of m
        part = lut if e - s == m else lut[:, s:e].contiguous()
        err = entry(part.data_ptr(), codes.data_ptr() + s, out.data_ptr(), nq, L, e - s,
                    ksub, m, bf16, int(accumulate), stream)
        _count_launch(err, adc_scan_shared)

    adc_scan_shared.slices = run_slices(m, width, launch)
    return out


def _launch_lists(lut, list_codes, li, sizes_g, list_ids):
    name = "adc_scan_lists"
    if lut.dim() != 3 or list_codes.dim() != 3 or li.dim() != 2:
        raise ValueError(f"{name}: lut and list_codes must be 3-d and li 2-d, got "
                         f"{lut.dim()}, {list_codes.dim()} and {li.dim()}")
    nq, g = li.shape
    P, m, ksub = lut.shape
    nlist, cap = list_codes.shape[0], list_codes.shape[1]
    dev = lut.device
    _check(name, "lut", lut, LUT_DTYPES, (nq * g, m, ksub), dev)
    _check(name, "list_codes", list_codes, (torch.uint8,), (nlist, cap, m), dev)
    _check(name, "li", li, (torch.int32,), (nq, g), dev)
    _check(name, "sizes_g", sizes_g, (torch.int32,), (nq, g), dev)
    _check(name, "list_ids", list_ids, (torch.int32,), (nlist, cap), dev)
    if not nibble_supported(m, ksub):
        raise ValueError(f"{name}: needs ksub == 256 and m % 8 == 0, got m={m} ksub={ksub}")
    if list_codes.data_ptr() % 8:
        raise ValueError(f"{name}: list_codes must be 8-byte aligned")
    out = torch.empty((nq, g, cap), dtype=torch.float32, device=dev)
    if P == 0 or cap == 0:
        return out
    width = slice_width(m, ksub, lut.element_size(), adc_scan_nibble)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(lut.dtype == torch.bfloat16)
    entry = _entry("dft_adc_scan_lists", 6, 6)

    def launch(s, e, accumulate):
        # a slice of the lists is a view: rows keep their pitch of m bytes
        part = lut if e - s == m else lut[:, s:e].contiguous()
        err = entry(part.data_ptr(), list_codes.data_ptr() + s, li.data_ptr(),
                    sizes_g.data_ptr(), list_ids.data_ptr(), out.data_ptr(), P, cap, e - s, m,
                    bf16, int(accumulate), stream)
        _count_launch(err, adc_scan_lists, adc_scan_nibble)

    adc_scan_lists.slices = adc_scan_nibble.slices = run_slices(m, width, launch)
    return out
