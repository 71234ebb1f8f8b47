"""IVF-Flat/SQ8 probe-group list scan: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of distributed_faiss_tpu/ops/flat_pallas.py).

``flat_list_scan`` computes, for each (query, probe, row), the masked
score of row ``pos`` of list ``li[i, j]`` against query ``i`` — the
function of the TPU kernel ``flat_list_scan_pallas``. For tensors on the
CPU it runs ``flat_list_scan_plain`` (gather + decode + einsum + mask,
the JAX package's non-Pallas body at models/ivf.py:176-196). For CUDA
tensors it launches the hand-written kernel in ``csrc/flat_scan.cu`` or
raises: there is no fallback. Each launch adds one to
``flat_list_scan.launches``. Under GRAFT_SANITIZE=1 the operands' shapes
and gather bounds are checked on the host first (``utils/sanitize.py``).
"""

import ctypes

import torch

from distributed_faiss_tpu_torch.ops import cuda_build, sq
from distributed_faiss_tpu_torch.ops.distance import NEG_INF, row_norms_f32
from distributed_faiss_tpu_torch.utils import lockdep, sanitize

# list codec -> (the kernel's codec id, the lists' storage dtype)
CODECS = {"f32": (0, torch.float32), "f16": (1, torch.float16), "sq8": (2, torch.uint8)}

_counter_lock = lockdep.lock("flat_scan._counter_lock")


def flat_list_scan_plain(q, list_data, list_ids, li, sizes_g, list_norms=None,
                         vmin=None, span=None, *, metric: str, codec: str = "f16",
                         scan_bf16: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch. Materializes the gathered
    (nq, g, cap, d) fp32 block — the transient the kernel never builds.

    scan_bf16 rounds q and the decoded rows to bf16 and multiplies in fp32:
    products of bf16 values are exact in fp32, so this is a bf16 dot with
    fp32 accumulation (the JAX package's ``preferred_element_type=f32``)."""
    q = q.float()
    idx = li.long()
    block = list_data[idx]  # (nq, g, cap, d) storage dtype
    if codec == "sq8":
        block = sq.sq8_decode(block, vmin, span)
    else:
        block = block.float()
    if scan_bf16:
        ip = torch.einsum("qd,qgcd->qgc", q.bfloat16().float(), block.bfloat16().float())
    else:
        ip = torch.einsum("qd,qgcd->qgc", q, block)
    if metric == "dot":
        s = ip
    else:
        qn = (q * q).sum(1, keepdim=True)
        bn = list_norms[idx] if list_norms is not None else row_norms_f32(block)
        s = -(qn[:, :, None] - 2.0 * ip + bn)
    cap = list_data.shape[1]
    pos = torch.arange(cap, device=q.device)
    valid = (pos[None, None, :] < sizes_g[:, :, None]) & (list_ids[idx] >= 0)
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def flat_list_scan(q, list_data, list_ids, li, sizes_g, list_norms=None,
                   vmin=None, span=None, *, metric: str, codec: str = "f16",
                   scan_bf16: bool = False) -> torch.Tensor:
    """Masked scores (nq, g, cap) fp32 of one probe group.

    q: (nq, d) fp32; list_data: (nlist, cap, d) f32/f16 (codec f32/f16) or
    uint8 (codec sq8, with (d,) fp32 vmin/span); list_ids: (nlist, cap)
    int32; li, sizes_g: (nq, g) int32 probed lists and their fill counts;
    list_norms: (nlist, cap) fp32 stored ``||x||^2`` of the decoded rows, or
    None to recompute them. Invalid slots (pos >= size, or id < 0) are -inf.
    """
    if sanitize.enabled():
        _sanitize(q, list_data, list_ids, li, sizes_g, list_norms)
    if q.device.type == "cpu":
        return flat_list_scan_plain(q, list_data, list_ids, li, sizes_g, list_norms,
                                    vmin, span, metric=metric, codec=codec,
                                    scan_bf16=scan_bf16)
    if q.device.type != "cuda":
        raise RuntimeError(f"flat_list_scan: unsupported device {q.device}")
    return _launch(q, list_data, list_ids, li, sizes_g, list_norms, vmin, span,
                   metric, codec, scan_bf16)


flat_list_scan.launches = 0


def _sanitize(q, list_data, list_ids, li, sizes_g, list_norms):
    """GRAFT_SANITIZE=1: shapes that agree and in-bounds gathers, before any
    launch."""
    name = "flat_list_scan"
    nlist, cap = list_data.shape[0], list_data.shape[1]
    sanitize.check_shape(name, "list_data", list_data, (nlist, cap, q.shape[-1]))
    sanitize.check_shape(name, "list_ids", list_ids, (nlist, cap))
    if list_norms is not None:
        sanitize.check_shape(name, "list_norms", list_norms, (nlist, cap))
    sanitize.check_shape(name, "li", li, (q.shape[0], li.shape[-1]))
    sanitize.check_probe(name, li, sizes_g, nlist, cap)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"flat_list_scan: {name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"flat_list_scan: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flat_list_scan: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flat_list_scan: {name} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(q, list_data, list_ids, li, sizes_g, list_norms, vmin, span,
            metric, codec, scan_bf16):
    """Check the inputs and launch the kernel."""
    if codec not in CODECS:
        raise ValueError(f"flat_list_scan: unknown codec {codec!r}")
    if metric not in ("l2", "dot"):
        raise ValueError(f"flat_list_scan: unknown metric {metric!r}")
    code, dtype = CODECS[codec]
    dev = q.device
    nq, d = q.shape
    nlist, cap = list_data.shape[0], list_data.shape[1]
    g = li.shape[1]
    _check("q", q, torch.float32, (nq, d), dev)
    _check("list_data", list_data, dtype, (nlist, cap, d), dev)
    _check("list_ids", list_ids, torch.int32, (nlist, cap), dev)
    _check("li", li, torch.int32, (nq, g), dev)
    _check("sizes_g", sizes_g, torch.int32, (nq, g), dev)
    norms = list_norms if metric == "l2" else None
    if norms is not None:
        _check("list_norms", norms, torch.float32, (nlist, cap), dev)
    if codec == "sq8":
        if vmin is None or span is None:
            raise ValueError("flat_list_scan: codec sq8 needs vmin and span")
        _check("vmin", vmin, torch.float32, (d,), dev)
        _check("span", span, torch.float32, (d,), dev)
    else:
        vmin = span = None
    out = torch.empty((nq, g, cap), dtype=torch.float32, device=dev)
    fn = cuda_build.load("flat_scan").dft_flat_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(q), _ptr(list_data), _ptr(list_ids), _ptr(li), _ptr(sizes_g),
             _ptr(norms), _ptr(vmin), _ptr(span), _ptr(out),
             nq, g, cap, d, code, int(metric == "l2"), int(bool(scan_bf16)),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flat_scan kernel launch failed: CUDA error {err}")
    with _counter_lock:
        flat_list_scan.launches += 1
    return out
