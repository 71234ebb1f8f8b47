"""IVF-Flat/SQ8 probe-group list scan: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of distributed_faiss_tpu/ops/flat_pallas.py).

``flat_list_scan`` computes, for each (query, probe, row), the masked
score of row ``pos`` of list ``li[i, j]`` against query ``i`` — the
function of the TPU kernel ``flat_list_scan_pallas``. For tensors on the
CPU it runs ``flat_list_scan_plain`` (gather + decode + einsum + mask,
the JAX package's non-Pallas body at models/ivf.py:176-196). For CUDA
tensors it launches the hand-written kernel in ``csrc/flat_scan.cu`` or
raises: there is no fallback. Each launch adds one to
``flat_list_scan.launches``, and each replay of a captured program adds
the launches it holds (``utils/programs.py``). Under GRAFT_SANITIZE=1 the operands' shapes
and gather bounds are checked on the host first (``utils/sanitize.py``).

``flat_list_scan_select`` launches the same kernel with its select
epilogue: each (query, probe) pair's best k rows (1 <= k <= 256) as
(nq, g, k) scores and ids, in place of the (nq, g, cap) score block, the
form the IVF search takes (``models/ivf.py``; ``ops/topk.py`` merges the
pairs). Its plain version is ``flat_list_scan_select_plain``. Its
launches count in ``flat_list_scan.launches`` (the kernel's) and in
``flat_list_scan_select.launches``.
"""

import ctypes

import torch

from distributed_faiss_tpu_torch.ops import cuda_build, sq, topk
from distributed_faiss_tpu_torch.ops.distance import NEG_INF, row_norms_f32
from distributed_faiss_tpu_torch.utils import lockdep, programs, sanitize

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
    return _plain_scores(q, list_data, list_ids, li, sizes_g, list_norms, vmin, span,
                         metric, codec, scan_bf16)


def _plain_scores(q, list_data, list_ids, li, sizes_g, list_norms, vmin, span, metric,
                  codec, scan_bf16):
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


def flat_list_scan_select_plain(q, list_data, list_ids, li, sizes_g, list_norms=None,
                                vmin=None, span=None, *, k: int, metric: str,
                                codec: str = "f16", scan_bf16: bool = False):
    """The select epilogue's function in plain PyTorch: each pair's best k
    of ``flat_list_scan_plain``'s scores, ordered as the kernel orders them
    (``topk.ordered_topk``). Scores one probe at a time, so the gathered
    block is (nq, cap, d) and not (nq, g, cap, d)."""
    vals, ids = [], []
    for j in range(li.shape[1]):
        lj = li[:, j:j + 1].contiguous()
        s = _plain_scores(q, list_data, list_ids, lj, sizes_g[:, j:j + 1], list_norms, vmin,
                          span, metric, codec, scan_bf16)[:, 0]
        best, best_ids = topk.ordered_topk(s, list_ids[lj[:, 0].long()], k)
        vals.append(best)
        ids.append(best_ids)
    return torch.stack(vals, 1), torch.stack(ids, 1)


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


def flat_list_scan_select(q, list_data, list_ids, li, sizes_g, list_norms=None,
                          vmin=None, span=None, *, k: int, metric: str, codec: str = "f16",
                          scan_bf16: bool = False):
    """Each (query, probe) pair's best k valid rows, 1 <= k <=
    ``topk.SELECT_MAX_K``: ((nq, g, k) fp32 scores, (nq, g, k) int32 ids
    ``list_ids[li[i, j], pos]``), best first (score, then lower id), (-inf,
    -1) past the pair's valid rows. Inputs as ``flat_list_scan``."""
    if sanitize.enabled():
        _sanitize(q, list_data, list_ids, li, sizes_g, list_norms)
    if q.device.type == "cpu":
        return flat_list_scan_select_plain(q, list_data, list_ids, li, sizes_g, list_norms,
                                           vmin, span, k=k, metric=metric, codec=codec,
                                           scan_bf16=scan_bf16)
    if q.device.type != "cuda":
        raise RuntimeError(f"flat_list_scan_select: unsupported device {q.device}")
    if not 1 <= k <= topk.SELECT_MAX_K:
        raise ValueError(f"flat_list_scan_select: k must be in [1, {topk.SELECT_MAX_K}], "
                         f"got {k}")
    return _launch(q, list_data, list_ids, li, sizes_g, list_norms, vmin, span,
                   metric, codec, scan_bf16, k=k)


flat_list_scan_select.launches = 0


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
            metric, codec, scan_bf16, k=0):
    """Check the inputs and launch the kernel (k > 0: with its select
    epilogue)."""
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
    out = torch.empty((nq, g, k or cap), dtype=torch.float32, device=dev)
    out_ids = torch.empty((nq, g, k), dtype=torch.int32, device=dev) if k else None
    fn = cuda_build.load("flat_scan").dft_flat_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(q), _ptr(list_data), _ptr(list_ids), _ptr(li), _ptr(sizes_g),
             _ptr(norms), _ptr(vmin), _ptr(span), _ptr(out), _ptr(out_ids),
             nq, g, cap, d, k, code, int(metric == "l2"), int(bool(scan_bf16)),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flat_scan kernel launch failed: CUDA error {err}")
    if k:
        programs.count_launches(_counter_lock, flat_list_scan, flat_list_scan_select)
        return out, out_ids
    programs.count_launches(_counter_lock, flat_list_scan)
    return out
