"""The final top-k of an IVF-Flat probe group: the CUDA kernel's wrapper and
its plain PyTorch version.

``topk_select`` merges each query's (w,) candidates, the per-(query, probe)
best k that K1's select epilogue writes (``ops.flat_scan.
flat_list_scan_select``), with an optional carried (nq, k) result into its
best k. It replaces no TPU kernel: the JAX package, and the port before
K1 selected, ran a library top-k here (``models/ivf.py``). For tensors on
the CPU it runs ``topk_select_plain``; for CUDA tensors it launches the
hand-written kernel in ``csrc/topk_select.cu`` or raises. Each launch adds
one to ``topk_select.launches`` (replays of a captured program add theirs,
``utils/programs.py``).

The order of a result, in both versions: a higher score first, then a
lower id; entries past the valid candidates are (-inf, -1).
"""

import ctypes

import torch

from distributed_faiss_tpu_torch.ops import cuda_build
from distributed_faiss_tpu_torch.ops.distance import NEG_INF
from distributed_faiss_tpu_torch.utils import lockdep, programs

# the widest k the kernels' shared-memory buffers hold (csrc/block_topk.cuh)
SELECT_MAX_K = 256

_counter_lock = lockdep.lock("topk._counter_lock")


def ordered_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """(…, w) scores and ids -> their best k in the kernels' order (score
    descending, then id ascending), (-inf, -1) past the finite scores and
    past w."""
    w = vals.shape[-1]
    if w < k:
        pad = list(vals.shape[:-1]) + [k - w]
        vals = torch.cat([vals, vals.new_full(pad, NEG_INF)], dim=-1)
        ids = torch.cat([ids, ids.new_full(pad, -1)], dim=-1)
    by_id = torch.argsort(ids, dim=-1, stable=True)
    vals, ids = torch.gather(vals, -1, by_id), torch.gather(ids, -1, by_id)
    best, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    best, pos = best[..., :k].contiguous(), pos[..., :k]
    out = torch.gather(ids, -1, pos)
    return best, torch.where(torch.isneginf(best), torch.full_like(out, -1), out)


def topk_select_plain(vals: torch.Tensor, ids: torch.Tensor, k: int, carry=None):
    """The kernel's function in plain PyTorch."""
    if carry is not None:
        vals = torch.cat([carry[0], vals], dim=1)
        ids = torch.cat([carry[1], ids], dim=1)
    return ordered_topk(vals.float(), ids, k)


def topk_select(vals: torch.Tensor, ids: torch.Tensor, k: int, carry=None):
    """The best k of each row of (nq, w) fp32 scores and int32 ids, merged
    with ``carry`` (an earlier (scores, ids) result of this function, or
    None) -> ((nq, k) fp32, (nq, k) int32), 1 <= k <= SELECT_MAX_K."""
    if vals.device.type == "cpu":
        return topk_select_plain(vals, ids, k, carry)
    if vals.device.type != "cuda":
        raise RuntimeError(f"topk_select: unsupported device {vals.device}")
    return _launch(vals, ids, k, carry)


topk_select.launches = 0


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"topk_select: {name} is on {t.device}, the scores on {device}")
    if t.dtype != dtype:
        raise ValueError(f"topk_select: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"topk_select: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"topk_select: {name} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(vals, ids, k, carry):
    """Check the inputs and launch the kernel."""
    if not 1 <= k <= SELECT_MAX_K:
        raise ValueError(f"topk_select: k must be in [1, {SELECT_MAX_K}], got {k}")
    if vals.dim() != 2:
        raise ValueError(f"topk_select: scores must be (nq, w), got {tuple(vals.shape)}")
    dev = vals.device
    nq, w = vals.shape
    _check("scores", vals, torch.float32, (nq, w), dev)
    _check("ids", ids, torch.int32, (nq, w), dev)
    carry_s = carry_i = None
    if carry is not None:
        carry_s, carry_i = carry
        _check("carry scores", carry_s, torch.float32, (nq, k), dev)
        _check("carry ids", carry_i, torch.int32, (nq, k), dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = cuda_build.load("topk_select").dft_topk_select
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(vals), _ptr(ids), _ptr(carry_s), _ptr(carry_i), _ptr(out_s), _ptr(out_i),
             nq, w, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"topk_select kernel launch failed: CUDA error {err}")
    programs.count_launches(_counter_lock, topk_select)
    return out_s, out_i
