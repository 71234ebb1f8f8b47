"""GRAFT_SANITIZE=1: NaN checks on the search programs and bounds checks on
the kernels' operands (counterpart of distributed_faiss_tpu/utils/sanitize.py).

The JAX package runs its jitted scans under ``checkify`` with NaN and
out-of-bounds-gather checks. Torch has no checkify, and the two halves
land where the port can check them:

- ``maybe_checked(fn, *args, **kwargs)`` runs ``fn`` and raises
  ``SanitizeError`` when a floating-point operand or result holds a NaN
  (a NaN score would otherwise travel through the top-k merges into a
  served result). Called at the JAX package's sites: the exact knn scan
  (which the flat search runs through), the IVF-Flat and IVF-PQ probe
  scans and the flat-PQ shared scan.
- ``check_probe`` / ``check_codes`` / ``check_shape`` are the gather
  bounds the four kernel wrappers check on the host BEFORE a launch: a
  probed list ``li`` in [0, nlist), a fill count in [0, cap], codes below
  ksub, shapes that agree. On a TPU an out-of-range gather clamps
  quietly; on CUDA it reads past the lists, and a device-side fault takes
  the process's CUDA context with it, so a bad index must never reach a
  launch.

Every check reads the device (a sync), inside ``xfercheck.explicit``. So
with the sanitizer on, the search programs run op by op, never captured
(``utils/programs.py``): the bounds checks before each launch need the
operands on the host, where the JAX package checks inside its program.
It is a test and drill knob, never a serving default. ``enabled()`` reads
the environment per call; disabled (the default), ``maybe_checked`` is a
plain call and the wrappers check nothing more than before.
"""

import os

import torch

from distributed_faiss_tpu_torch.utils import xfercheck

__all__ = ["SanitizeError", "enabled", "maybe_checked", "check_probe", "check_codes",
           "check_shape"]


class SanitizeError(RuntimeError):
    """A sanitizer check failed: a NaN in a search program's operands or
    results, or a kernel operand out of bounds."""


def enabled() -> bool:
    return os.environ.get("GRAFT_SANITIZE", "0") == "1"


def _floats(value, name, out):
    """Collect (name, tensor) for every floating-point tensor in value."""
    if isinstance(value, torch.Tensor):
        if value.is_floating_point():
            out.append((name, value))
    elif isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            _floats(v, f"{name}[{i}]", out)


def _raise_on_nan(fn_name: str, what: str, named) -> None:
    if not named:
        return
    with xfercheck.explicit("sanitize NaN check"):
        flags = [bool(torch.isnan(t).any()) for _, t in named]
    bad = [name for (name, _), hit in zip(named, flags) if hit]
    if bad:
        raise SanitizeError(f"sanitize: NaN in {what} of {fn_name}: {', '.join(bad)}")


def maybe_checked(fn, *args, **kwargs):
    """Call ``fn``; under GRAFT_SANITIZE=1 raise ``SanitizeError`` on a NaN
    in a floating-point operand (before the call) or result (after)."""
    if not enabled():
        return fn(*args, **kwargs)
    name = getattr(fn, "__name__", repr(fn))
    operands = []
    for i, a in enumerate(args):
        _floats(a, f"arg {i}", operands)
    for k, v in kwargs.items():
        _floats(v, k, operands)
    _raise_on_nan(name, "the operands", operands)
    out = fn(*args, **kwargs)
    results = []
    _floats(out, "result", results)
    _raise_on_nan(name, "the results", results)
    return out


def check_shape(wrapper: str, what: str, t: torch.Tensor, shape) -> None:
    """``t``'s shape must be ``shape``."""
    if tuple(t.shape) != tuple(shape):
        raise SanitizeError(f"sanitize: {wrapper}: {what} shape {tuple(t.shape)} != "
                            f"{tuple(shape)}")


def _bounds(t: torch.Tensor):
    with xfercheck.explicit("sanitize bounds check"):
        both = torch.stack([t.min(), t.max()]).tolist()
    return both[0], both[1]


def check_probe(wrapper: str, li: torch.Tensor, sizes_g: torch.Tensor, nlist: int,
                cap: int) -> None:
    """A probe group's operands: ``li`` and ``sizes_g`` of one (nq, g) shape,
    every probed list in [0, nlist) and every fill count in [0, cap]."""
    if li.dim() != 2:
        raise SanitizeError(f"sanitize: {wrapper}: li must be 2-d, got {tuple(li.shape)}")
    check_shape(wrapper, "sizes_g", sizes_g, li.shape)
    if li.numel() == 0:
        return
    lo, hi = _bounds(li)
    if lo < 0 or hi >= nlist:
        raise SanitizeError(f"sanitize: {wrapper}: li out of bounds: [{lo}, {hi}] not in "
                            f"[0, {nlist})")
    lo, hi = _bounds(sizes_g)
    if lo < 0 or hi > cap:
        raise SanitizeError(f"sanitize: {wrapper}: sizes_g out of bounds: [{lo}, {hi}] not "
                            f"in [0, {cap}]")


def check_codes(wrapper: str, codes: torch.Tensor, ksub: int) -> None:
    """Every code indexes the LUT: below ``ksub``."""
    if codes.numel() == 0:
        return
    _, hi = _bounds(codes)
    if hi >= ksub:
        raise SanitizeError(f"sanitize: {wrapper}: code {hi} out of bounds for ksub {ksub}")
