"""Device resolution for the port's entry points.

Every entry point (models, engine, ``IndexServer``) takes an explicit
``device`` and defaults to ``"cuda"``. A CUDA request on a machine without
CUDA raises: the port never falls back to the CPU quietly, because a CPU
run would be mistaken for a card run. Tests pass ``device="cpu"``.

Resolving a CUDA device also pins float32 matrix products to full fp32
(``torch.backends.cuda.matmul.allow_tf32 = False``, and the cuDNN flag
beside it). PyTorch's defaults already say so for matmul, but the flag is
process-wide and a caller may have flipped it; TF32 keeps about three
decimal digits, which would reorder near-tie neighbours in the coarse
scores, the k-means assignments and the exact flat scan.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' explicitly to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
