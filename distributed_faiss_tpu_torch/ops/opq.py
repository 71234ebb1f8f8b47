"""OPQ: optimized product quantization rotation, OPQ-NP training
(counterpart of distributed_faiss_tpu/ops/opq.py).

The rotation R (d, d_out), orthonormal columns, optionally dim-reducing, is
trained to minimize the PQ reconstruction error of ``x @ R`` by
alternating:

  1. PQ-train codebooks on the rotated training set x @ R;
  2. the Procrustes update R <- U V^T from the SVD of x^T x_hat, the
     orthonormal map that best aligns x with its reconstruction.

Everything runs as torch ops on x's device, in fp32; on a CUDA device the
products run without TF32 (the index that calls this resolved its device
through ``utils.device.resolve_device``, which pins TF32 off). The initial
rotation is the JAX package's, from ``np.random.default_rng(seed)`` and a
QR, so both packages start from the same R. The PQ training inside is the
port's ``pq.pq_train`` (torch RNG), so the trained rotations of the two
packages differ: an expected divergence, like their k-means centroids.
"""

import numpy as np
import torch

from distributed_faiss_tpu_torch.ops import pq


def initial_rotation(d: int, d_out: int, seed: int = 0) -> np.ndarray:
    """The first d_out columns of the Q of a seeded (d, d) gaussian: the
    JAX package's starting rotation, (d, d_out) fp32."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    return np.ascontiguousarray(q[:, :d_out], np.float32)


def _reconstruct(xr: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    return pq.pq_decode(pq.pq_encode(xr, codebooks), codebooks)


def _procrustes(x: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """R = U V^T minimizing ||x R - xhat||_F over orthonormal-column R."""
    u, _, vh = torch.linalg.svd(x.T @ xhat, full_matrices=False)
    return u @ vh


def opq_train(x, m: int, d_out: int = None, opq_iters: int = 10, pq_iters: int = 6,
              seed: int = 0):
    """Train the OPQ rotation. Returns (R, codebooks): R is (d, d_out) fp32
    on x's device with orthonormal columns; codebooks are the PQ codebooks
    trained on the rotated data in the last iteration (None with no
    iteration)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    d = x.shape[1]
    d_out = d if d_out is None else d_out
    if d_out > d:
        raise ValueError(f"OPQ d_out {d_out} > input dim {d}")
    if d_out % m != 0:
        raise ValueError(f"OPQ output dim {d_out} not divisible by m={m}")
    r = torch.as_tensor(initial_rotation(d, d_out, seed), device=x.device)
    codebooks = None
    for it in range(opq_iters):
        xr = x @ r
        codebooks = pq.pq_train(xr, m, iters=pq_iters, seed=seed + it)
        r = _procrustes(x, _reconstruct(xr, codebooks))
    return r, codebooks
