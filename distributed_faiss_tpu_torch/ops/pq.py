"""Product quantization: codebook training, encode/decode, ADC lookup tables
(counterpart of distributed_faiss_tpu/ops/pq.py).

The products here are plain matrix products, which the JAX package leaves
to XLA: they stay torch einsum/bmm in fp32 (on CUDA without TF32,
``utils.device.resolve_device`` pins it off). The ADC scan itself — the
lookup-table gather-sum over the probed codes — is the hand kernel's
business (``ops/adc_scan.py``); ``adc_scan`` below is its plain version
under the JAX package's name.

Scores follow the ops-wide bigger-is-better convention: l2 -> negated
squared distance contributions, dot -> inner products.
"""

import torch

from distributed_faiss_tpu_torch.ops import adc_scan as _adc
from distributed_faiss_tpu_torch.ops.kmeans import kmeans_batched


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) -> (m, n, dsub)."""
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def pq_train(x, m: int, nbits: int = 8, iters: int = 20, seed: int = 0) -> torch.Tensor:
    """Train per-subspace codebooks. x: (n, d) -> (m, ksub, dsub) fp32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return kmeans_batched(_split(x, m), 1 << nbits, iters=iters, seed=seed)


def _pq_encode_block(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    xs = _split(x.float(), codebooks.shape[0])  # (m, n, dsub)
    cn = (codebooks * codebooks).sum(2)  # (m, ksub)
    ip = torch.einsum("mnd,mkd->mnk", xs, codebooks)
    d2 = cn[:, None, :] - 2.0 * ip  # ||x||^2 is constant per row: argmin-invariant
    return torch.argmin(d2, dim=2).T.to(torch.uint8)  # (n, m)


def pq_encode(x, codebooks: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """x: (n, d), codebooks: (m, ksub, dsub) -> codes (n, m) uint8.

    Row-blocked as in the JAX package: the (m, block, ksub) fp32 distance
    transient is ~0.5 GB at m=64, block=8192."""
    x = torch.as_tensor(x, dtype=torch.float32, device=codebooks.device)
    if x.shape[0] <= block:
        return _pq_encode_block(x, codebooks)
    return torch.cat([_pq_encode_block(x[s:s + block], codebooks)
                      for s in range(0, x.shape[0], block)])


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes: (n, m) uint8 -> (n, d) fp32 reconstruction."""
    m, _, dsub = codebooks.shape
    sub = torch.arange(m, device=codebooks.device)
    return codebooks[sub[None, :], codes.long()].reshape(codes.shape[0], m * dsub)


def adc_lut(q: torch.Tensor, codebooks: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Per-query ADC lookup tables: q (nq, d), codebooks (m, ksub, dsub) ->
    lut (nq, m, ksub) fp32 with score(query, code) = sum_m lut[q, m, code[m]]
    (bigger is better). The JAX package's formula, in its order:
    ``ip`` for dot, ``-(qn - 2 ip + cn)`` for l2."""
    qs = _split(q.float(), codebooks.shape[0])  # (m, nq, dsub)
    ip = torch.einsum("mnd,mkd->nmk", qs, codebooks)
    if metric == "dot":
        return ip
    qn = (qs * qs).sum(2).T  # (nq, m)
    cn = (codebooks * codebooks).sum(2)  # (m, ksub)
    return -(qn[:, :, None] - 2.0 * ip + cn[None, :, :])


def adc_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """scores[p, c] = sum_m lut[p, m, codes[p, c, m]]: lut (P, m, ksub),
    codes (P, L, m) uint8 -> (P, L) fp32. The JAX package's XLA path; here
    the plain gather-sum (``ops.adc_scan.adc_scan_plain``), which the hand
    kernels are held to."""
    return _adc.adc_scan_plain(lut, codes)
