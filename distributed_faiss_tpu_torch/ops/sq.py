"""Scalar quantization codecs (counterpart of distributed_faiss_tpu/ops/sq.py).

- sq8: per-dimension affine codec. Train learns per-dim (vmin, span);
  encode maps onto a 255-step grid with round-half-even (``torch.round``,
  like ``jnp.round``); decode is the formula ``vmin + c * (span / 255)``.
  XLA compiles that formula as one fused multiply-add with the division
  folded into a product by the fp32 constant 1/255, so the port decodes
  to the same bits the same way: ``fma(c, span * f32(1/255), vmin)``
  (``sq8_decode``; the CUDA kernel calls ``fmaf`` on the same operands).
- fp16: plain dtype narrowing.
"""

import numpy as np
import torch

# 1/255 rounded to fp32: XLA's rewrite of the division by 255
INV_255 = float(np.float32(1.0 / 255.0))


def sq8_train(x: torch.Tensor) -> dict:
    """Learn the per-dim affine range. x: (n, d) -> {"vmin", "span"} (d,) fp32."""
    x = x.float()
    vmin = x.min(dim=0).values
    vmax = x.max(dim=0).values
    span = torch.clamp_min(vmax - vmin, 1e-12)
    return {"vmin": vmin, "span": span}


def sq8_encode(x: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    q = torch.round((x.float() - vmin) / span * 255.0)
    return torch.clamp(q, 0, 255).to(torch.uint8)


def sq8_decode(codes: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """Codes (..., d) uint8 -> fp32 (..., d). The fused multiply-add is
    evaluated in fp64, where ``c * step`` (8 by 24 bits) is exact and so is
    the sum with vmin unless the two differ by more than 2**29 in
    magnitude; the one rounding back to fp32 then gives the bits of an
    fp32 fma."""
    step = (span.float() * INV_255).double()
    return (codes.double() * step + vmin.double()).float()


def fp16_encode(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16)


def fp16_decode(x: torch.Tensor) -> torch.Tensor:
    return x.float()
