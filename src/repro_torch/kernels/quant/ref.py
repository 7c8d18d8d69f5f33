"""Plain PyTorch version of the row-wise int8 kernels (``csrc/quant.cu``).

Same operations in the same order as the kernels, so on one device the
two agree bit for bit: scale = amax/127 by IEEE division (1.0 where
amax = 0), q = clip(round-half-even(x/scale), ±127)."""
from __future__ import annotations

import torch


def row_scale(amax: torch.Tensor) -> torch.Tensor:
    """Per-row scale amax/127, or 1.0 for an all-zero row.  The divisor
    is a tensor on amax's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead, which is not the IEEE
    quotient the kernels compute."""
    return torch.where(amax > 0, amax / amax.new_full((), 127.0), 1.0)


def quant_int8_ref(x: torch.Tensor):
    """Row-wise symmetric int8 over the last dim: ``(q int8, s fp32 (..., 1))``."""
    xf = x.to(torch.float32)
    scale = row_scale(torch.amax(torch.abs(xf), dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequant_int8_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q·s in fp32."""
    return q.to(torch.float32) * s
