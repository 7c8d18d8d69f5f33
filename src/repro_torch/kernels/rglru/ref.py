"""Plain PyTorch version of the RG-LRU scan kernel (``csrc/rglru.cu``).

h_t = a_t ⊙ h_{t-1} + b_t along the sequence axis, from ``h0`` (zeros by
default), as ``repro/kernels/rglru/ref.py::rglru_scan_ref``.  One step
per position, a product rounded to fp32 and then a sum rounded to fp32,
the order the kernel keeps (it is built without FMA contraction), so on
one device the two agree bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, S, R) fp32; h0: (B, R).  Returns h: (B, S, R)."""
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype, device=a.device)
         if h0 is None else h0)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
