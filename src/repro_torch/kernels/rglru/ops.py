"""Wrapper of the RG-LRU scan kernel: the CUDA kernel from ``csrc/rglru.cu``
on CUDA tensors, the plain version (``ref.py``) on CPU tensors.  Replaces
``repro/kernels/rglru/{kernel,ops}.py``; nothing is padded, the kernel
masks ragged widths itself."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1 from h_0 = 0, in fp32.
    a, b: (B, S, R), cast to fp32.  Returns h: (B, S, R) fp32."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"share one (B, S, R) shape")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if build.on_cpu(a, b):
        return rglru_scan_ref(a, b)
    build.check(a, "a", (torch.float32,))
    build.check(b, "b", (torch.float32,))
    h = torch.empty_like(a)
    if h.numel():
        build.launch("rglru_scan", a.device, a.data_ptr(), b.data_ptr(),
                     h.data_ptr(), *a.shape)
    return h
