"""Wrapper of the RG-LRU scan kernel: the CUDA kernel from ``csrc/rglru.cu``
on CUDA tensors, the plain version (``ref.py``) on CPU tensors.  Replaces
``repro/kernels/rglru/{kernel,ops}.py``; nothing is padded, the kernel
masks ragged widths itself.

Gradients: where ``a`` or ``b`` requires one, the call goes through
:class:`RGLRUScan`, a :class:`torch.autograd.Function` whose forward is the
same kernel (the plain version on the CPU) and whose backward recomputes
the plain version from the saved ``a`` and ``b`` and returns its
vector-Jacobian product.  The reference's Pallas kernel has no backward,
and its LM differentiates the plain ``associative_scan``, so no backward
kernel is ported; one is queued in ROADMAP queue 2.  Calls that need no
gradient launch the kernel alone, as before.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels import build
from repro_torch.kernels.rglru.ref import rglru_scan_ref


@rl.declares("rglru_scan", lambda a, b: (*rl.scan_work(a.numel()), True))
def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1 from h_0 = 0, in fp32.
    a, b: (B, S, R), cast to fp32.  Returns h: (B, S, R) fp32."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"share one (B, S, R) shape")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return _forward(a, b)


class RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` under autograd: the forward is the kernel on CUDA
    tensors (the plain version on CPU tensors), the backward the plain
    version's VJP, recomputed from the saved ``a`` and ``b``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            return torch.autograd.grad(rglru_scan_ref(*ins), ins, grad)


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on CUDA operands, the plain version on CPU ones."""
    if build.on_cpu(a, b):
        return rglru_scan_ref(a, b)
    build.check(a, "a", (torch.float32,))
    build.check(b, "b", (torch.float32,))
    h = torch.empty_like(a)
    if h.numel():
        build.launch("rglru_scan", a.device, a.data_ptr(), b.data_ptr(),
                     h.data_ptr(), *a.shape)
    return h
