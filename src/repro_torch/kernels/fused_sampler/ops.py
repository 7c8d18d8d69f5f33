"""Wrappers of the fused int8 boundary kernels over wire rows ``(..., L)``
(rows = per-sample channel slices, L = H·W): the CUDA kernels from
``csrc/fused_sampler.cu`` on CUDA tensors, the plain versions
(``ref.py``) on CPU tensors.  Replaces
``repro/kernels/fused_sampler/ops.py::fused_cfg_step_{quant,dequant}``.

``coeffs`` is the (2,) fp32 vector of
:func:`repro_torch.core.samplers.step_coeffs` on the operands' device:
the kernels read it through a pointer, so no host sync is needed."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_sampler.ref import (fused_cfg_step_dequant_ref,
                                                    fused_cfg_step_quant_ref)


def _check_common(eps_c, eps_u, coeffs, shape):
    build.check(eps_c, "eps_c", build.FLOAT_DTYPES, shape=shape)
    build.check(eps_u, "eps_u", (eps_c.dtype,), shape=shape)
    build.check(coeffs, "coeffs", (torch.float32,))
    if coeffs.numel() != 2:
        raise ValueError(f"coeffs: expected 2 values, got {coeffs.numel()}")


def fused_cfg_step_quant(x, eps_c, eps_u, coeffs, *, guidance: float = 1.0,
                         mode: str = "ddim"):
    """Emit boundary: the step's output is written straight as the wire
    payload ``(q int8 shaped like x, s fp32 (..., 1))``; the stepped
    latent never reaches memory."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    if build.on_cpu(x, eps_c, eps_u, coeffs):
        return fused_cfg_step_quant_ref(x, eps_c, eps_u, coeffs,
                                        guidance=guidance, mode=mode)
    build.check(x, "x", build.FLOAT_DTYPES)
    _check_common(eps_c, eps_u, coeffs, x.shape)
    if eps_c.dtype != x.dtype:
        raise TypeError(f"eps_c: dtype {eps_c.dtype}, expected x's {x.dtype}")
    length = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if q.numel():
        build.launch(
            "fused_cfg_step_quant", x.device, x.data_ptr(), eps_c.data_ptr(),
            eps_u.data_ptr(), build.dtype_code(x), coeffs.data_ptr(),
            float(guidance), build.MODES[mode], q.data_ptr(), s.data_ptr(),
            q.numel() // length, length,
        )
    return q, s


def fused_cfg_step_dequant(q, s, eps_c, eps_u, coeffs, *,
                           guidance: float = 1.0, mode: str = "ddim"):
    """Consume boundary: the step reads the int8 payload ``(q, s)`` as its
    latent operand (dequantized in registers); returns the stepped rows in
    ε_c's dtype."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    if build.on_cpu(q, s, eps_c, eps_u, coeffs):
        return fused_cfg_step_dequant_ref(q, s, eps_c, eps_u, coeffs,
                                          guidance=guidance, mode=mode)
    build.check(q, "q", (torch.int8,))
    build.check(s, "s", (torch.float32,), shape=q.shape[:-1] + (1,))
    _check_common(eps_c, eps_u, coeffs, q.shape)
    out = torch.empty(q.shape, dtype=eps_c.dtype, device=q.device)
    if out.numel():
        build.launch(
            "fused_cfg_step_dequant", q.device, q.data_ptr(), s.data_ptr(),
            eps_c.data_ptr(), eps_u.data_ptr(), build.dtype_code(eps_c),
            coeffs.data_ptr(), float(guidance), build.MODES[mode],
            out.data_ptr(), out.numel() // q.shape[-1], q.shape[-1],
        )
    return out
