"""Wrappers of the sampler-step kernels of ``csrc/fused_sampler.cu``: the
CUDA kernels on CUDA tensors, the plain versions (``ref.py``) on CPU
tensors.  Replaces ``repro/kernels/fused_sampler/ops.py``:

* :func:`fused_cfg_step` — the interior step over a latent of any shape
  (nothing is padded);
* :func:`fused_cfg_step_quant` / :func:`fused_cfg_step_dequant` — the
  fused int8 boundaries over wire rows ``(..., L)`` (rows = per-sample
  channel slices, L = H·W).  Their ``coeffs`` is the (2,) fp32 vector of
  :func:`repro_torch.core.samplers.step_coeffs` on the operands' device:
  the kernels read it through a pointer, so no host sync is needed."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_sampler.ref import (fused_cfg_step_dequant_ref,
                                                    fused_cfg_step_quant_ref,
                                                    fused_cfg_step_ref)


def fused_cfg_step(x, eps_c, eps_u, *, guidance: float = 1.0, c1: float = 1.0,
                   c2: float = 0.0, mode: str = "ddim"):
    """One interior sampler step: ε̂ = ε_u + g·(ε_c − ε_u), then "ddim" x′ =
    c1·x + c2·ε̂ or "rf" x′ = x + c1·ε̂, in fp32; returns a new tensor in
    x's dtype.  x, ε_c and ε_u share one shape and dtype (fp32 or bf16)
    and are contiguous; ε_u may be the same tensor as ε_c."""
    if mode not in build.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(build.MODES)}")
    build.check(x, "x", build.FLOAT_DTYPES)
    build.check(eps_c, "eps_c", (x.dtype,), shape=x.shape)
    build.check(eps_u, "eps_u", (x.dtype,), shape=x.shape)
    if build.on_cpu(x, eps_c, eps_u):
        return fused_cfg_step_ref(x, eps_c, eps_u, guidance=guidance,
                                  mode=mode, c1=c1, c2=c2)
    out = torch.empty_like(x)
    if out.numel():
        build.launch(
            "fused_cfg_step", x.device, x.data_ptr(), eps_c.data_ptr(),
            eps_u.data_ptr(), build.dtype_code(x), float(guidance),
            float(c1), float(c2), build.MODES[mode], out.data_ptr(),
            out.numel(),
        )
    return out


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
