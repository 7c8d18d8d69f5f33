"""Plain PyTorch versions of the fused int8 boundary kernels
(``csrc/fused_sampler.cu``): the CFG combine and the two-term sampler step
of :func:`repro_torch.core.samplers.step_update`, followed by the row-wise
int8 quantize (emit) or preceded by the dequantize (consume)."""
from __future__ import annotations

import torch

from repro_torch.core.samplers import step_update
from repro_torch.kernels.quant.ref import dequant_int8_ref, quant_int8_ref


def combine(eps_c: torch.Tensor, eps_u: torch.Tensor, guidance: float):
    """Classifier-free guidance on evaluated nets; guidance 1.0 returns
    ε_c untouched (``cfg_combine``'s skip path)."""
    if guidance == 1.0:
        return eps_c
    return eps_u + guidance * (eps_c - eps_u)


def fused_cfg_step_quant_ref(x, eps_c, eps_u, coeffs, *, guidance, mode):
    """Emit: step update in fp32, then row-wise int8 of the stepped rows.
    Returns ``(q, s)``."""
    out = step_update(
        mode, x.to(torch.float32),
        combine(eps_c.to(torch.float32), eps_u.to(torch.float32), guidance),
        coeffs.reshape(2),
    )
    return quant_int8_ref(out)


def fused_cfg_step_dequant_ref(q, s, eps_c, eps_u, coeffs, *, guidance, mode):
    """Consume: x = q·s, then the step update; output in ε_c's dtype."""
    out = step_update(
        mode, dequant_int8_ref(q, s),
        combine(eps_c.to(torch.float32), eps_u.to(torch.float32), guidance),
        coeffs.reshape(2),
    )
    return out.to(eps_c.dtype)
