"""Plain PyTorch versions of the kernels of ``csrc/fused_sampler.cu``:

* the interior sampler step (:func:`fused_cfg_step_ref`): the CFG combine
  and the affine DDIM or rectified-flow update, as the Pallas kernel
  ``fused_cfg_step_fwd`` computes them;
* the fused int8 boundaries: the CFG combine and the two-term sampler step
  of :func:`repro_torch.core.samplers.step_update`, followed by the
  row-wise int8 quantize (emit) or preceded by the dequantize (consume)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.samplers import step_update
from repro_torch.kernels.quant.ref import dequant_int8_ref, quant_int8_ref


def fused_cfg_step_ref(x, eps_c, eps_u, *, guidance: float, mode: str,
                       c1: float, c2: float):
    """The interior step in fp32, cast back to x's dtype.  ε̂ = ε_u +
    g·(ε_c − ε_u) with no skip at g = 1 (with ε_u ≡ ε_c that is ε_c for
    finite values); "ddim": x′ = c1·x + c2·ε̂ (the affine collapse, with
    :func:`ddim_coeffs`), "rf": x′ = x + c1·ε̂ (c2 unused).  Each operation
    rounds once, in the kernel's order."""
    xf, ec, eu = (t.to(torch.float32) for t in (x, eps_c, eps_u))
    eps = eu + guidance * (ec - eu)
    out = c1 * xf + c2 * eps if mode == "ddim" else xf + c1 * eps
    return out.to(x.dtype)


def ddim_coeffs(ab_t, ab_s):
    """Affine DDIM coefficients (c1, c2) of x′ = c1·x + c2·ε̂ from the
    (ᾱ_t, ᾱ_s) pair, in numpy's arithmetic of the inputs' type."""
    c1 = np.sqrt(ab_s / ab_t)
    c2 = np.sqrt(1 - ab_s) - np.sqrt(ab_s) * np.sqrt(1 - ab_t) / np.sqrt(ab_t)
    return float(c1), float(c2)


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
