"""Unified low-precision quantization with shared error/deviation
accounting (port of ``repro/quantization.py``).

* the relay handoff wire format: :func:`quant_latent` /
  :func:`dequant_latent` over the :func:`latent_to_rows` row layout, and
  :func:`latent_roundtrip` composed from them;
* error feedback for compressed collectives
  (:func:`fused_error_feedback_step`);
* the log-domain int8 quantizer for optimizer moments.

The row-wise halves go through :mod:`repro_torch.kernels.quant`: its
CUDA kernels on CUDA tensors, its plain version on CPU tensors.  Rounding
is half to even throughout, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.kernels.quant.ops import dequant_int8, quant_int8

# ---------------------------------------------------------------------------
# linear row-wise int8
# ---------------------------------------------------------------------------


def quant_rowwise(x: torch.Tensor) -> dict:
    """Symmetric int8 quantization with one fp32 scale per last-dim row."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    q, s = quant_int8(x.contiguous())
    return {"q": q, "s": s}


def dequant_rowwise(qs: dict) -> torch.Tensor:
    return dequant_int8(qs["q"].contiguous(), qs["s"].contiguous())


# ---------------------------------------------------------------------------
# log-domain (dynamic-exponent) int8 for Adam moments
# ---------------------------------------------------------------------------

LOG8_RANGE = 24.0  # exponent range: 2^-24 … 1 relative to the row max


def quant_log8(x: torch.Tensor) -> dict:
    """Signed log-scale int8: |q| ∈ 1..127 encodes log2(|x|/rowmax)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax, 1.0)
    r = torch.abs(xf) / scale
    e = torch.log2(torch.clamp_min(r, 2.0 ** (-LOG8_RANGE - 1)))
    mag = torch.round(127.0 * (1.0 + e / LOG8_RANGE))
    mag = torch.where(r < 2.0 ** (-LOG8_RANGE), 0.0, torch.clamp(mag, 1, 127))
    q = (torch.sign(xf) * mag).to(torch.int8)
    return {"q": q, "s": scale}


def dequant_log8(qs: dict) -> torch.Tensor:
    q = qs["q"].to(torch.float32)
    mag = torch.abs(q)
    val = torch.exp2(LOG8_RANGE * (mag / 127.0 - 1.0)) * qs["s"]
    return torch.where(mag == 0, 0.0, torch.sign(q) * val)


# ---------------------------------------------------------------------------
# quantizer registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Quantizer:
    """A named (quant, dequant) pair with shared error accounting;
    ``rel_bound`` bounds |x − roundtrip(x)| against the row max."""

    name: str
    quant: Callable[[torch.Tensor], dict]
    dequant: Callable[[dict], torch.Tensor]
    rel_bound: float

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        return self.dequant(self.quant(x))

    def error(self, x: torch.Tensor) -> torch.Tensor:
        """Residual left behind by quantization (for error feedback)."""
        return x.to(torch.float32) - self.roundtrip(x)


QUANTIZERS: Dict[str, Quantizer] = {
    "rowwise": Quantizer("rowwise", quant_rowwise, dequant_rowwise,
                         rel_bound=0.5 / 127.0),
    "log8": Quantizer("log8", quant_log8, dequant_log8,
                      rel_bound=2.0 ** (0.5 * LOG8_RANGE / 127.0) - 1.0),
}


def get_quantizer(name) -> Quantizer:
    if isinstance(name, Quantizer):
        return name
    try:
        return QUANTIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown quantizer {name!r}; registered: {sorted(QUANTIZERS)}"
        ) from None


# ---------------------------------------------------------------------------
# shared accounting: error feedback (collectives) and deviation (Eq. 1)
# ---------------------------------------------------------------------------


def fused_error_feedback_step(x: torch.Tensor, err: torch.Tensor,
                              quantizer="rowwise"):
    """One error-feedback quantization step with the reconstruction handed
    back: ``(qs, rec, new_err)``, the int8 round trip computed once."""
    qz = get_quantizer(quantizer)
    v = x.to(torch.float32) + err
    qs = qz.quant(v)
    rec = qz.dequant(qs)
    return qs, rec, v - rec


def relative_deviation(x: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """‖rec − x‖₂ / ‖x‖₂ — the Eq. 1-style deviation of a reconstruction
    from its reference (a 0-d tensor on x's device)."""
    xf = x.to(torch.float32)
    return torch.linalg.vector_norm(rec.to(torch.float32) - xf) / (
        torch.linalg.vector_norm(xf) + 1e-12
    )


def payload_bytes(qs: dict) -> int:
    """Bytes on the wire of a quantized payload (int8 + fp32 scales)."""
    return qs["q"].numel() * qs["q"].element_size() + qs["s"].numel() * 4


# ---------------------------------------------------------------------------
# relay handoff wire format
# ---------------------------------------------------------------------------


def latent_to_rows(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) latent → contiguous (..., C, H·W) wire rows: each
    row is one sample's spatial slice of one channel.  A pure layout move."""
    xm = torch.movedim(x, -1, -3)  # (..., C, H, W)
    return xm.reshape(xm.shape[:-2] + (-1,)).contiguous()


def rows_to_latent(rows: torch.Tensor, latent_shape,
                   dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`latent_to_rows`: (..., C, H·W) rows back to a
    contiguous (..., H, W, C) latent of trailing shape ``latent_shape``."""
    h, w, c = latent_shape
    xm = rows.reshape(rows.shape[:-2] + (c, h, w))
    return torch.movedim(xm, -3, -1).to(dtype).contiguous()


def quant_latent(x: torch.Tensor, quantizer="rowwise"):
    """Quantize a (..., H, W, C) latent into the wire currency: the
    ``{"q", "s"}`` payload over :func:`latent_to_rows`.  Returns
    ``(qs, payload_bytes)``."""
    qs = get_quantizer(quantizer).quant(latent_to_rows(x))
    return qs, payload_bytes(qs)


def dequant_latent(qs: dict, latent_shape, dtype=torch.float32,
                   quantizer="rowwise") -> torch.Tensor:
    """Reconstruct a (..., H, W, C) latent from the wire currency."""
    return rows_to_latent(get_quantizer(quantizer).dequant(qs), latent_shape,
                          dtype)


def latent_roundtrip(x: torch.Tensor, quantizer="rowwise"):
    """Channel-rows int8 round trip of a (..., H, W, C) latent, composed
    from :func:`quant_latent` + :func:`dequant_latent`.  Returns
    ``(reconstruction in x's dtype, payload bytes)``."""
    qs, nbytes = quant_latent(x, quantizer)
    return dequant_latent(qs, x.shape[-3:], x.dtype, quantizer), nbytes
