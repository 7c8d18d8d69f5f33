"""Fused int8 segment boundaries: the sampler step that is the handoff
(port of ``repro/core/boundary.py``).

* **emit** — the last step of the emitting segment combines CFG, applies
  the two-term step update and writes the wire payload ``{"q" int8,
  "s" fp32}`` over the handoff's channel-row layout;
* **consume** — the first step of the consuming segment reads the payload
  as its latent operand and steps straight off it.

With the rowwise quantizer the ``"wire"`` emit and the consume go through
:mod:`repro_torch.kernels.fused_sampler` — its CUDA kernels on CUDA
tensors, its plain versions on CPU tensors.  The accounting flavors
(``"wire_dev"``, ``"wire_dev_latent"``) keep the stepped latent by
definition, so they compose the step with the quant and dequant halves of
:mod:`repro_torch.quantization` (the quant kernels on CUDA).

Parity contract: on one device, emit → consume and the unfused step →
``latent_roundtrip`` → step give the same payload bits, bytes and latents,
because the kernels and their plain versions round at the same places.
Against the JAX reference: exact bytes, payload ints exact but for ±1
flips at rounding ties, scales within 1 fp32 ulp, latents ~1e-6 relative.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import samplers
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_sampler.ops import (fused_cfg_step_dequant,
                                                    fused_cfg_step_quant)
from repro_torch.kernels.fused_sampler.ref import combine
from repro_torch.quantization import (dequant_latent, latent_to_rows,
                                      payload_bytes, quant_latent,
                                      relative_deviation, rows_to_latent)

# emit flavors: what the fused producer step returns beyond the payload.
#   "wire"            — payload only (the serving path; the fused kernel)
#   "wire_dev"        — + the Eq. 1 deviation pct of the payload vs the
#                       stepped latent (relay accounting)
#   "wire_dev_latent" — + the stepped latent itself
EMIT_FLAVORS = ("wire", "wire_dev", "wire_dev_latent")


def _net_eps(fn, params, x, t, cond, uncond, guidance: float):
    """Evaluate the denoiser(s) for one step: (ε_c, ε_u, effective
    guidance) — a single evaluation without uncond or at unit scale."""
    if uncond is None or guidance == 1.0:
        ec = fn(params, x, t, cond)
        return ec, ec, 1.0
    return fn(params, x, t, cond), fn(params, x, t, uncond), float(guidance)


def emit_fn(kind: str, quantizer: str = "rowwise", guidance: float = 1.0,
            flavor: str = "wire") -> Callable:
    """The emit tail of one boundary config: ``tail(x, ec, eu, coeffs) ->
    dict`` with ``"wire"`` (the payload) and, per ``flavor``,
    ``"dev_pct"`` / ``"latent"``.  ``coeffs`` is the (2,) vector of
    :func:`samplers.step_coeffs` on the latent's device."""
    if flavor not in EMIT_FLAVORS:
        raise ValueError(f"unknown emit flavor {flavor!r}; one of {EMIT_FLAVORS}")

    def tail(x, ec, eu, coeffs):
        if flavor == "wire" and quantizer == "rowwise":
            q, s = fused_cfg_step_quant(
                latent_to_rows(x), latent_to_rows(ec), latent_to_rows(eu),
                coeffs, guidance=float(guidance), mode=kind,
            )
            return {"wire": {"q": q, "s": s}}
        out = samplers.step_update(kind, x, combine(ec, eu, guidance), coeffs)
        qs, _ = quant_latent(out, quantizer)
        res = {"wire": qs}
        if flavor != "wire":
            rec = dequant_latent(qs, out.shape[-3:], out.dtype, quantizer)
            res["dev_pct"] = relative_deviation(out, rec) * 100.0
        if flavor == "wire_dev_latent":
            res["latent"] = out
        return res

    return tail


def peek_fn(quantizer: str = "rowwise") -> Callable:
    """The wire → latent reconstruction ``peek(q, s, latent_shape)`` — what
    the consuming step's denoiser reads."""
    def peek(q, s, latent_shape):
        return dequant_latent({"q": q, "s": s}, latent_shape, torch.float32,
                              quantizer)

    return peek


def consume_fn(kind: str, quantizer: str = "rowwise",
               guidance: float = 1.0) -> Callable:
    """The consume tail ``tail(q, s, ec, eu, coeffs, latent_shape) -> next
    latent``: the step update reads the int8 payload directly."""
    def tail(q, s, ec, eu, coeffs, latent_shape):
        if quantizer == "rowwise":
            rows = fused_cfg_step_dequant(
                q, s, latent_to_rows(ec), latent_to_rows(eu), coeffs,
                guidance=float(guidance), mode=kind,
            )
            return rows_to_latent(rows, latent_shape, torch.float32)
        x = dequant_latent({"q": q, "s": s}, latent_shape, torch.float32,
                           quantizer)
        return samplers.step_update(kind, x, combine(ec, eu, guidance),
                                    coeffs)

    return tail


def quant_step(kind: str, fn, params, x, sigmas, i: int, cond, uncond,
               guidance: float, *, quantizer: str = "rowwise",
               flavor: str = "wire") -> dict:
    """Run sampler step ``i`` and emit the wire payload — the producer side
    of a compressed segment boundary.  Returns ``"wire"``, ``"bytes"``
    (payload bytes, same accounting as ``latent_roundtrip``) and per
    ``flavor`` ``"dev_pct"`` / ``"latent"``."""
    ec, eu, g = _net_eps(fn, params, x, sigmas[i].to(x.device), cond, uncond,
                         guidance)
    coeffs = samplers.step_coeffs(kind, sigmas, i, x.device)
    res = dict(emit_fn(kind, quantizer, g, flavor)(x, ec, eu, coeffs))
    res["bytes"] = payload_bytes(res["wire"])
    return res


def dequant_step(kind: str, fn, params, qs: dict, latent_shape, sigmas,
                 i: int, cond, uncond, guidance: float, *,
                 quantizer: str = "rowwise"):
    """Run sampler step ``i`` straight off the wire payload — the consumer
    side of a compressed segment boundary.  The denoiser sees the
    reconstructed latent; the step tail reads the int8 payload.  Returns
    the next latent."""
    latent_shape = tuple(latent_shape)
    x = peek_fn(quantizer)(qs["q"], qs["s"], latent_shape)
    ec, eu, g = _net_eps(fn, params, x, sigmas[i].to(x.device), cond, uncond,
                         guidance)
    coeffs = samplers.step_coeffs(kind, sigmas, i, x.device)
    return consume_fn(kind, quantizer, g)(qs["q"], qs["s"], ec, eu, coeffs,
                                          latent_shape)


def warm(latent_shape, quantizer: str = "rowwise", device=None) -> int:
    """Fire every fused boundary tail once for one latent shape on
    ``device`` (the card unless the caller passes ``"cpu"``): both sampler
    kinds, both emit accounting flavors, the wire peek and the consume
    tail, at batch 4 and guidance 1.  Eager PyTorch compiles nothing per
    shape, so what this warms is the kernel library, built on the first
    launch, before the first compressed relay request needs it.  Returns
    the number of tail calls fired, as the reference's ``warm`` does."""
    latent_shape = tuple(latent_shape)
    dev = resolve_device(device)
    x = torch.zeros((4,) + latent_shape, dtype=torch.float32, device=dev)
    eps = torch.zeros_like(x)
    n = 0
    for kind in ("ddim", "rf"):
        # any valid coefficient pair fires the tail; values don't matter
        coeffs = torch.tensor([0.5, 0.6], dtype=torch.float32, device=dev)
        wire = None
        for flavor in ("wire", "wire_dev"):
            wire = emit_fn(kind, quantizer, 1.0, flavor)(
                x, eps, eps, coeffs)["wire"]
            n += 1
        peek_fn(quantizer)(wire["q"], wire["s"], latent_shape)
        n += 1
        consume_fn(kind, quantizer, 1.0)(
            wire["q"], wire["s"], eps, eps, coeffs, latent_shape)
        n += 1
    return n
