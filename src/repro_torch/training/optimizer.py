"""AdamW with fp32, bf16 or log-domain int8 moments, and a cosine schedule
with warm-up (port of ``repro/training/optimizer.py``).

The port's parameters are a mapping of name to tensor (an LM's
``named_parameters()``), its optimizer state ``{"m": {name: moment},
"v": {name: moment}, "count": int32 scalar}``, a moment being a tensor
(fp32 or bf16) or, for int8 states, the ``{"q", "s"}`` pair of
:func:`repro_torch.quantization.quant_log8`, as in the reference.  The
update writes the parameters in place (the reference returns new ones).

The scalars (the rate, ``b ** count``) are fp32 tensor arithmetic, as
the reference's under ``jit``; XLA may multiply by a reciprocal where the
port divides, so the tests hold them in ulps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from repro_torch.quantization import dequant_log8, quant_log8


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"  # fp32 | bf16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(c: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``lr`` to
    ``min_lr_frac * lr`` at ``total_steps``; fp32 from the step tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps)
                       / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)


def bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """Adam's 1 − b**step in fp32 from the fp32 ``step``."""
    return 1 - b ** step


def _encode(x: torch.Tensor, mode: str):
    if mode == "fp32":
        return x.to(torch.float32)
    if mode == "bf16":
        return x.to(torch.bfloat16)
    if mode == "int8":
        # log-domain quantization: Adam moments span orders of magnitude
        # within a row; linear int8 zeroes the small v entries
        return quant_log8(x)
    raise ValueError(mode)


def _decode(x, mode: str) -> torch.Tensor:
    if mode == "int8":
        return dequant_log8(x)
    return x.to(torch.float32)


def adamw_init(params: Mapping[str, torch.Tensor], c: OptConfig) -> dict:
    """Zero moments in ``c.state_dtype`` beside each parameter, count 0."""
    def zero_like(p):
        return _encode(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), c.state_dtype)

    device = next(iter(params.values())).device
    return {
        "m": {n: zero_like(p) for n, p in params.items()},
        "v": {n: zero_like(p) for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, in fp32; the
    norm before clipping)``.  The squares are summed tensor by tensor in
    the mapping's order (the reference sums over its stacked leaves, so
    the two differ in the last bits)."""
    g2 = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in grads.values())
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: g.to(torch.float32) * scale for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, Optional[torch.Tensor]], state: dict,
                 c: OptConfig, ranks: Optional[Mapping[str, int]] = None):
    """One AdamW step: clip, moments, bias corrections, decoupled weight
    decay.  ``params`` are written in place; returns ``(params, new_state,
    {"grad_norm", "lr"})``.

    A ``None`` gradient (a tensor the loss does not reach) is a zero
    gradient, as ``jax.grad`` returns for it.  A parameter is decayed when
    the rank of its leaf in the reference's tree is 2 or more: ``ranks``
    gives that rank (``training/checkpoint.py::lm_leaf_ranks``, where a
    pattern layer's leaves carry the stacked repeat axis), by default the
    tensor's own."""
    grads = {n: torch.zeros_like(p) if grads.get(n) is None else grads[n]
             for n, p in params.items()}
    grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
    count = state["count"] + 1
    lr = schedule(c, count)
    b1c = bias_correction(c.b1, count.to(torch.float32))
    b2c = bias_correction(c.b2, count.to(torch.float32))
    new_m: Dict[str, object] = {}
    new_v: Dict[str, object] = {}
    for n, p in params.items():
        g = grads[n]
        m = c.b1 * _decode(state["m"][n], c.state_dtype) + (1 - c.b1) * g
        v = (c.b2 * _decode(state["v"][n], c.state_dtype)
             + (1 - c.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + c.eps)
        rank = p.dim() if ranks is None else ranks[n]
        decay = c.weight_decay if rank >= 2 else 0.0
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (step + decay * p32))
        new_m[n] = _encode(m, c.state_dtype)
        new_v[n] = _encode(v, c.state_dtype)
    return params, {"m": new_m, "v": new_v, "count": count}, {
        "grad_norm": gnorm, "lr": lr}
