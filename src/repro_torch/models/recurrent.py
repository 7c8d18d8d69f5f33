"""Griffin RG-LRU recurrent block (port of the RG-LRU half of
``repro/models/recurrent.py``): in-projection, causal depthwise conv1d,
the real-gated linear recurrent unit, the gelu gate and the
out-projection, as RecurrentGemma's recurrent layers run it.

The recurrence runs in fp32, block I/O in the config's dtype.  The
full-sequence branch (``cache=None``) computes h_t = a_t ⊙ h_{t-1} + b_t
through :func:`repro_torch.kernels.rglru.ops.rglru_scan`, the
hand-written CUDA kernel on the card (the reference's
``associative_scan``); the one-token decode step is the plain
``h = a * h_prev + b``, as in the reference.  Decode updates the cache
{"h", "conv"} in place (the reference returns a new one) and returns the
same dict.

The xLSTM cells of the reference module (mLSTM, sLSTM) come with their
own slice (ROADMAP queue 1, item 10); ``transformer.check_supported``
refuses them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models import common as cm

RGLRU_C = 8.0


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  cache: Optional[torch.Tensor] = None):
    """x: (B, S, R); w: (cw, R); cache: (B, cw-1, R), the trailing inputs
    of the past.  Sums ``w[i] * xp[:, i:i+S]`` in x's dtype in the
    reference's order.  Returns ``(y, new_cache)``, ``new_cache`` the last
    cw-1 inputs (a new tensor; the caller writes it where it keeps it)."""
    cw = w.shape[0]
    if cache is None:
        pad = torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+cw-1, R)
    y = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(cw)) + b
    new_cache = xp[:, -(cw - 1):] if cw > 1 else pad
    return y.to(x.dtype), new_cache


class RGLRU(nn.Module):
    """Weights of one recurrent block, with ``init_rglru``'s names and
    distributions: ``w_x``/``w_g`` (d, R), ``w_a``/``w_i`` (R, R),
    ``w_out`` (R, d) truncated normal over √fan_in; ``conv_w`` (cw, R)
    N(0, 0.1²); zero biases ``conv_b``, ``b_a``, ``b_i``; all in the
    config's dtype, except ``lam`` (R,) ~ U[0, 1), which stays fp32 in
    every model."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        d, r, g = cfg.d_model, cfg.rnn_width or cfg.d_model, generator
        self.w_x = cm.param(cm.dense_init(g, d, (r,), dt, device))
        self.w_g = cm.param(cm.dense_init(g, d, (r,), dt, device))
        conv = torch.empty((cfg.conv_width, r), dtype=torch.float32,
                           device=device)
        self.conv_w = cm.param(conv.normal_(0.0, 1.0, generator=g)
                               .mul_(0.1).to(dt))
        self.conv_b = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_a = cm.param(cm.dense_init(g, r, (r,), dt, device))
        self.b_a = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_i = cm.param(cm.dense_init(g, r, (r,), dt, device))
        self.b_i = cm.param(torch.zeros(r, dtype=dt, device=device))
        lam = torch.empty(r, dtype=torch.float32, device=device)
        self.lam = cm.param(lam.uniform_(0.0, 1.0, generator=g))
        self.w_out = cm.param(cm.dense_init(g, r, (d,), dt, device))


def init_rglru(cfg: ArchConfig, generator: torch.Generator, device) -> RGLRU:
    return RGLRU(cfg, generator, device)


def _rglru_gates(p: RGLRU, xc: torch.Tensor):
    """The decay ``a`` and the gated input ``b`` of the recurrence, fp32.
    ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    rg = torch.sigmoid((xc @ p.w_a).float() + p.b_a)
    ig = torch.sigmoid((xc @ p.w_i).float() + p.b_i)
    softplus = torch.logaddexp(p.lam, torch.zeros_like(p.lam))
    log_a = -RGLRU_C * softplus * rg  # (..., R) fp32
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
             * ig * xc.float())
    return a, gated


def rglru_block_fwd(p: RGLRU, cfg: ArchConfig, x: torch.Tensor, *,
                    cache: Optional[dict] = None):
    """Griffin recurrent block: in-proj → causal conv → RG-LRU → gate →
    out-proj.  ``cache`` = {"h": (B, R) fp32, "conv": (B, cw-1, R)} for a
    one-token decode step, updated in place.  Returns ``(y, new_cache)``,
    ``new_cache`` None for a full sequence."""
    xm = x @ p.w_x
    gate = F.gelu(x @ p.w_g, approximate="tanh")  # jax.nn.gelu's default
    xc, new_conv = causal_conv1d(xm, p.conv_w, p.conv_b,
                                 None if cache is None else cache["conv"])
    a, b = _rglru_gates(p, xc)
    if cache is None:
        h = rglru_scan(a, b)
    else:
        if x.shape[1] != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        h = a * cache["h"][:, None] + b  # (B, 1, R) fp32
        cache["h"].copy_(h[:, 0])
        cache["conv"].copy_(new_conv)
    y = (h.to(x.dtype) * gate) @ p.w_out
    return y, cache


def init_rglru_cache(cfg: ArchConfig, batch: int, *, device) -> dict:
    r = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                            dtype=cm.dtype_of(cfg), device=device),
    }
