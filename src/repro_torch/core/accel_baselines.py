"""Training-free single-model acceleration baselines of the paper's Table
III (port of ``repro/core/accel_baselines.py``), adapted to the repo's
denoisers:

* DeepCache — reuses the denoiser's output across adjacent steps
  (interval N): the whole-output cache stands in for the cached deep UNet
  features;
* T-GATE — freezes the conditioning pathway after the gate step: the
  conditioning is replaced by zeros, post-gate calls priced at a fraction
  of a full call;
* SADA — when the prediction changes slowly (‖ε_t − ε_{t−1}‖ under a
  threshold, a norm over the whole batch), the next model call is
  skipped and its prediction reused.

Each sampler runs on its input latent's device and returns ``(x_final,
n_model_evals)``.  The step tail is the port's sampler step: an rf step
is one call of the interior-step kernel at guidance 1, a DDIM step the
two-term :func:`repro_torch.core.samplers.ddim_update` with ᾱ from
:func:`vp_alpha_bar`.  ``sigmas`` is the family's ladder on the host.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import samplers
from repro_torch.core.schedules import vp_alpha_bar
from repro_torch.device import keep_fp32
from repro_torch.kernels.fused_sampler import ops as fused_ops


def _step_update(kind: str, x, pred, sig_t, sig_s):
    """x at ``sig_s`` from x at ``sig_t`` and the prediction (host fp32
    ladder values), with the coefficients :func:`samplers.step_coeffs`
    computes."""
    if kind == "ddim":
        ab = torch.stack([vp_alpha_bar(sig_t), vp_alpha_bar(sig_s)])
        return samplers.step_update("ddim", x, pred, ab.to(x.device))
    # rf euler (sigmas are times)
    return fused_ops.fused_cfg_step(x, pred, pred, guidance=1.0,
                                    c1=float(sig_s - sig_t), c2=0.0,
                                    mode="rf")


def _start(x, sigmas):
    """The ladder's times on the latent's device; TF32 off on the card."""
    keep_fp32(x.device)
    return sigmas.to(x.device)


def deepcache_sample(kind: str, fn: Callable, params, x, sigmas, cond,
                     *, interval: int = 2):
    """Re-evaluate the model every ``interval`` steps; reuse the cached
    prediction otherwise."""
    times = _start(x, sigmas)
    n = len(sigmas) - 1
    evals = 0
    pred = None
    for i in range(n):
        if i % interval == 0:
            pred = fn(params, x, times[i], cond)
            evals += 1
        x = _step_update(kind, x, pred, sigmas[i], sigmas[i + 1])
    return x, evals


def tgate_sample(kind: str, fn: Callable, params, x, sigmas, cond,
                 *, gate_step: int = 20, cost_frac_after: float = 0.62):
    """Freeze the conditioning after ``gate_step``.  Returns fractional
    evals: a post-gate call costs ``cost_frac_after`` of a full call."""
    times = _start(x, sigmas)
    n = len(sigmas) - 1
    frozen_cond = torch.zeros_like(cond)
    evals = 0.0
    for i in range(n):
        if i < gate_step:
            pred = fn(params, x, times[i], cond)
            evals += 1.0
        else:
            pred = fn(params, x, times[i], frozen_cond)
            evals += cost_frac_after
        x = _step_update(kind, x, pred, sigmas[i], sigmas[i + 1])
    return x, evals


def sada_sample(kind: str, fn: Callable, params, x, sigmas, cond,
                *, threshold: float = 0.12):
    """Skip the next model call when the prediction is stable, reusing the
    last one.  The stability test reads one scalar to the host a model
    call (``bool(delta < threshold)``), as the reference's does."""
    times = _start(x, sigmas)
    n = len(sigmas) - 1
    evals = 0
    prev_pred = None
    skip_next = False
    for i in range(n):
        if skip_next and prev_pred is not None:
            pred = prev_pred
            skip_next = False
        else:
            pred = fn(params, x, times[i], cond)
            evals += 1
            if prev_pred is not None:
                delta = torch.linalg.norm(pred - prev_pred) / (
                    torch.linalg.norm(prev_pred) + 1e-8)
                skip_next = bool(delta < threshold)
            prev_pred = pred
        x = _step_update(kind, x, pred, sigmas[i], sigmas[i + 1])
    return x, evals


def full_sample(kind: str, fn: Callable, params, x, sigmas, cond):
    """Every step a model call: the baselines' reference point."""
    times = _start(x, sigmas)
    n = len(sigmas) - 1
    for i in range(n):
        pred = fn(params, x, times[i], cond)
        x = _step_update(kind, x, pred, sigmas[i], sigmas[i + 1])
    return x, n
