"""Samplers: VP-DDIM (paper Eq. 2) and rectified-flow Euler (paper Eq. 3)
with classifier-free guidance and opt-in trajectory capture (port of
``repro/core/samplers.py``).

The loop over ladder entries [start, stop) is a Python loop.  Ladders stay
on the host; a segment moves its time values and the per-step coefficient
vectors (:func:`step_coeffs`, computed on the host in fp32) to the
latent's device once, so a card run and a CPU run step with the same
coefficients.

A rectified-flow step runs its combine and update in one call of the
interior-step kernel (:func:`repro_torch.kernels.fused_sampler.ops.fused_cfg_step`):
ε̂ = ε_u + g·(ε_c − ε_u), then x + Δt·ε̂, each operation rounded once as in
:func:`cfg_combine` and :func:`rf_update`, so the step keeps their bits.
Without ``uncond`` or at g = 1 the unconditional net is not evaluated and
ε_u is ε_c itself, for which the combine returns ε_c.  A DDIM step stays
on the two-term :func:`ddim_update`: the kernel's affine DDIM form is not
bit-identical to it (≈5e-7 a step).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.schedules import vp_alpha_bar

# denoiser signature: eps/v = fn(params, x, sigma_or_t, cond)


def cfg_combine(fn, params, x, t, cond, uncond, scale: float):
    if uncond is None or scale == 1.0:
        return fn(params, x, t, cond)
    e_c = fn(params, x, t, cond)
    e_u = fn(params, x, t, uncond)
    return e_u + scale * (e_c - e_u)


def ddim_update(x, eps, ab_t, ab_s):
    """DDIM's elementwise tail (Eq. 2, VP) in the two-term form — x̂0, then
    recombine — which the fused boundary kernels reproduce exactly."""
    x0_hat = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_s) * x0_hat + torch.sqrt(1 - ab_s) * eps


def rf_update(x, v, dt):
    """The rectified-flow Euler tail (Eq. 3)."""
    return x + dt * v


def step_coeffs(kind: str, sigmas: torch.Tensor, i: int,
                device=None) -> torch.Tensor:
    """The (2,) fp32 coefficient vector of step ``i``: "ddim" → (ᾱ_t, ᾱ_s),
    "rf" → (Δt, 0); computed on the ladder's device, returned on
    ``device`` (the latent's)."""
    if kind == "ddim":
        c = torch.stack([vp_alpha_bar(sigmas[i]), vp_alpha_bar(sigmas[i + 1])])
    else:
        dt = sigmas[i + 1] - sigmas[i]
        c = torch.stack([dt, torch.zeros_like(dt)])
    return c if device is None else c.to(device)


def step_update(kind: str, x, eps, coeffs):
    """One sampler-step tail from its :func:`step_coeffs` vector."""
    if kind == "ddim":
        return ddim_update(x, eps, coeffs[0], coeffs[1])
    return rf_update(x, eps, coeffs[0])


def _sample(kind: str, fn: Callable, params, x: torch.Tensor,
            sigmas: torch.Tensor, cond, start: int, stop: Optional[int],
            uncond, guidance: float, capture_traj: bool):
    stop = len(sigmas) - 1 if stop is None else stop
    steps = range(start, stop)
    if not steps:
        return x, (x.new_empty((0,) + x.shape) if capture_traj else None)
    # the kernel's plain versions import this module
    from repro_torch.kernels.fused_sampler import ops as fused_ops

    times = sigmas.to(x.device)
    host_coeffs = torch.stack([step_coeffs(kind, sigmas, i) for i in steps])
    if kind == "rf":
        # Δt of each step: the fp32 values rf_update multiplies by, read on
        # the host (no device sync)
        dts = host_coeffs[:, 0].tolist()
    else:
        coeffs = host_coeffs.to(x.device)
    guided = uncond is not None and guidance != 1.0
    traj = []
    for k, i in enumerate(steps):
        if kind == "rf":
            e_c = fn(params, x, times[i], cond)
            e_u = fn(params, x, times[i], uncond) if guided else e_c
            x = fused_ops.fused_cfg_step(
                x, e_c, e_u, guidance=float(guidance) if guided else 1.0,
                c1=dts[k], c2=0.0, mode="rf")
        else:
            eps = cfg_combine(fn, params, x, times[i], cond, uncond, guidance)
            x = step_update(kind, x, eps, coeffs[k])
        if capture_traj:
            traj.append(x)
    return x, (torch.stack(traj) if capture_traj else None)


def ddim_sample(eps_fn: Callable, params, x: torch.Tensor,
                sigmas: torch.Tensor, cond, *, start: int = 0,
                stop: Optional[int] = None, uncond=None,
                guidance: float = 1.0, capture_traj: bool = True):
    """DDIM (Eq. 2) over sigma ladder entries [start, stop).  Returns
    ``(x_final, trajectory)`` — the trajectory (steps, *x.shape), or
    ``None`` with ``capture_traj=False``."""
    return _sample("ddim", eps_fn, params, x, sigmas, cond, start, stop,
                   uncond, guidance, capture_traj)


def rf_euler_sample(v_fn: Callable, params, x: torch.Tensor,
                    times: torch.Tensor, cond, *, start: int = 0,
                    stop: Optional[int] = None, uncond=None,
                    guidance: float = 1.0, capture_traj: bool = True):
    """Rectified-flow Euler integration (Eq. 3): x_{i+1} = x_i + Δt·v(x_i,
    t_i).  Same contract as :func:`ddim_sample`."""
    return _sample("rf", v_fn, params, x, times, cond, start, stop,
                   uncond, guidance, capture_traj)


def sampler_for(kind: str) -> Callable:
    """"ddim" → :func:`ddim_sample`, "rf" → :func:`rf_euler_sample`."""
    return ddim_sample if kind == "ddim" else rf_euler_sample


def _host_normal(generator: torch.Generator, like: torch.Tensor):
    """N(0, 1) of ``like``'s shape and dtype, drawn on the host from
    ``generator`` and moved to ``like``'s device."""
    return torch.randn(like.shape, generator=generator,
                       dtype=like.dtype).to(like.device)


def vp_noise(generator: torch.Generator, x0: torch.Tensor, sigma):
    """Forward-noise a clean latent to level σ in VP coords."""
    ab = vp_alpha_bar(torch.as_tensor(sigma, dtype=torch.float32,
                                      device=x0.device))
    n = _host_normal(generator, x0)
    return torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * n


def rf_noise(generator: torch.Generator, x0: torch.Tensor, t):
    """Forward-noise a clean latent to rectified-flow time t."""
    n = _host_normal(generator, x0)
    t = torch.as_tensor(t, dtype=torch.float32, device=x0.device)
    return (1.0 - t) * x0 + t * n
