"""Noise schedules for the two relay families (port of
``repro/core/schedules.py``).

Ladders are built on the host in fp32 with the reference's operation
order, so they equal the JAX ladders bit for bit; callers move them to
the device they sample on.

* Family "XL": VP diffusion over a Karras σ ladder (edge T=50, device
  T=25, mid T=40) — sigma matching (Eq. 4) is a real search.
* Family "F3": linear rectified-flow times, T=50 for every role.
"""
from __future__ import annotations

import torch


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """fp32 ``linspace`` computed as XLA computes ``jnp.linspace``:
    ``start·(1−step) + stop·step`` with ``step = iota · (1/(num−1))`` and
    the exact endpoint appended."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / float(div)
    step = torch.arange(div, dtype=torch.float32) * recip
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


def karras_sigmas(n: int, sigma_min: float = 0.03, sigma_max: float = 10.0,
                  rho: float = 7.0) -> torch.Tensor:
    """Monotonically decreasing Karras (EDM) sigma ladder of length n+1
    (last entry 0).  The power is taken in fp64 and rounded once, which is
    what the reference's fp32 ``pow`` returns on these inputs."""
    i = torch.arange(n, dtype=torch.float32)
    ramp = sigma_max ** (1 / rho) + i / (n - 1) * (
        sigma_min ** (1 / rho) - sigma_max ** (1 / rho)
    )
    sig = ramp.double().pow(rho).float()
    return torch.cat([sig, torch.zeros(1, dtype=torch.float32)])


def rf_times(n: int) -> torch.Tensor:
    """Linear rectified-flow times 1 → 0, length n+1.  σ(t)=t."""
    return linspace_f32(1.0, 0.0, n + 1)


def vp_alpha_bar(sigma: torch.Tensor) -> torch.Tensor:
    """VP ᾱ from the VE-style σ: ᾱ = 1/(1+σ²)."""
    return 1.0 / (1.0 + torch.square(sigma))


def sigma_match(sigmas_edge: torch.Tensor, s: int,
                sigmas_device: torch.Tensor) -> int:
    """Eq. (4): device-side start step s' = argmin_j |σ_j^(d) − σ_s^(e)|
    over the device ladder's step entry points (indices 0..T_d-1); ties go
    to the first index."""
    target = sigmas_edge[s]
    return int(torch.argmin(torch.abs(sigmas_device[:-1] - target)))
