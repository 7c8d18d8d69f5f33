"""Relay family registry: schedules + net configs + trained denoisers
(port of ``repro/diffusion/families.py``), and the loader of trained
checkpoints that ``repro_torch/diffusion/train.py::get_or_train_families``
reads on a cache hit.

Each family carries a (large, small) pair sharing a latent space plus an
optional mid-size stage.  The denoisers are ``nn.Module``s predicting the
clean latent; the role functions turn that into ε̂ (VP, family XL) or v̂
(rectified flow, family F3) for the samplers."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.relay import FamilySpec
from repro_torch.core.schedules import karras_sigmas, rf_times, vp_alpha_bar
from repro_torch.device import resolve_device
from repro_torch.models import diffusion_nets as dn
from repro_torch.training.checkpoint import load_flat, params_from_jax, subtree

T_EDGE_XL, T_DEV_XL = 50, 25  # SDXL / Vega (Karras, different ladders)
T_MID_XL = 40  # mid stage ("SSD-1B"): its own Karras ladder
T_F3 = 50  # SD3.5 L and M (identical linear schedule), mid stage likewise


def xl_spec() -> FamilySpec:
    return FamilySpec(
        name="XL", kind="ddim",
        sigmas_edge=karras_sigmas(T_EDGE_XL),
        sigmas_device=karras_sigmas(T_DEV_XL),
        sigmas_mid=karras_sigmas(T_MID_XL),
    )


def f3_spec() -> FamilySpec:
    return FamilySpec(
        name="F3", kind="rf",
        sigmas_edge=rf_times(T_F3),
        sigmas_device=rf_times(T_F3),
        sigmas_mid=rf_times(T_F3),
    )


NET_CONFIGS = {
    ("XL", "large"): dn.XL_LARGE,
    ("XL", "mid"): dn.XL_MID,
    ("XL", "small"): dn.XL_SMALL,
    ("F3", "large"): dn.F3_LARGE,
    ("F3", "mid"): dn.F3_MID,
    ("F3", "small"): dn.F3_SMALL,
}

SPECS = {"XL": xl_spec, "F3": f3_spec}


def _expand(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def rf_velocity_from_x0(x0_hat, x, t):
    """RF velocity from the x̂0-parameterized net: v = (x_t − x̂0)/t, with
    t clamped at 1e-3."""
    t = torch.clamp_min(torch.as_tensor(t, dtype=torch.float32,
                                        device=x.device), 1e-3)
    return (x - x0_hat) / _expand(t, x)


def vp_eps_from_x0(x0_hat, x, sigma):
    """VP ε̂ from the x̂0-parameterized net: ε̂ = (x − √ᾱ·x̂0)/√(1−ᾱ), with
    1−ᾱ clamped at 1e-6."""
    ab = _expand(vp_alpha_bar(torch.as_tensor(sigma, dtype=torch.float32,
                                              device=x.device)), x)
    return (x - torch.sqrt(ab) * x0_hat) / torch.sqrt(torch.clamp_min(1.0 - ab,
                                                                      1e-6))


@dataclass
class Family:
    spec: FamilySpec
    large_cfg: dn.DiffNetConfig
    small_cfg: dn.DiffNetConfig
    large_params: nn.Module
    small_params: nn.Module
    mid_cfg: Optional[dn.DiffNetConfig] = None
    mid_params: Optional[nn.Module] = None

    def _apply(self, params, x, t, cond):
        out = params(x, t, cond)
        if self.spec.kind == "rf":
            return rf_velocity_from_x0(out, x, t)
        return vp_eps_from_x0(out, x, t)

    def large_fn(self, params, x, t, cond):
        return self._apply(params, x, t, cond)

    def small_fn(self, params, x, t, cond):
        return self._apply(params, x, t, cond)

    def mid_fn(self, params, x, t, cond):
        if self.mid_params is None:
            raise ValueError(
                f"family {self.spec.name} has no mid-size net (load with "
                f"with_mid=True to enable cascade programs)"
            )
        return self._apply(params, x, t, cond)

    @property
    def has_mid(self) -> bool:
        return self.mid_params is not None


def role_fn(family, role: str):
    """Denoiser callable of a model role — works for :class:`Family` and
    for duck-typed toy families."""
    return getattr(family, f"{role}_fn")


def role_params(family, role: str):
    return getattr(family, f"{role}_params")


def make_family(name: str, large_params, small_params,
                mid_params=None) -> Family:
    return Family(
        spec=SPECS[name](),
        large_cfg=NET_CONFIGS[(name, "large")],
        small_cfg=NET_CONFIGS[(name, "small")],
        large_params=large_params,
        small_params=small_params,
        mid_cfg=NET_CONFIGS[(name, "mid")],
        mid_params=mid_params,
    )


def load_net(flat, cfg: dn.DiffNetConfig, device) -> nn.Module:
    """A denoiser with the reference's trained weights, in eval mode."""
    net = dn.build_net(cfg)
    net.load_state_dict(params_from_jax(flat, cfg))
    return net.eval().to(device)


def checkpoint_path(ckpt_dir, fam: str, mid: bool = False) -> Path:
    """``diffusion_<fam>.ckpt`` (the large and small nets) or
    ``diffusion_<fam>_mid.ckpt`` (the mid stage) under ``ckpt_dir``."""
    return Path(ckpt_dir) / f"diffusion_{fam}{'_mid' if mid else ''}.ckpt"


def load_roles(path, fam: str, roles, device) -> Dict[str, nn.Module]:
    """The nets of ``roles`` of family ``fam`` from one checkpoint."""
    flat = load_flat(path)
    return {role: load_net(subtree(flat, role), NET_CONFIGS[(fam, role)],
                           device) for role in roles}


def load_families(ckpt_dir="results/ckpts", *, with_mid: bool = False,
                  device=None) -> Dict[str, Family]:
    """Load both relay families from their checkpoints
    (``diffusion_<fam>.ckpt``, and ``diffusion_<fam>_mid.ckpt`` with
    ``with_mid``) onto ``device`` (CUDA unless given).  Raises
    ``FileNotFoundError`` naming a missing checkpoint; train one with
    :func:`repro_torch.diffusion.train.get_or_train_families`."""
    dev = resolve_device(device)
    out = {}
    for fam in SPECS:
        paths = [checkpoint_path(ckpt_dir, fam)]
        if with_mid:
            paths.append(checkpoint_path(ckpt_dir, fam, mid=True))
        for p in paths:
            if not p.exists():
                raise FileNotFoundError(
                    f"{p} missing: train it with "
                    "repro_torch.diffusion.train.get_or_train_families"
                )
        nets = load_roles(paths[0], fam, ("large", "small"), dev)
        if with_mid:
            nets.update(load_roles(paths[1], fam, ("mid",), dev))
        out[fam] = make_family(fam, nets["large"], nets["small"],
                               mid_params=nets.get("mid"))
    return out
