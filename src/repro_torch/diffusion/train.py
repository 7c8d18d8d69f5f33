"""Training for the relay-family denoisers on the synthetic latent task
(port of ``repro/diffusion/train.py``).

Large models train on data (x̂0-parameterized VP diffusion for XL, x̂0-
parameterized rectified flow for F3); small and mid models are distilled
from their family's large model, which is what makes the scales'
denoising trajectories line up, the property relay inference needs.

Every loss is split in two: a draw (``_draw_*``: the noise level and the
noise, made from a ``torch.Generator`` on the host and moved to the
latent's device) and a loss over those given draws (``_loss_*``), so a
card run and a CPU run train on identical inputs.  The port does not
reproduce ``jax.random``'s bits: the reference's ``PRNGKey(k)`` becomes a
generator seeded with ``k``.  Gradients come from autograd through the
plain-torch denoisers (no kernel runs inside a loss); the optimizer is the
reference's hand-written Adam (:func:`_adam_step`), not ``torch.optim``.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import samplers
from repro_torch.core.schedules import vp_alpha_bar
from repro_torch.device import keep_fp32, resolve_device
from repro_torch.diffusion import synth
from repro_torch.diffusion.families import (NET_CONFIGS, SPECS,
                                            checkpoint_path, load_roles,
                                            make_family)
from repro_torch.models import diffusion_nets as dn
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import bias_correction

SIGMA_MIN, SIGMA_MAX = 0.03, 10.0


def _split(seed: int, n: int = 2) -> Tuple[int, ...]:
    """``n`` seeds drawn from a generator seeded with ``seed`` (the port's
    ``jax.random.split`` of a key)."""
    g = torch.Generator().manual_seed(int(seed))
    return tuple(int(s) for s in torch.randint(0, 2 ** 62, (n,), generator=g))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _sample_sigma(generator: torch.Generator, b: int,
                  low_bias: bool = False) -> torch.Tensor:
    """Log-uniform σ in [σ_min, σ_max] on the host, fp32.  With
    ``low_bias`` (distillation), 70 % of draws come from the low-noise
    region the device model serves after a relay handoff (σ ≤ 1); without
    it the second uniform is still drawn and never wins."""
    u = torch.rand(b, generator=generator)
    hi = torch.where(torch.rand(b, generator=generator)
                     < (0.7 if low_bias else 0.0), _f32(1.0), _f32(SIGMA_MAX))
    lo = torch.log(_f32(SIGMA_MIN))
    return torch.exp(lo + u * (torch.log(hi) - lo))


def _normal(generator: torch.Generator, x0: torch.Tensor):
    """N(0, 1) of ``x0``'s shape, on the host."""
    return torch.randn(x0.shape, generator=generator)


def _to(draw, x0: torch.Tensor):
    return tuple(d.to(x0.device) for d in draw)


def _draw_xl(generator, x0):
    """(σ, noise) of :func:`_loss_xl`."""
    sig = _sample_sigma(generator, x0.shape[0])
    return _to((sig, _normal(generator, x0)), x0)


def _draw_f3(generator, x0):
    """(t, noise) of :func:`_loss_f3`."""
    t = torch.rand(x0.shape[0], generator=generator)
    return _to((t, _normal(generator, x0)), x0)


def _draw_distill(generator, family: str, x0):
    """(σ or t, noise) of :func:`_loss_distill`.  XL: σ low-biased.  F3:
    70 % of t from the post-handoff region t ≤ 0.6; as in the reference,
    the low draw and the full draw are one uniform u (``t_lo = 0.6·u``,
    ``t_full = u``: both come from the same key there)."""
    b = x0.shape[0]
    if family == "XL":
        tvar = _sample_sigma(generator, b, low_bias=True)
        return _to((tvar, _normal(generator, x0)), x0)
    u = torch.rand(b, generator=generator)
    noise = _normal(generator, x0)
    mix = torch.rand(b, generator=generator) < 0.7
    return _to((torch.where(mix, u * 0.6, u), noise), x0)


def _vp_xt(x0, sig, noise):
    ab = vp_alpha_bar(sig)[:, None, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise


def _rf_xt(x0, t, noise):
    return (1 - t)[:, None, None, None] * x0 + t[:, None, None, None] * noise


def _loss_xl(net: nn.Module, x0, cond, sig, noise):
    """x̂0-parameterized VP diffusion (ε̂ is derived at sampling time, see
    ``families.vp_eps_from_x0``) at the given σ and noise."""
    pred = net(_vp_xt(x0, sig, noise), sig, cond)
    return torch.mean(torch.square(pred - x0))


def _loss_f3(net: nn.Module, x0, cond, t, noise):
    """x̂0-parameterized rectified flow (the sampler derives v = (x_t −
    x̂0)/t) at the given t and noise."""
    pred = net(_rf_xt(x0, t, noise), t, cond)
    return torch.mean(torch.square(pred - x0))


def _loss_distill(net: nn.Module, teacher: nn.Module, family: str, x0, cond,
                  tvar, noise):
    """The student matches the teacher's prediction (no gradient reaches
    the teacher) at the given noise level, mixed with a small data term."""
    xt = (_vp_xt if family == "XL" else _rf_xt)(x0, tvar, noise)
    with torch.no_grad():
        teach = teacher(xt, tvar, cond)
    pred = net(xt, tvar, cond)
    return 0.8 * torch.mean(torch.square(pred - teach)) + 0.2 * torch.mean(
        torch.square(pred - x0))


def cosine_lr(base_lr: float, i: torch.Tensor, steps: int) -> torch.Tensor:
    """The reference's schedule base·(0.1 + 0.9·½(1 + cos(π·i/steps))) in
    fp32 from the fp32 step ``i``."""
    return base_lr * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * i / steps)))


@torch.no_grad()
def _adam_step(params: Sequence[torch.Tensor], grads, m, v, step, lr,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam update in place, written as the reference writes it: m, v,
    then p − lr·(m/bc1)/(√(v/bc2) + eps) (:func:`bias_correction`).  A
    ``None`` gradient (a tensor the loss does not reach) is a zero
    gradient, as ``jax.grad`` returns for it."""
    bc1 = bias_correction(b1, step)
    bc2 = bias_correction(b2, step)
    for p, g, mi, vi in zip(params, grads, m, v):
        if g is None:
            g = torch.zeros_like(p)
        mi.copy_(b1 * mi + (1 - b1) * g)
        vi.copy_(b2 * vi + (1 - b2) * g * g)
        p.copy_(p - lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps))


class Adam:
    """The trainable parameters of one net and their Adam moments."""

    def __init__(self, net: nn.Module):
        self.params = [p for p in net.parameters() if p.requires_grad]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]


def train_step(opt: Adam, loss_fn: Callable[[], torch.Tensor], i: int,
               steps: int, base_lr: float) -> torch.Tensor:
    """One training step (the reference's jitted ``step_fn``): the loss
    and its gradients, the cosine learning rate at step ``i`` of
    ``steps``, one Adam update.  Returns the loss (not synchronized)."""
    loss = loss_fn()
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    step = torch.tensor(float(i), dtype=torch.float32,
                        device=opt.params[0].device)
    _adam_step(opt.params, grads, opt.m, opt.v, step,
               cosine_lr(base_lr, step, steps))
    return loss.detach()


def _frozen(net: nn.Module) -> nn.Module:
    return net.requires_grad_(False).eval()


def _step_batch(family: str, seed0: int, i: int, batch: int, device):
    seeds = np.arange(seed0 + i * batch, seed0 + (i + 1) * batch)
    _, x0, cond = synth.batch(seeds, family)
    return (torch.from_numpy(x0).to(device),
            torch.from_numpy(cond).to(device))


def train_model(seed: int, family: str, size: str, *, steps: int = 400,
                batch: int = 128, teacher: Optional[nn.Module] = None,
                seed0: int = 0, verbose: bool = False, device=None):
    """Train the (family, size) net for ``steps`` steps on ``device`` (CUDA
    unless given); with ``teacher`` (a trained net of the family)
    distill from it.  Step i trains on ``synth.batch`` of seeds ``seed0 +
    i·batch`` onward.  The generator seeded with ``seed`` draws the
    initial weights, then each step's draws.  Returns (net, losses), the
    net frozen."""
    dev = resolve_device(device)
    keep_fp32(dev)
    cfg = NET_CONFIGS[(family, size)]
    gen = torch.Generator().manual_seed(int(seed))
    net = dn.init_net(cfg, gen).to(dev)
    opt = Adam(net)
    if teacher is not None:
        draw = lambda x0: _draw_distill(gen, family, x0)
        loss = lambda x0, c, d: _loss_distill(net, teacher, family, x0, c, *d)
    elif family == "XL":
        draw = lambda x0: _draw_xl(gen, x0)
        loss = lambda x0, c, d: _loss_xl(net, x0, c, *d)
    else:
        draw = lambda x0: _draw_f3(gen, x0)
        loss = lambda x0, c, d: _loss_f3(net, x0, c, *d)
    base_lr = 3e-3 if cfg.kind == "mmdit" else 1e-3  # conv net needs lower

    t0 = time.time()
    losses = []
    for i in range(1, steps + 1):
        x0, cond = _step_batch(family, seed0, i, batch, dev)
        d = draw(x0)
        val = train_step(opt, lambda: loss(x0, cond, d), i, steps, base_lr)
        losses.append(float(val))
        if verbose and i % 100 == 0:
            print(f"  [{family}/{size}] step {i}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s)")
    return _frozen(net), losses


def train_family_pair(seed: int, family: str, *, steps_large: int = 400,
                      steps_small: int = 400, batch: int = 64,
                      verbose: bool = False, device=None):
    """The large net on data, then the small net distilled from it, each
    from a seed drawn from ``seed``'s generator (the reference splits its
    key).  Returns (large, small, {"loss_large", "loss_small"})."""
    k1, k2 = _split(seed)
    large, ll = train_model(k1, family, "large", steps=steps_large,
                            batch=batch, verbose=verbose, device=device)
    small, ls = train_model(k2, family, "small", steps=steps_small,
                            batch=batch, teacher=large, verbose=verbose,
                            device=device)
    return large, small, {"loss_large": ll, "loss_small": ls}


def teacher_pool(family: str, large: nn.Module, xT: torch.Tensor, cond):
    """States of the large net's own sampling trajectories over the edge
    ladder from ``xT``: (states (T−1, n, ...), their noise levels (T−1,)),
    the state after step i at level ``sigmas_edge[i + 1]``, the final
    σ = 0 state dropped."""
    spec = SPECS[family]()
    fam = make_family(family, large, large)
    sampler = samplers.sampler_for(spec.kind)
    with torch.no_grad():
        _, traj = sampler(fam.large_fn, large, xT, spec.sigmas_edge, cond)
    return traj[:-1], spec.sigmas_edge[1:-1].to(xT.device)


def finetune_on_trajectories(seed: int, family: str, large: nn.Module,
                             small: nn.Module, *, steps: int = 400,
                             n_traj: int = 192, batch: int = 128,
                             verbose: bool = False, device=None):
    """Trajectory-matched distillation: fine-tune a copy of ``small`` on
    states of the teacher's own sampling trajectories (the distribution
    the device model sees after a relay handoff), matching the teacher's
    prediction at each.  ``xT`` is drawn from a generator seeded with
    ``seed``; the picks from ``np.random.default_rng(0)``, as the
    reference's.  Returns the fine-tuned net, frozen."""
    dev = resolve_device(device)
    keep_fp32(dev)
    spec = SPECS[family]()
    gen = torch.Generator().manual_seed(int(seed))
    xT = torch.randn((n_traj,) + spec.latent_shape, generator=gen).to(dev)
    return finetune_from(family, large, small, xT, steps=steps, batch=batch,
                         verbose=verbose)


def finetune_from(family: str, large: nn.Module, small: nn.Module, xT, *,
                  steps: int, batch: int, verbose: bool = False):
    """:func:`finetune_on_trajectories` from given initial latents ``xT``
    (n_traj, ...) on their device: the pool of :func:`teacher_pool` over
    the conditioning of seeds 500,000 onward, then ``steps`` steps."""
    dev = xT.device
    n_traj = xT.shape[0]
    seeds = np.arange(500_000, 500_000 + n_traj)
    _, _, cond = synth.batch(seeds, family)
    cond = torch.from_numpy(cond).to(dev)
    states, sig_pool = teacher_pool(family, large, xT, cond)
    n_lvls = states.shape[0]

    net = copy.deepcopy(small).requires_grad_(True)
    opt = Adam(net)

    def loss(x, t, c):
        with torch.no_grad():
            teach = large(x, t, c)
        return torch.mean(torch.square(net(x, t, c) - teach))

    rng = np.random.default_rng(0)
    for i in range(1, steps + 1):
        li = torch.from_numpy(rng.integers(0, n_lvls, size=batch)).to(dev)
        ti = torch.from_numpy(rng.integers(0, n_traj, size=batch)).to(dev)
        x, t, c = states[li, ti], sig_pool[li], cond[ti]
        val = train_step(opt, lambda: loss(x, t, c), i, steps, 5e-4)
        if verbose and i % 100 == 0:
            print(f"  [traj-distill {family}] step {i}: loss "
                  f"{float(val):.5f}")
    return _frozen(net)


def _save_nets(path, family: str, nets) -> None:
    """One checkpoint of ``{role: net}`` in the reference's layout (roles
    in its flatten order, sorted)."""
    flat = {}
    for role in sorted(nets):
        cfg = NET_CONFIGS[(family, role)]
        for k, a in ckpt.params_to_jax(nets[role].state_dict(), cfg).items():
            flat[f"{role}/{k}"] = a
    ckpt.save(path, flat)


def get_or_train_families(ckpt_dir="results/ckpts", *, steps: int = 400,
                          batch: int = 64, verbose: bool = False,
                          families=("XL", "F3"), with_mid: bool = False,
                          device=None):
    """Train (or load cached) relay families on ``device`` (CUDA unless
    given).  A family whose ``diffusion_<fam>.ckpt`` exists is loaded;
    otherwise its pair is trained (seed 100 + i for the i-th family),
    fine-tuned on the teacher's trajectories when ``steps >= 300`` (seed
    200 + i, ``min(350, steps)`` steps) and written there.
    ``with_mid=True`` loads or distills each family's mid stage (seed 300 +
    i) in its own ``diffusion_<fam>_mid.ckpt``.  The files are the
    reference's format: its ``checkpoint.restore`` reads them."""
    dev = resolve_device(device)
    keep_fp32(dev)
    out = {}
    for i, fam in enumerate(families):
        path = checkpoint_path(ckpt_dir, fam)
        if path.exists():
            nets = load_roles(path, fam, ("large", "small"), dev)
            large, small = nets["large"], nets["small"]
        else:
            if verbose:
                print(f"training family {fam} ({steps} steps each)...")
            large, small, _ = train_family_pair(
                100 + i, fam, steps_large=steps, steps_small=steps,
                batch=batch, verbose=verbose, device=dev)
            if steps >= 300:
                small = finetune_on_trajectories(
                    200 + i, fam, large, small, steps=min(350, steps),
                    verbose=verbose, device=dev)
            _save_nets(path, fam, {"large": large, "small": small})
        mid = None
        if with_mid:
            mid_path = checkpoint_path(ckpt_dir, fam, mid=True)
            if mid_path.exists():
                mid = load_roles(mid_path, fam, ("mid",), dev)["mid"]
            else:
                if verbose:
                    print(f"distilling mid-size {fam} stage ({steps} "
                          f"steps)...")
                mid, _ = train_model(300 + i, fam, "mid", steps=steps,
                                     batch=batch, teacher=large,
                                     verbose=verbose, device=dev)
                _save_nets(mid_path, fam, {"mid": mid})
        out[fam] = make_family(fam, large, small, mid_params=mid)
    return out
