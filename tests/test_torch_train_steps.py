"""Training step for step, the port against the JAX package on the CPU.

* The distillation loss (``_loss_distill``, XL's low-biased σ and F3's
  coupled t) and its gradients, as ``tests/test_torch_train.py`` holds the
  other two losses.
* Ten consecutive steps of the port's training step
  (``repro_torch/diffusion/train.py::train_step``, what ``train_model``
  runs each step) against the reference's jitted ``step_fn``
  (``repro/diffusion/train.py:138-143``, copied below with a narrow
  config), on a narrow UNet and a narrow MMDiT from the reference's
  ``init_net`` weights, fed the reference's key sequence (``key, sub =
  split(key)`` a step, the loss's draws from ``sub``) and the same
  ``synth.batch`` data.  Every step's loss within ``STEP_LOSS_RTOL``;
  after the tenth step every parameter element within ``STEP_RTOL`` of
  its tensor's largest reference value, except elements whose reference
  gradient fell under ``FLOOR`` of its tensor's largest at some step: at
  that level the two frameworks' rounding can flip the gradient's sign,
  and Adam moves such an element by about ±lr whatever its size.  Those
  beyond ``STEP_RTOL`` are counted and at most ``FLOOR_ELEMENTS``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import synth as jsynth
from repro.diffusion import train as jt
from repro.models import diffusion_nets as jdn
from repro.training.checkpoint import _flatten
from repro_torch.diffusion import train as tt
from repro_torch.models import diffusion_nets as tdn
from repro_torch.training import checkpoint as tck
from test_torch_train import (check_loss_and_gradients, port_net,
                              _reference_draws)

torch.set_num_threads(1)

STEPS, BATCH = 10, 32
NARROW = {"XL": tdn.DiffNetConfig("unet", width=8, depth=1),
          "F3": tdn.DiffNetConfig("mmdit", width=16, depth=2)}
# every step's loss: read 8.6e-7 (UNet), 1.3e-6 (MMDiT)
STEP_LOSS_RTOL = 5e-6
# parameters after ten steps, off the noise floor: read 9.6e-6 (UNet),
# 3.6e-6 (MMDiT)
STEP_RTOL = 5e-5
FLOOR = 1e-4
# floor elements beyond STEP_RTOL: read 3 (UNet) and 0 (MMDiT)
FLOOR_ELEMENTS = 8


@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_distill_loss_and_gradients_match_reference(fam):
    check_loss_and_gradients("distill", fam)


def reference_steps(cfg, fam, key, data):
    """The reference's training loop (``train_model``'s, at ``cfg``) over
    ``data``; returns (params, losses, floor masks by key)."""
    params = jdn.init_net(key, cfg)
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    jloss = jt._loss_xl if fam == "XL" else jt._loss_f3
    loss_fn = lambda p, k, x, c: jloss(p, cfg, k, x, c)
    base_lr = 3e-3 if cfg.kind == "mmdit" else 1e-3

    @jax.jit
    def step_fn(params, m, v, key, x0, cond, i):
        loss, grads = jax.value_and_grad(loss_fn)(params, key, x0, cond)
        lr = base_lr * (0.1 + 0.9 * 0.5 * (1 + jnp.cos(jnp.pi * i / STEPS)))
        params, m, v = jt._adam_step(params, grads, m, v, i, lr)
        return params, m, v, loss, grads

    losses, floor = [], {}
    for i, (sub, x0, cond) in enumerate(data, start=1):
        params, m, v, loss, grads = step_fn(params, m, v, sub, x0, cond,
                                            jnp.float32(i))
        losses.append(float(loss))
        for k, g in _flatten(grads).items():
            g = np.abs(g)
            low = (g < FLOOR * g.max()) if g.max() > 0 else np.zeros(g.shape,
                                                                      bool)
            floor[k] = floor.get(k, low) | low
    return params, losses, floor


@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_training_steps_match_reference(fam):
    cfg = NARROW[fam]
    key = jax.random.PRNGKey(3)
    data, k = [], key
    for i in range(1, STEPS + 1):
        _, x0, cond = jsynth.batch(np.arange(i * BATCH, (i + 1) * BATCH), fam)
        k, sub = jax.random.split(k)
        data.append((sub, jnp.asarray(x0), jnp.asarray(cond)))
    ref_params, ref_losses, floor = reference_steps(cfg, fam, key, data)

    net = port_net(jdn.init_net(key, cfg), cfg)
    opt = tt.Adam(net)
    loss = tt._loss_xl if fam == "XL" else tt._loss_f3
    base_lr = 3e-3 if cfg.kind == "mmdit" else 1e-3
    worst_loss = 0.0
    for i, (sub, x0, cond) in enumerate(data, start=1):
        x0, cond = (torch.from_numpy(np.array(a)) for a in (x0, cond))
        draws = [torch.from_numpy(np.array(d)) for d in
                 _reference_draws(fam.lower(), fam, sub, x0)]
        got = tt.train_step(opt, lambda: loss(net, x0, cond, *draws), i,
                            STEPS, base_lr)
        want = ref_losses[i - 1]
        worst_loss = max(worst_loss, abs(float(got) - want) / abs(want))
    assert worst_loss <= STEP_LOSS_RTOL, worst_loss

    got = tck.params_to_jax(net.state_dict(), cfg)
    ref = _flatten(ref_params)
    assert list(got) == list(ref)
    worst, beyond = 0.0, 0
    for k in ref:
        err = (np.abs(got[k].astype(np.float64) - ref[k])
               / np.max(np.abs(ref[k])))
        off = ~floor[k]
        if off.any():
            worst = max(worst, float(err[off].max()))
        beyond += int((err[floor[k]] > STEP_RTOL).sum())
    assert worst <= STEP_RTOL, worst
    assert beyond <= FLOOR_ELEMENTS, beyond
