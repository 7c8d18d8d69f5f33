"""Diffusion training's pieces, the port (``repro_torch/diffusion/train.py``
and ``models/diffusion_nets.py::init_net``) against the JAX package on the
CPU.

* ``init_net``: the reference's keys, order and shapes (through
  ``params_to_jax``), exact zeros where the reference initializes zeros,
  every other tensor's mean and standard deviation within five standard
  errors of the reference's distribution, the same seed the same weights.
* ``_sample_sigma`` on the port's generator: the range [σ_min, σ_max], the
  share of σ ≤ 1 with and without ``low_bias`` within five binomial
  standard errors of its expectation, the same number of draws either
  way; the distillation draw for F3 couples t_lo = 0.6·t_full.
* The losses, fed the reference's own draws (its key splits and
  ``_sample_sigma``) and the reference's ``init_net`` weights carried
  across: the loss within ``LOSS_RTOL`` and every gradient (autograd
  against ``jax.grad``, max |Δ| over max |reference| per tensor) within
  ``GRAD_RTOL``; a tensor the port leaves without a gradient (the last
  MMDiT layer's text-stream output, MLP) has an all-zero reference
  gradient.
* Adam and the learning rate: the bias corrections and the cosine rate
  within ``ADAM_ULPS`` fp32 ulps of the jitted reference expressions, one
  ``_adam_step`` within ``ADAM_RTOL``, and a ``None`` gradient equal to a
  zero gradient.

The distillation loss and ten whole training steps against the reference
are in ``tests/test_torch_train_steps.py``; families, checkpoints and the
trajectory fine-tune in ``tests/test_torch_train_families.py``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import families as jfam
from repro.diffusion import train as jt
from repro.models import diffusion_nets as jdn
from repro.training.checkpoint import _flatten
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.diffusion import train as tt
from repro_torch.models import diffusion_nets as tdn
from repro_torch.training import checkpoint as tck

torch.set_num_threads(1)

NETS = [(f, r) for f in ("XL", "F3") for r in ("large", "mid", "small")]
# loss and gradients, port against jax.grad on the same draws and weights
# (batch 64): losses read 1.39e-7 (XL), 1.20e-7 (F3), 1.06e-7 and 1.27e-7
# (distillation XL and F3); gradients 3.4e-6 (XL, up/0/conv2), 3.7e-7
# (F3, patch), 2.0e-6 and 2.6e-7
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
# bias corrections and the cosine learning rate against the reference's
# expressions: equal bit for bit to them run eagerly; under jit (as the
# reference trains) XLA folds π·i/steps into i·(π/steps), which moves the
# angle by an ulp and the rate by up to 5 ulps (read: 5 at step 7 of 10,
# base 3e-3); the bias corrections read 0
ADAM_ULPS = 8
# one Adam step on the same tree, params and moments: read 5.0e-8
ADAM_RTOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale) if scale else float(
        np.max(np.abs(a)))


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


def port_net(params, cfg, grad=True) -> torch.nn.Module:
    """The port's net with the reference's parameter tree carried across."""
    net = tdn.build_net(cfg)
    net.load_state_dict(tck.params_from_jax(_flatten(params), cfg))
    return net.requires_grad_(grad)


def _scale(key: str, shape) -> float:
    """The reference's standard deviation of a drawn tensor (HWIO conv
    kernels, (cin, cout) dense weights, ``pos``)."""
    if key.endswith("pos"):
        return 0.02
    if len(shape) == 4:
        return 1.0 / math.sqrt(shape[0] * shape[1] * shape[2])
    return 1.0 / math.sqrt(shape[0])


@pytest.mark.parametrize("fam,role", NETS)
def test_init_net_matches_reference_distributions(fam, role):
    cfg = tfam.NET_CONFIGS[(fam, role)]
    ref = _flatten(jax.jit(jdn.init_net, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))
    net = tdn.init_net(cfg, torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in net.parameters())
    got = tck.params_to_jax(net.state_dict(), cfg)
    assert list(got) == list(ref)
    for key, a in got.items():
        assert a.shape == ref[key].shape and a.dtype == np.float32, key
        if not ref[key].any():
            assert not a.any(), key
            continue
        n, s = a.size, _scale(key, a.shape)
        assert abs(a.mean()) <= 5 * s / math.sqrt(n), key
        assert abs(a.std() / s - 1) <= 5 / math.sqrt(2 * n), key


def test_init_net_is_seeded():
    cfg = tfam.NET_CONFIGS[("F3", "small")]
    a, b, c = (tdn.init_net(cfg, torch.Generator().manual_seed(s)).state_dict()
               for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["patch"], c["patch"])


@pytest.mark.parametrize("low_bias", [False, True])
def test_sample_sigma_range_and_share(low_bias):
    n = 20_000
    gen = torch.Generator().manual_seed(4)
    sig = tt._sample_sigma(gen, n, low_bias=low_bias)
    assert sig.dtype == torch.float32 and sig.shape == (n,)
    eps = float(np.finfo(np.float32).eps)
    assert float(sig.min()) >= tt.SIGMA_MIN * (1 - 4 * eps)
    assert float(sig.max()) <= tt.SIGMA_MAX * (1 + 4 * eps)
    # log-uniform up to σ_max: P(σ ≤ 1) = ln(1/σ_min) / ln(σ_max/σ_min); the
    # low-biased draws put 70 % on [σ_min, 1]
    p_hi = math.log(1 / tt.SIGMA_MIN) / math.log(tt.SIGMA_MAX / tt.SIGMA_MIN)
    p = 0.7 + 0.3 * p_hi if low_bias else p_hi
    share = float((sig <= 1.0).float().mean())
    assert abs(share - p) <= 5 * math.sqrt(p * (1 - p) / n)
    # the second uniform is drawn either way
    other = torch.Generator().manual_seed(4)
    tt._sample_sigma(other, n, low_bias=not low_bias)
    assert torch.equal(gen.get_state(), other.get_state())


def test_distill_draw_couples_t_lo_and_t_full():
    """F3's distillation draw: t_lo = 0.6·u and t_full = u from one
    uniform u (the reference draws both from key k1), 70 % low."""
    b = 4096
    x0 = torch.zeros(b, 8, 8, 4)
    t, noise = tt._draw_distill(torch.Generator().manual_seed(9), "F3", x0)
    again = torch.Generator().manual_seed(9)
    u = torch.rand(b, generator=again)
    assert noise.shape == x0.shape
    low = ~torch.eq(t, u)
    assert torch.equal(t[low], u[low] * 0.6)
    share = float(low.float().mean())
    assert abs(share - 0.7) <= 5 * math.sqrt(0.21 / b)
    sig, _ = tt._draw_distill(torch.Generator().manual_seed(9), "XL", x0)
    assert float(sig.min()) >= tt.SIGMA_MIN * 0.999


def _reference_draws(kind, fam, key, x0):
    """The reference's draws of one loss, from its own key splits."""
    b = x0.shape[0]
    if kind == "xl":
        k1, k2 = jax.random.split(key)
        return jt._sample_sigma(k1, b), jax.random.normal(k2, x0.shape)
    if kind == "f3":
        k1, k2 = jax.random.split(key)
        return jax.random.uniform(k1, (b,)), jax.random.normal(k2, x0.shape)
    k1, k2, k3 = jax.random.split(key, 3)
    if fam == "XL":
        return (jt._sample_sigma(k1, b, low_bias=True),
                jax.random.normal(k2, x0.shape))
    t = jnp.where(jax.random.uniform(k3, (b,)) < 0.7,
                  jax.random.uniform(k1, (b,)) * 0.6,
                  jax.random.uniform(k1, (b,)))
    return t, jax.random.normal(k2, x0.shape)


@pytest.mark.parametrize("kind,fam", [("xl", "XL"), ("f3", "F3")])
def test_loss_and_gradients_match_reference(kind, fam):
    check_loss_and_gradients(kind, fam)


def check_loss_and_gradients(kind, fam):
    """One loss at the reference's ``init_net`` weights (the distillation
    teacher too), batch 64 of ``synth.batch``, the reference's draws."""
    role = "small" if kind == "distill" else "large"
    cfg = jfam.NET_CONFIGS[(fam, role)]
    params = jdn.init_net(jax.random.PRNGKey(0), cfg)
    _, x0, cond = synth.batch(np.arange(64), fam)
    key = jax.random.PRNGKey(5)
    xj, cj = jnp.asarray(x0), jnp.asarray(cond)
    if kind == "xl":
        ref_loss = lambda p: jt._loss_xl(p, cfg, key, xj, cj)
        port_loss = tt._loss_xl
    elif kind == "f3":
        ref_loss = lambda p: jt._loss_f3(p, cfg, key, xj, cj)
        port_loss = tt._loss_f3
    else:
        t_cfg = jfam.NET_CONFIGS[(fam, "large")]
        t_params = jdn.init_net(jax.random.PRNGKey(1), t_cfg)
        ref_loss = lambda p: jt._loss_distill(p, cfg, t_params, t_cfg, fam,
                                              key, xj, cj)
        teacher = port_net(t_params, t_cfg, grad=False)
        port_loss = lambda net, *a: tt._loss_distill(net, teacher, fam, *a)
    loss_j, grads_j = jax.jit(jax.value_and_grad(ref_loss))(params)
    draws = [torch.from_numpy(np.array(d))
             for d in _reference_draws(kind, fam, key, x0)]
    net = port_net(params, cfg)
    loss = port_loss(net, torch.from_numpy(x0), torch.from_numpy(cond),
                     *draws)
    assert abs(loss.item() - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    named = list(net.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    missing = {n for (n, _), g in zip(named, grads) if g is None}
    want = set()
    if cfg.kind == "mmdit":  # the last layer's text stream reaches nothing
        want = {f"layers.{cfg.depth - 1}.{k}"
                for k in ("o_txt", "mlp1_txt", "mlp2_txt")}
    assert missing == want
    got = tck.params_to_jax(
        {n: torch.zeros_like(p) if g is None else g
         for (n, p), g in zip(named, grads)}, cfg)
    ref = _flatten(grads_j)
    assert list(got) == list(ref)
    for k in ref:
        if not ref[k].any():
            assert not got[k].any(), k
    worst = max(_rel(got[k], ref[k]) for k in ref)
    assert worst <= GRAD_RTOL, worst


def _moments(tree, rng, positive=False):
    return jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)) * 1e-3
                              if positive else rng.normal(size=a.shape) * 1e-2,
                              jnp.float32), tree)


def _port_list(tree, cfg, net):
    """A reference tree as tensors in the order of ``net``'s parameters."""
    sd = tck.params_from_jax(_flatten(tree), cfg)
    return [sd[n].clone() for n, _ in net.named_parameters()]


@pytest.mark.parametrize("i,steps", [(1, 10), (7, 10), (300, 350)])
def test_bias_corrections_and_lr_match_reference(i, steps):
    step_j = jnp.float32(i)
    step_t = torch.tensor(float(i), dtype=torch.float32)
    for b in (0.9, 0.999):
        ref = lambda s: 1 - b ** s
        got = tt.bias_correction(b, step_t)
        assert _ulps(got, ref(step_j)) == 0
        assert _ulps(got, jax.jit(ref)(step_j)) <= ADAM_ULPS
    for base in (3e-3, 1e-3, 5e-4):
        # train.py:141, inside the reference's jitted step_fn
        ref = lambda s: base * (0.1 + 0.9 * 0.5 * (
            1 + jnp.cos(jnp.pi * s / steps)))
        got = tt.cosine_lr(base, step_t, steps)
        assert _ulps(got, ref(step_j)) == 0
        assert _ulps(got, jax.jit(ref)(step_j)) <= ADAM_ULPS


def test_adam_step_matches_reference():
    cfg = jfam.NET_CONFIGS[("F3", "small")]
    rng = np.random.default_rng(2)
    params = jdn.init_net(jax.random.PRNGKey(3), cfg)
    grads, m = _moments(params, rng), _moments(params, rng)
    v = _moments(params, rng, positive=True)
    step, lr = jnp.float32(3), jnp.float32(2e-3)
    ref = jax.jit(jt._adam_step)(params, grads, m, v, step, lr)
    net = port_net(params, cfg, grad=False)
    p, g, mt, vt = (_port_list(t, cfg, net) for t in (params, grads, m, v))
    tt._adam_step(p, g, mt, vt, torch.tensor(3.0), torch.tensor(2e-3))
    for got, want in zip((p, mt, vt), ref):
        sd = dict(zip((n for n, _ in net.named_parameters()), got))
        flat = tck.params_to_jax(sd, cfg)
        want = _flatten(want)
        assert max(_rel(flat[k], want[k]) for k in want) <= ADAM_RTOL


def test_none_gradient_is_a_zero_gradient():
    """A tensor the loss does not reach: the port's ``None`` gradient
    updates it and its moments exactly as a zero gradient does, and as the
    reference's zero-gradient update within ``ADAM_RTOL``."""
    rng = np.random.default_rng(6)
    shape = (32, 32)
    p0, m0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    v0 = np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-3
    runs = []
    for g in (None, torch.zeros(shape)):
        p, m, v = (torch.from_numpy(a.copy()) for a in (p0, m0, v0))
        tt._adam_step([p], [g], [m], [v], torch.tensor(4.0),
                      torch.tensor(3e-3))
        runs.append((p, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ref = jax.jit(jt._adam_step)(
        {"w": jnp.asarray(p0)}, {"w": jnp.zeros(shape)}, {"w": jnp.asarray(m0)},
        {"w": jnp.asarray(v0)}, jnp.float32(4), jnp.float32(3e-3))
    for got, want in zip(runs[0], ref):
        assert _rel(got, want["w"]) <= ADAM_RTOL


@pytest.mark.parametrize("which", ["vp", "rf"])
def test_forward_noise_matches_reference_formula(which):
    """``vp_noise`` and ``rf_noise`` (``core/samplers.py``) equal the
    reference's (``repro/core/samplers.py:169-180``) fed the port's draw,
    which comes from the given generator on the host."""
    from repro.core import schedules as jsched
    from repro_torch.core import samplers as tsamplers

    x0 = np.random.default_rng(8).normal(size=(3, 8, 8, 4)).astype(np.float32)
    level = 0.37
    fn = tsamplers.vp_noise if which == "vp" else tsamplers.rf_noise
    got = fn(torch.Generator().manual_seed(2), torch.from_numpy(x0), level)
    n = jnp.asarray(torch.randn(x0.shape, generator=torch.Generator()
                                .manual_seed(2)).numpy())
    if which == "vp":
        ab = jsched.vp_alpha_bar(jnp.float32(level))
        want = jnp.sqrt(ab) * x0 + jnp.sqrt(1 - ab) * n
    else:
        want = (1.0 - jnp.float32(level)) * x0 + jnp.float32(level) * n
    assert _rel(got, want) <= 1e-6
