"""The Table III acceleration baselines, the port
(``repro_torch/core/accel_baselines.py``) against the JAX package
(``repro/core/accel_baselines.py``) on the CPU.

* Full sampling, DeepCache, T-GATE and SADA on the committed trained
  large nets of both families (3 requests, the reference's ``xT`` from
  ``PRNGKey(2)`` as ``tests/test_system.py`` draws it, the edge ladder):
  latents within ``LATENT_RTOL`` (norm-wise, as ``tests/test_torch_executor.py``
  holds the relay's), ``evals``
  exactly equal (T-GATE's float sum included), and the steps each sampler
  calls the model at equal, so SADA skips the same steps.
* The step tail is the port's sampler step: ``_step_update`` equals
  ``samplers.step_update`` at ``step_coeffs`` bit for bit, and a counting
  wrapper of the interior-step kernel's wrapper sees one call per rf step
  and none on DDIM.
* ``tests/test_system.py::test_sada_and_deepcache_reduce_evals`` runs on
  both packages.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accel_baselines as jab
from repro.diffusion import families as jfam
from repro.models import diffusion_nets as jdn
from repro.training import checkpoint as jck
from repro_torch.core import accel_baselines as tab
from repro_torch.core import samplers as tsamplers
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.kernels.fused_sampler import ops as fops

torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
# the final latents of each sampler, port against reference, norm-wise:
# read 5.4e-7 (XL, DeepCache) and 1.4e-6 (F3, SADA; its max |Δ| over max
# |reference| 7.7e-6)
LATENT_RTOL = 1e-5
SAMPLERS = ("full", "deepcache", "tgate", "sada")


def _sampler(mod, name):
    return getattr(mod, f"{name}_sample")


@pytest.fixture(scope="module")
def large_nets():
    ref = {}
    for fam in ("XL", "F3"):
        like = {role: jax.eval_shape(lambda: jdn.init_net(
            jax.random.PRNGKey(0), jfam.NET_CONFIGS[(fam, role)]))
            for role in ("large", "small")}
        pair = jck.restore(CKPTS / f"diffusion_{fam}.ckpt", like)[0]
        ref[fam] = jfam.make_family(fam, pair["large"], pair["small"])
    return ref, tfam.load_families(CKPTS, device="cpu")


def _inputs(fam):
    prompts = [synth.sample_prompt(i) for i in range(3)]
    cond = np.stack([synth.embed(p, fam) for p in prompts])
    xT = jax.random.normal(jax.random.PRNGKey(2), (3, 8, 8, 4))
    return xT, cond


def _recording(fn, calls):
    def call(params, x, t, cond):
        calls.append(float(t))
        return fn(params, x, t, cond)
    return call


@pytest.fixture
def counted(monkeypatch):
    calls = []
    real = fops.fused_cfg_step

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(fops, "fused_cfg_step", counting)
    return calls


@pytest.mark.parametrize("fam", ["XL", "F3"])
@pytest.mark.parametrize("name", SAMPLERS)
def test_baseline_matches_reference(large_nets, counted, fam, name):
    ref_fams, port_fams = large_nets
    xT, cond = _inputs(fam)
    spec = port_fams[fam].spec
    ref_calls, port_calls = [], []
    want, ref_evals = _sampler(jab, name)(
        spec.kind, _recording(jax.jit(ref_fams[fam].large_fn), ref_calls),
        ref_fams[fam].large_params, xT, ref_fams[fam].spec.sigmas_edge,
        jnp.asarray(cond))
    with torch.no_grad():
        got, evals = _sampler(tab, name)(
            spec.kind, _recording(port_fams[fam].large_fn, port_calls),
            port_fams[fam].large_params, torch.from_numpy(np.array(xT)),
            spec.sigmas_edge, torch.from_numpy(cond))
    assert got.shape == xT.shape
    want = np.asarray(want, np.float64)
    rel = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert rel <= LATENT_RTOL, rel
    assert type(evals) is type(ref_evals) and evals == ref_evals
    assert port_calls == ref_calls
    steps = len(spec.sigmas_edge) - 1
    assert len(counted) == (steps if spec.kind == "rf" else 0)
    assert all(kw["guidance"] == 1.0 and kw["mode"] == "rf" for kw in counted)


def test_sada_skips_and_tgate_evals():
    """SADA skips a step only after a call whose change is small, never
    twice in a row; T-GATE's evals are the reference's float sum."""
    x = torch.ones(2, 8, 8, 4)
    sig = tfam.SPECS["F3"]().sigmas_edge
    calls = []
    steady = _recording(lambda p, x, t, c: torch.full_like(x, 0.5), calls)
    _, evals = tab.sada_sample("rf", steady, None, x, sig, torch.zeros(2, 16))
    assert evals == len(calls) == 26  # every second step after the first two
    _, gate = tab.tgate_sample("rf", lambda p, x, t, c: x, None, x, sig,
                               torch.zeros(2, 16))
    want = 0.0
    for i in range(50):
        want += 1.0 if i < 20 else 0.62
    assert gate == want


@pytest.mark.parametrize("kind", ["ddim", "rf"])
def test_step_update_is_the_sampler_step(kind):
    gen = torch.Generator().manual_seed(1)
    x, pred = (torch.randn(4, 8, 8, 4, generator=gen) for _ in range(2))
    sig = tfam.SPECS["XL" if kind == "ddim" else "F3"]().sigmas_edge
    for i in (0, 17, 48):
        got = tab._step_update(kind, x, pred, sig[i], sig[i + 1])
        want = tsamplers.step_update(kind, x, pred,
                                     tsamplers.step_coeffs(kind, sig, i))
        assert torch.equal(got, want)
        ref = jab._step_update(kind, jnp.asarray(x.numpy()),
                               jnp.asarray(pred.numpy()),
                               jnp.asarray(sig[i].numpy()),
                               jnp.asarray(sig[i + 1].numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()))


def _reduce_evals(pkg, ref_fams, port_fams):
    """``tests/test_system.py::test_sada_and_deepcache_reduce_evals``."""
    xT, cond = _inputs("F3")
    if pkg == "jax":
        fam, mod = ref_fams["F3"], jab
        args = (fam.large_fn, fam.large_params, xT, fam.spec.sigmas_edge,
                jnp.asarray(cond))
    else:
        fam, mod = port_fams["F3"], tab
        args = (fam.large_fn, fam.large_params, torch.from_numpy(np.array(xT)),
                fam.spec.sigmas_edge, torch.from_numpy(cond))
    with torch.no_grad():
        _, ev_full = mod.full_sample("rf", *args)
        _, ev_dc = mod.deepcache_sample("rf", *args, interval=2)
        _, ev_sada = mod.sada_sample("rf", *args)
    assert ev_dc <= ev_full // 2 + 1
    assert ev_sada <= ev_full


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sada_and_deepcache_reduce_evals(large_nets, pkg):
    _reduce_evals(pkg, *large_nets)
