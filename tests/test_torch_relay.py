"""The port's relay path against the reference on the trained families:
schedules and Eq. 4 sigma matching, the sampler step, program
construction, the fused boundary steps and ``execute_program`` raw,
compressed-unfused and compressed-fused, on the same numpy inputs.

Tolerances (fp32 on the CPU in both frameworks):
* byte accounting exact; ladders and sigma-matched indices exact;
* int8 payloads exact but for ±1 flips at rounding ties, counted and
  bounded at 1% of elements: the latents reaching the quantizer agree to
  ~1e-6, not bitwise, so a value within an ulp of a half step may round
  the other way;
* final latents within 1e-4 relative for raw relays (fp32 sum-order
  differences through ~50 denoiser calls) and 1e-3 for compressed ones (a
  tie flip moves a latent element by one quantization step, ~0.8% of its
  row's max, which the downstream steps carry);
* the port's fused and unfused boundaries give the same bits: the kernels'
  plain versions round exactly where the unfused composition does.
"""
from __future__ import annotations

from dataclasses import astuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as jb
from repro.core import relay as jrelay
from repro.core import samplers as js
from repro.core import schedules as jsch
from repro.core.program import make_program as j_make_program
from repro.diffusion import families as jfam
from repro.models import diffusion_nets as jdn
from repro.quantization import quant_latent as j_quant_latent
from repro.serving import arms as jarms
from repro.training import checkpoint as jck
from repro_torch.core import boundary as tb
from repro_torch.core import relay as trelay
from repro_torch.core import samplers as ts
from repro_torch.core.program import make_program
from repro_torch.core.schedules import sigma_match
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.quantization import quant_latent
from repro_torch.serving import arms as tarms

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
RAW_RTOL, COMPRESSED_RTOL = 1e-4, 1e-3


def reference_family(fam, with_mid=False):
    """The reference family, its weights read by the JAX package's own
    checkpoint code (``repro.training.checkpoint.restore``)."""
    def like(role):
        return jax.eval_shape(lambda: jdn.init_net(
            jax.random.PRNGKey(0), jfam.NET_CONFIGS[(fam, role)]))

    pair, _ = jck.restore(CKPTS / f"diffusion_{fam}.ckpt",
                          {"large": like("large"), "small": like("small")})
    mid = None
    if with_mid:
        mid = jck.restore(CKPTS / f"diffusion_{fam}_mid.ckpt",
                          {"mid": like("mid")})[0]["mid"]
    return jfam.make_family(fam, pair["large"], pair["small"], mid_params=mid)


@pytest.fixture(scope="module")
def families():
    """(reference families, port families) with the trained weights."""
    return ({fam: reference_family(fam) for fam in ("XL", "F3")},
            tfam.load_families(CKPTS, device="cpu"))


def _models(fam):
    return {r: (tfam.role_fn(fam, r), tfam.role_params(fam, r))
            for r in ("large", "small")}


def _inputs(fam, n=2, seed=11):
    x = np.random.default_rng(seed).normal(size=(n, 8, 8, 4)).astype(np.float32)
    _, _, cond = synth.batch(np.arange(n) + 20, fam)
    return x, cond.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flips(q, q_ref):
    d = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    assert d.max(initial=0) <= 1
    return np.count_nonzero(d)


def test_schedules_and_sigma_match_equal_reference():
    for fam in ("XL", "F3"):
        spec_t, spec_j = tfam.SPECS[fam](), jfam.SPECS[fam]()
        roles = ("large", "mid", "small")
        for role in roles:
            np.testing.assert_array_equal(spec_t.ladder(role).numpy(),
                                          np.asarray(spec_j.ladder(role)))
        for up in roles:
            for down in roles:
                lt, lj = spec_t.ladder(up), spec_j.ladder(up)
                for s in range(len(lt)):
                    assert sigma_match(lt, s, spec_t.ladder(down)) == \
                        jsch.sigma_match(lj, s, spec_j.ladder(down))


def test_step_math_matches_reference():
    rng = np.random.default_rng(3)
    x, eps = (rng.normal(size=(2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    for fam, kind in (("XL", "ddim"), ("F3", "rf")):
        sig_t, sig_j = tfam.SPECS[fam]().sigmas_edge, jfam.SPECS[fam]().sigmas_edge
        for i in (0, 17, 49):
            c = ts.step_coeffs(kind, sig_t, i)
            np.testing.assert_array_equal(c.numpy(), np.asarray(
                js.step_coeffs(kind, sig_j, i)))
            got = ts.step_update(kind, torch.from_numpy(x),
                                 torch.from_numpy(eps), c)
            ref = js.step_update(kind, jnp.asarray(x), jnp.asarray(eps),
                                 jnp.asarray(c.numpy()))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6)


def test_programs_match_reference():
    for compress in (False, True):
        for a_t, a_j in zip(tarms.build_action_space(compress=compress),
                            jarms.build_action_space()):
            prog_j = a_j.program
            if compress and prog_j.is_relay:
                prog_j = j_make_program(
                    jarms._spec(prog_j.family),
                    [(s.model, s.pool, s.steps) for s in prog_j.segments[:-1]]
                    + [(prog_j.segments[-1].model, prog_j.segments[-1].pool,
                        None)], compress=True)
            assert astuple(a_t.program) == astuple(prog_j)
            assert a_t.label.split("|")[0] == a_j.label
            assert (a_t.relay_step, a_t.edge_pool, a_t.device_pool) == (
                a_j.relay_step, a_j.edge_pool, a_j.device_pool)
            if a_j.plan is not None:
                assert astuple(a_t.plan) == astuple(a_j.plan)


@pytest.mark.parametrize("fam,kind", [("XL", "ddim"), ("F3", "rf")])
def test_boundary_steps_match_reference(families, fam, kind):
    """quant_step / dequant_step with the trained nets: the same payload
    (but for counted tie flips), bytes and deviation; the consumed latent
    agrees and equals the unfused step off the dequantized latent."""
    ref, port = families
    fj, ft = ref[fam], port[fam]
    x, cond = _inputs(fam)
    i = 14
    res = tb.quant_step(kind, ft.large_fn, ft.large_params, torch.from_numpy(x),
                        ft.spec.sigmas_edge, i, torch.from_numpy(cond), None,
                        1.0, flavor="wire_dev")
    res_j = jb.quant_step(kind, fj.large_fn, fj.large_params, jnp.asarray(x),
                          fj.spec.sigmas_edge, i, jnp.asarray(cond), None, 1.0,
                          flavor="wire_dev")
    assert res["bytes"] == res_j["bytes"]
    assert _flips(res["wire"]["q"].numpy(), res_j["wire"]["q"]) <= 0.01 * x.size
    np.testing.assert_allclose(res["wire"]["s"].numpy(),
                               np.asarray(res_j["wire"]["s"]), rtol=1e-5)
    assert float(res["dev_pct"]) == pytest.approx(float(res_j["dev_pct"]),
                                                  rel=1e-3)
    wire = tb.quant_step(kind, ft.large_fn, ft.large_params,
                         torch.from_numpy(x), ft.spec.sigmas_edge, i,
                         torch.from_numpy(cond), None, 1.0)["wire"]
    for k in ("q", "s"):  # the fused emit equals the composed one
        assert torch.equal(wire[k], res["wire"][k])
    payload_j = {k: jnp.asarray(v.numpy()) for k, v in wire.items()}
    sig_t, sig_j = ft.spec.sigmas_device, fj.spec.sigmas_device
    nxt = tb.dequant_step(kind, ft.small_fn, ft.small_params, wire, (8, 8, 4),
                          sig_t, 7, torch.from_numpy(cond), None, 1.0)
    nxt_j = jb.dequant_step(kind, fj.small_fn, fj.small_params, payload_j,
                            (8, 8, 4), sig_j, 7, jnp.asarray(cond), None, 1.0)
    assert _rel(nxt, nxt_j) <= RAW_RTOL
    rec = tb.peek_fn()(wire["q"], wire["s"], (8, 8, 4))
    unfused, _ = ts.sampler_for(kind)(ft.small_fn, ft.small_params, rec, sig_t,
                                      torch.from_numpy(cond), start=7, stop=8,
                                      capture_traj=False)
    assert torch.equal(nxt, unfused)


@pytest.mark.parametrize("mode", ["raw", "unfused", "fused"])
@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_execute_program_matches_reference(families, fam, mode):
    ref, port = families
    fj, ft = ref[fam], port[fam]
    compress = mode != "raw"
    route = [("large", "p0", 15), ("small", "p1", None)]
    prog = make_program(ft.spec, route, compress=compress)
    prog_j = j_make_program(fj.spec, route, compress=compress)
    x, cond = _inputs(fam)
    out, info = trelay.execute_program(
        ft.spec, prog, _models(ft), torch.from_numpy(x), torch.from_numpy(cond),
        fused_boundary=mode == "fused")
    out_j, info_j = jrelay.execute_program(
        fj.spec, prog_j, {r: (getattr(fj, f"{r}_fn"), getattr(fj, f"{r}_params"))
                          for r in ("large", "small")},
        jnp.asarray(x), jnp.asarray(cond), capture_traj=False,
        fused_boundary=mode == "fused")
    assert info["transfer_bytes"] == info_j["transfer_bytes"]
    assert info["phases"] == info_j["phases"]
    assert info["segment_steps"] == info_j["segment_steps"]
    assert _rel(out, out_j) <= (COMPRESSED_RTOL if compress else RAW_RTOL)
    dev, dev_j = (float(i["handoff_deviation_pct"]) for i in (info, info_j))
    assert dev == pytest.approx(dev_j, rel=1e-3, abs=1e-9)
    hop, hop_j = info["hops"][0], info_j["hops"][0]
    if mode == "fused":
        assert hop["x_out"] is None
    else:
        assert _rel(hop["x_out"], hop_j["x_out"]) <= RAW_RTOL
    if mode == "unfused":
        q = quant_latent(hop["x_out"])[0]["q"].numpy()
        q_j = j_quant_latent(hop_j["x_out"])[0]["q"]
        assert _flips(q, q_j) <= 0.01 * q.size


@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_fused_and_unfused_give_the_same_bits(families, fam):
    ft = families[1][fam]
    prog = make_program(ft.spec, [("large", "p0", 10), ("small", "p1", None)],
                        compress=True)
    x, cond = (torch.from_numpy(a) for a in _inputs(fam, seed=12))
    out_u, info_u = trelay.execute_program(ft.spec, prog, _models(ft), x, cond)
    out_f, info_f = trelay.execute_program(ft.spec, prog, _models(ft), x, cond,
                                           fused_boundary=True)
    assert torch.equal(out_u, out_f)
    assert info_u["transfer_bytes"] == info_f["transfer_bytes"]
    assert torch.equal(info_u["handoff_deviation_pct"],
                       info_f["handoff_deviation_pct"])


def test_relay_generate_and_guards(families):
    ft = families[1]["XL"]
    x, cond = (torch.from_numpy(a) for a in _inputs("XL", seed=13))
    plan = trelay.make_relay_plan(ft.spec, 20)
    assert astuple(plan) == astuple(jrelay.make_relay_plan(
        jfam.SPECS["XL"](), 20))
    out, info = trelay.relay_generate(ft.spec, plan, ft.large_fn,
                                      ft.large_params, ft.small_fn,
                                      ft.small_params, x, cond, cond)
    assert info["traj_edge"].shape == (20,) + x.shape
    assert info["traj_device"].shape == (25 - plan.s_prime,) + x.shape
    assert torch.equal(info["traj_device"][-1], out)
    assert info["transfer_bytes"] == x.numel() * 4
    prog = make_program(ft.spec, [("large", "p0", 20), ("small", "p1", None)],
                        compress=True)
    with pytest.raises(ValueError, match="capture_traj"):
        trelay.execute_program(ft.spec, prog, _models(ft), x, cond,
                               capture_traj=True, fused_boundary=True)
    bad = make_program(ft.spec, [("large", "p0", 10), ("mid", "p1", 1),
                                 ("small", "p2", None)], compress=True)
    toy = {r: (lambda p, x, t, c: 0.5 * x, None) for r in ("large", "mid",
                                                         "small")}
    with pytest.raises(ValueError, match="too few steps"):
        trelay.execute_program(ft.spec, bad, toy, x, cond, fused_boundary=True)
