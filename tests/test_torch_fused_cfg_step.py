"""The port's interior sampler step (``fused_cfg_step``) against the JAX
reference, its wiring into the rectified-flow sampler, and the guided F3
relay against ``repro.core.relay.execute_program``.

* The plain version against the Pallas kernel in interpret mode and
  against the jitted JAX oracle, at ``tests/test_kernels.py``'s shapes and
  modes, with that test's ``TOL`` (fp32 2e-5, bf16 4e-2).  Each computes
  in fp32; the port rounds after every operation, XLA may contract into
  FMAs.
* ``ddim_coeffs`` equals the reference's exactly.
* Wiring: every rf step of ``rf_euler_sample`` calls the kernel's wrapper
  once, no ddim step does; the rf sample equals a loop of ``cfg_combine``
  and ``rf_update`` bit for bit, at g = 1 and at g = 3.5 with ``uncond``;
  the executor's F3 arms call it once per interior step (the fused
  boundary steps take the emit and consume kernels), its XL arms never.
* Guidance: an s = 15 F3 relay (trained weights; raw, int8 unfused, int8
  fused) at g = 3.5 with ``uncond`` zeros — a test input, not the
  families' null prompt — against the reference: latents within 1e-5
  relative, bytes exact, the worst hop's deviation within 1e-3 relative
  (as ``test_torch_relay.py``), int8 tie flips counted and at most 1 %;
  the guided latents differ from the unguided ones, so a dropped
  ``uncond`` fails.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import relay as jrelay
from repro.core.program import make_program as j_make_program
from repro.kernels.fused_sampler import ops as jfops
from repro.kernels.fused_sampler import ref as jfref
from repro.quantization import quant_latent as j_quant_latent
from repro_torch.core import samplers as ts
from repro_torch.core import relay as trelay
from repro_torch.core.program import make_program
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.kernels.fused_sampler import ops as fops
from repro_torch.kernels.fused_sampler.ref import (ddim_coeffs,
                                                   fused_cfg_step_ref)
from repro_torch.quantization import quant_latent
from repro_torch.serving import arms as tarms
from repro_torch.serving.executor import Executor

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
# tests/test_kernels.py's shapes and tolerances
SHAPES = [(4, 8, 8, 4), (2, 5, 7, 3), (1, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 4e-2}
GUIDED = 3.5
REF_RTOL = 1e-5  # guided relay, port against reference


def _coeffs(mode):
    return ddim_coeffs(0.4, 0.6) if mode == "ddim" else (-0.02, 0.0)


def _inputs(shape, dtype, seed=2):
    """x, ε_c, ε_u as normal arrays in both frameworks; bf16 rounded from
    the same fp32 values by both."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(a):
    return np.asarray(a.to(torch.float32) if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["ddim", "rf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, mode, dtype):
    (xj, ecj, euj), (x, ec, eu) = _inputs(shape, dtype)
    c1, c2 = _coeffs(mode)
    ref = jfops.fused_cfg_step(xj, ecj, euj, guidance=GUIDED, c1=c1, c2=c2,
                               mode=mode, block_n=32, interpret=True)
    out = fops.fused_cfg_step(x, ec, eu, guidance=GUIDED, c1=c1, c2=c2,
                              mode=mode)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("guidance", [1.0, GUIDED])
@pytest.mark.parametrize("mode", ["ddim", "rf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_oracle(shape, mode, guidance):
    (xj, ecj, euj), (x, ec, eu) = _inputs(shape, "f32", seed=3)
    c1, c2 = _coeffs(mode)
    ref = jax.jit(jfref.fused_cfg_step_ref,
                  static_argnames=("guidance", "mode", "c1", "c2"))(
        xj, ecj, euj, guidance=guidance, mode=mode, c1=c1, c2=c2)
    out = fused_cfg_step_ref(x, ec, eu, guidance=guidance, mode=mode, c1=c1,
                             c2=c2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL["f32"], rtol=TOL["f32"])


@pytest.mark.parametrize("ab", [(0.4, 0.6), (0.05, 0.93),
                                (np.float32(0.3), np.float32(0.7))])
def test_ddim_coeffs_equal_reference(ab):
    assert ddim_coeffs(*ab) == jfref.ddim_coeffs(*ab)


def test_eps_u_aliasing_eps_c_returns_the_plain_step():
    """ε_u passed as ε_c itself: the combine gives ε_c at any g, so the rf
    step equals x + Δt·ε_c and the ddim step c1·x + c2·ε_c."""
    _, (x, ec, _) = _inputs((3, 8, 8, 4), "f32", seed=4)
    for g in (1.0, GUIDED):
        out = fops.fused_cfg_step(x, ec, ec, guidance=g, c1=-0.02, mode="rf")
        assert torch.equal(out, ts.rf_update(x, ec, torch.tensor(-0.02)))
        c1, c2 = _coeffs("ddim")
        out = fops.fused_cfg_step(x, ec, ec, guidance=g, c1=c1, c2=c2,
                                  mode="ddim")
        assert torch.equal(out, c1 * x + c2 * ec)


def test_wrapper_refuses_bad_operands():
    x = torch.zeros(4, 8, 8, 4)
    with pytest.raises(ValueError, match="unknown mode"):
        fops.fused_cfg_step(x, x, x, mode="euler")
    with pytest.raises(ValueError, match="shape"):
        fops.fused_cfg_step(x, x, x[:2])
    with pytest.raises(TypeError, match="dtype"):
        fops.fused_cfg_step(x, x.to(torch.bfloat16), x)
    with pytest.raises(TypeError, match="dtype"):
        fops.fused_cfg_step(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        fops.fused_cfg_step(x, x.transpose(1, 2), x)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        fops.fused_cfg_step(x, x, x.to("meta"))


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of ``ops.fused_cfg_step`` (the sampler resolves it
    on the module at call time)."""
    calls = []
    original = fops.fused_cfg_step

    def counting(*args, **kw):
        calls.append(kw)
        return original(*args, **kw)

    monkeypatch.setattr(fops, "fused_cfg_step", counting)
    return calls


def _toy(p, x, t, c):
    """A denoiser whose output depends on x, t and the conditioning."""
    return torch.tanh(x) * (1.0 + t) + c.mean(-1)[:, None, None, None]


@pytest.mark.parametrize("capture_traj", [False, True])
def test_rf_steps_call_the_kernel_ddim_steps_do_not(counted, capture_traj):
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    cond = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    spec_f3, spec_xl = tfam.SPECS["F3"](), tfam.SPECS["XL"]()
    for start, stop in ((0, 50), (15, 50), (0, 15), (7, 8)):
        counted.clear()
        out, traj = ts.rf_euler_sample(_toy, None, x, spec_f3.sigmas_edge,
                                       cond, start=start, stop=stop,
                                       capture_traj=capture_traj)
        assert len(counted) == stop - start
        assert all(kw["mode"] == "rf" and kw["c2"] == 0.0 for kw in counted)
        if capture_traj:
            assert torch.equal(traj[-1], out)
    counted.clear()
    ts.ddim_sample(_toy, None, x, spec_xl.sigmas_edge, cond, start=3,
                   capture_traj=capture_traj)
    assert counted == []


@pytest.fixture(scope="module")
def port_families():
    return tfam.load_families(CKPTS, device="cpu")


@pytest.mark.parametrize("guidance,with_uncond", [(1.0, False),
                                                  (GUIDED, True),
                                                  (GUIDED, False),
                                                  (1.0, True)])
def test_rf_sample_equals_the_plain_loop(port_families, guidance,
                                         with_uncond):
    """F3's trained small net: the kernel's sample against a loop of the
    plain ``cfg_combine`` and ``rf_update``, bit for bit; the coefficient
    is the fp32 Δt that ``step_coeffs`` gives."""
    fam = port_families["F3"]
    sig = fam.spec.sigmas_device
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 8, 8, 4)).astype(np.float32))
    _, _, cond = synth.batch(np.arange(2) + 20, "F3")
    cond = torch.from_numpy(cond.astype(np.float32))
    uncond = torch.zeros_like(cond) if with_uncond else None
    out, traj = ts.rf_euler_sample(fam.small_fn, fam.small_params, x, sig,
                                   cond, start=10, uncond=uncond,
                                   guidance=guidance)
    want = x
    with torch.inference_mode():
        for i in range(10, 50):
            v = ts.cfg_combine(fam.small_fn, fam.small_params, want, sig[i],
                               cond, uncond, guidance)
            want = ts.rf_update(want, v, ts.step_coeffs("rf", sig, i)[0])
            assert torch.equal(traj[i - 10], want)
    assert torch.equal(out, want)


@pytest.mark.parametrize("idx,mode,want", [
    (8, "raw", 50), (8, "fused", 48), (8, "unfused", 50),
    (3, "raw", 0), (3, "fused", 0), (0, "raw", 0)])
def test_executor_calls_per_request_batch(port_families, counted, idx, mode,
                                          want):
    """Calls of the interior step per ``generate_bucketed`` call: every
    step of an F3 arm but the fused emit and consume; none on XL."""
    arm = tarms.build_action_space(compress=mode != "raw")[idx]
    ex = Executor(port_families, fused_boundary=mode != "unfused",
                  device="cpu")
    ex.generate_bucketed(arm, np.arange(3))
    assert len(counted) == want


def _reference_family():
    from repro.diffusion import families as jfam
    from repro.models import diffusion_nets as jdn
    from repro.training import checkpoint as jck

    def like(role):
        return jax.eval_shape(lambda: jdn.init_net(
            jax.random.PRNGKey(0), jfam.NET_CONFIGS[("F3", role)]))

    pair, _ = jck.restore(CKPTS / "diffusion_F3.ckpt",
                          {"large": like("large"), "small": like("small")})
    return jfam.make_family("F3", pair["large"], pair["small"])


@pytest.fixture(scope="module")
def f3_pair(port_families):
    return _reference_family(), port_families["F3"]


def _run_both(f3_pair, mode, guidance, uncond):
    fj, ft = f3_pair
    compress = mode != "raw"
    route = [("large", "p0", 15), ("small", "p1", None)]
    prog = make_program(ft.spec, route, guidance=guidance, compress=compress)
    prog_j = j_make_program(fj.spec, route, guidance=guidance,
                            compress=compress)
    x = np.random.default_rng(11).normal(size=(2, 8, 8, 4)).astype(np.float32)
    _, _, cond = synth.batch(np.arange(2) + 20, "F3")
    cond = cond.astype(np.float32)
    # zeros as the unconditional input: a test input, not the families'
    # null prompt
    un = np.zeros_like(cond) if uncond else None
    models = {r: (getattr(ft, f"{r}_fn"), getattr(ft, f"{r}_params"))
              for r in ("large", "small")}
    out, info = trelay.execute_program(
        ft.spec, prog, models, torch.from_numpy(x), torch.from_numpy(cond),
        uncond=None if un is None else torch.from_numpy(un),
        fused_boundary=mode == "fused")
    out_j, info_j = jrelay.execute_program(
        fj.spec, prog_j, {r: (getattr(fj, f"{r}_fn"), getattr(fj, f"{r}_params"))
                          for r in ("large", "small")},
        jnp.asarray(x), jnp.asarray(cond),
        uncond=None if un is None else jnp.asarray(un), capture_traj=False,
        fused_boundary=mode == "fused")
    return (out, info), (out_j, info_j)


@pytest.mark.parametrize("mode", ["raw", "unfused", "fused"])
def test_guided_f3_relay_matches_reference(f3_pair, counted, mode):
    (out, info), (out_j, info_j) = _run_both(f3_pair, mode, GUIDED, True)
    assert len(counted) == (48 if mode == "fused" else 50)
    assert all(kw["guidance"] == GUIDED for kw in counted)
    assert _rel(out, out_j) <= REF_RTOL
    assert info["transfer_bytes"] == info_j["transfer_bytes"]
    dev, dev_j = (float(i["handoff_deviation_pct"]) for i in (info, info_j))
    assert dev == pytest.approx(dev_j, rel=1e-3, abs=1e-9)
    if mode == "unfused":
        q = quant_latent(info["hops"][0]["x_out"])[0]["q"].numpy()
        q_j = np.asarray(j_quant_latent(info_j["hops"][0]["x_out"])[0]["q"])
        flips = np.abs(q.astype(np.int32) - q_j.astype(np.int32))
        assert flips.max(initial=0) <= 1
        assert np.count_nonzero(flips) <= 0.01 * q.size
    # guidance moves the result: a dropped uncond (or g) fails here
    (plain, _), (plain_j, _) = _run_both(f3_pair, mode, 1.0, False)
    assert _rel(plain, plain_j) <= REF_RTOL
    assert _rel(out, plain) > 0.5
