"""The port's four kernels (``repro_torch.kernels``) against the JAX
reference: each plain PyTorch version against the Pallas kernel run in
interpret mode and against its jitted oracle, on the same numpy inputs,
at the shapes and cases of ``tests/test_fused_boundary.py``.

Tolerances.  Quantizing the same values: int8 payloads exact, scales
within 1 fp32 ulp (XLA's jit turns ``/127`` into a multiply by the
reciprocal; the port divides).  Stepping: XLA contracts the step into
FMAs where the port rounds after every operation, so stepped values agree
to ~1e-6 relative — emitted scales within 1e-6 relative, payloads exact
but for ±1 flips at rounding ties (counted, at most 1% of elements),
consumed fp32 rows within 1e-6 relative, bf16 rows within one bf16 ulp.
``test_torch_cuda_kernels.py`` holds the CUDA kernels to these plain
versions on the card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_sampler import ops as jfops
from repro.kernels.fused_sampler import ref as jfref
from repro.kernels.quant import ops as jqops
from repro.kernels.quant import ref as jqref
from repro_torch.core import samplers
from repro_torch.kernels import build
from repro_torch.kernels.fused_sampler.ops import (fused_cfg_step_dequant,
                                                   fused_cfg_step_quant)
from repro_torch.kernels.fused_sampler.ref import (fused_cfg_step_dequant_ref,
                                                   fused_cfg_step_quant_ref)
from repro_torch.kernels.quant.ops import dequant_int8, quant_int8
from repro_torch.kernels.quant.ref import dequant_int8_ref, quant_int8_ref

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

SHAPES = [(8, 64), (3, 33), (1, 5), (13, 17)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
_jit_quant_step_ref = jax.jit(jfref.fused_cfg_step_quant_ref,
                              static_argnames=("guidance", "mode"))
_jit_dequant_step_ref = jax.jit(jfref.fused_cfg_step_dequant_ref,
                                static_argnames=("guidance", "mode"))


def _coeffs(mode):
    return np.asarray([0.4, 0.6] if mode == "ddim" else [-0.02, 0.0], np.float32)


def _inputs(shape, dtype, seed):
    """Three normal arrays in both frameworks; bf16 is rounded from the
    same fp32 values by both (round to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(t):
    return np.asarray(t.to(torch.float32) if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b))) if a.size else 0


def _assert_payload(q, s, qj, sj):
    """Payload of the same values: ints exact, scales within 1 ulp."""
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert _ulps(s.numpy(), np.asarray(sj)) <= 1


def assert_stepped_payload(q, s, qj, sj, max_flip_frac=0.01):
    """Payload of values stepped in two frameworks: ints equal but for
    counted ±1 tie flips, scales within 1e-6 relative."""
    d = np.abs(np.asarray(q, np.int32) - np.asarray(qj, np.int32))
    assert d.max(initial=0) <= 1
    assert np.count_nonzero(d) <= max_flip_frac * d.size
    np.testing.assert_allclose(np.asarray(s), np.asarray(sj), rtol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["ddim", "rf"])
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_emit_plain_matches_pallas(shape, guidance, mode, dtype):
    (x, ec, eu), (tx, tec, teu) = _inputs(shape, dtype, 1)
    cf = _coeffs(mode)
    q, s = fused_cfg_step_quant(tx, tec, teu, torch.from_numpy(cf),
                                guidance=guidance, mode=mode)
    assert q.dtype == torch.int8 and q.shape == shape
    assert s.dtype == torch.float32 and s.shape == shape[:-1] + (1,)
    qk, sk = jfops.fused_cfg_step_quant(x, ec, eu, jnp.asarray(cf),
                                        guidance=guidance, mode=mode,
                                        block_r=16, interpret=True)
    assert_stepped_payload(q, s, qk, sk)
    qo, so = _jit_quant_step_ref(x, ec, eu, jnp.asarray(cf).reshape(1, 2),
                                 guidance=guidance, mode=mode)
    assert_stepped_payload(q, s, qo, so)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["ddim", "rf"])
@pytest.mark.parametrize("guidance", [1.0, 3.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_consume_plain_matches_pallas(shape, guidance, mode, dtype):
    (x, ec, eu), (tx, tec, teu) = _inputs(shape, dtype, 2)
    qs_j = jqref.quant_int8_ref(x.astype(jnp.float32) * 2.0)
    q, s = quant_int8(tx.to(torch.float32) * 2.0)
    _assert_payload(q, s, *qs_j)
    s = torch.from_numpy(np.array(qs_j[1]))  # same scales on both sides
    cf = _coeffs(mode)
    out = fused_cfg_step_dequant(q, s, tec, teu, torch.from_numpy(cf),
                                 guidance=guidance, mode=mode)
    assert out.dtype == tec.dtype and out.shape == shape
    ok = jfops.fused_cfg_step_dequant(qs_j[0], qs_j[1], ec, eu,
                                      jnp.asarray(cf), guidance=guidance,
                                      mode=mode, block_r=16, interpret=True)
    oo = _jit_dequant_step_ref(qs_j[0], qs_j[1], ec, eu,
                               jnp.asarray(cf).reshape(1, 2),
                               guidance=guidance, mode=mode)
    for ref in (ok, oo):
        if dtype == "f32":
            np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6,
                                       atol=1e-6)
        else:  # one bf16 ulp: 2^-7 relative
            np.testing.assert_allclose(_np(out), _np(ref), rtol=2 ** -7,
                                       atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + [(16, 64)])
def test_quant_plain_matches_pallas(shape):
    rng = np.random.default_rng(3)
    a = (rng.normal(size=shape) * 3.0).astype(np.float32)
    a[0] = 0.0  # an all-zero row takes scale 1.0
    q, s = quant_int8(torch.from_numpy(a))
    qk, sk = jqops.quant_int8(jnp.asarray(a), block_r=16, interpret=True)
    _assert_payload(q, s, qk, sk)
    _assert_payload(q, s, *jqref.quant_int8_ref(jnp.asarray(a)))
    assert float(s[0, 0]) == 1.0 and not q[0].any()
    rec = dequant_int8(q, s)
    # the same payload dequantizes to the same bits in both frameworks
    s_j = torch.from_numpy(np.array(sk))
    np.testing.assert_array_equal(
        dequant_int8(q, s_j).numpy(),
        np.asarray(jqops.dequant_int8(qk, sk, block_r=16, interpret=True)))
    np.testing.assert_array_equal(dequant_int8(q, s_j).numpy(),
                                  np.asarray(jqref.dequant_int8_ref(qk, sk)))
    assert rec.dtype == torch.float32 and rec.shape == shape


def test_emit_plain_is_the_sampler_step_then_quant():
    """The emit's plain version is ``samplers.step_update`` followed by the
    row-wise quantize, bit for bit."""
    rng = np.random.default_rng(4)
    x, eps = (torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
              for _ in range(2))
    cf = torch.tensor([0.4, 0.6])
    q, s = fused_cfg_step_quant_ref(x, eps, eps, cf, guidance=1.0, mode="ddim")
    q2, s2 = quant_int8_ref(samplers.step_update("ddim", x, eps, cf))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    out = fused_cfg_step_dequant_ref(q, s, eps, eps, cf, guidance=1.0,
                                     mode="rf")
    assert torch.equal(out, samplers.step_update(
        "rf", dequant_int8_ref(q, s), eps, cf))


def test_wrappers_validate():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="unknown mode"):
        fused_cfg_step_quant(x, x, x, torch.zeros(2), mode="euler")
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        build.on_cpu(x, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        build.check(x.t(), "x", build.FLOAT_DTYPES)
    with pytest.raises(TypeError, match="dtype"):
        build.check(x.to(torch.float64), "x", build.FLOAT_DTYPES)
