"""The port's quantizer module (``repro_torch.quantization``) against the
reference (``repro.quantization``) on the same numpy inputs, plus the
cases of ``tests/test_quantization.py`` run on the port.

Tolerances: row-wise payloads exact and scales within 1 fp32 ulp (the
reference's jitted ``/127`` is a multiply by the reciprocal; the port
divides), so reconstructions within 1 ulp; layouts and byte counts exact;
log8 payloads exact but for counted ±1 flips at rounding ties (its log2 is
not correctly rounded in either framework); deviations within 1e-6
relative.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quantization as jq
from repro_torch import quantization as tq

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)


def _rows(seed=0, shape=(16, 64), scale=3.0):
    """Rows spanning orders of magnitude (the log8 regime)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return (x * np.logspace(-4, 1, shape[0], dtype=np.float32)[:, None]
            ).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


@pytest.mark.parametrize("jitted", [False, True])
def test_rowwise_matches_reference(jitted):
    x = _rows(1)
    x[3] = 0.0
    quant = jax.jit(jq.quant_rowwise) if jitted else jq.quant_rowwise
    ref = quant(jnp.asarray(x))
    got = tq.quant_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    assert _ulps(got["s"].numpy(), ref["s"]) <= 1
    assert float(got["s"][3, 0]) == 1.0
    assert _ulps(tq.dequant_rowwise(got).numpy(),
                 jq.dequant_rowwise(ref)) <= 1


def test_log8_matches_reference():
    x = _rows(2)
    ref = jq.quant_log8(jnp.asarray(x))
    got = tq.quant_log8(torch.from_numpy(x))
    d = np.abs(got["q"].numpy().astype(np.int32) - np.asarray(ref["q"], np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) <= 0.01 * d.size
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    # the same payload dequantizes alike in both frameworks
    payload = {"q": torch.from_numpy(np.array(ref["q"])), "s": got["s"]}
    np.testing.assert_allclose(tq.dequant_log8(payload).numpy(),
                               np.asarray(jq.dequant_log8(ref)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_roundtrip_bound(name):
    q = tq.get_quantizer(name)
    x = torch.from_numpy(_rows())
    rec = q.roundtrip(x)
    rowmax = torch.amax(torch.abs(x), -1, keepdim=True)
    if name == "rowwise":
        bound = q.rel_bound * rowmax + 1e-7
    else:
        bound = q.rel_bound * torch.abs(x) + 2.0 ** (-tq.LOG8_RANGE + 1) * rowmax
    assert torch.all(torch.abs(rec - x) <= bound), name


@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_quant_preserves_sign_and_zero(name):
    q = tq.get_quantizer(name)
    x = torch.tensor([[-2.0, -1e-3, 0.0, 1e-3, 2.0]])
    rec = q.roundtrip(x)
    assert torch.all(torch.sign(rec) * torch.sign(x) >= 0)
    assert float(rec[0, 2]) == 0.0
    assert torch.equal(q.roundtrip(torch.zeros(3, 8)), torch.zeros(3, 8))


@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_error_feedback_matches_reference_and_shrinks(name):
    """Same residual recursion as the reference, and the accumulated mean
    of the dequantized payloads converges to x."""
    q = tq.get_quantizer(name)
    xn = _rows(seed=3, shape=(8, 32))
    x = torch.from_numpy(xn)
    err, err_j = torch.zeros_like(x), jnp.zeros(xn.shape, jnp.float32)
    acc = torch.zeros_like(x)
    step_bound = float(torch.max(torch.abs(q.error(x)))) + 1e-6
    first_dev = None
    for k in range(1, 9):
        qs, rec, err = tq.fused_error_feedback_step(x, err, name)
        _, rec_j, err_j = jq.fused_error_feedback_step(jnp.asarray(xn), err_j,
                                                       name)
        np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(xn).max()))
        acc = acc + q.dequant(qs)
        dev = float(torch.max(torch.abs(acc / k - x)))
        first_dev = first_dev or max(dev, 1e-9)
        assert float(torch.max(torch.abs(err))) <= step_bound * 2.0
    assert dev <= first_dev / 4 + 1e-8
    _, _, err1 = tq.fused_error_feedback_step(x, torch.zeros_like(x), name)
    assert torch.equal(err1, q.error(x))


def test_latent_layout_matches_reference():
    x = np.random.default_rng(4).normal(size=(3, 8, 6, 5)).astype(np.float32)
    rows = tq.latent_to_rows(torch.from_numpy(x))
    assert rows.is_contiguous() and rows.shape == (3, 5, 48)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jq.latent_to_rows(jnp.asarray(x))))
    back = tq.rows_to_latent(rows, (8, 6, 5))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_latent_wire_matches_reference(name):
    """quant_latent / dequant_latent / latent_roundtrip: the same payload
    ints, scales, bytes and Eq. 1 deviation as the reference."""
    x = np.random.default_rng(5).normal(size=(4, 8, 8, 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    qs, nbytes = tq.quant_latent(xt, name)
    qs_j, nbytes_j = jq.quant_latent(jnp.asarray(x), name)
    assert nbytes == nbytes_j == tq.payload_bytes(qs)
    assert qs["q"].shape == qs_j["q"].shape and qs["s"].shape == qs_j["s"].shape
    d = np.abs(qs["q"].numpy().astype(np.int32) - np.asarray(qs_j["q"], np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) <= 0.01 * d.size
    if name == "rowwise":
        assert not d.any() and _ulps(qs["s"].numpy(), qs_j["s"]) <= 1
    rec, nb = tq.latent_roundtrip(xt, name)
    rec_j, _ = jq.latent_roundtrip(jnp.asarray(x), name)
    assert nb == nbytes and rec.shape == xt.shape
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), rtol=1e-6,
                               atol=1e-6)
    dev = float(tq.relative_deviation(xt, rec))
    dev_j = float(jq.relative_deviation(jnp.asarray(x), rec_j))
    assert dev == pytest.approx(dev_j, rel=1e-5)


def test_payload_bytes_matches_reference():
    x = np.zeros((1, 128, 128, 16), np.float32)
    qs, nbytes = tq.quant_latent(torch.from_numpy(x))
    assert nbytes == jq.quant_latent(jnp.asarray(x))[1] == 128 * 128 * 16 + 16 * 4
    assert tq.payload_bytes(qs) == nbytes


def test_unknown_quantizer_rejected():
    with pytest.raises(ValueError, match="unknown quantizer"):
        tq.get_quantizer("fp4")
