"""The port's latent handoff transport (``serving/runtime/transport.py``)
and ``core/boundary.py::warm`` against the reference on the same numpy
inputs, plus the transport cases of ``tests/test_quantization.py`` and
``tests/test_runtime.py`` run on the port.

Tolerances: payload ints exact and scales within 1 fp32 ulp (the
reference's jitted ``/127`` is a multiply by the reciprocal); row-wise
reconstructions within 1 ulp, log8's within 1e-6 relative (its ``exp2``
is correctly rounded in neither framework); byte counts exact; the round
trip's relative error within 1e-6 of its float64 value and within 1e-5 of
the reference's, whose float32 norm sums in another order (F3's log8
latent reads 3.1e-6 off the float64 value there, the port 6e-8); quality
deltas priced at an explicit deviation exact.
"""
from __future__ import annotations

import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quantization as jq
from repro.core import boundary as jbnd
from repro.serving import latency as jlat
from repro.serving.runtime import transport as jtr
from repro_torch import quantization as tq
from repro_torch.core import boundary as tbnd
from repro_torch.serving import latency as lat
from repro_torch.serving.runtime import (HandoffTransport, TransportConfig,
                                         channelwise_roundtrip)
from repro_torch.serving.runtime import transport as ttr

torch.set_num_threads(1)

QUALITY = {"clip": 0.8, "ir": -0.7, "aes": 5.5, "pick": 0.22, "ocr": 0.1}


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


def _handoff_latent(family):
    """The transport's representative latent, drawn as the reference does."""
    rng = np.random.default_rng(zlib.crc32(family.encode()))
    c = lat.LATENT_CHANNELS[family]
    return rng.normal(size=(4, 16, 16, c)).astype(np.float32)


def _cpu(cfg=None):
    return HandoffTransport(cfg, device="cpu")


@pytest.mark.parametrize("family", ["XL", "F3"])
@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_channelwise_roundtrip_matches_reference(name, family):
    x = _handoff_latent(family)
    qs, nbytes = tq.quant_latent(torch.from_numpy(x), name)
    qs_j, nbytes_j = jq.quant_latent(jnp.asarray(x), name)
    assert nbytes == nbytes_j
    np.testing.assert_array_equal(qs["q"].numpy(), np.asarray(qs_j["q"]))
    assert _ulps(qs["s"].numpy(), qs_j["s"]) <= 1
    rec, err = channelwise_roundtrip(x, name)
    rec_j, err_j = jtr.channelwise_roundtrip(x, name)
    assert rec.dtype == torch.float32 and rec.shape == x.shape
    if name == "rowwise":
        assert _ulps(rec.numpy(), rec_j) <= 1
    else:  # log8's exp2 is correctly rounded in neither framework
        np.testing.assert_allclose(rec.numpy(), rec_j, rtol=1e-6, atol=0)
    r64 = rec.numpy().astype(np.float64)
    exact = np.linalg.norm(r64 - x) / (np.linalg.norm(x.astype(np.float64))
                                       + 1e-12)
    assert err == pytest.approx(exact, rel=1e-6)
    assert err == pytest.approx(err_j, rel=1e-5)
    # the round trip runs where its input lies
    assert channelwise_roundtrip(torch.from_numpy(x), name)[0].device == \
        torch.device("cpu")


@pytest.mark.parametrize("name", sorted(tq.QUANTIZERS))
def test_handoff_error_matches_reference(name):
    ours = _cpu(TransportConfig(quantizer=name))
    ref = jtr.HandoffTransport(jtr.TransportConfig(quantizer=name))
    for fam in ("XL", "F3"):
        err = ours.handoff_error(fam)
        assert 0.0 < err < 0.05
        assert err == pytest.approx(ref.handoff_error(fam), rel=1e-5)
        assert ours.wire_bytes(fam) == ref.wire_bytes(fam)
        assert ours.transfer_time(fam, 63.0) == ref.transfer_time(fam, 63.0)
        got = ours.quality_delta(fam, QUALITY, n_hops=2)
        want = ref.quality_delta(fam, QUALITY, n_hops=2)
        assert got.keys() == want.keys()
        for k in QUALITY:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-9)
        for dev in (0.0, 0.37, 9.716):
            assert (ours.deviation_quality_delta(fam, QUALITY, dev)
                    == ref.deviation_quality_delta(fam, QUALITY, dev))
    for t in (ours, ref):
        assert t.quality_delta(None, QUALITY) is QUALITY
        assert t.deviation_quality_delta(None, QUALITY, 1.0) is QUALITY


def test_compression_off_is_free():
    ours = _cpu(TransportConfig(compress=False))
    ref = jtr.HandoffTransport(jtr.TransportConfig(compress=False))
    for fam in ("XL", "F3"):
        assert ours.handoff_error(fam) == ref.handoff_error(fam) == 0.0
        assert ours.quality_delta(fam, QUALITY) == QUALITY
        assert ours.deviation_quality_delta(fam, QUALITY, 5.0) == QUALITY
        assert ours.wire_bytes(fam) == ref.wire_bytes(fam)


def test_for_runtime_reads_the_runtime_knobs():
    rt = SimpleNamespace(compress_handoff=False, bw_mbps=7.5,
                         quality_sensitivity=2.0)
    t = HandoffTransport.for_runtime(rt, device="cpu")
    assert t.cfg == TransportConfig(compress=False, bw_mbps=7.5,
                                    quality_sensitivity=2.0)
    want = jtr.HandoffTransport.for_runtime(rt).cfg
    assert (t.cfg.compress, t.cfg.bw_mbps, t.cfg.quality_sensitivity,
            t.cfg.quantizer) == (want.compress, want.bw_mbps,
                                 want.quality_sensitivity, want.quantizer)


def test_transport_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HandoffTransport()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbnd.warm((16, 16, 4))


def test_handoff_error_is_measured_once_per_family(monkeypatch):
    calls = []
    real = ttr.channelwise_roundtrip

    def counting(x, quantizer="rowwise"):
        calls.append((tuple(x.shape), x.device.type))
        return real(x, quantizer)

    monkeypatch.setattr(ttr, "channelwise_roundtrip", counting)
    t = _cpu()
    for _ in range(3):
        t.handoff_error("XL")
        t.quality_delta("F3", QUALITY)
    assert calls == [((4, 16, 16, 4), "cpu"), ((4, 16, 16, 16), "cpu")]


# ---------------------------------------------------------------------------
# boundary.warm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 4), (16, 16, 16), (8, 8, 4)])
def test_boundary_warm_fires_the_reference_count(shape):
    # two sampler kinds x (two emits, a peek, a consume)
    assert tbnd.warm(shape, device="cpu") == jbnd.warm(shape) == 8


def _count_tails(monkeypatch):
    """Wrap the boundary tail factories: each fired tail is recorded."""
    fired = []
    for name in ("emit_fn", "peek_fn", "consume_fn"):
        real = getattr(tbnd, name)

        def factory(*args, _real=real, _name=name, **kw):
            tail = _real(*args, **kw)

            def run(*targs):
                fired.append((_name, tuple(targs[0].shape)))
                return tail(*targs)
            return run
        monkeypatch.setattr(tbnd, name, factory)
    return fired


def test_transport_warm_fires_the_tails_only_with_boundary(monkeypatch):
    fired = _count_tails(monkeypatch)
    t = _cpu()
    t.warm(["XL", "F3", None], boundary=False)
    assert fired == [] and set(t._fidelity) == {"XL", "F3"}
    t.warm(["XL", "F3", None], boundary=True)
    per_kind = ["emit_fn", "emit_fn", "peek_fn", "consume_fn"]
    assert [n for n, _ in fired] == per_kind * 4  # 2 families x 2 kinds
    assert {s for n, s in fired if n == "emit_fn"} == {(4, 16, 16, 4),
                                                      (4, 16, 16, 16)}
    fired.clear()
    _cpu(TransportConfig(compress=False)).warm(["XL", "F3"], boundary=True)
    assert fired == []


# ---------------------------------------------------------------------------
# tests/test_quantization.py's and tests/test_runtime.py's transport
# cases, on the port
# ---------------------------------------------------------------------------


def test_transport_compression_parity():
    """The serving transport's round-trip and the quantizer module's latent
    round-trip are the same computation, bit for bit, on identical inputs —
    the consolidation's core guarantee."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 16, 16, 8)).astype(np.float32)
    for name in sorted(tq.QUANTIZERS):
        rec_t, err_t = channelwise_roundtrip(x, name)
        rec_q, _ = tq.latent_roundtrip(torch.from_numpy(x), name)
        assert torch.equal(rec_t, rec_q)
        assert err_t == pytest.approx(
            float(tq.relative_deviation(torch.from_numpy(x), rec_q)))


def test_latent_wire_bytes_matches_latency_model():
    """payload accounting agrees with the latency model's analytic
    `latent_wire_bytes` for both families' latent layouts (@1024²)."""
    for fam, c in lat.LATENT_CHANNELS.items():
        x = torch.zeros((1, 128, 128, c))
        _, payload = tq.latent_roundtrip(x, "rowwise")
        assert payload == lat.latent_wire_bytes(fam, compressed=True)
        assert payload == jlat.latent_wire_bytes(fam, compressed=True)


def test_latent_wire_bytes_compression_ratio():
    for fam in ("XL", "F3"):
        raw = lat.latent_wire_bytes(fam)
        comp = lat.latent_wire_bytes(fam, compressed=True)
        assert raw == lat.LATENT_BYTES[fam]
        assert comp < raw / 1.9  # int8 + per-channel scales ≈ half of fp16
    assert lat.latent_wire_bytes(None) == 0
    assert lat.transfer_time("XL", 80.0, compressed=True) < lat.transfer_time(
        "XL", 80.0, compressed=False
    )


def test_transport_quality_delta_bounds():
    tr = _cpu(TransportConfig(compress=True))
    err = tr.handoff_error("XL")
    assert 0.0 < err < 0.02  # row-wise int8 keeps relative error < 2 %
    q = {"clip": 0.8, "ir": 0.7, "aes": 5.5, "pick": 0.22, "ocr": 0.0}
    dq = tr.quality_delta("XL", q)
    assert dq["clip"] < q["clip"] and dq["ir"] < q["ir"]
    assert dq["clip"] > 0.97 * q["clip"]  # ...but only marginally
    assert dq["aes"] == q["aes"]  # target-free metrics untouched
    # subtractive penalty: negative scores also degrade (never improve)
    neg = tr.quality_delta("XL", {"clip": -0.5, "ir": -1.0})
    assert neg["clip"] < -0.5 and neg["ir"] < -1.0
    off = _cpu(TransportConfig(compress=False))
    assert off.quality_delta("XL", q) == q
