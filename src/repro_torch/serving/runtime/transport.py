"""Latent handoff transport: edge→device latent serialization (port of
``repro/serving/runtime/transport.py``).

The relay handoff moves the intermediate latent from the edge pool to the
device pool over a constrained link.  This layer serializes it through the
unified quantizer module (:mod:`repro_torch.quantization`, the code path
the relay's Eq. 1 deviation accounting uses), applied channel-wise — one
fp32 scale per channel row — so the payload shrinks ≈2× vs fp16 while the
quantization error stays well under the per-step deviation tolerance of
Eq. 1.

The *measured* quality delta (relative reconstruction error of the int8
round trip on a representative handoff latent) is cached per family and
fed back into the reward the scheduler learns from, so LinUCB sees
compression as a (tiny) quality cost traded against halved transfer
latency.  The round trip runs on the transport's device: on the card, the
row-wise quantizer's ``quant_int8`` and ``dequant_int8`` kernels, once per
family.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quantization import latent_roundtrip, relative_deviation
from repro_torch.serving import latency as lat


def channelwise_roundtrip(x, quantizer: str = "rowwise"):
    """int8 round trip of a latent batch ``x`` (..., H, W, C) via the
    shared wire format (:func:`repro_torch.quantization.latent_roundtrip`):
    rows are per-channel spatial slices, matching
    :func:`repro_torch.serving.latency.latent_wire_bytes`, and the reported
    error is the Eq. 1-style :func:`relative_deviation` the relay's handoff
    accounting uses.  ``x`` is a tensor (the round trip runs on its device)
    or a numpy array (on the CPU).  Returns (reconstruction in fp32 on
    ``x``'s device, relative error)."""
    xt = torch.as_tensor(x).to(torch.float32)
    rec, _ = latent_roundtrip(xt, quantizer)
    return rec, float(relative_deviation(xt, rec))


def handoff_latent(family: str) -> np.ndarray:
    """The representative handoff latent whose round trip prices a
    family's compression: unit-variance noise at the handoff noise level
    (latents are ~N(0,1)-scaled mid-relay), (4, 16, 16, C), drawn with
    numpy from ``zlib.crc32(family)`` as the reference draws it (crc32
    keeps the seed stable across processes; ``hash()`` is randomized per
    interpreter)."""
    rng = np.random.default_rng(zlib.crc32(family.encode()))
    c = lat.LATENT_CHANNELS[family]
    return rng.normal(size=(4, 16, 16, c)).astype(np.float32)


@dataclass
class TransportConfig:
    """Knobs for the latent handoff link: compression on/off, link
    bandwidth in Mbit/s, quality-penalty sensitivity and wire quantizer."""

    compress: bool = True
    bw_mbps: float = 20.0
    # how strongly the measured reconstruction error discounts the
    # similarity-type quality metrics (clip / ir); int8 row-wise error is
    # ~0.3–0.5 % so the delta is small but visible to the bandit.
    quality_sensitivity: float = 1.0
    # which registered quantizer serializes the latent
    # (repro_torch.quantization.QUANTIZERS); "rowwise" is the production
    # wire format — the latency model's byte accounting assumes its
    # int8+per-channel-scale layout
    quantizer: str = "rowwise"


class HandoffTransport:
    """Bytes-on-wire, transfer-latency and quality-delta model for the
    edge→device latent handoff; the round trips it measures run on
    ``device`` (the card unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: Optional[TransportConfig] = None, device=None):
        self.cfg = cfg or TransportConfig()
        self.device = resolve_device(device)
        self._fidelity: Dict[str, float] = {}

    @classmethod
    def for_runtime(cls, rt_cfg, device=None) -> "HandoffTransport":
        """Transport configured from a runtime configuration — the one
        place that maps runtime knobs to transport knobs.  Reads
        ``compress_handoff``, ``bw_mbps`` and ``quality_sensitivity`` by
        attribute."""
        return cls(TransportConfig(
            compress=rt_cfg.compress_handoff, bw_mbps=rt_cfg.bw_mbps,
            quality_sensitivity=rt_cfg.quality_sensitivity,
        ), device=device)

    def wire_bytes(self, family: Optional[str]) -> int:
        """Payload bytes for one latent handoff of this family."""
        return lat.latent_wire_bytes(family, compressed=self.cfg.compress)

    def transfer_time(self, family: Optional[str], rtt_ms: float) -> float:
        """Simulated seconds to move one latent over the configured link."""
        return lat.transfer_time(
            family, rtt_ms, bw_mbps=self.cfg.bw_mbps,
            compressed=self.cfg.compress,
        )

    def warm(self, families, boundary: bool = False) -> None:
        """Measure the round-trip error for the given families before a
        serving loop starts, so the first completion does not pay it.

        With ``boundary=True`` the fused int8 segment-boundary tails
        (:func:`repro_torch.core.boundary.warm`) fire once too, at each
        family's representative handoff latent shape, on this transport's
        device: on the card that builds the kernel library before the
        first compressed relay request needs it."""
        for fam in families:
            if fam is not None:
                self.handoff_error(fam)
        if boundary and self.cfg.compress:
            from repro_torch.core import boundary as bnd

            for fam in families:
                if fam is not None:
                    c = lat.LATENT_CHANNELS[fam]
                    bnd.warm((16, 16, c), quantizer=self.cfg.quantizer,
                             device=self.device)

    def handoff_error(self, family: str) -> float:
        """Measured relative error of the int8 round trip for this family's
        handoff latents (cached; 0 when compression is off)."""
        if not self.cfg.compress:
            return 0.0
        if family not in self._fidelity:
            x = torch.from_numpy(handoff_latent(family)).to(self.device)
            _, err = channelwise_roundtrip(x, self.cfg.quantizer)
            self._fidelity[family] = err
        return self._fidelity[family]

    def quality_delta(self, family: Optional[str], quality: Dict[str, float],
                      n_hops: int = 1) -> Dict[str, float]:
        """Apply the measured compression quality delta to a quality dict.

        Similarity metrics (clip / ir) lose a *subtractive* penalty
        proportional to the measured round-trip error — subtractive so the
        delta degrades quality regardless of the metric's sign (a
        multiplicative factor would shrink negative scores toward zero,
        i.e. reward compression on bad generations); target-free metrics
        are untouched.  An N-hop cascade pays the penalty once per
        compressed hop (``n_hops``)."""
        if family is None or not self.cfg.compress:
            return quality
        penalty = (self.cfg.quality_sensitivity * self.handoff_error(family)
                   * max(n_hops, 1))
        return _penalize(quality, penalty)

    def deviation_quality_delta(self, family: Optional[str],
                                quality: Dict[str, float],
                                dev_pct: float) -> Dict[str, float]:
        """Quality delta priced at an *explicit* Eq. 1 deviation (percent)
        instead of the per-family wire constant — the DAG select path,
        where the surviving handoff's deviation is request-dependent (an
        accepted speculation carries its modeled post-verification
        deviation; a rejected one degenerates to the fixed arm's
        ``quality_delta``).  Same subtractive clip/ir semantics."""
        if family is None or not self.cfg.compress:
            return quality
        return _penalize(quality,
                         self.cfg.quality_sensitivity * dev_pct / 100.0)


def _penalize(quality: Dict[str, float], penalty: float) -> Dict[str, float]:
    """``quality`` with ``penalty`` subtracted from clip and ir."""
    out = dict(quality)
    for k in ("clip", "ir"):
        if k in out:
            out[k] = out[k] - penalty
    return out
