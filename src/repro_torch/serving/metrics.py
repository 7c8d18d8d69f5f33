"""Quality oracles (numpy copy of ``repro/serving/metrics.py``) standing
in for CLIP / ImageReward / PickScore / Aesthetic / OCR (no pretrained
scorers exist offline).

Each is a deterministic functional of (generated latent, prompt) designed to
preserve the *ordering structure* the scheduler learns from:
* clip — cosine similarity between pooled random-projection features of the
  generation and of the target render (semantic alignment).
* ir   — 1 − 2·normalized-MSE to target, saturated (human-preference proxy).
* pick — affine map of quality into PickScore's narrow [0.20, 0.23] band.
* aes  — target-free smoothness/contrast functional (visual appeal).
* ocr  — phase-sensitive correlation of the channel-3 high-frequency band
  with the true glyph stripe pattern (text-rendering fidelity).  Family XL
  never receives the phase features → low OCR, mechanically (Finding 2).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.diffusion import synth

_rng = np.random.default_rng(7)
_FEAT = _rng.normal(size=(synth.HW * synth.HW * synth.CH, 32)).astype(np.float32)


def _feat(x: np.ndarray) -> np.ndarray:
    v = x.reshape(-1) @ _FEAT
    return v / (np.linalg.norm(v) + 1e-8)


def quality_metrics(x_gen: np.ndarray, prompt: synth.Prompt) -> Dict[str, float]:
    """Paper Table IV quality proxies of a generated image against its
    prompt's reference render: CLIP-like cosine ("clip"), ImageReward-like
    reconstruction score ("ir"), PickScore-like ("pick") and an aesthetic
    term ("aes") — all dimensionless, deterministic in (image, prompt)."""
    target = synth.render(prompt)
    clip = float(np.clip(_feat(x_gen) @ _feat(target), -1, 1))

    mse = float(np.mean((x_gen - target) ** 2))
    scale = float(np.mean(target ** 2)) + 1e-6
    ir = float(np.clip(1.0 - 2.0 * mse / scale, -2.0, 1.5))

    q01 = np.clip(0.5 * (clip + 1.0) * 0.6 + 0.4 * np.clip(1 - mse / scale, 0, 1), 0, 1)
    pick = float(0.20 + 0.03 * q01)

    # aesthetic: penalize clipping/noise, reward moderate contrast
    tv = np.mean(np.abs(np.diff(x_gen, axis=0))) + np.mean(np.abs(np.diff(x_gen, axis=1)))
    contrast = np.std(x_gen)
    aes = float(np.clip(5.0 + 2.0 * np.exp(-tv) + np.tanh(contrast) - 0.5, 0.0, 10.0))

    if prompt.wants_text:
        ph = prompt.text_phase[0]
        yy, xx = np.mgrid[0 : synth.HW, 0 : synth.HW].astype(np.float32) / (synth.HW - 1)
        stripes = np.sin(2 * np.pi * synth.STRIPE_FREQ * xx + ph)
        band = x_gen[:, :, 3] - x_gen[:, :, 3].mean()
        denom = np.linalg.norm(band) * np.linalg.norm(stripes) + 1e-8
        ocr = float(np.clip(np.sum(band * stripes) / denom, 0.0, 1.0))
    else:
        ocr = 0.0
    return {"clip": clip, "ir": ir, "pick": pick, "aes": aes, "ocr": ocr}

