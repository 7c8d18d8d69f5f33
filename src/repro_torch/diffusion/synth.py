"""Synthetic text-to-image latent task (numpy copy of
``repro/diffusion/synth.py``: the same prompts, renders and conditioning
for the same seeds).

Prompts are structured feature vectors; a fixed procedural renderer G(z)
produces the target 8×8×4 latent.  The text-rendering capability gap between
the two families is *mechanistic*: family F3's conditioning embedding carries
the text-pattern features (phase/frequency); family XL's does not — exactly
mirroring SDXL's inability to render legible text vs SD3.5 (paper Finding 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HW = 8
CH = 4
CONTENT_DIM = 8
COND_DIM = 16

_rng = np.random.default_rng(1234)
_PROJ = _rng.normal(size=(CONTENT_DIM, 3 * 4)).astype(np.float32)  # blob params


@dataclass
class Prompt:
    seed: int
    content: np.ndarray  # (8,) scene features
    complexity: float  # ∈ [0,1] — number of clauses / objects
    wants_text: bool
    text_phase: np.ndarray  # (2,) phase/frequency of the glyph pattern


def sample_prompt(seed: int, *, p_text: float = 0.35) -> Prompt:
    rng = np.random.default_rng(seed)
    return Prompt(
        seed=seed,
        content=rng.normal(size=CONTENT_DIM).astype(np.float32),
        complexity=float(rng.uniform()),
        wants_text=bool(rng.uniform() < p_text),
        text_phase=rng.uniform(0, 2 * np.pi, size=2).astype(np.float32),
    )


STRIPE_FREQ = 3.0  # fixed glyph-band frequency; phase carries the content


def blob_params(prompt: Prompt) -> np.ndarray:
    """(12,) renderer parameters: 4 × (cx, cy, amp), squashed to (−1, 1)."""
    return np.tanh(prompt.content @ _PROJ).astype(np.float32)


def render(prompt: Prompt) -> np.ndarray:
    """G(z): deterministic target latent (8,8,4)."""
    yy, xx = np.mgrid[0:HW, 0:HW].astype(np.float32) / (HW - 1)
    lat = np.zeros((HW, HW, CH), np.float32)
    bp = blob_params(prompt)
    n_blobs = 1 + int(prompt.complexity * 3)
    for i in range(n_blobs):
        cx, cy, amp = bp[3 * i : 3 * i + 3]
        cx, cy = (cx + 1) / 2, (cy + 1) / 2
        g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.08))
        lat[:, :, i % 3] += amp * g
    if prompt.wants_text:
        ph = prompt.text_phase[0]
        stripes = np.sin(2 * np.pi * STRIPE_FREQ * xx + ph)
        lat[:, :, 3] = 0.8 * stripes  # high-frequency "glyph" band
    return lat


def embed(prompt: Prompt, family: str) -> np.ndarray:
    """Conditioning vector per family — informative about composition, like a
    CLIP text embedding (it carries the renderer parameters directly; the
    glyph phase is sin/cos-encoded so the map to the stripe pattern is
    bilinear and learnable).  XL never sees the text features (Finding 2)."""
    e = np.zeros(COND_DIM, np.float32)
    e[:12] = blob_params(prompt)
    e[12] = prompt.complexity
    if family == "F3":
        ph = prompt.text_phase[0]
        flag = 1.0 if prompt.wants_text else 0.0
        e[13] = flag
        e[14] = flag * np.sin(ph)
        e[15] = flag * np.cos(ph)
    return e


def batch(seeds, family: str):
    ps = [sample_prompt(int(s)) for s in seeds]
    x0 = np.stack([render(p) for p in ps])
    cond = np.stack([embed(p, family) for p in ps])
    return ps, x0, cond
