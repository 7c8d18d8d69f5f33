"""Dynamic composite reward (paper Eqs. 12–13), a copy of
``repro/core/reward.py`` (numpy only).

r = Σ_m w_m·Q_m − w_time·t_total − w_cost·m_vram − γ·l_dev, tanh-compressed.
Weights adapt to the request context (text-rendering / speed / quality /
low-battery regimes).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np

ETA = 20.0  # tanh compression scale (r_final ∈ (−η, η))

BASE_WEIGHTS = {
    "clip": 8.0,
    "ir": 4.0,
    "pick": 20.0,
    "aes": 0.6,
    "ocr": 6.0,
}
BASE_W_TIME = 0.35
BASE_W_COST = 0.08
BASE_GAMMA = 1.5


@dataclass
class RewardInputs:
    quality: Dict[str, float]  # keys: clip, ir, pick, aes, ocr
    t_total: float  # end-to-end latency incl. queueing (s)
    m_vram: float  # peak VRAM of the chosen configuration (GB)
    l_dev: float  # max occupancy of the pools used ∈ [0,1]
    # context flags
    c_txt: float = 0.0
    c_pref: float = 0.0
    c_bat: float = 0.0


@lru_cache(maxsize=8)
def _weights_for(txt: bool, pref: bool, bat: bool):
    """Weight sets depend only on the three thresholded context flags, so
    there are exactly 8 of them — built once each, then reused (the reward
    path runs once per completed request).  Returned structures are shared:
    treat them as read-only."""
    w = dict(BASE_WEIGHTS)
    w_time, w_cost, gamma = BASE_W_TIME, BASE_W_COST, BASE_GAMMA
    if txt:  # text-rendering: raise OCR, drop visual weights
        w["ocr"] *= 4.0
        for k in ("clip", "ir", "pick", "aes"):
            w[k] *= 0.5
    if pref:  # speed-sensitive: amplify time, halve quality
        w_time *= 2.5
        for k in w:
            w[k] *= 0.5
    else:  # quality-focused: maximize CLIP/IR, reduce time
        w["clip"] *= 1.5
        w["ir"] *= 1.5
        w_time *= 0.6
    if bat:  # low battery: scale up cost and time penalties
        w_cost *= 2.0
        w_time *= 1.5
    return w, w_time, w_cost, gamma


def dynamic_weights(c_txt: float, c_pref: float, c_bat: float):
    w, w_time, w_cost, gamma = _weights_for(
        c_txt >= 0.5, c_pref > 0.5, c_bat >= 0.5
    )
    return dict(w), w_time, w_cost, gamma  # copy: callers may mutate


def compute_reward(x: RewardInputs, *, dynamic: bool = True) -> float:
    """Eqs. 12–13 → compressed reward in (−η, η).  ``dynamic=False`` freezes
    the weights at their base values (Table IV "w/o Dynamic Reward")."""
    if dynamic:
        w, w_time, w_cost, gamma = _weights_for(
            x.c_txt >= 0.5, x.c_pref > 0.5, x.c_bat >= 0.5
        )
    else:
        w, w_time, w_cost, gamma = BASE_WEIGHTS, BASE_W_TIME, BASE_W_COST, BASE_GAMMA
    q = x.quality
    r = sum(w[k] * q.get(k, 0.0) for k in w)
    r -= w_time * x.t_total + w_cost * x.m_vram + gamma * x.l_dev
    return float(ETA * np.tanh(r / ETA))
