"""Context vector construction (paper Eq. 5), a copy of
``repro/core/context.py`` (numpy only):

c = [c_cplx, c_txt, c_net, c_bat, c_pref, l_vega, l_sdxl, l_sd3]  (d = 8)

Engines may append extra features (live runtime telemetry) after the base
8 dims, so downstream consumers index the base features by position.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CTX_DIM = 8


@dataclass
class Request:
    rid: int
    arrival: float
    # prompt-level
    complexity: float  # normalized clause count ∈ [0,1]
    wants_text: bool  # text-rendering indicator
    rtt_ms: float  # measured round-trip latency (network quality)
    battery: float  # device battery fraction ∈ [0,1]
    pref_speed: float  # 0 = max quality … 1 = max speed
    # synthetic prompt payload (drives the generative models + oracles)
    prompt_seed: int = 0


def context_vector(req: Request, occupancy: dict,
                   extra: "np.ndarray | None" = None) -> np.ndarray:
    """occupancy: {"vega": l, "sdxl": l, "sd3": l} pool-occupancy fractions.
    ``extra``: optional trailing features (e.g. runtime telemetry)."""
    c_net = np.clip(np.log1p(req.rtt_ms) / np.log1p(2000.0), 0.0, 1.0)
    base = np.array(
        [
            np.clip(req.complexity, 0.0, 1.0),
            1.0 if req.wants_text else 0.0,
            c_net,
            1.0 if req.battery < 0.2 else 0.0,
            np.clip(req.pref_speed, 0.0, 1.0),
            occupancy.get("vega", 0.0),
            occupancy.get("sdxl", 0.0),
            occupancy.get("sd3", 0.0),
        ],
        dtype=np.float32,
    )
    if extra is None:
        return base
    return np.concatenate([base, np.asarray(extra, np.float32)])
