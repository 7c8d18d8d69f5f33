"""Dense gated MLP (port of ``repro/models/mlp.py:35-48``):
``act(x @ w_gate) * (x @ w_up) @ w_down``.  The mixture of experts comes
with its own slice (ROADMAP queue 1, item 10)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm


class MLP(nn.Module):
    """Weights ``w_gate``/``w_up`` (d, f) and ``w_down`` (f, d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        dt = cm.dtype_of(cfg)
        f = d_ff or cfg.d_ff
        g = generator
        for name, fan_in, out in (("w_gate", cfg.d_model, f),
                                  ("w_up", cfg.d_model, f),
                                  ("w_down", f, cfg.d_model)):
            setattr(self, name,
                    cm.param(cm.dense_init(g, fan_in, (out,), dt, device)))


def init_mlp(cfg: ArchConfig, generator: torch.Generator, device,
             d_ff: Optional[int] = None) -> MLP:
    return MLP(cfg, generator, device, d_ff)


def mlp_fwd(p: MLP, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = cm.act_fn(cfg.act)
    return (act(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
