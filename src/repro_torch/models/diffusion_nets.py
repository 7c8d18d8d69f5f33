"""Diffusion denoiser backbones of the two relay families (port of
``repro/models/diffusion_nets.py``) as ``nn.Module``s:

* :class:`UNet`  — conv UNet with FiLM conditioning (family "XL");
* :class:`MMDiT` — two-stream MMDiT with joint image+text attention and
  per-modality adaLN (family "F3").

Both keep the reference's ``(B, H, W, C)`` latent layout at ``forward``
(the UNet permutes to NCHW inside) and take their weights from the
reference checkpoints (:func:`repro_torch.training.checkpoint.params_from_jax`):
conv kernels OIHW, dense weights ``(cin, cout)`` applied as ``x @ W``.
:func:`build_net`'s parameters start at zero and take no gradient; load a
state dict before use.  :func:`init_net` draws a trainable net with the
reference's initial distributions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.schedules import linspace_f32


@dataclass(frozen=True)
class DiffNetConfig:
    kind: str  # unet | mmdit
    width: int = 48
    depth: int = 2  # res blocks per level (unet) / transformer layers (mmdit)
    heads: int = 4
    latent_hw: int = 8
    latent_ch: int = 4
    cond_dim: int = 16
    text_tokens: int = 4  # mmdit text-stream length


# the reference's configurations (sized for a 1-core CPU)
XL_LARGE = DiffNetConfig("unet", width=32, depth=2)  # "SDXL"
XL_SMALL = DiffNetConfig("unet", width=16, depth=1)  # "Segmind-Vega"
F3_LARGE = DiffNetConfig("mmdit", width=64, depth=3)  # "SD3.5 Large"
F3_SMALL = DiffNetConfig("mmdit", width=32, depth=2)  # "SD3.5 Medium"
XL_MID = DiffNetConfig("unet", width=24, depth=2)  # "SSD-1B"-like
F3_MID = DiffNetConfig("mmdit", width=48, depth=2)  # distilled mid SD3.5

_TIME_DIM = 64


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def time_freqs(dim: int) -> torch.Tensor:
    """Fourier frequencies exp(linspace(0, 4, dim/2)) in fp32."""
    return torch.exp(linspace_f32(0.0, 4.0, dim // 2))


def time_embed(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Fourier features of log-σ (or RF time): t (B,) → (B, 2·len(freqs))."""
    ang = torch.log1p(t)[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _batch_time(t, b: int, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=torch.float32, device=like.device)
    return t.reshape(-1).expand(b)


# ---------------------------------------------------------------------------
# UNet (family XL)
# ---------------------------------------------------------------------------


def _conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 "SAME" convolution (padding 1 on every side)."""
    return F.conv2d(x, w, padding=1)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.conv1 = _param(cout, cin, 3, 3)
        self.conv2 = _param(cout, cout, 3, 3)
        self.film = _param(emb_dim, 2 * cout)
        self.skip = _param(cout, cin, 1, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(_conv3(x, self.conv1))
        scale, shift = torch.chunk(emb @ self.film, 2, dim=-1)
        h = h * (1 + scale[:, :, None, None]) + shift[:, :, None, None]
        h = _conv3(F.silu(h), self.conv2)
        skip = F.conv2d(x, self.skip) if self.skip is not None else x
        return h + skip


class UNet(nn.Module):
    """x (B,8,8,4), t scalar σ, cond (B, cond_dim) → x̂0 (B,8,8,4)."""

    def __init__(self, cfg: DiffNetConfig):
        super().__init__()
        w, d = cfg.width, cfg.depth
        emb_dim = 4 * w
        self.emb1 = _param(_TIME_DIM + cfg.cond_dim, emb_dim)
        self.emb2 = _param(emb_dim, emb_dim)
        self.stem = _param(w, cfg.latent_ch + cfg.cond_dim, 3, 3)
        self.down = nn.ModuleList(ResBlock(w, w, emb_dim) for _ in range(d))
        self.down_proj = _param(2 * w, w, 3, 3)
        self.mid = nn.ModuleList(ResBlock(2 * w, 2 * w, emb_dim)
                                 for _ in range(d))
        self.up_proj = _param(w, 2 * w, 3, 3)
        self.up = nn.ModuleList([ResBlock(2 * w, w, emb_dim)]
                                + [ResBlock(w, w, emb_dim)
                                   for _ in range(d - 1)])
        self.out = _param(cfg.latent_ch, w, 3, 3)
        self.register_buffer("freqs", time_freqs(_TIME_DIM), persistent=False)

    def forward(self, x: torch.Tensor, t, cond: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        te = time_embed(_batch_time(t, b, x), self.freqs)
        emb = F.silu(torch.cat([te, cond], -1) @ self.emb1)
        emb = F.silu(emb @ self.emb2)
        xc = x.permute(0, 3, 1, 2)
        cond_maps = cond[:, :, None, None].expand(b, cond.shape[-1],
                                                  *xc.shape[-2:])
        h = _conv3(torch.cat([xc, cond_maps], dim=1), self.stem)
        for blk in self.down:
            h = blk(h, emb)
        skip = h
        # stride-2 "SAME" on an even size pads (0, 1), not (1, 1)
        h = F.conv2d(F.pad(h, (0, 1, 0, 1)), self.down_proj, stride=2)
        for blk in self.mid:
            h = blk(h, emb)
        h = F.interpolate(h, size=skip.shape[-2:], mode="nearest")
        h = _conv3(h, self.up_proj)
        h = torch.cat([h, skip], dim=1)
        for blk in self.up:
            h = blk(h, emb)
        return _conv3(F.silu(h), self.out).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# MMDiT (family F3)
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm, population variance, eps 1e-6."""
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _modulate(x, shift, scale):
    return _ln(x) * (1 + scale[:, None]) + shift[:, None]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MMDiTLayer(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        for mod in ("img", "txt"):
            setattr(self, f"ada_{mod}", _param(w, 6 * w))
            setattr(self, f"qkv_{mod}", _param(w, 3 * w))
            setattr(self, f"o_{mod}", _param(w, w))
            setattr(self, f"mlp1_{mod}", _param(w, 4 * w))
            setattr(self, f"mlp2_{mod}", _param(4 * w, w))


class MMDiT(nn.Module):
    """x (B,8,8,4), t RF time, cond (B, cond_dim) → x̂0 (B,8,8,4)."""

    heads = 4

    def __init__(self, cfg: DiffNetConfig):
        super().__init__()
        w = cfg.width
        self.patch = _param(cfg.latent_ch, w)
        self.pos = _param(cfg.latent_hw * cfg.latent_hw, w)
        self.txt_proj = _param(cfg.cond_dim, cfg.text_tokens * w)
        self.t_emb = _param(_TIME_DIM, w)
        self.c_emb = _param(cfg.cond_dim, w)
        self.layers = nn.ModuleList(MMDiTLayer(w) for _ in range(cfg.depth))
        self.out_norm = _param(w)
        self.out = _param(w, cfg.latent_ch)
        self.register_buffer("freqs", time_freqs(_TIME_DIM), persistent=False)

    def _attn(self, q, k, v):
        """Joint attention over the concatenated image+text keys: plain
        einsum + softmax, as the reference."""
        b, n, w = q.shape
        dh = w // self.heads
        qh = q.reshape(b, n, self.heads, dh)
        kh = k.reshape(b, k.shape[1], self.heads, dh)
        vh = v.reshape(b, v.shape[1], self.heads, dh)
        sc = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(dh)
        pr = torch.softmax(sc, -1)
        return torch.einsum("bhnm,bmhd->bnhd", pr, vh).reshape(b, n, w)

    def forward(self, x: torch.Tensor, t, cond: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        w = self.patch.shape[1]
        img = x.reshape(b, hh * ww, c) @ self.patch + self.pos[None]
        txt = (cond @ self.txt_proj).reshape(b, -1, w)
        temb = (time_embed(_batch_time(t, b, x), self.freqs) @ self.t_emb
                + cond @ self.c_emb)
        for lp in self.layers:
            mi = F.silu(temb) @ lp.ada_img
            mt = F.silu(temb) @ lp.ada_txt
            si1, sc1, g1, si2, sc2, g2 = torch.chunk(mi, 6, -1)
            ti1, tc1, tg1, ti2, tc2, tg2 = torch.chunk(mt, 6, -1)

            qi, ki, vi = torch.chunk(_modulate(img, si1, sc1) @ lp.qkv_img,
                                     3, -1)
            qt, kt, vt = torch.chunk(_modulate(txt, ti1, tc1) @ lp.qkv_txt,
                                     3, -1)
            k = torch.cat([ki, kt], 1)
            v = torch.cat([vi, vt], 1)
            img = img + g1[:, None] * (self._attn(qi, k, v) @ lp.o_img)
            txt = txt + tg1[:, None] * (self._attn(qt, k, v) @ lp.o_txt)

            img_n = _modulate(img, si2, sc2)
            txt_n = _modulate(txt, ti2, tc2)
            img = img + g2[:, None] * (_gelu(img_n @ lp.mlp1_img)
                                       @ lp.mlp2_img)
            txt = txt + tg2[:, None] * (_gelu(txt_n @ lp.mlp1_txt)
                                        @ lp.mlp2_txt)

        out = _ln(img) * (1 + self.out_norm)
        return (out @ self.out).reshape(b, hh, ww, c)


def build_net(cfg: DiffNetConfig) -> nn.Module:
    return UNet(cfg) if cfg.kind == "unet" else MMDiT(cfg)


# parameters the reference initializes to zero (adaLN-Zero style: FiLM,
# the MMDiT's modulations and the output norm's gain)
_ZERO_INIT = ("film", "ada_img", "ada_txt", "out_norm")


def init_net(cfg: DiffNetConfig, generator: torch.Generator) -> nn.Module:
    """A trainable net (every parameter ``requires_grad``) drawn from
    ``generator`` (a CPU generator) with the reference's distributions
    (``repro/models/diffusion_nets.py::init_net``): conv kernels N(0, 1) /
    √(kh·kw·cin), dense weights N(0, 1) / √cin, ``pos`` N(0, 1)·0.02, and
    zeros for every ``film``, ``ada_img``, ``ada_txt`` and ``out_norm``.
    The draws follow the state dict's order; the port does not reproduce
    the reference's bits."""
    net = build_net(cfg)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZERO_INIT:
                p.zero_()
                continue
            draw = torch.randn(p.shape, generator=generator)
            if leaf == "pos":
                p.copy_(draw * 0.02)
            elif p.ndim == 4:  # OIHW: fan-in kh·kw·cin
                cout, cin, kh, kw = p.shape
                p.copy_(draw * (1.0 / torch.sqrt(torch.tensor(
                    float(kh * kw * cin)))))
            else:  # (cin, cout)
                p.copy_(draw / torch.sqrt(torch.tensor(float(p.shape[0]))))
    return net.requires_grad_(True)
