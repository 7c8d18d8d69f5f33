"""Recurrent mixers (port of ``repro/models/recurrent.py``): the Griffin
RG-LRU block of RecurrentGemma and the two xLSTM cells, the mLSTM (matrix
memory; parallel and chunkwise-parallel forms, one-token recurrent
decode) and the sLSTM (scalar memory, a strict scan).

The recurrences run in fp32, block I/O in the config's dtype.  The
RG-LRU's full-sequence branch (``cache=None``) computes h_t = a_t ⊙
h_{t-1} + b_t through :func:`repro_torch.kernels.rglru.ops.rglru_scan`,
the hand-written CUDA kernel on the card (the reference's
``associative_scan``); its one-token decode step is the plain ``h = a *
h_prev + b``, as in the reference.  The xLSTM cells are plain torch, as
the reference's are plain ``jnp`` with no Pallas kernel: the sLSTM's
``lax.scan`` is a loop over the sequence.  A decode step updates its
cache ({"h", "conv"}; {"C", "n", "m", "conv"}; {"h", "c", "n", "m"}) in
place (the reference returns a new one) and returns the same dict.

The reference's numerics are kept where torch's defaults differ:
``log_sigmoid`` is ``-softplus(-x)`` and ``softplus`` is ``logaddexp(x,
0)``, as in ``jax.nn``; the mLSTM's ``silu`` is ``x * (1 / (1 +
exp(-x)))``, each operation rounded to the model's dtype as XLA expands
``jax.nn.silu``; the stabilizer ``m`` starts at -1e30 and the sLSTM's
``n`` at 1e-6 (in the scans and the ``init_*_cache`` states; the model's
cache of a repeated layer starts from zeros, as the reference's
``init_lm_cache``), masks are ``-inf`` and the denominators ``max(|.|,
exp(-m))``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models import common as cm

RGLRU_C = 8.0


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  cache: Optional[torch.Tensor] = None):
    """x: (B, S, R); w: (cw, R); cache: (B, cw-1, R), the trailing inputs
    of the past.  Sums ``w[i] * xp[:, i:i+S]`` in x's dtype in the
    reference's order.  Returns ``(y, new_cache)``, ``new_cache`` the last
    cw-1 inputs (a new tensor; the caller writes it where it keeps it)."""
    cw = w.shape[0]
    if cache is None:
        pad = torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+cw-1, R)
    y = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(cw)) + b
    new_cache = xp[:, -(cw - 1):] if cw > 1 else pad
    return y.to(x.dtype), new_cache


class RGLRU(nn.Module):
    """Weights of one recurrent block, with ``init_rglru``'s names and
    distributions: ``w_x``/``w_g`` (d, R), ``w_a``/``w_i`` (R, R),
    ``w_out`` (R, d) truncated normal over √fan_in; ``conv_w`` (cw, R)
    N(0, 0.1²); zero biases ``conv_b``, ``b_a``, ``b_i``; all in the
    config's dtype, except ``lam`` (R,) ~ U[0, 1), which stays fp32 in
    every model."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        d, r, g = cfg.d_model, cfg.rnn_width or cfg.d_model, generator
        self.w_x = cm.param(cm.dense_init(g, d, (r,), dt, device))
        self.w_g = cm.param(cm.dense_init(g, d, (r,), dt, device))
        conv = torch.empty((cfg.conv_width, r), dtype=torch.float32,
                           device=device)
        self.conv_w = cm.param(conv.normal_(0.0, 1.0, generator=g)
                               .mul_(0.1).to(dt))
        self.conv_b = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_a = cm.param(cm.dense_init(g, r, (r,), dt, device))
        self.b_a = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_i = cm.param(cm.dense_init(g, r, (r,), dt, device))
        self.b_i = cm.param(torch.zeros(r, dtype=dt, device=device))
        lam = torch.empty(r, dtype=torch.float32, device=device)
        self.lam = cm.param(lam.uniform_(0.0, 1.0, generator=g))
        self.w_out = cm.param(cm.dense_init(g, r, (d,), dt, device))


def init_rglru(cfg: ArchConfig, generator: torch.Generator, device) -> RGLRU:
    return RGLRU(cfg, generator, device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(p: RGLRU, xc: torch.Tensor):
    """The decay ``a`` and the gated input ``b`` of the recurrence, fp32."""
    rg = torch.sigmoid((xc @ p.w_a).float() + p.b_a)
    ig = torch.sigmoid((xc @ p.w_i).float() + p.b_i)
    log_a = -RGLRU_C * _softplus(p.lam) * rg  # (..., R) fp32
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
             * ig * xc.float())
    return a, gated


def rglru_block_fwd(p: RGLRU, cfg: ArchConfig, x: torch.Tensor, *,
                    cache: Optional[dict] = None):
    """Griffin recurrent block: in-proj → causal conv → RG-LRU → gate →
    out-proj.  ``cache`` = {"h": (B, R) fp32, "conv": (B, cw-1, R)} for a
    one-token decode step, updated in place.  Returns ``(y, new_cache)``,
    ``new_cache`` None for a full sequence."""
    xm = x @ p.w_x
    gate = F.gelu(x @ p.w_g, approximate="tanh")  # jax.nn.gelu's default
    xc, new_conv = causal_conv1d(xm, p.conv_w, p.conv_b,
                                 None if cache is None else cache["conv"])
    a, b = _rglru_gates(p, xc)
    if cache is None:
        h = rglru_scan(a, b)
    else:
        if x.shape[1] != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        h = a * cache["h"][:, None] + b  # (B, 1, R) fp32
        cache["h"].copy_(h[:, 0])
        cache["conv"].copy_(new_conv)
    y = (h.to(x.dtype) * gate) @ p.w_out
    return y, cache


def init_rglru_cache(cfg: ArchConfig, batch: int, *, device) -> dict:
    r = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                            dtype=cm.dtype_of(cfg), device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM numerics shared by both cells
# ---------------------------------------------------------------------------


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` (``F.logsigmoid`` computes
    it another way)."""
    return -_softplus(-x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA expands it: ``x * (1 / (1 + exp(-x)))``,
    each operation rounded to x's dtype (``F.silu`` rounds once; in bf16
    the two differ in the last bit of a third of the elements)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """Weights of one mLSTM block, with ``init_mlstm``'s names and
    distributions (R = ``rnn_width``, NH heads of DH = R / NH):
    ``w_up`` (d, 2R) and ``w_down`` (R, d) truncated normal over √fan_in;
    ``conv_w`` (cw, R) N(0, 0.1²); ``conv_b`` zero; the block-diagonal
    head projections ``wq_h``/``wk_h``/``wv_h`` (NH, DH, DH) N(0, 1/DH);
    ``gn_scale`` (R,) zero; all in the config's dtype, except the gate
    projection ``w_if`` (R, 2·NH), truncated normal, and its bias ``b_if``
    (zeros for the input gates, linspace(3, 6) for the forget gates),
    which stay fp32 in every model."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        d, nh, g = cfg.d_model, cfg.n_heads, generator
        r = cfg.rnn_width or 2 * cfg.d_model
        dh = r // nh
        f32 = dict(dtype=torch.float32, device=device)
        self.w_up = cm.param(cm.dense_init(g, d, (2 * r,), dt, device))
        conv = torch.empty((cfg.conv_width, r), **f32)
        self.conv_w = cm.param(conv.normal_(0.0, 1.0, generator=g)
                               .mul_(0.1).to(dt))
        self.conv_b = cm.param(torch.zeros(r, dtype=dt, device=device))
        for name in ("wq_h", "wk_h", "wv_h"):
            w = torch.empty((nh, dh, dh), **f32).normal_(0.0, 1.0,
                                                         generator=g)
            setattr(self, name, cm.param((w / math.sqrt(dh)).to(dt)))
        self.w_if = cm.param(cm.dense_init(g, r, (2 * nh,), torch.float32,
                                           device))
        self.b_if = cm.param(torch.cat([torch.zeros(nh, **f32),
                                        torch.linspace(3.0, 6.0, nh, **f32)]))
        self.gn_scale = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_down = cm.param(cm.dense_init(g, r, (d,), dt, device))


def init_mlstm(cfg: ArchConfig, generator: torch.Generator, device) -> MLSTM:
    return MLSTM(cfg, generator, device)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, s, r = x.shape
    return x.reshape(b, s, nh, r // nh)


def _causal(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def mlstm_parallel(q, k, v, i_raw, log_f):
    """Stabilized parallel mLSTM: q, k, v (B, S, NH, DH) fp32 (k already
    scaled by 1/√DH); gates (B, S, NH) fp32.  Returns h (B, S, NH, DH)."""
    fcum = torch.cumsum(log_f, dim=1)  # (B, S, NH): F_t
    # (B, t, s, NH): F_t - F_s + i_s
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + i_raw[:, None, :, :]
    causal = _causal(dmat.shape[1], dmat.device)
    dmat = torch.where(causal[None, :, :, None], dmat, -math.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)  # (B, t, 1, NH)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bthd,bshd->btsh", q, k)
    c = scores * dexp
    denom = torch.maximum(torch.abs(torch.sum(c, dim=2)),
                          torch.exp(-m[:, :, 0]))  # (B, t, NH)
    return torch.einsum("btsh,bshd->bthd", c, v) / denom[..., None]


def mlstm_chunkwise(q, k, v, i_raw, log_f, chunk: int):
    """Chunkwise-parallel mLSTM: O(S·chunk) memory instead of O(S²); a
    loop over the S / chunk chunks (the reference's ``lax.scan``) carrying
    the (C, n, m) state, parallel within a chunk.  Its stabilizer differs
    from :func:`mlstm_parallel`'s, so the two agree only to the
    ``max(|.|, exp(-m))`` floors' difference."""
    b, s, nh, dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.zeros((b, nh, dh, dh), **f32)
    n = torch.zeros((b, nh, dh), **f32)
    m = torch.full((b, nh), -1e30, **f32)
    causal = _causal(chunk, q.device)
    hs = []
    for i in range(0, s, chunk):
        qb, kb, vb = q[:, i:i + chunk], k[:, i:i + chunk], v[:, i:i + chunk]
        ib, fb = i_raw[:, i:i + chunk], log_f[:, i:i + chunk]
        fcs = torch.cumsum(fb, dim=1)  # within-chunk cumulative log f
        ftot = fcs[:, -1]  # (B, NH)
        # intra-chunk decay matrix
        dmat = fcs[:, :, None, :] - fcs[:, None, :, :] + ib[:, None, :, :]
        dmat = torch.where(causal[None, :, :, None], dmat, -math.inf)
        # inter-chunk: query t sees the state C with decay fcs_t, offset m
        m_inter = fcs + m[:, None, :]  # (B, chunk, NH)
        m_intra = torch.amax(dmat, dim=2)
        m_new = torch.maximum(m_inter, m_intra)
        dexp = torch.exp(dmat - m_new[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * dexp
        inter_w = torch.exp(m_inter - m_new)  # (B, chunk, NH)
        h_intra = torch.einsum("btsh,bshd->bthd", scores, vb)
        h_inter = torch.einsum("bthd,bhde->bthe", qb, C) * inter_w[..., None]
        norm_intra = torch.sum(scores, dim=2)  # (B, chunk, NH)
        norm_inter = torch.einsum("bthd,bhd->bth", qb, n) * inter_w
        denom = torch.maximum(torch.abs(norm_intra + norm_inter),
                              torch.exp(-m_new))
        hs.append((h_intra + h_inter) / denom[..., None])
        # the state: C' = exp(F_tot + m - m')·C
        #                 + Σ_s exp(F_tot - F_s + i_s - m')·k_s v_s
        m_state = torch.maximum(
            ftot + m, torch.amax(ftot[:, None] - fcs + ib, dim=1))
        carry_decay = torch.exp(ftot + m - m_state)  # (B, NH)
        kv_decay = torch.exp(ftot[:, None] - fcs + ib
                             - m_state[:, None])  # (B, chunk, NH)
        C = carry_decay[:, :, None, None] * C + torch.einsum(
            "bshd,bsh,bshe->bhde", kb, kv_decay, vb)
        n = carry_decay[:, :, None] * n + torch.einsum("bshd,bsh->bhd", kb,
                                                       kv_decay)
        m = m_state
    return torch.cat(hs, dim=1)


def mlstm_block_fwd(p: MLSTM, cfg: ArchConfig, x: torch.Tensor, *,
                    cache: Optional[dict] = None,
                    chunk: Optional[int] = None):
    """mLSTM block: up-projection → causal conv + silu → per-head q/k (from
    the conv) and v (from the main branch) → the cell → per-head group
    norm → silu gate → down-projection.  ``cache`` = {"C": (B, NH, DH, DH),
    "n": (B, NH, DH), "m": (B, NH), all fp32, "conv": (B, cw-1, R)} for a
    one-token decode step, updated in place.  A full sequence runs the
    chunkwise form when ``chunk`` divides S and S > chunk, else the
    parallel form.  Returns ``(y, cache)``.

    The dtypes follow the reference: the head products in the model's
    dtype, then cast to fp32 (k divided by √DH after the cast); the gates
    ``main.float() @ w_if + b_if``; h cast back to the model's dtype
    before the group norm, whose rsqrt is taken in fp32 and cast to h's
    dtype; ``1 + gn_scale`` and the silu gate in the model's dtype."""
    nh = cfg.n_heads
    r = cfg.rnn_width or 2 * cfg.d_model
    dh = r // nh
    up = x @ p.w_up
    main, gate = up[..., :r], up[..., r:]
    c_out, new_conv = causal_conv1d(main, p.conv_w, p.conv_b,
                                    None if cache is None else cache["conv"])
    c_out = _silu(c_out)

    ch, mh = _heads(c_out, nh), _heads(main, nh)
    q = torch.einsum("bshd,hde->bshe", ch, p.wq_h).float()
    k = torch.einsum("bshd,hde->bshe", ch, p.wk_h).float() / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", mh, p.wv_h).float()
    gif = main.float() @ p.w_if + p.b_if
    i_raw, f_raw = gif[..., :nh], gif[..., nh:]
    log_f = log_sigmoid(f_raw)

    if cache is None:
        s = x.shape[1]
        if chunk and s % chunk == 0 and s > chunk:
            h = mlstm_chunkwise(q, k, v, i_raw, log_f, chunk)
        else:
            h = mlstm_parallel(q, k, v, i_raw, log_f)
    else:
        if x.shape[1] != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        C, n, m = cache["C"], cache["n"], cache["m"]
        lf, ir = log_f[:, 0], i_raw[:, 0]  # (B, NH)
        m_new = torch.maximum(lf + m, ir)
        fprime = torch.exp(lf + m - m_new)
        iprime = torch.exp(ir - m_new)
        k1, v1, q1 = k[:, 0], v[:, 0], q[:, 0]  # (B, NH, DH)
        kv = k1[..., :, None] * v1[..., None, :]
        # C' = f'·C + i'·(k ⊗ v), each product rounded, as the reference
        C.mul_(fprime[..., None, None]).add_(kv.mul_(iprime[..., None, None]))
        n.mul_(fprime[..., None]).add_(iprime[..., None] * k1)
        m.copy_(m_new)
        cache["conv"].copy_(new_conv)
        denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q1, n)),
                              torch.exp(-m_new))
        h = (torch.einsum("bhd,bhde->bhe", q1, C) / denom[..., None])[:, None]

    h = h.reshape(x.shape[0], x.shape[1], r).to(x.dtype)
    # per-head group norm
    hh = _heads(h, nh)
    rms = torch.rsqrt(torch.mean(torch.square(hh.float()), -1, keepdim=True)
                      + 1e-6)
    h = (hh * rms.to(h.dtype)).reshape(h.shape) * (1.0 + p.gn_scale)
    return (h * _silu(gate)) @ p.w_down, cache


def init_mlstm_cache(cfg: ArchConfig, batch: int, *, device) -> dict:
    nh = cfg.n_heads
    r = cfg.rnn_width or 2 * cfg.d_model
    dh = r // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, nh, dh, dh), **f32),
        "n": torch.zeros((batch, nh, dh), **f32),
        "m": torch.full((batch, nh), -1e30, **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                            dtype=cm.dtype_of(cfg), device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar cell, strictly sequential)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """Weights of one sLSTM block, with ``init_slstm``'s names and
    distributions (width R = d, NH heads of DH = R / NH): ``w_gates`` (d,
    4R) truncated normal, the recurrent ``r_gates`` (NH, 4, DH, DH)
    N(0, 1/DH) and ``b_gates`` (4R: zeros, the forget gates
    linspace(3, 6), zeros), all fp32 in every model; ``gn_scale`` (R,)
    zero and ``w_out`` (R, d) truncated normal in the config's dtype."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        r, nh, g = cfg.d_model, cfg.n_heads, generator  # proj factor 1
        dh = r // nh
        f32 = dict(dtype=torch.float32, device=device)
        self.w_gates = cm.param(cm.dense_init(g, cfg.d_model, (4 * r,),
                                              torch.float32, device))
        rg = torch.empty((nh, 4, dh, dh), **f32).normal_(0.0, 1.0,
                                                          generator=g)
        self.r_gates = cm.param(rg / math.sqrt(dh))
        self.b_gates = cm.param(torch.cat([
            torch.zeros(r, **f32), torch.linspace(3.0, 6.0, r, **f32),
            torch.zeros(2 * r, **f32)]))
        self.gn_scale = cm.param(torch.zeros(r, dtype=dt, device=device))
        self.w_out = cm.param(cm.dense_init(g, r, (cfg.d_model,), dt, device))


def init_slstm(cfg: ArchConfig, generator: torch.Generator, device) -> SLSTM:
    return SLSTM(cfg, generator, device)


def _slstm_step(p: SLSTM, nh: int, dh: int, carry, xg):
    """carry: h, c, n, m each (B, NH, DH) fp32; xg: (B, 4R) the input's
    gate pre-activations.  Returns the new carry and h."""
    h, c, n, m = carry
    b = h.shape[0]
    rec = torch.einsum("bhd,hgde->bhge", h, p.r_gates)  # (B, NH, 4, DH)
    g = xg.reshape(b, 4, nh, dh).transpose(1, 2) + rec  # (B, NH, 4, DH)
    gi, gf, gz, go = g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3]
    log_f = log_sigmoid(gf)
    m_new = torch.maximum(log_f + m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c2 = f_p * c + i_p * torch.tanh(gz)
    n2 = torch.clamp(f_p * n + i_p, min=1e-6)
    h2 = torch.sigmoid(go) * c2 / n2
    return (h2, c2, n2, m_new), h2


def slstm_block_fwd(p: SLSTM, cfg: ArchConfig, x: torch.Tensor, *,
                    cache: Optional[dict] = None):
    """sLSTM block: the gate pre-activations ``x.float() @ w_gates +
    b_gates``, the scan over the sequence (from h = c = 0, n = 1e-6, m =
    -1e30) or one step from ``cache`` = {"h", "c", "n", "m"} each (B, NH,
    DH) fp32 (updated in place), then the per-head norm (its rsqrt
    repeated over each head's DH channels), ``1 + gn_scale`` in fp32, the
    cast to the model's dtype and ``w_out``.  Returns ``(y, cache)``."""
    nh = cfg.n_heads
    r = cfg.d_model
    dh = r // nh
    b, s, _ = x.shape
    xg = x.float() @ p.w_gates + p.b_gates

    if cache is None:
        zeros = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros + 1e-6, zeros - 1e30)
        hs = []
        for t in range(s):
            carry, ht = _slstm_step(p, nh, dh, carry, xg[:, t])
            hs.append(ht)
        h = torch.stack(hs, dim=1)  # (B, S, NH, DH)
    else:
        if s != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        carry = (cache["h"], cache["c"], cache["n"], cache["m"])
        new, h2 = _slstm_step(p, nh, dh, carry, xg[:, 0])
        for key, val in zip(("h", "c", "n", "m"), new):
            cache[key].copy_(val)
        h = h2[:, None]

    h = h.reshape(b, s, r)
    ms = torch.mean(torch.square(h.reshape(b, s, nh, dh)), -1, keepdim=True)
    hn = h * torch.rsqrt(ms.expand(b, s, nh, dh).reshape(b, s, r) + 1e-6)
    hn = (hn * (1.0 + p.gn_scale.float())).to(x.dtype)
    return hn @ p.w_out, cache


def init_slstm_cache(cfg: ArchConfig, batch: int, *, device) -> dict:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    z = torch.zeros((batch, nh, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z + 1e-6, "m": z - 1e30}
