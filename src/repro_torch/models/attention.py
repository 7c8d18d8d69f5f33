"""Attention (port of ``repro/models/attention.py``): GQA with qk-norm,
RoPE, the logit softcap and a KV cache, and DeepSeek's MLA.

GQA's full-sequence branch and one-token decode branch compute their
attention through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the
hand-written CUDA kernel on the card:

* full sequence: ``causal=True`` (with the layer's window, if any), or
  ``causal=False`` for a bidirectional call;
* decode at ``cache_pos``: ``causal=False, kv_len=cache_pos + 1`` over the
  whole cache — the reference's ``causal_mask(1, T, cache_pos)``;
* decode of a sliding-window layer, whose cache is a ring of ``w <=
  window`` slots: the new K/V goes to slot ``cache_pos % w``, then
  ``causal=False, kv_len=min(cache_pos + 1, w)`` over the whole ring — the
  reference's ring-buffer validity mask.

The projections stay plain matrix products, as they are plain ``jnp``
products in the reference.  Weights keep the reference's einsum layouts:
``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d).

MLA (multi-head latent attention, :func:`mla_fwd`) caches the compressed
latents ``{"c_kv", "k_rope"}`` and decodes either by expanding them into
per-head keys and values or, with ``cfg.mla.absorb``, by folding
``w_uk``/``w_uv`` into the query and the output and attending over the
latent itself.  Its attention stays plain torch, as it is plain ``jnp`` in
the reference: its query/key and value head dims differ (192 and 128
expanded, 576 and 512 absorbed), and the flash kernel takes one head dim.

Not ported, and raising :class:`NotImplementedError` on every device
(ROADMAP queue 1 says where each is lifted): cross-attention, a sharded
GQA call (head padding), a cached GQA call with more than one token, and
windowed decode over a cache longer than the window (which the
reference's own caches never are).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common as cm

NEG_INF = -2.3819763e38  # the reference's masked logit (fits fp32)


class GQA(nn.Module):
    """Grouped-query attention weights of one layer."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        g = generator
        self.wq = cm.param(cm.dense_init(g, d, (h, hd), dt, device))
        self.wk = cm.param(cm.dense_init(g, d, (kv, hd), dt, device))
        self.wv = cm.param(cm.dense_init(g, d, (kv, hd), dt, device))
        self.wo = cm.param(cm.dense_init(g, h * hd, (d,), dt, device)
                         .reshape(h, hd, d))
        if cfg.qk_norm:
            self.q_norm = cm.param(torch.zeros(hd, dtype=dt, device=device))
            self.k_norm = cm.param(torch.zeros(hd, dtype=dt, device=device))


def init_gqa(cfg: ArchConfig, generator: torch.Generator, device) -> GQA:
    return GQA(cfg, generator, device)


def init_gqa_cache(cfg: ArchConfig, batch: int, max_len: int, window=None,
                   *, device) -> dict:
    """Zero K/V cache {"k", "v"} of shape (B, max_len, KV, hd) in the
    config's dtype; a windowed layer's ring buffer holds ``window`` slots."""
    dt = cm.dtype_of(cfg)
    length = min(max_len, window) if window else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def gqa_fwd(
    p: GQA,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: Optional[int] = None,
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
    ctx: Optional[torch.Tensor] = None,
    causal: bool = True,
    mesh=None,
):
    """Full-sequence (``cache=None``) or one-token decode GQA attention.

    Returns ``(out, new_cache)``.  ``cache`` holds {"k", "v"} of shape
    (B, max_len, KV, hd) and ``cache_pos`` is the write index (an int).
    The port writes the new K/V into ``cache`` in place (the reference
    returns an updated copy) and returns the same dict."""
    if ctx is not None:
        raise NotImplementedError(
            "cross-attention is not ported: ROADMAP queue 1, item 10 "
            "(encoder and cross-attention slice)")
    if mesh is not None:
        raise NotImplementedError(
            "sharded attention (and its head padding) is not ported: "
            "ROADMAP queue 1, item 11")
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq.reshape(d, h * hd)).view(b, s, h, hd)
    k = (x @ p.wk.reshape(d, kv * hd)).view(b, s, kv, hd)
    v = (x @ p.wv.reshape(d, kv * hd)).view(b, s, kv, hd)

    if cfg.qk_norm:  # before RoPE, as the reference
        q = cm.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = cm.rms_norm(k, p.k_norm, cfg.norm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if cache is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=(window or None) if causal else None,
                              softcap=cfg.attn_softcap)
    else:
        if s != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        t = cache["k"].shape[1]
        if window and t > window:
            raise NotImplementedError(
                f"windowed decode over a cache longer than the window ({t} > "
                f"{window}) is not ported: the kernel has no query offset, "
                f"and init_gqa_cache caps a windowed layer's cache at its "
                f"window (a ring buffer)")
        if cache_pos < 0:
            raise ValueError(f"cache_pos {cache_pos} is negative")
        if window:
            # ring buffer of t <= window slots: position p lives in slot
            # p % t.  RoPE was applied at write time and softmax ignores
            # slot order, so the written slots (all inside the window) are
            # the keys
            slot, kv_len = cache_pos % t, min(cache_pos + 1, t)
        elif cache_pos < t:
            slot, kv_len = cache_pos, cache_pos + 1
        else:
            raise ValueError(f"cache_pos {cache_pos} outside a cache of {t}")
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        out = flash_attention(q.transpose(1, 2), cache["k"].transpose(1, 2),
                              cache["v"].transpose(1, 2), causal=False,
                              softcap=cfg.attn_softcap, kv_len=kv_len)
    # the kernel's (B, H, S, hd) output is a view of a (B, S, H, hd) buffer
    y = out.transpose(1, 2).reshape(b, s, h * hd) @ p.wo.reshape(h * hd, d)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA weights of one layer, in the reference's einsum layouts:
    ``w_dq`` (d, q_rank), ``q_norm`` (q_rank,), ``w_uq`` (q_rank, H,
    nope + rope), ``w_dkv`` (d, kv_rank + rope), ``kv_norm`` (kv_rank,),
    ``w_uk`` (kv_rank, H, nope), ``w_uv`` (kv_rank, H, v), ``wo`` (H, v,
    d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        m: MLAConfig = cfg.mla
        dt = cm.dtype_of(cfg)
        d, h = cfg.d_model, cfg.n_heads
        g = generator
        qk = m.qk_nope_dim + m.qk_rope_dim
        self.w_dq = cm.param(cm.dense_init(g, d, (m.q_lora_rank,), dt,
                                           device))
        self.q_norm = cm.param(torch.zeros(m.q_lora_rank, dtype=dt,
                                           device=device))
        self.w_uq = cm.param(cm.dense_init(g, m.q_lora_rank, (h, qk), dt,
                                           device))
        self.w_dkv = cm.param(cm.dense_init(
            g, d, (m.kv_lora_rank + m.qk_rope_dim,), dt, device))
        self.kv_norm = cm.param(torch.zeros(m.kv_lora_rank, dtype=dt,
                                            device=device))
        self.w_uk = cm.param(cm.dense_init(g, m.kv_lora_rank,
                                           (h, m.qk_nope_dim), dt, device))
        self.w_uv = cm.param(cm.dense_init(g, m.kv_lora_rank,
                                           (h, m.v_head_dim), dt, device))
        self.wo = cm.param(cm.dense_init(g, h * m.v_head_dim, (d,), dt,
                                         device).reshape(h, m.v_head_dim, d))


def init_mla(cfg: ArchConfig, generator: torch.Generator, device) -> MLA:
    return MLA(cfg, generator, device)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                   device) -> dict:
    """Zero latent cache {"c_kv" (B, max_len, kv_rank), "k_rope" (B,
    max_len, rope)} in the config's dtype."""
    m: MLAConfig = cfg.mla
    dt = cm.dtype_of(cfg)
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dt,
                                  device=device)}


def _mla_qkv(p: MLA, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """``(q_nope, q_rope, c_kv, k_rope)``: the query's two parts (B, S, H,
    .), RoPE on the second; the normed latent (B, S, kv_rank) and the one
    shared RoPE key (B, S, rope)."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = cm.rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps)
    q = (cq @ p.w_uq.reshape(m.q_lora_rank, -1)).view(b, s, h, -1)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = cm.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p.w_dkv
    c_kv = cm.rms_norm(ckv_full[..., :m.kv_lora_rank], p.kv_norm,
                       cfg.norm_eps)
    k_rope = cm.apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                           positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_fwd(p: MLA, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor, *, cache: Optional[dict] = None,
            cache_pos: Optional[int] = None):
    """Full-sequence (``cache=None``) or cached MLA attention; returns
    ``(out, new_cache)``.  A cached call writes its latents into ``cache``
    in place at ``cache_pos`` (the reference returns an updated copy) and
    attends over the whole cache under the causal mask of its positions.
    The scores, softmax and the value product run in fp32, scaled by
    1/√(nope + rope); absorbed, the latent output is cast to ``x``'s dtype
    before ``w_uv``, expanded, the product is cast after."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    f32 = torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.qk_nope_dim + m.qk_rope_dim), dtype=f32))
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)

    new_cache = cache
    if cache is not None:
        t = cache["c_kv"].shape[1]
        if not 0 <= cache_pos <= t - s:
            raise ValueError(f"cache_pos {cache_pos} + {s} tokens outside a "
                             f"cache of {t}")
        cache["c_kv"][:, cache_pos:cache_pos + s] = c_kv
        cache["k_rope"][:, cache_pos:cache_pos + s] = k_rope
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        mask = cm.causal_mask(s, t, cache_pos, device=x.device)
    else:
        mask = cm.causal_mask(s, s, 0, device=x.device)

    rope_scores = torch.einsum("bshk,btk->bhst", q_rope.to(f32),
                               k_rope.to(f32))
    if m.absorb:
        # fold W_uk into q, attend over the latent itself
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk)
        scores = (torch.einsum("bshr,btr->bhst", q_lat.to(f32),
                               c_kv.to(f32)) + rope_scores) * scale
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        out_lat = torch.einsum("bhst,btr->bshr", probs, c_kv.to(f32))
        out = torch.einsum("bshr,rhk->bshk", out_lat.to(x.dtype), p.w_uv)
    else:
        k_nope = torch.einsum("btr,rhk->bthk", c_kv, p.w_uk)
        vv = torch.einsum("btr,rhk->bthk", c_kv, p.w_uv)
        scores = (torch.einsum("bshk,bthk->bhst", q_nope.to(f32),
                               k_nope.to(f32)) + rope_scores) * scale
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        out = torch.einsum("bhst,bthk->bshk", probs,
                           vv.to(f32)).to(x.dtype)
    y = out.reshape(b, s, h * m.v_head_dim) @ p.wo.reshape(
        h * m.v_head_dim, -1)
    return y, new_cache
