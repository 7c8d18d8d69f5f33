"""GQA attention (port of ``repro/models/attention.py``'s GQA half) with
qk-norm, RoPE, the logit softcap and a KV cache.  Both the full-sequence
branch and the one-token decode branch compute their attention through
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

Not ported, and raising :class:`NotImplementedError` on every device
(ROADMAP queue 1 says where each is lifted): cross-attention, MLA, a
sharded call (head padding), a cached call with more than one token,
and windowed decode over a cache longer than the window (which the
reference's own caches never are).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common as cm


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
