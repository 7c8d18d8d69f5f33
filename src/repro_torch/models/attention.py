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
  reference's ring-buffer validity mask;
* cross-attention (``ctx`` given, (B, T, d_model) after the LM's
  ``ctx_proj`` or the encoder): K and V projected from ``ctx`` by the
  layer's own ``wk``/``wv``, no RoPE on Q or K, then ``causal=False`` over
  all T context rows, with no mask and no cache, in a full-sequence call
  and inside a decode step alike.

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

With a mesh (``mesh=``, a DeviceMesh whose dims are named from
``pod``/``data``/``model``), GQA runs sharded: each rank of the ``model``
dim projects, attends over and writes back its own block of query heads
(``wq`` and ``wo`` redistributed to the head dim, the reference's head
constraint), and the partial outputs are summed over ``model``
(``distributed/compat.py``).  K and V are sharded on their heads when
``n_kv_heads`` divides over ``model`` (each rank's query heads then read
its own KV heads), else replicated over it, as the reference replicates
them under head padding; a rank reads the KV heads its query heads map
to.  When ``model`` does not divide ``n_heads`` and the config asks for
``attn_head_padding``, the query heads are zero-padded inside each KV
group (:func:`pad_heads_grouped`) to the reference's ``pad_to``; without
padding such a call runs every head on every rank of ``model``.  The
flash kernel sees each rank's local tensors only (under
``compat.shard_map``), and a cache is written on each rank's block.

MLA takes no mesh, as in the reference.

Not ported, and raising :class:`NotImplementedError` on every device
(ROADMAP queue 1 says where each is lifted): a cached GQA call with more
than one token, and windowed decode over a cache longer than the window
(which the reference's own caches never are).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import P, batch_axes, mesh_shape
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


def pad_heads_grouped(wq: torch.Tensor, wo: torch.Tensor, n_kv: int,
                      pad_to: int):
    """Zero-pad the query heads inside each KV group, so that the (kv,
    group) layout of the real heads is unchanged: each group of g real
    heads becomes ``pad_to / n_kv`` heads whose extra rows are zero in
    ``wq`` (uniform attention) and zero in ``wo`` (no contribution)."""
    d, h, hd = wq.shape
    group = h // n_kv
    pad = pad_to // n_kv - group
    wq_p = F.pad(wq.reshape(d, n_kv, group, hd),
                 (0, 0, 0, pad)).reshape(d, pad_to, hd)
    wo_p = F.pad(wo.reshape(n_kv, group, hd, -1),
                 (0, 0, 0, 0, 0, pad)).reshape(pad_to, hd, -1)
    return wq_p, wo_p


def head_padding(cfg: ArchConfig, mesh) -> Optional[int]:
    """The padded head count (the reference's ``pad_to``: the smallest
    count >= n_heads divisible by the model dim and by ``n_kv_heads``)
    when ``cfg.attn_head_padding`` is set and the mesh's ``model`` dim
    does not divide ``n_heads``; else None."""
    tp = mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    if not cfg.attn_head_padding or cfg.n_heads % tp == 0:
        return None
    pad_to = tp * (-(-cfg.n_heads // tp))
    while pad_to % cfg.n_kv_heads or pad_to % tp:
        pad_to += 1
    return pad_to


def _batch_spec(mesh, b: int):
    """The batch axes when they divide ``b``, else None (replicated)."""
    ba = batch_axes(mesh)
    n = 1
    for a in ba:
        n *= mesh_shape(mesh)[a]
    return ba if ba and b % n == 0 else None


def kv_spec(cfg: ArchConfig, mesh, batch: int) -> P:
    """The placement of a K/V tensor or cache (B, T, KV, hd) that sharded
    GQA attends over: the batch on the batch axes, the KV heads on
    ``model`` when they divide over it (and no head padding), else
    replicated over ``model``."""
    tp = mesh_shape(mesh).get("model", 1)
    shard = (tp > 1 and head_padding(cfg, mesh) is None
             and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0)
    return P(_batch_spec(mesh, batch), None, "model" if shard else None,
             None)


def _local_kv_heads(k: torch.Tensor, heads) -> torch.Tensor:
    """The KV heads (B, T, ., hd) that query heads ``lo .. lo+hl`` read
    out of all of ``k`` (replicated over the model dim), ``heads = (lo,
    hl, group)``: a run of whole groups, the one KV head all the local
    heads share, or else one KV head per query head."""
    lo, hl, group = heads
    first, last = lo // group, (lo + hl - 1) // group
    if (lo % group == 0 and hl % group == 0) or first == last:
        return k[:, :, first:last + 1]
    idx = (lo + torch.arange(hl, device=k.device)) // group
    return k.index_select(2, idx)


def _attend(cfg: ArchConfig, q, k, v, *, window, cache, cache_pos, cross,
            causal, heads=None):
    """The attention of projected ``q`` (B, S, H, hd) over ``k``/``v``
    (B, T, KV, hd) or, cached, over ``cache`` after writing ``k``/``v``
    at ``cache_pos``: (B, H, S, hd) in ``q``'s dtype.  ``heads`` (lo, hl,
    group): ``q`` holds query heads ``lo .. lo+hl`` of a model whose
    query groups are ``group`` wide, over all its KV heads
    (:func:`_local_kv_heads`)."""
    s, dt = q.shape[1], q.dtype
    kv_len = None
    if cross:
        # every context row, no mask, no cache; an fp32 context raises a
        # bf16 query to fp32 (the reference's promotion) and the output
        # returns to the query's dtype
        q, k, v = cm.promoted(q, k, v)
    elif cache is not None:
        if s != 1:
            raise NotImplementedError(
                "a cached call with more than one token is not ported: "
                "ROADMAP queue 1, item 10 (chunked prefill)")
        t = cache["k"].shape[1]
        if window and t > window:
            raise NotImplementedError(
                f"windowed decode over a cache longer than the window ({t} "
                f"> {window}) is not ported: the kernel has no query "
                f"offset, and init_gqa_cache caps a windowed layer's cache "
                f"at its window (a ring buffer)")
        if cache_pos < 0:
            raise ValueError(f"cache_pos {cache_pos} is negative")
        if window:
            # ring buffer of t <= window slots: position p lives in slot
            # p % t.  RoPE was applied at write time and softmax ignores
            # slot order, so the written slots (all inside the window)
            # are the keys
            slot, kv_len = cache_pos % t, min(cache_pos + 1, t)
        elif cache_pos < t:
            slot, kv_len = cache_pos, cache_pos + 1
        else:
            raise ValueError(f"cache_pos {cache_pos} outside a cache of {t}")
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        k, v = cache["k"], cache["v"]
    if heads is not None:
        k, v = _local_kv_heads(k, heads), _local_kv_heads(v, heads)
    if cross or cache is not None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False,
                              softcap=cfg.attn_softcap, kv_len=kv_len)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=(window or None) if causal else None,
                              softcap=cfg.attn_softcap)
    return out.to(dt) if cross else out


def _project(cfg: ArchConfig, x, src, wq, wk, wv, q_norm, k_norm,
             positions, cross: bool):
    """Q (B, S, H, hd) of ``x``, K and V (B, T, KV, hd) of ``src``, the
    Q/K norms (before RoPE, as the reference) and RoPE unless ``cross``;
    ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd)."""
    b, s, d = x.shape
    t = src.shape[1]
    h, kv, hd = wq.shape[1], wk.shape[1], wq.shape[2]
    q = cm.mm(x, wq.reshape(d, h * hd)).view(b, s, h, hd)
    k = cm.mm(src, wk.reshape(d, kv * hd)).view(b, t, kv, hd)
    v = cm.mm(src, wv.reshape(d, kv * hd)).view(b, t, kv, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, q_norm, cfg.norm_eps)
        k = cm.rms_norm(k, k_norm, cfg.norm_eps)
    if not cross:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    """Full-sequence (``cache=None``) or one-token decode GQA attention,
    or cross-attention over ``ctx`` (B, T, d_model).

    Returns ``(out, new_cache)``.  ``cache`` holds {"k", "v"} of shape
    (B, max_len, KV, hd) and ``cache_pos`` is the write index (an int).
    The port writes the new K/V into ``cache`` in place (the reference
    returns an updated copy) and returns the same dict.  A cross call
    takes K and V from ``ctx``, skips RoPE, attends over every context
    row and leaves ``cache`` alone (the reference passes none).  With
    ``mesh`` the sharded path (module docstring); its output is a
    DTensor, and the cache's tensors become DTensors placed by
    :func:`kv_spec`."""
    if mesh is not None:
        return _gqa_sharded(p, cfg, x, positions, window=window, cache=cache,
                            cache_pos=cache_pos, ctx=ctx, causal=causal,
                            mesh=mesh)
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    cross = ctx is not None
    q, k, v = _project(cfg, x, x if ctx is None else ctx, p.wq, p.wk, p.wv,
                       getattr(p, "q_norm", None), getattr(p, "k_norm", None),
                       positions, cross)
    out = _attend(cfg, q, k, v, window=window,
                  cache=None if cross else cache, cache_pos=cache_pos,
                  cross=cross, causal=causal)
    # the kernel's (B, H, S, hd) output is a view of a (B, S, H, hd) buffer
    y = cm.mm(out.transpose(1, 2).reshape(b, s, h * hd),
              p.wo.reshape(h * hd, d))
    return y, cache


def _gqa_sharded(p: GQA, cfg: ArchConfig, x, positions, *, window, cache,
                 cache_pos, ctx, causal, mesh):
    """GQA under ``compat.shard_map`` (the module docstring's layout)."""
    b, s, d = x.shape
    tp = mesh_shape(mesh).get("model", 1)
    pad_to = head_padding(cfg, mesh)
    hp = pad_to or cfg.n_heads
    heads = tp > 1 and hp % tp == 0  # each rank its own query heads
    cross = ctx is not None
    bs = _batch_spec(mesh, b)
    kvs = kv_spec(cfg, mesh, b)
    kv_sharded = kvs[2] == "model"
    wq, wo = p.wq, p.wo
    if pad_to is not None:
        # padded on the whole weights (gathered if sharded), then split
        wq, wo = pad_heads_grouped(compat.replicated(wq, mesh),
                                   compat.replicated(wo, mesh),
                                   cfg.n_kv_heads, pad_to)
    cached = cache is not None and not cross
    if cached:
        # written in place on each rank's block: placed as read, once
        for name in ("k", "v"):
            cache[name] = compat.placed(cache[name], mesh, kvs)
    mh = "model" if heads else None
    mk = "model" if kv_sharded else None
    none = x.new_zeros(0)
    norms = (p.q_norm, p.k_norm) if cfg.qk_norm else (none, none)
    kc = (cache["k"], cache["v"]) if cached else (none, none)
    kc_spec = kvs if cached else P()

    def body(x_l, src_l, wq_l, wk_l, wv_l, wo_l, qn, kn, pos_l, ck, cv):
        q, k, v = _project(cfg, x_l, src_l, wq_l, wk_l, wv_l, qn, kn, pos_l,
                           cross)
        hl = q.shape[2]
        local = None
        if heads and not kv_sharded:  # all KV heads here: read its own
            local = (compat.axis_index(mesh, "model") * hl, hl,
                     hp // cfg.n_kv_heads)
        out = _attend(cfg, q, k, v, window=window,
                      cache={"k": ck, "v": cv} if cached else None,
                      cache_pos=cache_pos, cross=cross, causal=causal,
                      heads=local)
        y = cm.mm(out.transpose(1, 2).reshape(x_l.shape[0], s,
                                              hl * cfg.head_dim),
                  wo_l.reshape(hl * cfg.head_dim, d))
        if heads:
            return compat.psum(y, "model", mesh)
        # each rank of `model` computed all of it: its cotangent counts once
        return compat.invariant(y, "model", mesh)

    y = compat.shard_map(
        body, mesh=mesh,
        in_specs=(P(bs, None, None), P(bs, None, None), P(None, mh, None),
                  P(None, mk, None), P(None, mk, None), P(mh, None, None),
                  P(), P(), P(bs, None), kc_spec, kc_spec),
        out_specs=P(bs, None, None),
    )(x, x if ctx is None else ctx, wq, p.wk, p.wv, wo, *norms, positions,
      *kc)
    return y, cache


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
