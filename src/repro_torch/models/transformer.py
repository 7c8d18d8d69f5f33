"""LM transformer (port of ``repro/models/transformer.py``) for layers of
GQA or MLA attention (global or sliding-window), the Griffin RG-LRU block
or an xLSTM cell (mLSTM or sLSTM), with a dense, a mixture-of-experts or
no MLP, and optionally a cross-attention block over a context:
``qwen3-4b`` and the other dense configurations, the hybrid
``recurrentgemma-9b``, the recurrent ``xlstm-1.3b``, the MoE models
``deepseek-v3-671b`` (MLA, MTP head) and ``llama4-maverick-400b-a17b``,
the encoder-decoder ``whisper-medium`` (:class:`Encoder` over precomputed
frame embeddings) and ``llama-3.2-vision-11b`` (precomputed patch
embeddings through ``ctx_proj``).

The reference stacks each super-block's parameters on a leading
``n_repeats`` axis and scans over it; the port unrolls the super-blocks
into one :class:`torch.nn.ModuleList` (:func:`layer_specs` gives each
layer's spec: repeat ``r``, pattern slot ``j`` is layer
``r * len(pattern) + j``, then the remainder), and its caches into one
list.  ``mlstm_chunk`` reaches every mLSTM layer of a full-sequence
forward (its chunkwise form, ``models/recurrent.py``), as the
reference threads it.

A context reaches the decoder as the reference hands it: ``batch["ctx"]``
(or ``decode_step``'s ``ctx``) goes through the encoder first when the
config has one (:func:`encode_ctx`; a decode step re-encodes it, as the
reference does), then through ``ctx_proj`` once per call when the config
has a ``ctx_dim``; each cross layer attends over it.  A call without a
context skips the cross blocks, as the reference's does.  A context or
frames wider than the model (fp32 into bf16) promote as the reference's
einsums do (``models/common.py::promoted``): ``ctx_proj``, the cross K/V
and their attention run in fp32, the attention's output returns to the
query's dtype, and the encoder runs in fp32 over fp32 frames.

Training (``training/train_step.py``) reads the model through
:func:`train_fwd`: the logits or the final hidden states, the MoE layers'
aux term summed, and the MTP head's logits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, EncoderConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import P, param_pspecs
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import recurrent as rec


def layer_specs(cfg: ArchConfig) -> Tuple[LayerSpec, ...]:
    """The spec of every layer, in execution order."""
    return tuple(cfg.pattern) * cfg.n_repeats + tuple(cfg.remainder)


#: the mixers a layer may hold
MIXERS = ("attn", "rglru", "mlstm", "slstm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise :class:`ValueError` for a layer the port cannot build."""
    for spec in layer_specs(cfg):
        if spec.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        if spec.mlp == "moe" and cfg.moe is None:
            raise ValueError("a MoE layer needs cfg.moe")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """Pre-norm mixer (GQA or MLA attention, RG-LRU, mLSTM or sLSTM),
    cross-attention (``norm_cross`` and ``cross``, a GQA whose K/V read
    the context) when the spec has one, and MLP (dense or MoE) block; no
    ``norm_mlp`` for ``mlp="none"``."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec,
                 generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        self.norm_mix = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                             device=device))
        if spec.mixer == "rglru":
            self.rglru = rec.init_rglru(cfg, generator, device)
        elif spec.mixer == "mlstm":
            self.mlstm = rec.init_mlstm(cfg, generator, device)
        elif spec.mixer == "slstm":
            self.slstm = rec.init_slstm(cfg, generator, device)
        elif cfg.mla is not None:
            self.attn = attn.init_mla(cfg, generator, device)
        else:
            self.attn = attn.init_gqa(cfg, generator, device)
        if spec.cross_attn:
            self.norm_cross = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                                   device=device))
            self.cross = attn.init_gqa(cfg, generator, device)
        if spec.mlp in ("dense", "moe"):
            self.norm_mlp = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                                 device=device))
        if spec.mlp == "dense":
            self.mlp = mlp_mod.init_mlp(cfg, generator, device)
        elif spec.mlp == "moe":
            self.moe = mlp_mod.init_moe(cfg, generator, device)


def init_layer(cfg: ArchConfig, spec: LayerSpec, generator: torch.Generator,
               device) -> Layer:
    return Layer(cfg, spec, generator, device)


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, *, device) -> dict:
    if spec.mixer == "rglru":
        return rec.init_rglru_cache(cfg, batch, device=device)
    if spec.mixer == "mlstm":
        return rec.init_mlstm_cache(cfg, batch, device=device)
    if spec.mixer == "slstm":
        return rec.init_slstm_cache(cfg, batch, device=device)
    if cfg.mla is not None:
        return attn.init_mla_cache(cfg, batch, max_len, device=device)
    return attn.init_gqa_cache(cfg, batch, max_len, window=spec.window,
                               device=device)


def _replicated_mixer(fn, p: nn.Module, hin, cache: Optional[dict], mesh,
                      *extra):
    """``fn(p, hin, cache, *extra)`` (a mixer the reference lets GSPMD
    shard: MLA, RG-LRU, mLSTM, sLSTM) under ``compat.shard_map`` with its
    weights replicated over the mesh and the batch split over the batch
    axes: every rank of ``model`` runs the whole mixer on its batch
    block, and the output's cotangent counts once over ``model``.  The
    cache, written in place, is placed so once.  ``extra`` are tensors
    split with the batch (positions)."""
    import types

    bs = attn._batch_spec(mesh, hin.shape[0])
    names = [n for n, _ in p.named_parameters()]
    keys = sorted(cache) if cache is not None else []
    if cache is not None:
        for k in keys:
            cache[k] = compat.placed(cache[k], mesh, P(bs))

    def body(x_l, *rest):
        weights, rest = rest[:len(names)], rest[len(names):]
        c_l, extra_l = rest[:len(keys)], rest[len(keys):]
        local = types.SimpleNamespace()
        for name, w in zip(names, weights):
            *heads, leaf = name.split(".")
            node = local
            for part in heads:
                if not hasattr(node, part):
                    setattr(node, part, types.SimpleNamespace())
                node = getattr(node, part)
            setattr(node, leaf, w)
        y = fn(local, x_l, dict(zip(keys, c_l)) if keys else None, *extra_l)
        return compat.invariant(y, "model", mesh) if "model" in \
            mesh.mesh_dim_names else y

    params = [w for _, w in p.named_parameters()]
    return compat.shard_map(
        body, mesh=mesh,
        in_specs=(P(bs), *[P()] * len(names), *[P(bs)] * len(keys),
                  *[P(bs)] * len(extra)),
        out_specs=P(bs),
    )(hin, *params, *[cache[k] for k in keys], *extra)


def layer_fwd(p: Layer, cfg: ArchConfig, spec: LayerSpec, h: torch.Tensor,
              *, positions: torch.Tensor, cache: Optional[dict] = None,
              cache_pos: Optional[int] = None,
              ctx: Optional[torch.Tensor] = None, causal: bool = True,
              mlstm_chunk: Optional[int] = None, mesh=None):
    """Returns ``(h, new_cache, aux)``: ``aux`` the MoE's balance term
    (fp32), ``None`` for a layer without a MoE.  The cross block runs only
    when the layer has one and ``ctx`` is given; ``causal=False`` makes a
    full-sequence GQA call bidirectional (the encoder's); ``mlstm_chunk``
    is an mLSTM layer's chunk.  With ``mesh`` (the layer's parameters
    DTensors, ``distributed/sharding.py::distribute``) GQA and the MoE run
    their sharded paths, the dense MLP runs on DTensors as its weights
    are placed, and the other mixers run replicated over ``model``
    (:func:`_replicated_mixer`)."""
    aux = None
    hin = cm.rms_norm(h, p.norm_mix, cfg.norm_eps)
    if mesh is not None and (spec.mixer != "attn" or cfg.mla is not None):
        out = _replicated_mixer(
            lambda lp, x, c, pos: _mixer(lp, cfg, spec, x, c, pos, cache_pos,
                                         causal, mlstm_chunk),
            _mixer_module(p, cfg, spec), hin, cache, mesh, positions)
        c2 = cache
    elif spec.mixer == "rglru":
        out, c2 = rec.rglru_block_fwd(p.rglru, cfg, hin, cache=cache)
    elif spec.mixer == "mlstm":
        out, c2 = rec.mlstm_block_fwd(p.mlstm, cfg, hin, cache=cache,
                                      chunk=mlstm_chunk)
    elif spec.mixer == "slstm":
        out, c2 = rec.slstm_block_fwd(p.slstm, cfg, hin, cache=cache)
    elif cfg.mla is not None:
        out, c2 = attn.mla_fwd(p.attn, cfg, hin, positions, cache=cache,
                               cache_pos=cache_pos)
    else:
        out, c2 = attn.gqa_fwd(p.attn, cfg, hin, positions,
                               window=spec.window, cache=cache,
                               cache_pos=cache_pos, causal=causal, mesh=mesh)
    h = h + out
    if spec.cross_attn and ctx is not None:
        xin = cm.rms_norm(h, p.norm_cross, cfg.norm_eps)
        h = h + attn.gqa_fwd(p.cross, cfg, xin, positions, ctx=ctx,
                             mesh=mesh)[0]
    if spec.mlp == "dense":
        h = h + mlp_mod.mlp_fwd(p.mlp, cfg,
                                cm.rms_norm(h, p.norm_mlp, cfg.norm_eps))
    elif spec.mlp == "moe":
        out, aux = mlp_mod.moe_fwd(p.moe, cfg,
                                   cm.rms_norm(h, p.norm_mlp, cfg.norm_eps),
                                   mesh=mesh)
        h = h + out
    return h, c2, aux


def _mixer_module(p: Layer, cfg: ArchConfig, spec: LayerSpec) -> nn.Module:
    if spec.mixer in ("rglru", "mlstm", "slstm"):
        return getattr(p, spec.mixer)
    return p.attn


def _mixer(p, cfg: ArchConfig, spec: LayerSpec, x, cache, positions,
           cache_pos, causal, mlstm_chunk):
    """The output of a non-GQA mixer (its cache updated in place)."""
    if spec.mixer == "rglru":
        return rec.rglru_block_fwd(p, cfg, x, cache=cache)[0]
    if spec.mixer == "mlstm":
        return rec.mlstm_block_fwd(p, cfg, x, cache=cache,
                                   chunk=mlstm_chunk)[0]
    if spec.mixer == "slstm":
        return rec.slstm_block_fwd(p, cfg, x, cache=cache)[0]
    return attn.mla_fwd(p, cfg, x, positions, cache=cache,
                        cache_pos=cache_pos)[0]


# ---------------------------------------------------------------------------
# LM (decoder stack + embeddings)
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Embedding (over the padded vocabulary), the layers, the final norm,
    the LM head when the embeddings are not tied, ``ctx_proj`` (ctx_dim,
    d) when the config has a ``ctx_dim``, the MTP head's ``mtp_norm`` and
    ``mtp_proj`` (d, d) when the config has one, and ``encoder`` (an
    :class:`Encoder`) when it has an encoder."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        check_supported(cfg)
        dt = cm.dtype_of(cfg)
        g = generator
        self.embed = cm.param(
            cm.embed_init(g, cfg.padded_vocab, cfg.d_model, dt, device))
        self.layers = nn.ModuleList(
            init_layer(cfg, spec, g, device) for spec in layer_specs(cfg))
        self.final_norm = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                               device=device))
        if not cfg.tie_embeddings:
            self.lm_head = cm.param(
                cm.dense_init(g, cfg.d_model, (cfg.padded_vocab,), dt, device))
        if cfg.ctx_dim:
            self.ctx_proj = cm.param(
                cm.dense_init(g, cfg.ctx_dim, (cfg.d_model,), dt, device))
        if cfg.mtp:
            self.mtp_norm = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                                 device=device))
            self.mtp_proj = cm.param(
                cm.dense_init(g, cfg.d_model, (cfg.d_model,), dt, device))
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, g, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg: ArchConfig, generator: torch.Generator,
               device=None) -> LM:
    """A model with weights drawn from ``generator`` (which must live on
    ``device``) with the reference's distributions: truncated normal on ±2
    over √fan_in, embeddings N(0, 0.02²), norms zero.  The device is CUDA
    unless the caller names another."""
    return LM(cfg, generator, resolve_device(device))


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                  device) -> dict:
    """One cache per layer, under ``"layers"``: {"k", "v"} for GQA
    attention (a ring of at most ``window`` slots for a sliding-window
    layer), {"c_kv", "k_rope"} for MLA, {"h", "conv"} for an RG-LRU
    block, {"C", "n", "m", "conv"} for an mLSTM, {"h", "c", "n", "m"} for
    an sLSTM.  The layers of the repeated pattern start from zeros, as the
    reference's ``init_lm_cache`` stacks them (``jnp.zeros`` of each
    leaf's shape): an xLSTM layer's ``m`` and ``n`` start at 0 there, not
    at ``init_mlstm_cache``'s and ``init_slstm_cache``'s -1e30 and 1e-6,
    which the remainder's layers keep.  Every other cache is zeros
    either way."""
    n_body = cfg.n_repeats * len(cfg.pattern)
    layers = []
    for i, spec in enumerate(layer_specs(cfg)):
        cache = init_layer_cache(cfg, spec, batch, max_len, device=device)
        if i < n_body:
            cache = {k: torch.zeros_like(v) for k, v in cache.items()}
        layers.append(cache)
    return {"layers": layers}


def embed_scale(cfg: ArchConfig) -> torch.Tensor:
    """√d_model rounded to the model's dtype, as the reference's
    ``jnp.asarray(jnp.sqrt(d_model), dtype)``: 50.5 in bf16 at d = 2560."""
    return torch.sqrt(torch.tensor(float(cfg.d_model))).to(cm.dtype_of(cfg))


def _embed(model: LM, cfg: ArchConfig, tokens: torch.Tensor, mesh):
    """The scaled embedding rows of ``tokens``.  With ``mesh``, under
    ``compat.shard_map``: a table split over ``model`` (its rule's spec)
    is looked up on every rank's block of rows, the other ranks' tokens
    zero, and the blocks summed over ``model`` (one nonzero term: exact);
    the batch splits over the batch axes."""
    scale = float(embed_scale(cfg))  # exact as a scalar
    if mesh is None:
        return model.embed[tokens] * scale
    spec = param_pspecs({"embed": model.embed.shape}, mesh)["embed"]
    bs = attn._batch_spec(mesh, tokens.shape[0])
    split = tuple(spec)[:1] == ("model",)

    def body(emb_l, tok_l):
        if not split:
            rows = emb_l[tok_l]
            return compat.invariant(rows, "model", mesh) if "model" in \
                mesh.mesh_dim_names else rows
        n = emb_l.shape[0]
        local = tok_l - compat.axis_index(mesh, "model") * n
        hit = (local >= 0) & (local < n)
        rows = torch.where(hit[..., None], emb_l[local.clamp(0, n - 1)], 0.0)
        return compat.psum(rows.to(emb_l.dtype), "model", mesh)

    h = compat.shard_map(body, mesh=mesh, in_specs=(spec, P(bs, None)),
                         out_specs=P(bs, None, None))(model.embed, tokens)
    return h * scale


def _stack(model: LM, cfg: ArchConfig, tokens: torch.Tensor, *,
           cache: Optional[dict], cache_pos: Optional[int], remat: bool,
           ctx: Optional[torch.Tensor] = None,
           mlstm_chunk: Optional[int] = None, mesh=None):
    """The embedding and every layer, then the final norm: ``(h,
    new_cache, aux)``, ``aux`` the MoE layers' balance terms summed in
    layer order (``None`` without a MoE layer).  ``ctx`` (encoded, if the
    config has an encoder) goes through ``ctx_proj`` here, once.  With
    ``mesh`` the tensors are DTensors (a plain ``ctx`` is placed with the
    batch split over the batch axes)."""
    h = _embed(model, cfg, tokens, mesh)
    b, s = h.shape[:2]
    offset = 0 if cache is None else cache_pos
    positions = (offset + torch.arange(s, device=tokens.device)
                 )[None, :].expand(b, s)
    if ctx is not None and mesh is not None:
        ctx = compat.placed(ctx, mesh, P(attn._batch_spec(mesh, b)))
    if ctx is not None and cfg.ctx_dim:
        ctx = cm.mm(ctx, model.ctx_proj)  # fp32 over an fp32 context

    aux = None
    new_layers = []
    for i, (p, spec) in enumerate(zip(model.layers, layer_specs(cfg))):
        if remat and cache is None:
            # the aux term leaves the checkpoint beside h; ctx goes in as
            # an input, so that its gradient flows through the recompute
            h, a = checkpoint(lambda x, c, p=p, spec=spec: layer_fwd(
                p, cfg, spec, x, positions=positions, ctx=c,
                mlstm_chunk=mlstm_chunk, mesh=mesh)[0::2], h, ctx,
                use_reentrant=False)
        else:
            c_in = cache["layers"][i] if cache is not None else None
            h, c2, a = layer_fwd(p, cfg, spec, h, positions=positions,
                                 cache=c_in, cache_pos=cache_pos, ctx=ctx,
                                 mlstm_chunk=mlstm_chunk, mesh=mesh)
            new_layers.append(c2)
        if a is not None:
            aux = a if aux is None else aux + a
    new_cache = {"layers": new_layers} if cache is not None else None
    return cm.rms_norm(h, model.final_norm, cfg.norm_eps), new_cache, aux


def _logits(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    logits = h @ head
    if cfg.logit_softcap:
        logits = cm.softcap(logits.float(), cfg.logit_softcap)
    return logits


def lm_fwd(model: LM, cfg: ArchConfig, tokens: torch.Tensor, *,
           ctx: Optional[torch.Tensor] = None,
           cache: Optional[dict] = None, cache_pos: Optional[int] = None,
           remat: bool = False, mlstm_chunk: Optional[int] = None,
           return_hidden: bool = False, mesh=None):
    """Full-sequence forward (``cache=None``) or cached decode step, over
    the context ``ctx`` (already encoded) when given; ``mlstm_chunk`` for
    the mLSTM layers of a full sequence.
    Returns ``(logits over the padded vocabulary, new_cache)``; with
    ``return_hidden``, the final hidden states (after the final norm) in
    place of the logits, for the chunked loss.  With ``remat`` (full
    sequence only) each layer's activations are recomputed in the backward
    pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
    over its super-block), which changes no value.  The MTP head is not
    computed here: :func:`train_fwd` gives its logits.  With ``mesh``
    the model runs sharded (:func:`layer_fwd`) and the results are
    DTensors."""
    h, new_cache, _ = _stack(model, cfg, tokens, cache=cache,
                             cache_pos=cache_pos, remat=remat, ctx=ctx,
                             mlstm_chunk=mlstm_chunk, mesh=mesh)
    if return_hidden:
        return h, new_cache
    return _logits(model, cfg, h), new_cache


# ---------------------------------------------------------------------------
# Encoder (whisper's): a stack of bidirectional self-attention layers over
# precomputed frame embeddings (the reference's frontend is a stub too)
# ---------------------------------------------------------------------------


def encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's own config, as the reference's ``_encoder_cfg``
    builds it: one ``(attn, dense)`` pattern, as many KV heads as heads,
    ``head_dim = d_model // n_heads``, vocabulary 256, the decoder's
    ``act`` and ``dtype``; RoPE, the norms' eps, Q/K norm and the softcap
    at the defaults."""
    e: EncoderConfig = cfg.encoder
    return ArchConfig(
        name=cfg.name + "-enc",
        n_layers=e.n_layers,
        d_model=e.d_model,
        n_heads=e.n_heads,
        n_kv_heads=e.n_heads,
        head_dim=e.d_model // e.n_heads,
        d_ff=e.d_ff,
        vocab_size=256,
        pattern=(LayerSpec(mixer="attn", mlp="dense"),),
        act=cfg.act,
        dtype=cfg.dtype,
    )


class Encoder(nn.Module):
    """The encoder's layers (unrolled, as the LM's: the reference stacks
    them on a leading ``n_layers`` axis) and its final norm."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        ecfg = encoder_cfg(cfg)
        self.layers = nn.ModuleList(
            init_layer(ecfg, ecfg.pattern[0], generator, device)
            for _ in range(ecfg.n_layers))
        self.final_norm = cm.param(torch.zeros(
            ecfg.d_model, dtype=cm.dtype_of(ecfg), device=device))


def encoder_fwd(encoder: Encoder, cfg: ArchConfig, frames: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """``frames`` (B, n_frames, d_enc), precomputed frame embeddings,
    through every encoder layer (bidirectional self-attention with RoPE
    at positions ``arange(n_frames)``) and the final norm; sharded with
    ``mesh`` as :func:`layer_fwd` runs a layer."""
    ecfg = encoder_cfg(cfg)
    spec = ecfg.pattern[0]
    # the reference's scan starts from the frames: fp32 frames keep a bf16
    # encoder's carry fp32 through every layer
    h = frames.to(torch.promote_types(frames.dtype, cm.dtype_of(ecfg)))
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    if mesh is not None:
        h = compat.placed(h, mesh, P(attn._batch_spec(mesh, b)))
    for p in encoder.layers:
        h = layer_fwd(p, ecfg, spec, h, positions=positions, causal=False,
                      mesh=mesh)[0]
    return cm.rms_norm(h, encoder.final_norm, ecfg.norm_eps)


def encode_ctx(model: LM, cfg: ArchConfig, ctx: Optional[torch.Tensor],
               mesh=None) -> Optional[torch.Tensor]:
    """The context the decoder reads: ``ctx`` through the encoder when the
    config has one (the reference's ``train_step.py::_encode_ctx`` and the
    encoder call of its ``model_fwd`` and ``decode_step``), else as
    given."""
    if cfg.encoder is not None and ctx is not None:
        return encoder_fwd(model.encoder, cfg, ctx, mesh=mesh)
    return ctx


# ---------------------------------------------------------------------------
# Top-level model: forward / decode
# ---------------------------------------------------------------------------


def model_fwd(model: LM, cfg: ArchConfig, batch: dict, *,
              mlstm_chunk: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Prefill forward of ``batch["tokens"]`` over ``batch["ctx"]`` (if
    any): the logits."""
    ctx = encode_ctx(model, cfg, batch.get("ctx"), mesh)
    return lm_fwd(model, cfg, batch["tokens"], ctx=ctx,
                  mlstm_chunk=mlstm_chunk, mesh=mesh)[0]


def mtp_logits(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """The MTP head on the final hidden states ``h``: ``rms_norm`` by
    ``mtp_norm``, ``mtp_proj``, then the embedding as the head (the
    logits of the token after the next)."""
    mh = cm.rms_norm(h, model.mtp_norm, cfg.norm_eps) @ model.mtp_proj
    return mh @ model.embed.t()


def train_fwd(model: LM, cfg: ArchConfig, batch: dict, *, remat: bool = False,
              mlstm_chunk: Optional[int] = None, return_hidden: bool = False,
              mesh=None):
    """The training forward of ``batch["tokens"]`` over ``batch["ctx"]``
    (encoded by :func:`encode_ctx`), as the reference's
    ``model_fwd``/``lm_fwd`` hand it to the loss: ``(logits, or the final
    hidden states with return_hidden, aux, extras)``.  ``aux`` is the MoE
    layers' balance term, an fp32 zero without a MoE layer; ``extras``
    holds ``"mtp_logits"`` when the config has an MTP head, on the logits
    path only (the reference's chunked loss leaves MTP out)."""
    ctx = encode_ctx(model, cfg, batch.get("ctx"), mesh)
    h, _, aux = _stack(model, cfg, batch["tokens"], cache=None,
                       cache_pos=None, remat=remat, ctx=ctx,
                       mlstm_chunk=mlstm_chunk, mesh=mesh)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if mesh is not None:
            aux = compat.placed(aux, mesh, P())
    if return_hidden:
        return h, aux, {}
    extras = {"mtp_logits": mtp_logits(model, cfg, h)} if cfg.mtp else {}
    return _logits(model, cfg, h), aux, extras


def init_model_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                     device) -> dict:
    return init_lm_cache(cfg, batch, max_len, device=device)


def decode_step(model: LM, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                cache_pos: int, *, ctx: Optional[torch.Tensor] = None,
                mesh=None):
    """One-token decode over the context ``ctx`` (if any; re-encoded at
    every step when the config has an encoder, as the reference does).
    token: (B, 1) int.  Returns ``(logits, new_cache)``; the cache is
    updated in place (with ``mesh``, its tensors become DTensors placed as
    the layers read them, on the first step)."""
    ctx = encode_ctx(model, cfg, ctx, mesh)
    return lm_fwd(model, cfg, token, ctx=ctx, cache=cache,
                  cache_pos=cache_pos, mesh=mesh)
