"""LM transformer (port of ``repro/models/transformer.py``) for layers of
GQA attention (global or sliding-window) or the Griffin RG-LRU block, with
a dense or no MLP: ``qwen3-4b`` and the other dense configurations, and
the hybrid ``recurrentgemma-9b``.

The reference stacks each super-block's parameters on a leading
``n_repeats`` axis and scans over it; the port unrolls the super-blocks
into one :class:`torch.nn.ModuleList` (:func:`layer_specs` gives each
layer's spec: repeat ``r``, pattern slot ``j`` is layer
``r * len(pattern) + j``, then the remainder), and its caches into one
list.  The xLSTM mixers, the MoE, MLA, cross-attention, encoders and the
MTP head raise :class:`NotImplementedError` naming the ROADMAP slice that
brings them.

Training (``training/train_step.py``) reads the model through
:func:`train_fwd`: the logits or the final hidden states, and the aux
term.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import recurrent as rec


def layer_specs(cfg: ArchConfig) -> Tuple[LayerSpec, ...]:
    """The spec of every layer, in execution order."""
    return tuple(cfg.pattern) * cfg.n_repeats + tuple(cfg.remainder)


def check_supported(cfg: ArchConfig) -> None:
    """Raise :class:`NotImplementedError` for what the port cannot run yet."""
    for spec in layer_specs(cfg):
        if spec.mixer in ("mlstm", "slstm"):
            raise NotImplementedError(
                f"mixer {spec.mixer!r} is not ported: ROADMAP queue 1, item "
                f"10 (xLSTM slice)")
        if spec.mixer not in ("attn", "rglru"):
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        if spec.mlp == "moe":
            raise NotImplementedError(
                "the MoE MLP is not ported: ROADMAP queue 1, item 10 "
                "(MoE/MLA slice)")
        if spec.cross_attn:
            raise NotImplementedError(
                "cross-attention is not ported: ROADMAP queue 1, item 10 "
                "(encoder and cross-attention slice)")
    if cfg.mla is not None:
        raise NotImplementedError(
            "MLA is not ported: ROADMAP queue 1, item 10 (MoE/MLA slice)")
    if cfg.encoder is not None or cfg.ctx_dim:
        raise NotImplementedError(
            "encoders and context projections are not ported: ROADMAP "
            "queue 1, item 10 (encoder and cross-attention slice)")
    if cfg.mtp:
        raise NotImplementedError(
            "the MTP head is not ported: ROADMAP queue 1, item 10 "
            "(MoE/MLA slice)")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """Pre-norm mixer (attention or RG-LRU) and dense MLP block."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec,
                 generator: torch.Generator, device):
        super().__init__()
        dt = cm.dtype_of(cfg)
        self.norm_mix = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                             device=device))
        if spec.mixer == "rglru":
            self.rglru = rec.init_rglru(cfg, generator, device)
        else:
            self.attn = attn.init_gqa(cfg, generator, device)
        if spec.mlp == "dense":
            self.norm_mlp = cm.param(torch.zeros(cfg.d_model, dtype=dt,
                                                 device=device))
            self.mlp = mlp_mod.init_mlp(cfg, generator, device)


def init_layer(cfg: ArchConfig, spec: LayerSpec, generator: torch.Generator,
               device) -> Layer:
    return Layer(cfg, spec, generator, device)


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, *, device) -> dict:
    if spec.mixer == "rglru":
        return rec.init_rglru_cache(cfg, batch, device=device)
    return attn.init_gqa_cache(cfg, batch, max_len, window=spec.window,
                               device=device)


def layer_fwd(p: Layer, cfg: ArchConfig, spec: LayerSpec, h: torch.Tensor,
              *, positions: torch.Tensor, cache: Optional[dict] = None,
              cache_pos: Optional[int] = None):
    """Returns ``(h, new_cache)``."""
    hin = cm.rms_norm(h, p.norm_mix, cfg.norm_eps)
    if spec.mixer == "rglru":
        out, c2 = rec.rglru_block_fwd(p.rglru, cfg, hin, cache=cache)
    else:
        out, c2 = attn.gqa_fwd(p.attn, cfg, hin, positions,
                               window=spec.window, cache=cache,
                               cache_pos=cache_pos)
    h = h + out
    if spec.mlp == "dense":
        h = h + mlp_mod.mlp_fwd(p.mlp, cfg,
                                cm.rms_norm(h, p.norm_mlp, cfg.norm_eps))
    return h, c2


# ---------------------------------------------------------------------------
# LM (decoder stack + embeddings)
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Embedding (over the padded vocabulary), the layers, the final norm
    and, when the embeddings are not tied, the LM head."""

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
    """One cache per layer, under ``"layers"``: {"k", "v"} for attention
    (a ring of at most ``window`` slots for a sliding-window layer), {"h", "conv"}
    for an RG-LRU block."""
    return {"layers": [init_layer_cache(cfg, spec, batch, max_len,
                                        device=device)
                       for spec in layer_specs(cfg)]}


def embed_scale(cfg: ArchConfig) -> torch.Tensor:
    """√d_model rounded to the model's dtype, as the reference's
    ``jnp.asarray(jnp.sqrt(d_model), dtype)``: 50.5 in bf16 at d = 2560."""
    return torch.sqrt(torch.tensor(float(cfg.d_model))).to(cm.dtype_of(cfg))


def lm_fwd(model: LM, cfg: ArchConfig, tokens: torch.Tensor, *,
           cache: Optional[dict] = None, cache_pos: Optional[int] = None,
           remat: bool = False, return_hidden: bool = False):
    """Full-sequence forward (``cache=None``) or cached decode step.
    Returns ``(logits over the padded vocabulary, new_cache)``; with
    ``return_hidden``, the final hidden states (after the final norm) in
    place of the logits, for the chunked loss.  With ``remat`` (full
    sequence only) each layer's activations are recomputed in the backward
    pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
    over its super-block), which changes no value."""
    h = model.embed[tokens] * float(embed_scale(cfg))  # exact as a scalar
    b, s = h.shape[:2]
    offset = 0 if cache is None else cache_pos
    positions = (offset + torch.arange(s, device=h.device))[None, :].expand(b, s)

    new_layers = []
    for i, (p, spec) in enumerate(zip(model.layers, layer_specs(cfg))):
        if remat and cache is None:
            h = checkpoint(lambda x, p=p, spec=spec: layer_fwd(
                p, cfg, spec, x, positions=positions)[0], h,
                use_reentrant=False)
            continue
        c_in = cache["layers"][i] if cache is not None else None
        h, c2 = layer_fwd(p, cfg, spec, h, positions=positions, cache=c_in,
                          cache_pos=cache_pos)
        new_layers.append(c2)
    new_cache = {"layers": new_layers} if cache is not None else None

    h = cm.rms_norm(h, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return h, new_cache
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    logits = h @ head
    if cfg.logit_softcap:
        logits = cm.softcap(logits.float(), cfg.logit_softcap)
    return logits, new_cache


# ---------------------------------------------------------------------------
# Top-level model: forward / decode
# ---------------------------------------------------------------------------


def model_fwd(model: LM, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Prefill forward of ``batch["tokens"]``: the logits."""
    return lm_fwd(model, cfg, batch["tokens"])[0]


def train_fwd(model: LM, cfg: ArchConfig, batch: dict, *, remat: bool = False,
              return_hidden: bool = False):
    """The training forward of ``batch["tokens"]``, as the reference's
    ``model_fwd``/``lm_fwd`` hand it to the loss: ``(logits, or the final
    hidden states with return_hidden, aux)``.  ``aux`` is the MoE's
    balance term, an fp32 zero for every configuration the port runs
    (:func:`check_supported` refuses the MoE)."""
    out, _ = lm_fwd(model, cfg, batch["tokens"], remat=remat,
                    return_hidden=return_hidden)
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


def init_model_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                     device) -> dict:
    return init_lm_cache(cfg, batch, max_len, device=device)


def decode_step(model: LM, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                cache_pos: int):
    """One-token decode.  token: (B, 1) int.  Returns ``(logits,
    new_cache)``; the cache is updated in place."""
    return lm_fwd(model, cfg, token, cache=cache, cache_pos=cache_pos)
