"""Losses and the train, prefill and serve step factories of the LM (port
of ``repro/training/train_step.py``).

``cross_entropy`` takes the full (B, S, V) logits; ``chunked_ce`` walks
the sequence in chunks against the embedding (or head) matrix, as the
reference's ``scan``.  Both run over the padded vocabulary's logits, as
the reference takes them.  A train step computes the loss and its
gradients under autograd (the LM's attention and RG-LRU scan through
their kernels' ``autograd.Function``), sums micro-batch gradients in fp32
when ``accum_steps`` > 1, and applies :func:`adamw_update` to the model's
parameters in place.  The loss adds ``AUX_WEIGHT`` times the MoE's balance
term and, for a config with an MTP head, ``MTP_WEIGHT`` times its cross
entropy against the labels shifted left once more (wrapping around, as
``jnp.roll``); the chunked loss leaves MTP out, as the reference's does.

A batch may carry a context, ``batch["ctx"]``: precomputed frame
embeddings for a config with an encoder (``whisper-medium``), which the
forward encodes first on both loss paths (the reference's
``_encode_ctx``, here ``models/transformer.py::encode_ctx``), or patch
embeddings for a config with a ``ctx_dim`` (``llama-3.2-vision-11b``).
The cross layers, the encoder and ``ctx_proj`` get their gradients
through the flash kernel's ``autograd.Function`` like every attention
layer.  ``mlstm_chunk`` runs an xLSTM model's mLSTM layers in their
chunkwise form (``models/recurrent.py``), as the reference's factories
take it.  The factories take no mesh (ROADMAP queue 1, item 11(c)).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import lm_leaf_ranks
from repro_torch.training.optimizer import OptConfig, adamw_update

MTP_WEIGHT = 0.1
AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) any dtype; labels (B, S) int.  Mean CE in fp32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def chunked_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
               transpose_w: bool, softcap: Optional[float],
               chunk: int) -> torch.Tensor:
    """CE without materializing (B, S, V): a loop over S-chunks.

    h: (B, S, D); w: (V, D) if ``transpose_w`` (tied embedding) else
    (D, V).  S must be a multiple of ``chunk``."""
    b, s, _ = h.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of ce chunk {chunk}")
    head = w.t() if transpose_w else w
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        logits = (h[:, i:i + chunk] @ head).to(torch.float32)
        if softcap:
            logits = cm.softcap(logits, softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, i:i + chunk, None].long())[..., 0]
        tot = tot + torch.sum(lse - gold)
    return tot / (b * s)


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True,
                 mlstm_chunk: Optional[int] = None,
                 ce_chunk: Optional[int] = None):
    """``loss_fn(model, batch) -> (loss, {"ce", "aux"})``: CE over
    ``batch["labels"]`` (chunked when ``ce_chunk``) plus ``AUX_WEIGHT``
    times the aux term, plus ``MTP_WEIGHT`` times the MTP head's CE on the
    logits path."""
    tr.check_supported(cfg)

    def loss_fn(model: tr.LM, batch: dict):
        if ce_chunk:
            h, aux, extras = tr.train_fwd(model, cfg, batch, remat=remat,
                                          mlstm_chunk=mlstm_chunk,
                                          return_hidden=True)
            w = model.embed if cfg.tie_embeddings else model.lm_head
            ce = chunked_ce(h, w, batch["labels"],
                            transpose_w=cfg.tie_embeddings,
                            softcap=cfg.logit_softcap, chunk=ce_chunk)
        else:
            logits, aux, extras = tr.train_fwd(model, cfg, batch,
                                               remat=remat,
                                               mlstm_chunk=mlstm_chunk)
            ce = cross_entropy(logits, batch["labels"])
        loss = ce + AUX_WEIGHT * aux
        if "mtp_logits" in extras:
            # predict token t+2: the labels shifted left once more
            mtp_labels = torch.roll(batch["labels"], -1, 1)
            loss = loss + MTP_WEIGHT * cross_entropy(extras["mtp_logits"],
                                                     mtp_labels)
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    remat: bool = True, mlstm_chunk: Optional[int] = None,
                    ce_chunk: Optional[int] = None, accum_steps: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss and its gradients (over ``accum_steps``
    micro-batches, the batch's rows split in order, gradients summed in
    fp32 and averaged), then one AdamW step on the model's parameters in
    place.  ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and, for one
    micro-batch, ``ce`` and ``aux``.  The step turns on ``requires_grad``
    for every parameter of the model."""
    loss_fn = make_loss_fn(cfg, remat=remat, mlstm_chunk=mlstm_chunk,
                           ce_chunk=ce_chunk)

    def grads_of(model, params, batch):
        loss, parts = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return loss.detach(), parts, dict(zip(params, grads))

    def train_step(model: tr.LM, opt_state: dict, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if accum_steps == 1:
            loss, parts, grads = grads_of(model, params, batch)
            parts = {k: v.detach() for k, v in parts.items()}
        else:
            def split(x):
                return x.reshape((accum_steps, x.shape[0] // accum_steps)
                                 + x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(accum_steps):
                l, _, g = grads_of(model, params,
                                   {k: v[i] for k, v in micro.items()})
                for n, gi in g.items():
                    if gi is not None:
                        grads[n] = grads[n] + gi
                loss = loss + l
            grads = {n: g / accum_steps for n, g in grads.items()}
            loss = loss / accum_steps
            parts = {}
        _, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                        ranks=lm_leaf_ranks(params, cfg))
        return model, opt_state, {"loss": loss, **om, **parts}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, mlstm_chunk: Optional[int] = None):
    """``prefill_step(model, batch) -> logits`` (no gradient), over
    ``batch["ctx"]`` when the batch has one."""
    tr.check_supported(cfg)

    @torch.no_grad()
    def prefill_step(model: tr.LM, batch: dict) -> torch.Tensor:
        return tr.model_fwd(model, cfg, batch, mlstm_chunk=mlstm_chunk)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``serve_step(model, cache, token, cache_pos, ctx=None) -> (logits,
    new_cache)``: one decode step (no gradient) over the context ``ctx``
    (re-encoded at every step for a config with an encoder, as the
    reference does), the cache updated in place."""
    tr.check_supported(cfg)

    @torch.no_grad()
    def serve_step(model: tr.LM, cache: dict, token: torch.Tensor,
                   cache_pos: int, ctx: Optional[torch.Tensor] = None):
        return tr.decode_step(model, cfg, cache, token, cache_pos, ctx=ctx)

    return serve_step
