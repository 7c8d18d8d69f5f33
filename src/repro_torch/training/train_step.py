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
take it.

With ``mesh`` (a DeviceMesh, ``distributed/sharding.py``) a factory runs
the sharded model: the model's parameters are DTensors placed by
``param_pspecs`` (:func:`repro_torch.distributed.sharding.distribute`),
the batch's tensors are split over the batch axes (``data_pspec``), and
a train step places AdamW's moments by ``zero_pspec`` (ZeRO-1 on the
data axis, as ``repro/launch/specs.py`` places them) before its first
update.  :func:`adamw_update` runs on those DTensors unchanged (DTensor
redistributes a moment and its gradient to a common layout where they
meet); the moments are placed back by ``zero_pspec`` after each update.
Logits come back as DTensors; the step's metrics as plain tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import lm_leaf_ranks
from repro_torch.training.optimizer import OptConfig, adamw_update

MTP_WEIGHT = 0.1
AUX_WEIGHT = 0.01


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp - gold logit`` in fp32, (B, S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`_token_ce`; DTensor logits under ``compat.shard_map`` on
    each rank's batch block with the whole vocabulary (gathered where it
    is split: DTensor's own gather of the gold column fails on a split
    vocabulary), every rank of ``model`` computing the same terms."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        return _token_ce(logits, labels)
    mesh = logits.device_mesh
    bs = attn._batch_spec(mesh, labels.shape[0])

    def body(lg, lb):
        terms = _token_ce(lg, lb)
        return (compat.invariant(terms, "model", mesh)
                if "model" in mesh.mesh_dim_names else terms)

    return compat.shard_map(body, mesh=mesh,
                            in_specs=(sh.P(bs, None, None), sh.P(bs, None)),
                            out_specs=sh.P(bs, None))(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) any dtype; labels (B, S) int.  Mean CE in fp32."""
    return torch.mean(_ce_terms(logits, labels))


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
    tot = 0.0
    for i in range(0, s, chunk):
        logits = (h[:, i:i + chunk] @ head).to(torch.float32)
        if softcap:
            logits = cm.softcap(logits, softcap)
        tot = tot + torch.sum(_ce_terms(logits, labels[:, i:i + chunk]))
    return tot / (b * s)


def place_batch(batch: dict, mesh) -> dict:
    """``batch``'s tensors (the same on every rank) split over the batch
    axes (``data_pspec``) where they divide, else replicated."""
    out = {}
    for k, v in batch.items():
        spec = sh.data_pspec(mesh, v.dim())
        n = sh._axis_size(mesh, spec[0])
        out[k] = compat.placed(v, mesh, spec if v.shape[0] % n == 0 else
                               sh.P())
    return out


def _plain(x):
    """A DTensor metric as a plain tensor (replicated: no collective)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True,
                 mlstm_chunk: Optional[int] = None,
                 ce_chunk: Optional[int] = None, mesh=None):
    """``loss_fn(model, batch) -> (loss, {"ce", "aux"})``: CE over
    ``batch["labels"]`` (chunked when ``ce_chunk``) plus ``AUX_WEIGHT``
    times the aux term, plus ``MTP_WEIGHT`` times the MTP head's CE on the
    logits path."""
    tr.check_supported(cfg)

    def loss_fn(model: tr.LM, batch: dict):
        if mesh is not None:
            batch = place_batch(batch, mesh)
        if ce_chunk:
            h, aux, extras = tr.train_fwd(model, cfg, batch, remat=remat,
                                          mlstm_chunk=mlstm_chunk,
                                          return_hidden=True, mesh=mesh)
            w = model.embed if cfg.tie_embeddings else model.lm_head
            ce = chunked_ce(h, w, batch["labels"],
                            transpose_w=cfg.tie_embeddings,
                            softcap=cfg.logit_softcap, chunk=ce_chunk)
        else:
            logits, aux, extras = tr.train_fwd(model, cfg, batch,
                                               remat=remat,
                                               mlstm_chunk=mlstm_chunk,
                                               mesh=mesh)
            ce = cross_entropy(logits, batch["labels"])
        loss = ce + AUX_WEIGHT * aux
        if "mtp_logits" in extras:
            # predict token t+2: the labels shifted left once more
            mtp_labels = torch.roll(batch["labels"], -1, 1)
            loss = loss + MTP_WEIGHT * cross_entropy(extras["mtp_logits"],
                                                     mtp_labels)
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def zero_state(opt_state: dict, model: tr.LM, mesh, cfg=None) -> dict:
    """``opt_state`` with each moment leaf placed by ``zero_pspec`` of its
    parameter's spec (a leaf shaped otherwise, an int8 state's scales,
    by the spec of its leading dims); plain leaves are the global value.
    The count stays replicated; ``cfg`` as ``param_pspecs`` takes it."""
    params = dict(model.named_parameters())
    specs = sh.param_pspecs(params, mesh, cfg)

    def place(leaf, name):
        spec = specs[name]
        if tuple(leaf.shape) != tuple(params[name].shape):
            spec = sh.P(*tuple(spec)[:leaf.dim() - 1])
        spec = sh.zero_pspec(spec, tuple(leaf.shape), mesh)
        if not sh._fits(mesh, tuple(spec) + (None,) * (leaf.dim() - len(spec)),
                        tuple(leaf.shape)):
            spec = sh.P()
        return compat.placed(leaf, mesh, spec)

    def moments(tree):
        return {n: ({k: place(v, n) for k, v in m.items()}
                    if isinstance(m, dict) else place(m, n))
                for n, m in tree.items()}

    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
            "count": compat.placed(opt_state["count"], mesh, sh.P())}


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    remat: bool = True, mlstm_chunk: Optional[int] = None,
                    ce_chunk: Optional[int] = None, accum_steps: int = 1,
                    mesh=None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss and its gradients (over ``accum_steps``
    micro-batches, the batch's rows split in order, gradients summed in
    fp32 and averaged), then one AdamW step on the model's parameters in
    place.  ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and, for one
    micro-batch, ``ce`` and ``aux``.  The step turns on ``requires_grad``
    for every parameter of the model.  With ``mesh`` the parameters are
    DTensors and the moments are placed by :func:`zero_state`."""
    loss_fn = make_loss_fn(cfg, remat=remat, mlstm_chunk=mlstm_chunk,
                           ce_chunk=ce_chunk, mesh=mesh)

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
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
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
        if mesh is not None:
            opt_state = zero_state(opt_state, model, mesh, cfg)
        _, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                        ranks=lm_leaf_ranks(params, cfg))
        if mesh is not None:
            opt_state = zero_state(opt_state, model, mesh, cfg)
        metrics = {"loss": loss, **om, **parts}
        return model, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, mlstm_chunk: Optional[int] = None,
                      mesh=None):
    """``prefill_step(model, batch) -> logits`` (no gradient), over
    ``batch["ctx"]`` when the batch has one."""
    tr.check_supported(cfg)

    @torch.no_grad()
    def prefill_step(model: tr.LM, batch: dict) -> torch.Tensor:
        if mesh is not None:
            batch = place_batch(batch, mesh)
        return tr.model_fwd(model, cfg, batch, mlstm_chunk=mlstm_chunk,
                            mesh=mesh)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, mesh=None):
    """``serve_step(model, cache, token, cache_pos, ctx=None) -> (logits,
    new_cache)``: one decode step (no gradient) over the context ``ctx``
    (re-encoded at every step for a config with an encoder, as the
    reference does), the cache updated in place."""
    tr.check_supported(cfg)

    @torch.no_grad()
    def serve_step(model: tr.LM, cache: dict, token: torch.Tensor,
                   cache_pos: int, ctx: Optional[torch.Tensor] = None):
        if mesh is not None:
            placed = place_batch({"token": token} if ctx is None else
                                 {"token": token, "ctx": ctx}, mesh)
            token, ctx = placed["token"], placed.get("ctx")
        return tr.decode_step(model, cfg, cache, token, cache_pos, ctx=ctx,
                              mesh=mesh)

    return serve_step
