"""Prefix relay for LM serving (port of ``repro/serving/lm_relay.py``).

The large model decodes the first ``s`` tokens, then a small model of the
same token space re-prefills the shared prefix and continues: tokens play
the role of the diffusion relay's shared latent.  :func:`lm_program` plans
the relay over the *token ladder* in the relay-program IR,
:func:`execute_lm_program` compiles the plan (``compile_plan``) and folds
the sequence through its canonical node order, and :func:`relay_decode`
is the two-segment case.  Attention runs through the flash-attention
kernel on the card (``models/attention.py``), and a RecurrentGemma
model's scoring forward through the RG-LRU scan kernel
(``models/recurrent.py``); the decode loop carries every layer's cache,
K/V rings and recurrent states alike, unchanged.

:func:`execute_lm_program` and :func:`relay_decode` take a
:class:`~repro_torch.serving.obs.tracer.SpanTracer`: per-node spans on a
logical clock of one second per token, as the reference records them.
The tracer touches no tensor and launches nothing.

Entry points run on CUDA unless the caller passes ``device="cpu"``; the
models must live on that device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.program import (SEGMENT_NODE, Handoff, RelayProgram,
                                      RelaySegment, as_graph, compile_plan)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr

#: replica pools of the LM relay roles (simulation bookkeeping only)
LM_POOLS = {"large": "lm-large", "small": "lm-small"}


def _tokens(x, device: torch.device) -> torch.Tensor:
    """A token array (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


def _on(model: tr.LM, device: torch.device) -> None:
    if model.device.type != device.type:
        raise ValueError(f"the model lives on {model.device}, the call runs "
                         f"on {device}")


@torch.no_grad()
def greedy_decode(
    model: tr.LM,
    cfg: ArchConfig,
    prompt,  # (B, P) ints
    n_tokens: int,
    *,
    device=None,
) -> torch.Tensor:
    """Prefill the prompt token by token (as the reference does), then
    decode ``n_tokens`` greedily; returns (B, P + n) in the prompt's dtype."""
    dev = resolve_device(device)
    _on(model, dev)
    prompt = _tokens(prompt, dev)
    b, p = prompt.shape
    cache = tr.init_model_cache(cfg, b, p + n_tokens, device=dev)
    logits = None
    for t in range(p):
        logits, cache = tr.decode_step(model, cfg, cache, prompt[:, t:t + 1], t)
    seq = prompt
    for i in range(n_tokens):
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        seq = torch.cat([seq, nxt.to(prompt.dtype)], dim=1)
        logits, cache = tr.decode_step(model, cfg, cache, nxt, p + i)
    return seq


def lm_program(s: int, total_tokens: int, *,
               family: str = "LM",
               pools: Dict[str, str] = LM_POOLS) -> RelayProgram:
    """The LM prefix relay as a relay program over the token ladder: the
    large model decodes tokens [0, s), the small one [s, total); the
    handoff is the token index (``sigma_out == sigma_in``, an exact
    handoff) and the wire ships the prefix uncompressed.  ``s ==
    total_tokens`` is the one-segment large-only program."""
    if not 0 < s <= total_tokens:
        raise ValueError(f"need 0 < s <= total, got s={s}, total={total_tokens}")
    segments = [RelaySegment("large", pools["large"], 0, s)]
    handoffs = []
    if s < total_tokens:
        segments.append(RelaySegment("small", pools["small"], s, total_tokens))
        handoffs.append(Handoff(sigma_out=float(s), sigma_in=float(s)))
    return RelayProgram(family, tuple(segments), tuple(handoffs))


def execute_lm_program(
    program,
    models: Dict[str, tr.LM],
    cfgs: Dict[str, ArchConfig],
    prompt,
    *,
    tracer=None,
    rid: int = 0,
    device=None,
) -> Tuple[torch.Tensor, dict]:
    """Compile the plan (a :class:`RelayProgram` or a chain
    :class:`~repro_torch.core.program.RelayGraph`) and fold the token
    sequence through its canonical node order: each segment node greedily
    decodes its token slice with its role's model (re-prefilling the
    shared prefix), each handoff edge ships the prefix at 4 bytes a token.

    ``tracer`` gets request ``rid``'s queue/segment/hop spans on a logical
    clock of one second per token; hops are zero-length and carry the
    prefix's bytes, so the spans tile the request exactly.  Returns
    ``(sequence, info)`` with per-node token counts and the total handoff
    bytes."""
    plan = compile_plan(as_graph(program))
    if any(n.kind != SEGMENT_NODE for n in plan.nodes):
        raise ValueError("LM relay plans are segment chains — merge/select "
                         "joins have no token-space semantics")
    vocab = {cfgs[n.segment.model].vocab_size for n in plan.nodes}
    if len(vocab) != 1:
        raise ValueError(f"shared token space required, got vocabs {vocab}")
    dev = resolve_device(device)
    if tracer is not None:
        tracer.start_request(rid, 0.0, -1, f"lm:{plan.graph.family}")
    seq = _tokens(prompt, dev)
    t = 0.0
    node_tokens: Dict[str, int] = {}
    transfer_bytes = 0
    for ni, node in enumerate(plan.nodes):
        seg = node.segment
        if tracer is not None:
            tracer.enqueue(rid, node.nid, t)
            tracer.start_segment(rid, node.nid, t, seg.pool, role=seg.model,
                                 seg_idx=ni)
        seq = greedy_decode(models[seg.model], cfgs[seg.model], seq,
                            seg.steps, device=dev)
        t += float(seg.steps)
        node_tokens[node.nid] = seg.steps
        if tracer is not None:
            tracer.end_segment(rid, t, name=node.nid, tokens=seg.steps)
        for e in plan.succs[node.nid]:
            if e.handoff is None:
                continue
            # 4 bytes a token, as the reference counts, whatever the token
            # tensor's dtype
            nbytes = int(seq.shape[0] * seq.shape[1] * 4)
            transfer_bytes += nbytes
            if tracer is not None:
                tracer.hop(rid, f":{node.nid}->{e.dst}", t, t, nbytes,
                           compressed=e.handoff.compress, pool=seg.pool)
    if tracer is not None:
        tracer.end_request(rid, t)
    info = {
        "node_tokens": node_tokens,
        "total_tokens": sum(node_tokens.values()),
        "transfer_bytes": transfer_bytes,
        "shape_key": program.shape_key(),
    }
    return seq, info


def relay_decode(
    large: tr.LM,
    large_cfg: ArchConfig,
    small: tr.LM,
    small_cfg: ArchConfig,
    prompt,
    s: int,
    total_tokens: int,
    *,
    tracer=None,
    rid: int = 0,
    device=None,
) -> Tuple[torch.Tensor, dict]:
    """The large model decodes the first ``s`` tokens; the small model
    re-prefills the shared prefix and finishes.  Returns (sequence, info),
    planned and run through :func:`lm_program` → :func:`execute_lm_program`
    (``tracer`` and ``rid`` pass through)."""
    if large_cfg.vocab_size != small_cfg.vocab_size:
        raise ValueError("relay models need a shared token space")
    seq, run_info = execute_lm_program(
        lm_program(s, total_tokens),
        {"large": large, "small": small},
        {"large": large_cfg, "small": small_cfg},
        prompt, tracer=tracer, rid=rid, device=device,
    )
    info = {
        "edge_tokens": s,
        "device_tokens": total_tokens - s,
        "transfer_bytes": int(prompt.shape[0] * (prompt.shape[1] + s) * 4),
        **run_info,
    }
    return seq, info


@torch.no_grad()
def sequence_logprob(model: tr.LM, cfg: ArchConfig, seq, *,
                     device=None) -> float:
    """Mean log-prob of seq[1:] under the model — quality proxy for relay."""
    dev = resolve_device(device)
    _on(model, dev)
    seq = _tokens(seq, dev).long()
    logits = tr.model_fwd(model, cfg, {"tokens": seq})
    logp = torch.log_softmax(logits[:, :-1, :cfg.vocab_size].float(), dim=-1)
    gold = torch.gather(logp, -1, seq[:, 1:, None])[..., 0]
    return float(gold.mean())
