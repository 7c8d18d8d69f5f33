"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``), in fp32.

It computes what ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd`` computes, with the same arguments: scores
``q·k * (1/sqrt(d))`` (a multiply, as the TPU kernel does), then the logit
softcap ``cap·tanh(s/cap)``; key ``j`` of query row ``i`` attends iff
``j < kv_len``, and ``j <= i`` when causal, and ``j > i - window`` with a
window; a row with no valid key is zero.  GQA maps query head ``h`` to kv
head ``h // (H // KV)``.  The tests and the CPU path use it; nothing on
the card's path does.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else kv_len
    qg = q.reshape(b, kv, h // kv, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / d ** 0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, 1.0, denom)  # fully masked rows → zeros
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / denom
    return out.reshape(b, h, s, d).to(q.dtype)


def flash_attention_split_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    *,
    splits: int,
    split_len: Optional[int] = None,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """The same function computed as the decode kernel does over its KV
    splits, in fp32: split ``j`` takes keys ``[j*L, (j+1)*L)`` (``L`` is
    ``split_len``, by default ``ceil(T / splits)``) and yields a partial
    ``(m_j, l_j, acc_j)``: its largest valid logit (``NEG_INF`` if it has
    no valid key), the sum of ``exp(s - m_j)`` over its valid keys and
    their ``exp(s - m_j)``-weighted values.  The partials merge in split
    order: ``M = max_j m_j``, ``out = sum_j e^(m_j - M) acc_j /
    sum_j e^(m_j - M) l_j``, a zero sum giving zeros.  The tests use it; no
    path does."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else kv_len
    split_len = -(-t // splits) if split_len is None else split_len
    qg = q.reshape(b, kv, h // kv, s, d).float()
    q_pos = torch.arange(s, device=q.device)[:, None]
    parts = []
    for j in range(splits):
        lo, hi = j * split_len, min((j + 1) * split_len, t)
        kj, vj = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        scores = torch.einsum("bkgsd,bktd->bkgst", qg, kj) * (1.0 / d ** 0.5)
        if softcap is not None:
            scores = softcap * torch.tanh(scores / softcap)
        k_pos = torch.arange(lo, max(hi, lo), device=q.device)[None, :]
        mask = k_pos < kv_len
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        scores = torch.where(mask, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True) if hi > lo else torch.full(
            (b, kv, h // kv, s, 1), NEG_INF, device=q.device)
        p = torch.where(mask, torch.exp(scores - m), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgst,bktd->bkgsd", p, vj)))
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - big)
        num = num + w * acc
        den = den + w * l
    out = num / torch.where(den == 0, 1.0, den)
    return out.reshape(b, h, s, d).to(q.dtype)
