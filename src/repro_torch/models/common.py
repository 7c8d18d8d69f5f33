"""Shared LM building blocks (port of ``repro/models/common.py``).

Initializers draw from an explicit :class:`torch.Generator` the
distributions of the reference (truncated normal on ±2 over √fan_in for
matmul weights, N(0, 0.02²) for embeddings), in fp32 and then cast; the
bits differ from ``jax.random``'s, so the tests carry JAX weights across
(``training/checkpoint.py::lm_params_from_jax``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight: the port serves and does not train, so no gradient."""
    return nn.Parameter(t, requires_grad=False)


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def dense_init(generator: torch.Generator, in_dim: int, out_shape, dtype,
               device) -> torch.Tensor:
    """Truncated-normal fan-in init, matmul weight of shape (in_dim, *out):
    a standard normal cut to [-2, 2] (inverse CDF of a uniform draw) times
    1/√in_dim."""
    shape = (in_dim,) + tuple(out_shape)
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2.0 * _phi(-2.0) - 1.0, 2.0 * _phi(2.0) - 1.0,
               generator=generator)
    x = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    x = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    return x.normal_(0.0, 1.0, generator=generator).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """In fp32, scaled by ``1 + scale`` (a zero-initialised norm is the
    identity), cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    split halves (not interleaved pairs), angles in fp32."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # (half,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks (the attention kernel takes causal/window/kv_len instead; these
# state the same masks for the tests)
# ---------------------------------------------------------------------------


def causal_mask(q_len: int, kv_len: int, q_offset: int,
                device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask, True = attend.  ``q_offset`` is the
    absolute position of query row 0."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def window_mask(q_len: int, kv_len: int, q_offset: int, window: int,
                device=None) -> torch.Tensor:
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


# ---------------------------------------------------------------------------
# Type promotion (``jnp``'s, for a context or frames wider than the model)
# ---------------------------------------------------------------------------


def promoted(*xs: torch.Tensor):
    """``xs`` cast to their common promoted dtype, as ``jnp`` promotes the
    operands of one product: an fp32 context or fp32 frames against a bf16
    model's weights make the product fp32, the weights raised one product
    at a time.  Operands that share a dtype come back as they are (the
    bits of a call whose context is in the model's dtype do not move)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x.dtype == dt else x.to(dt) for x in xs)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (:func:`promoted`)."""
    x, w = promoted(x, w)
    return x @ w


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
