"""Wrapper of the flash-attention kernel: the CUDA kernel from
``csrc/flash_attention.cu`` on CUDA tensors, the plain version
(``ref.py``) on CPU tensors.  Replaces ``repro/kernels/flash_attention/
{kernel,ops}.py``.

Layout: the kernel takes strides, not copies.  ``q``, ``k`` and ``v`` may
be any views whose last dim is contiguous, such as the model's
``(B, S, H, D)`` projections and ``(B, T, KV, D)`` cache seen through
``.transpose(1, 2)``; the output is a ``(B, H, S, D)`` view of a fresh
``(B, S, H, D)`` buffer, so ``out.transpose(1, 2)`` is the model's layout
with no copy.  Nothing is padded: the kernel masks the ragged q and kv
blocks itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: largest head dim the kernel instantiates (8 fp32 columns per lane)
MAX_HEAD_DIM = 256


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` as ``flash_attention_fwd``
    computes it (see ``ref.py``): GQA through ``h // (H // KV)``, the
    causal and window masks, the logit softcap, keys at ``kv_len`` and past
    masked (``kv_len`` is read at launch, so a decode step passes
    ``cache_pos + 1`` over the whole cache), fully masked rows zero.
    Returns ``(B, H, S, D)`` in ``q``'s dtype."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape != (b, kv, t, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit (B, H, S, D) / "
                         f"(B, KV, T, D)")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    kv_len = t if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [0, {t}]")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap} must be > 0")
    if build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, kv_len=kv_len)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in build.FLOAT_DTYPES or x.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {x.dtype}; q, k and v share one "
                            f"of {build.FLOAT_DTYPES}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the kernel needs a contiguous last dim")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} over the kernel's {MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} over the grid's 65535")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel():
        build.launch(
            "flash_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            build.dtype_code(q), b, h, kv, s, t, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), window or 0, 0.0 if softcap is None else softcap,
            1.0 / d ** 0.5, kv_len)
    return out
