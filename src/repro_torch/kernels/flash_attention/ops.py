"""Wrapper of the flash-attention kernels: the CUDA kernels from
``csrc/flash_attention.cu`` on CUDA tensors, the plain version
(``ref.py``) on CPU tensors.  Replaces ``repro/kernels/flash_attention/
{kernel,ops}.py``.

Three kernels compute the same function; :func:`plan` picks one from the
dtype, D, S, G = H/KV, T and the strides alone:

* ``decode`` (bf16, S·G ≤ 16, D in :data:`TENSOR_CORE_HEAD_DIMS`): every
  decode step of both LMs.  Bound by the bytes of the KV cache and the
  launch.  One CTA per (b, KV head, KV split) takes the whole query group
  as the 16 rows of ``mma.sync.m16n8k16``, so each K/V element is read once
  per call; K/V arrive by ``cp.async`` into two-stage rings; the splits
  (:func:`decode_splits`, from T and B·KV, never from ``kv_len``) merge in
  split order inside the same launch, in the last CTA of each (b, KV head).
* ``scoring`` (bf16, every other call at those head dims): bound by bytes
  at S = T = 128 and by tensor-core operations at S = T = 4096.  One
  warpgroup per (b, h, 64 query rows), Q/K/V tiles by TMA, ``wgmma`` for
  both products, whole tiles outside the causal/window band skipped.
* ``simt`` (fp32, and bf16 at other head dims): the CUDA-core kernel.  No
  LM path shape lands here.

Layout: the kernels take strides, not copies.  ``q``, ``k`` and ``v`` may
be any views whose last dim is contiguous, such as the model's
``(B, S, H, D)`` projections and ``(B, T, KV, D)`` cache seen through
``.transpose(1, 2)``; the output is a ``(B, H, S, D)`` view of a fresh
``(B, S, H, D)`` buffer, so ``out.transpose(1, 2)`` is the model's layout
with no copy.  Nothing is padded: the kernels mask the ragged tiles
themselves.  The tensor-core kernels copy 16 bytes at a time (``cp.async``
and TMA): a bf16 view whose base or strides are not 16-byte multiples is
refused.

Grid limits: ``simt`` and ``scoring`` launch (⌈S/rows⌉, B·H) blocks and
``decode`` (splits, B·KV), so B·H is at most 65,535 (and B·KV ≤ B·H).
The decode kernel's split counters are one zeroed buffer per device, kept
zero by the kernel: two decode launches on different streams of one device
must not run at the same time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: largest head dim the CUDA-core kernel instantiates (8 fp32 columns per lane)
MAX_HEAD_DIM = 256
#: head dims the tensor-core kernels instantiate
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
#: query rows of the decode kernel's tile: calls with S·G up to this
DECODE_ROWS = 16
#: a split's unit of keys (the kernel steps 16 keys per warp group)
DECODE_KEYS = 64
#: CTAs the split rule aims at: one wave on the H100's 132 SMs
DECODE_CTAS = 132
#: fewest keys worth a split of their own: below it, the split merge costs
#: more than the keys it spreads
DECODE_MIN_SPLIT = 128
#: most splits the decode kernel merges (csrc kMaxSplits)
MAX_SPLITS = 128
VARIANTS = ("simt", "decode", "scoring")
#: launches of each variant since the last :func:`reset_variant_launches`
VARIANT_LAUNCHES = {name: 0 for name in VARIANTS}
_GRID_Y = 65535
_counters: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel a CUDA call runs, and the decode kernel's KV splits."""
    variant: str
    splits: int = 1
    split_len: int = 0


def reset_variant_launches() -> None:
    for name in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[name] = 0


def decode_splits(t: int, bkv: int) -> tuple:
    """``(splits, split_len)`` of the decode kernel over a cache of ``t``
    keys for ``bkv`` (b, KV head) pairs: as many splits as fill one wave of
    :data:`DECODE_CTAS` CTAs, each a multiple of :data:`DECODE_KEYS` keys
    and none much shorter than :data:`DECODE_MIN_SPLIT`.  It depends on
    ``t`` and ``bkv`` only, never on ``kv_len``, so a captured decode step
    launches the same grid at every ``cache_pos``."""
    steps = max(1, -(-t // DECODE_KEYS))
    want = max(1, min(-(-t // DECODE_MIN_SPLIT), DECODE_CTAS // bkv,
                      MAX_SPLITS))
    split_len = -(-steps // want) * DECODE_KEYS
    return -(-max(t, 1) // split_len), split_len


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The variant :func:`flash_attention` launches for these operands (see
    the module docstring), from the dtype, the shapes and the strides only.
    Raises on a bf16 view at a tensor-core head dim whose base or strides
    are not 16-byte multiples."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or d not in TENSOR_CORE_HEAD_DIMS:
        return Plan("simt")
    for name, x in (("q", q), ("k", k), ("v", v)):
        steps = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if x.data_ptr() % 16 or any(st % 8 for st in steps):
            raise ValueError(
                f"{name}: the tensor-core kernels copy 16 bytes at a time; "
                f"base {x.data_ptr() % 16} bytes off 16, strides "
                f"{tuple(x.stride())} must be multiples of 8 bf16")
    if s * (h // kv) <= DECODE_ROWS:
        return Plan("decode", *decode_splits(t, b * kv))
    return Plan("scoring")


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters, one per (b, KV head), kept per device and
    kept zero by the decode kernel (its last CTA resets its counter)."""
    key = device.index or 0
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    if b * h > _GRID_Y:
        raise ValueError(f"B*H = {b * h} over the grid's {_GRID_Y}")
    p = plan(q, k, v)
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if not out.numel():
        return out
    part, counters = None, None
    if p.variant == "decode" and p.splits > 1:
        # fp32 partials: acc [B*KV][splits][16][D], then (m, l)
        part = torch.empty(b * kv * p.splits * DECODE_ROWS * (d + 2),
                           dtype=torch.float32, device=q.device)
        counters = _split_counters(q.device, b * kv)
    build.launch(
        "flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.dtype_code(q), b, h, kv, s, t, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        int(causal), window or 0, 0.0 if softcap is None else softcap,
        1.0 / d ** 0.5, kv_len, VARIANTS.index(p.variant), p.split_len,
        p.splits, 0 if part is None else part.data_ptr(),
        0 if counters is None else counters.data_ptr())
    VARIANT_LAUNCHES[p.variant] += 1
    return out
