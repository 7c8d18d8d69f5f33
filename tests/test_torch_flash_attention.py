"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX reference on the CPU: the plain PyTorch version (which the
wrapper runs on CPU tensors) against the jnp oracle ``attention_ref`` and
against the Pallas kernel run in interpret mode, on the same numpy inputs,
at the shapes of ``tests/test_kernels.py`` — and the decode mapping the
port's model uses, ``causal=False, kv_len=cache_pos + 1``, against the
reference model's ``_sdpa`` with ``causal_mask(1, T, cache_pos)``.

The decode kernel's split-KV merge has a plain version of its own
(``flash_attention_split_ref``), held to ``flash_attention_ref`` (fp32,
1e-6) and to the Pallas kernel with ``block_k`` equal to the split length
(its KV steps merge the same way).  The wrapper's dispatch rule
(``ops.plan``, ``ops.decode_splits``) is tested here too: the LM paths'
shapes go to the tensor-core kernels, fp32 to the CUDA-core one, the
split count does not move with ``kv_len``, and misaligned views raise.

Tolerance: ``tests/test_kernels.py``'s ``TOL`` (2e-5 fp32, 4e-2 bf16: one
bf16 rounding of an output near 4).  ``tests/test_torch_cuda_kernels.py``
holds the CUDA kernels to the plain version on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import common as jcm
from repro.models.attention import _sdpa
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_attention_split_ref)

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 4e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py:52-58
SHAPES = [
    (2, 4, 2, 64, 64, 32, True, None, None),
    (1, 4, 4, 40, 40, 16, True, None, 50.0),  # softcap + unpadded len
    (2, 8, 2, 32, 96, 32, False, None, None),  # cross-attn style
    (1, 4, 1, 64, 64, 32, True, 16, None),  # MQA + sliding window
    (1, 2, 2, 16, 128, 64, True, None, None),  # long kv
]


def _qkv(b, h, kv, s, t, d, dtype, seed):
    """q, k, v as numpy fp32, in both frameworks (bf16 rounded from the
    same fp32 values by both: round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", SHAPES)
def test_plain_matches_oracle_and_pallas(b, h, kv, s, t, d, causal, window,
                                         cap, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kv, s, t, d, dtype, seed=s + t)
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    assert out.dtype == q.dtype and out.shape == (b, h, s, d)
    oracle = attention_ref(jq, jk, jv, causal=causal, window=window,
                           softcap=cap)
    pallas = jflash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                    block_q=16, block_k=16, interpret=True)
    for ref in (oracle, pallas):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("cache_pos", [0, 13, 31])
def test_decode_mapping_matches_sdpa_and_pallas(cache_pos):
    """One-token decode at ``cache_pos`` over a cache of T = 32: the
    reference model's ``_sdpa`` with ``causal_mask(1, T, cache_pos)`` is
    the kernel's ``causal=False, kv_len=cache_pos + 1``."""
    b, h, kv, t, d = 2, 4, 2, 32, 16
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kv, 1, t, d, "f32", seed=cache_pos)
    # the model's layouts: q (B, 1, H, hd), cache (B, T, KV, hd)
    sdpa = _sdpa(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                 jv.transpose(0, 2, 1, 3),
                 jcm.causal_mask(1, t, cache_pos)[None], None)
    pallas = flash_attention_fwd(jq, jk, jv, causal=False,
                                 kv_len=cache_pos + 1, interpret=True)
    # the port's model passes strided views of its own layouts
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                          vm.transpose(1, 2), causal=False,
                          kv_len=cache_pos + 1)
    np.testing.assert_allclose(_f32(out.transpose(1, 2)), _f32(sdpa),
                               atol=TOL["f32"], rtol=TOL["f32"])
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["f32"],
                               rtol=TOL["f32"])


@pytest.mark.parametrize("kv_len", [0, 5, 16])
def test_kv_len_window_and_fully_masked_rows(kv_len):
    """Keys at ``kv_len`` and past are masked; with a window of 2 the rows
    past ``kv_len + 1`` have no valid key and are exactly zero, as in the
    Pallas kernel."""
    b, h, kv, s, t, d = 1, 4, 2, 16, 16, 16
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kv, s, t, d, "f32", seed=kv_len)
    out = flash_attention(q, k, v, causal=True, window=2, kv_len=kv_len)
    pallas = flash_attention_fwd(jq, jk, jv, causal=True, window=2,
                                 kv_len=kv_len, block_q=16, block_k=16,
                                 interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["f32"],
                               rtol=TOL["f32"])
    assert torch.count_nonzero(out[:, :, kv_len + 1:]) == 0
    if kv_len:  # every row up to kv_len sees key q - 1 or q
        assert (out[:, :, :kv_len + 1].abs().sum(-1) > 0).all()


def test_wrapper_validates_operands():
    q, k = torch.zeros(1, 4, 3, 16), torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k, k[:, :, :4])
    with pytest.raises(ValueError, match="group"):
        flash_attention(torch.zeros(1, 3, 3, 16), k, k)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, k, kv_len=6)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, k, k, softcap=0.0)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        flash_attention(q, k.to("meta"), k)


def test_plain_version_multiplies_by_the_kernel_scale():
    """The plain version scales by 1/sqrt(d) as the TPU kernel does (a
    multiply), so at d = 128 it agrees with the Pallas kernel to fp32
    rounding and with ``_sdpa``'s division within TOL."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 1, 8, 8, 128, "f32", seed=3)
    out = flash_attention_ref(q, k, v, causal=True)
    pallas = flash_attention_fwd(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=2e-6, rtol=2e-6)
    sdpa = _sdpa(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                 jv.transpose(0, 2, 1, 3), jcm.causal_mask(8, 8, 0)[None],
                 None)
    np.testing.assert_allclose(_f32(out.transpose(1, 2)), _f32(sdpa),
                               atol=TOL["f32"], rtol=TOL["f32"])


# (b, h, kv, s, t, d, causal, window, cap, kv_len, splits, split_len)
SPLIT_CASES = [
    # decode over 4 splits, the last two wholly at or past kv_len
    (2, 8, 2, 1, 128, 32, False, None, None, 37, 4, 32),
    # no valid key at all: every row zero
    (1, 4, 2, 1, 64, 16, False, None, None, 0, 2, 32),
    # causal, windowed and softcapped
    (1, 4, 1, 16, 64, 32, True, 8, 30.0, None, 4, 16),
    # S != T causal (key j attends query i iff j <= i)
    (1, 4, 2, 8, 64, 32, True, None, None, None, 2, 32),
    # the kernel's own splits of recurrentgemma-9b's full ring of 2048
    # (16 query heads over 1 KV head, B = 8) at a narrow head dim
    (1, 16, 1, 1, 2048, 16, False, None, None, 37,
     *ops.decode_splits(2048, 8)),
]


@pytest.mark.parametrize(
    "b,h,kv,s,t,d,causal,window,cap,kv_len,splits,split_len", SPLIT_CASES)
def test_split_merge_matches_plain_and_pallas(b, h, kv, s, t, d, causal,
                                               window, cap, kv_len, splits,
                                               split_len):
    """Per-split partials merged in split order equal the one-pass plain
    version (fp32, 1e-6) and the Pallas kernel whose KV steps are the
    splits (``TOL``)."""
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kv, s, t, d, "f32", seed=t + s)
    kw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len)
    out = flash_attention_split_ref(q, k, v, splits=splits,
                                    split_len=split_len, **kw)
    assert out.shape == (b, h, s, d) and out.dtype == q.dtype
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v,
                                                                   **kw)),
                               atol=1e-6, rtol=1e-6)
    pallas = flash_attention_fwd(jq, jk, jv, block_q=s, block_k=split_len,
                                 interpret=True, **kw)
    np.testing.assert_allclose(_f32(out), _f32(pallas), atol=TOL["f32"],
                               rtol=TOL["f32"])
    if kv_len == 0:
        assert torch.count_nonzero(out) == 0


def _model_views(b, h, kv, s, t, d, dtype):
    """Uninitialised (B, H, S, D) and (B, KV, T, D) views of the model's
    (B, S, H, D) projections and (B, T, KV, D) cache."""
    return [torch.empty(shape, dtype=dtype).transpose(1, 2)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


# every flash call of the two LM paths (8 prompts): qwen3-4b decode over its
# cache and scoring; recurrentgemma-9b decode over its ring (as wrapped
# in chip_smoke.py's check, and at the model's window) and windowed
# scoring; and the long caches of chip_smoke.py's phase 6
LM_SHAPES = [
    ("qwen decode", 8, 32, 8, 1, 128, 128, "decode"),
    ("qwen scoring", 8, 32, 8, 128, 128, 128, "scoring"),
    ("qwen decode, cache of 2048", 8, 32, 8, 1, 2048, 128, "decode"),
    ("qwen decode, cache of 4096", 8, 32, 8, 1, 4096, 128, "decode"),
    ("rg decode", 8, 16, 1, 1, 128, 256, "decode"),
    ("rg decode, ring of 16", 8, 16, 1, 1, 16, 256, "decode"),
    ("rg decode, ring of 2048", 8, 16, 1, 1, 2048, 256, "decode"),
    ("rg scoring", 8, 16, 1, 128, 128, 256, "scoring"),
    # llama4-maverick-400b-a17b: 40 query heads over 8 KV heads (G = 5),
    # chip_smoke.py phase 22's decode over a cache of 32 and its scoring
    ("llama4 decode", 8, 40, 8, 1, 32, 128, "decode"),
    ("llama4 scoring", 8, 40, 8, 32, 32, 128, "scoring"),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,kv_len", [(1, 1), (1, 17), (1, 32), (32, None)],
                         ids=["decode-1", "decode-17", "decode-32", "scoring"])
def test_plain_matches_oracle_at_a_group_of_five(s, kv_len, dtype):
    """llama4's grouping, H = 40 over KV = 8 at head dim 128 (2 rows, T
    = 32): a decode step at ``kv_len`` (``causal=False``, as the model
    calls it) and the causal scoring forward, the plain version against
    the JAX oracle; 5 of the decode kernel's 16 tile rows are live."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 40, 8, s, 32, 128, dtype,
                                   seed=s + (kv_len or 0))
    causal = kv_len is None
    out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    # the oracle has no kv_len: it attends over the first kv_len keys
    keys = slice(None) if causal else slice(0, kv_len)
    ref = attention_ref(jq, jk[:, :, keys], jv[:, :, keys], causal=causal)
    assert out.shape == (2, 40, s, 128)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("name,b,h,kv,s,t,d,variant", LM_SHAPES)
def test_lm_path_shapes_run_tensor_core_kernels(name, b, h, kv, s, t, d,
                                                variant):
    """bf16 at the LM paths' shapes goes to the mma.sync decode kernel or
    the wgmma scoring kernel, with the splits of ``decode_splits``; fp32
    at the same shapes goes to the CUDA-core kernel."""
    plan = ops.plan(*_model_views(b, h, kv, s, t, d, torch.bfloat16))
    assert plan.variant == variant, name
    if variant == "decode":
        assert (plan.splits, plan.split_len) == ops.decode_splits(t, b * kv)
        assert s * (h // kv) <= ops.DECODE_ROWS
    assert ops.plan(*_model_views(b, h, kv, s, t, d,
                                  torch.float32)).variant == "simt"


@pytest.mark.parametrize("d", [16, 32, 96])
def test_other_head_dims_run_the_cuda_core_kernel(d):
    assert ops.plan(*_model_views(2, 4, 2, 1, 64, d,
                                  torch.bfloat16)).variant == "simt"


@pytest.mark.parametrize("t,bkv", [(1, 1), (16, 128), (128, 64), (128, 8),
                                   (300, 8), (2048, 8), (4096, 64),
                                   (4096, 1), (100_000, 1)])
def test_decode_splits_cover_the_cache(t, bkv):
    """Splits are whole 64-key CTA steps, cover the cache with no split
    wholly past T, fill at most one wave of CTAs (or one split per (b, KV
    head)) and stay under the kernel's merge limit."""
    splits, split_len = ops.decode_splits(t, bkv)
    assert split_len % ops.DECODE_KEYS == 0 and split_len > 0
    assert (splits - 1) * split_len < max(t, 1) <= splits * split_len
    assert 1 <= splits <= ops.MAX_SPLITS
    assert splits * bkv <= max(ops.DECODE_CTAS, bkv)


def _captured_launches(monkeypatch, calls):
    """Run the wrapper's CUDA branch on CPU tensors, recording each
    launch's arguments instead of launching."""
    monkeypatch.setattr(build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "launch",
                        lambda name, device, *args: calls.append(args))
    monkeypatch.setattr(ops, "VARIANT_LAUNCHES",
                        {name: 0 for name in ops.VARIANTS})
    monkeypatch.setattr(ops, "_counters", {})


@pytest.mark.parametrize("b,h,kv,t,d", [(8, 32, 8, 2048, 128),
                                        (8, 16, 1, 2048, 256),
                                        (2, 4, 1, 300, 64)])
def test_split_count_does_not_follow_kv_len(monkeypatch, b, h, kv, t, d):
    """A decode call's launch shape (variant, split length, splits) is the
    same at every kv_len, so a captured step does not change with
    cache_pos; with several splits the wrapper passes the fp32 scratch and
    the counters."""
    calls = []
    _captured_launches(monkeypatch, calls)
    q, k, v = _model_views(b, h, kv, 1, t, d, torch.bfloat16)
    for kv_len in (0, 1, 37, t):
        flash_attention(q, k, v, causal=False, kv_len=kv_len)
    # (..., kv_len, variant, split_len, splits, scratch, counters)
    shapes = {args[-5:-2] for args in calls}
    assert [args[-6] for args in calls] == [0, 1, 37, t]
    splits, split_len = ops.decode_splits(t, b * kv)
    assert shapes == {(ops.VARIANTS.index("decode"), split_len, splits)}
    assert all((args[-2] != 0) == (splits > 1) and
               (args[-1] != 0) == (splits > 1) for args in calls)
    assert ops.VARIANT_LAUNCHES == {"simt": 0, "decode": 4, "scoring": 0}


def test_misaligned_views_raise(monkeypatch):
    """The tensor-core kernels copy 16 bytes at a time: a bf16 view at a
    base off 16 bytes, or with a stride off 8 elements, is refused (no
    other kernel takes it instead)."""
    calls = []
    _captured_launches(monkeypatch, calls)
    buf = torch.empty(1, 4, 8, 136, dtype=torch.bfloat16)
    q = buf[..., 1:129]  # base 2 bytes past an aligned buffer
    k = torch.empty(1, 2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.plan(q, k, k)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, k, k)
    # (B, S, H, 132) projections cut to D = 128: a head stride of 132
    qm = torch.empty(1, 20, 4, 132, dtype=torch.bfloat16)[..., :128]
    km = torch.empty(1, 20, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                        km.transpose(1, 2))
    assert calls == []
    # the same operands in fp32 go to the CUDA-core kernel, which takes
    # any stride
    assert ops.plan(q.float(), k.float(), k.float()).variant == "simt"
