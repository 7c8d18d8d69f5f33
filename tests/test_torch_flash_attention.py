"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX reference on the CPU: the plain PyTorch version (which the
wrapper runs on CPU tensors) against the jnp oracle ``attention_ref`` and
against the Pallas kernel run in interpret mode, on the same numpy inputs,
at the shapes of ``tests/test_kernels.py`` — and the decode mapping the
port's model uses, ``causal=False, kv_len=cache_pos + 1``, against the
reference model's ``_sdpa`` with ``causal_mask(1, T, cache_pos)``.

Tolerance: ``tests/test_kernels.py``'s ``TOL`` (2e-5 fp32, 4e-2 bf16: one
bf16 rounding of an output near 4).  ``tests/test_torch_cuda_kernels.py``
holds the CUDA kernel to the plain version on the card.
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

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
