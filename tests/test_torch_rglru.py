"""The port's RG-LRU scan and recurrent block against the JAX package on
the CPU, on the same numpy inputs.

* ``rglru_scan`` (on CPU tensors, the plain version of ``csrc/rglru.cu``)
  against JAX's ``rglru_scan`` (the Pallas kernel in interpret mode) and
  ``rglru_scan_ref``, over ``tests/test_kernels.py``'s property ranges
  (b 1–3, s 2–70, r 1–70) at that test's atol of 1e-5.  The port scans
  sequentially and the reference's block forward as a tree
  (``associative_scan``), so they round differently.
* ``causal_conv1d`` with and without a stream cache, ``_rglru_gates`` and
  ``rglru_block_fwd`` (full sequence, and decode steps carrying ``h`` and
  ``conv``) against ``repro.models.recurrent`` in fp32 within 1e-5
  relative (norm of the difference over the norm of the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import make_reduced as jmake_reduced
from repro import configs as jconfigs
from repro.kernels.rglru.ops import rglru_scan as jrglru_scan
from repro.kernels.rglru.ref import rglru_scan_ref as jrglru_scan_ref
from repro.models import recurrent as jrec
from repro_torch import configs
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import recurrent as rec

torch.set_num_threads(1)

RTOL = 1e-5
JCFG = jmake_reduced(jconfigs.get_config("recurrentgemma-9b"))
CFG = configs.make_reduced(configs.get_config("recurrentgemma-9b"))
# (b, s, r) inside tests/test_kernels.py's property ranges, with the
# corners, ragged against the interpret-mode kernel's 16-blocks
SCAN_SHAPES = [(1, 2, 1), (3, 70, 70), (2, 17, 33), (1, 64, 16), (3, 5, 1),
               (2, 70, 9), (1, 33, 70), (3, 16, 48)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.999, size=shape).astype(np.float32)
    b = (rng.normal(size=shape) * 0.2).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_rglru_scan_matches_reference_kernel_and_oracle(shape):
    a, b = _scan_inputs(shape, sum(shape))
    out = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == shape
    kern = jrglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=16,
                       block_r=16, interpret=True)
    oracle = jrglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=1e-5)


def test_rglru_scan_ref_keeps_the_initial_state():
    a, b = _scan_inputs((2, 9, 7), 3)
    h0 = np.random.default_rng(4).normal(size=(2, 7)).astype(np.float32)
    out = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0))
    ref = jrglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # a step by hand: h_1 = a_1 * h0 + b_1, a product then a sum in fp32
    h1 = torch.from_numpy(a[:, 0]) * torch.from_numpy(h0) + torch.from_numpy(b[:, 0])
    assert torch.equal(out[:, 0], h1)


def test_rglru_scan_wrapper_casts_and_checks():
    a, b = _scan_inputs((2, 6, 5), 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    half = rglru_scan(ta.to(torch.bfloat16), tb.to(torch.bfloat16))
    assert half.dtype == torch.float32
    assert torch.equal(half, rglru_scan_ref(ta.to(torch.bfloat16).float(),
                                            tb.to(torch.bfloat16).float()))
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(ta, tb[:, :5])
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(ta[0], tb[0])


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv1d_matches_reference(cached):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    cache = rng.normal(size=(2, 3, 12)).astype(np.float32) if cached else None
    y, new = rec.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if cache is None else torch.from_numpy(cache))
    jy, jnew = jrec.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  None if cache is None else jnp.asarray(cache))
    assert _rel(y.numpy(), jy) <= RTOL
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    assert new.shape == (2, 3, 12)


@pytest.fixture(scope="module")
def block():
    """The reference's RG-LRU weights (non-zero biases, so that every
    term counts) and the port's block carrying them."""
    p = jrec.init_rglru(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(7)
    p = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5, v.dtype)
             if k in ("b_a", "b_i", "conv_b") else v) for k, v in p.items()}
    m = rec.init_rglru(CFG, torch.Generator().manual_seed(0), "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return p, m


def test_rglru_weights_draw_the_reference_distributions():
    cfg = CFG.replace(d_model=256, rnn_width=256, dtype="bfloat16")
    m = rec.init_rglru(cfg, torch.Generator().manual_seed(1), "cpu")
    assert m.lam.dtype == torch.float32 and m.w_x.dtype == torch.bfloat16
    lam = m.lam.numpy()
    assert lam.min() >= 0.0 and lam.max() < 1.0 and abs(lam.mean() - 0.5) < 0.06
    conv = m.conv_w.float().numpy()
    assert conv.shape == (4, 256) and abs(conv.std() - 0.1) < 0.01
    assert np.abs(m.w_a.float().numpy()).max() <= 2.0 / 16.0
    for name in ("conv_b", "b_a", "b_i"):
        assert not getattr(m, name).any() and getattr(m, name).dtype == torch.bfloat16
    assert not any(p.requires_grad for p in m.parameters())


def test_rglru_gates_match_reference(block):
    p, m = block
    xc = np.random.default_rng(8).normal(size=(2, 5, 64)).astype(np.float32) * 3
    a, b = rec._rglru_gates(m, torch.from_numpy(xc))
    ja, jb = jrec._rglru_gates(p, jnp.asarray(xc))
    assert a.dtype == b.dtype == torch.float32
    assert _rel(a.numpy(), ja) <= RTOL and _rel(b.numpy(), jb) <= RTOL
    # softplus is logaddexp(x, 0): exact where torch's F.softplus switches
    # to x above its threshold
    big = torch.tensor([25.0, 30.0])
    assert torch.equal(torch.logaddexp(big, torch.zeros(2)),
                       torch.from_numpy(np.array(jax.nn.softplus(big.numpy()))))


def test_rglru_block_full_sequence_matches_reference(block):
    p, m = block
    x = np.random.default_rng(9).normal(size=(2, 23, 64)).astype(np.float32)
    y, cache = rec.rglru_block_fwd(m, CFG, torch.from_numpy(x))
    jy, _ = jrec.rglru_block_fwd(p, JCFG, jnp.asarray(x))
    assert cache is None and y.shape == (2, 23, 64)
    assert _rel(y.numpy(), jy) <= RTOL


def test_rglru_block_decode_carries_h_and_conv(block):
    """Nine one-token steps, each against the reference's step and against
    the full-sequence forward at the same position; the cache is updated
    in place, ``h`` fp32 and ``conv`` in the model's dtype."""
    p, m = block
    x = np.random.default_rng(10).normal(size=(2, 9, 64)).astype(np.float32)
    full, _ = rec.rglru_block_fwd(m, CFG, torch.from_numpy(x))
    cache = rec.init_rglru_cache(CFG, 2, device="cpu")
    jcache = jrec.init_rglru_cache(JCFG, 2)
    h_buf, conv_buf = cache["h"], cache["conv"]
    for t in range(9):
        y, c2 = rec.rglru_block_fwd(m, CFG, torch.from_numpy(x[:, t:t + 1]),
                                    cache=cache)
        jy, jcache = jrec.rglru_block_fwd(p, JCFG, jnp.asarray(x[:, t:t + 1]),
                                          cache=jcache)
        assert c2 is cache
        assert _rel(y.numpy(), jy) <= RTOL
        assert _rel(y[:, 0].numpy(), full[:, t].numpy()) <= RTOL
        assert _rel(cache["h"].numpy(), jcache["h"]) <= RTOL
        # the conv cache holds in-projected inputs: matmul rounding apart
        assert _rel(cache["conv"].numpy(), jcache["conv"]) <= RTOL
    assert cache["h"] is h_buf and cache["conv"] is conv_buf
    assert h_buf.dtype == torch.float32 and conv_buf.shape == (2, 3, 64)
    bf = rec.init_rglru_cache(CFG.replace(dtype="bfloat16"), 2, device="cpu")
    assert bf["h"].dtype == torch.float32 and bf["conv"].dtype == torch.bfloat16
