"""The port's LM modules (``repro_torch.models``) against the JAX package
on the CPU, in fp32 at reduced size (``make_reduced(qwen3-4b)`` with 2
layers: d_model 64, 4 heads over 2 KV heads, head_dim 16, vocab 512), with
the reference's weights carried across by ``lm_params_from_jax``.

Tolerance: 1e-5 relative (norm of the difference over the norm of the
reference).  Both sides compute in fp32; they differ by the order of the
sums in the matrix products and by ``_sdpa`` dividing the scores by
√hd where the kernel's plain version multiplies by 1/√hd (exact at hd = 16).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.configs.base import LayerSpec, MLAConfig, MoEConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import lm_params_from_jax

torch.set_num_threads(1)

RTOL = 1e-5
JCFG = jmake_reduced(jconfigs.get_config("qwen3-4b")).replace(n_layers=2)
CFG = configs.make_reduced(configs.get_config("qwen3-4b")).replace(n_layers=2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    """The JAX parameters (with random, non-zero norm scales, so that the
    norms are not the identity) and the port's model carrying them."""
    params = jtr.init_model(jax.random.PRNGKey(0), JCFG)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if "norm" in jax.tree_util.keystr(path) else x),
        params)
    model = tr.init_model(CFG, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), CFG))
    return params, model


def test_port_config_equals_reference():
    full = configs.get_config("qwen3-4b")
    ref = jconfigs.get_config("qwen3-4b")
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "padded_vocab", "qk_norm",
                 "tie_embeddings", "rope_theta", "act", "norm_eps", "dtype"):
        assert getattr(full, name) == getattr(ref, name), name
    assert full.padded_vocab == 152064 and full.n_repeats == 36
    assert CFG.n_layers == JCFG.n_layers == 2
    assert configs.make_reduced(full).n_layers == 1
    assert configs.make_reduced(full) == configs.make_reduced(full)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3.0
    scale = rng.normal(size=(64,)).astype(np.float32)
    out = cm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    ref = jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    assert _rel(out.numpy(), ref) <= RTOL
    # a zero scale is the identity scaling of the normalised rows
    ident = cm.rms_norm(torch.from_numpy(x), torch.zeros(64))
    rms = np.sqrt(np.mean(x.astype(np.float64) ** 2, -1, keepdims=True))
    assert _rel(ident.numpy(), x / rms) <= RTOL


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    """Split halves, fp32 angles; positions with an offset as in decode."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (40 + np.arange(7))[None, :].repeat(2, 0).astype(np.int32)
    out = cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert _rel(out.numpy(), ref) <= RTOL
    # the rotation pairs dim i with dim i + 8, not with i + 1
    out1 = cm.apply_rope(torch.from_numpy(x), torch.ones(2, 7), theta).numpy()
    c, s = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(out1[..., 0], x[..., 0] * c - x[..., 8] * s,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_qk_norm_comes_before_rope(models, causal):
    """The attention block (causal, and bidirectional as an encoder calls
    it) with non-zero q/k norm scales equals the reference's, whose qk-norm
    precedes RoPE; the other order would not."""
    params, model = models
    jp = jax.tree.map(lambda a: a[0], params["lm"]["blocks"][0]["attn"])
    p = model.layers[0].attn
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    pos = np.arange(6)[None, :].repeat(2, 0)
    out, _ = attn.gqa_fwd(p, CFG, torch.from_numpy(x), torch.from_numpy(pos),
                          causal=causal)
    ref, _ = jattn.gqa_fwd(jp, JCFG, jnp.asarray(x), jnp.asarray(pos),
                           causal=causal)
    assert _rel(out.numpy(), ref) <= RTOL
    # the opposite order changes q by far more than the tolerance
    q = (torch.from_numpy(x) @ p.wq.reshape(64, -1)).view(2, 6, 4, 16)
    tp = torch.from_numpy(pos)
    a = cm.apply_rope(cm.rms_norm(q, p.q_norm), tp, CFG.rope_theta)
    b = cm.rms_norm(cm.apply_rope(q, tp, CFG.rope_theta), p.q_norm)
    assert _rel(a.numpy(), b.numpy()) > 1e-2


def test_masks_match_reference():
    """The masks the kernel's causal/window/kv_len arguments stand for."""
    for q_len, kv_len, off in ((1, 9, 4), (5, 5, 0), (3, 8, 2)):
        np.testing.assert_array_equal(
            cm.causal_mask(q_len, kv_len, off).numpy(),
            np.asarray(jcm.causal_mask(q_len, kv_len, off)))
        np.testing.assert_array_equal(
            cm.window_mask(q_len, kv_len, off, 3).numpy(),
            np.asarray(jcm.window_mask(q_len, kv_len, off, 3)))


def test_embed_scale_rounds_to_the_model_dtype():
    full = configs.get_config("qwen3-4b")
    ref = jnp.asarray(jnp.sqrt(full.d_model), jnp.bfloat16)
    assert float(tr.embed_scale(full)) == float(ref) == 50.5
    assert tr.embed_scale(full).dtype == torch.bfloat16
    ref32 = jnp.asarray(jnp.sqrt(CFG.d_model), jnp.float32)
    assert float(tr.embed_scale(CFG)) == float(ref32) == 8.0
    f32 = full.replace(dtype="float32")
    assert float(tr.embed_scale(f32)) == float(
        jnp.asarray(jnp.sqrt(2560), jnp.float32))


def test_model_fwd_logits_match_reference(models):
    params, model = models
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    ref, _, _ = jtr.model_fwd(params, JCFG, {"tokens": jnp.asarray(toks)})
    out = tr.model_fwd(model, CFG, {"tokens": torch.from_numpy(toks)})
    assert out.shape == (2, 11, CFG.padded_vocab) == ref.shape
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= RTOL


def test_decode_step_token_by_token_matches_reference(models):
    """A cached decode over 7 tokens: every step's logits within 1e-5 of
    the reference's, the cache written in place in the config's dtype."""
    params, model = models
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 7))
    toks = toks.astype(np.int32)
    jcache = jtr.init_model_cache(JCFG, 2, 7)
    cache = tr.init_model_cache(CFG, 2, 7, device="cpu")
    full = tr.model_fwd(model, CFG, {"tokens": torch.from_numpy(toks)})
    for t in range(7):
        tok = toks[:, t:t + 1]
        ref, jcache = jtr.decode_step(params, JCFG, jcache, jnp.asarray(tok),
                                      jnp.int32(t))
        out, cache = tr.decode_step(model, CFG, cache, torch.from_numpy(tok), t)
        assert out.shape == (2, 1, CFG.padded_vocab)
        assert _rel(out.numpy(), ref) <= RTOL
        # the cached step computes the full forward's logits at position t
        assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL
    k = cache["layers"][1]["k"]
    assert k.dtype == torch.float32 and k.shape == (2, 7, 2, 16)
    jk = jcache["blocks"][0]["k"][1]  # layer 1 = repeat 1 of the pattern
    assert _rel(k.numpy(), jk) <= RTOL


def test_init_model_draws_the_reference_distributions():
    cfg = CFG.replace(d_model=256, d_ff=512, vocab_size=4096)
    model = tr.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    emb = model.embed.numpy()
    assert emb.shape == (cfg.padded_vocab, 256)
    assert abs(emb.std() - 0.02) < 0.02 * 0.02
    wq = model.layers[0].attn.wq.numpy()  # (d, H, hd), fan-in d
    assert wq.shape == (256, 4, 16)
    assert np.abs(wq).max() <= 2.0 / 16.0
    # a normal cut to ±2 has standard deviation 0.8796
    assert abs(wq.std() * 16.0 - 0.8796) < 0.02
    wo = model.layers[0].attn.wo.numpy()  # fan-in H*hd = 64
    assert wo.shape == (4, 16, 256) and np.abs(wo).max() <= 2.0 / 8.0
    assert not any(p.requires_grad for p in model.parameters())
    for name, p in model.named_parameters():
        if "norm" in name:
            assert not p.any(), name
    # the same generator seed gives the same weights
    again = tr.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again.layers[1].mlp.w_down, model.layers[1].mlp.w_down)


def test_weight_carry_over_unstacks_the_blocks(models):
    params, model = models
    blocks = params["lm"]["blocks"][0]
    for r in range(2):
        np.testing.assert_array_equal(
            model.layers[r].mlp.w_up.numpy(), np.asarray(blocks["mlp"]["w_up"][r]))
        np.testing.assert_array_equal(
            model.layers[r].attn.wo.numpy(), np.asarray(blocks["attn"]["wo"][r]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["lm"]["embed"]))


def test_unported_paths_raise(models):
    """xLSTM, cross-attention, a sharded call and a chunked prefill raise;
    a MoE layer and MLA, which raised before the MoE/MLA slice, build and
    run (a forward and a decode step, finite)."""
    _, model = models
    with pytest.raises(NotImplementedError, match="xLSTM"):
        tr.init_model(CFG.replace(pattern=(LayerSpec(mixer="mlstm"),)),
                      torch.Generator(), "cpu")
    toks = torch.zeros(1, 3, dtype=torch.long)
    for cfg in (CFG.replace(pattern=(LayerSpec(mlp="moe"),),
                            moe=MoEConfig(n_experts=4, d_ff_expert=32)),
                CFG.replace(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                          qk_nope_dim=16, qk_rope_dim=8,
                                          v_head_dim=16))):
        m = tr.init_model(cfg, torch.Generator(), "cpu")
        assert torch.isfinite(tr.model_fwd(m, cfg, {"tokens": toks})).all()
        cache = tr.init_model_cache(cfg, 1, 4, device="cpu")
        step, _ = tr.decode_step(m, cfg, cache, toks[:, :1], 0)
        assert torch.isfinite(step).all()
    with pytest.raises(ValueError, match="cfg.moe"):
        tr.init_model(CFG.replace(pattern=(LayerSpec(mlp="moe"),)),
                      torch.Generator(), "cpu")
    p = model.layers[0].attn
    x = torch.zeros(1, 2, 64)
    pos = torch.zeros(1, 2, dtype=torch.long)
    cache = tr.init_model_cache(CFG, 1, 8, device="cpu")["layers"][0]
    with pytest.raises(NotImplementedError, match="more than one token"):
        attn.gqa_fwd(p, CFG, x, pos, cache=cache, cache_pos=0)
    with pytest.raises(NotImplementedError, match="longer than the window"):
        attn.gqa_fwd(p, CFG, x[:, :1], pos[:, :1], window=4, cache=cache,
                     cache_pos=0)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        attn.gqa_fwd(p, CFG, x, pos, ctx=x)
    with pytest.raises(NotImplementedError, match="sharded"):
        attn.gqa_fwd(p, CFG, x, pos, mesh=object())


def test_entry_point_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init_model(CFG, torch.Generator())
