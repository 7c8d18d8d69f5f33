"""The port's configurations (the dense ``gemma2-27b``, ``granite-8b``,
``stablelm-1.6b``, beside ``qwen3-4b`` and ``recurrentgemma-9b``, and the
MoE ``deepseek-v3-671b`` and ``llama4-maverick-400b-a17b``) against the
JAX package on the CPU: each config field for field, and the reduced
models (``make_reduced``: d_model 64, 4 heads over at most 2 KV heads of
16, vocab 512, fp32; gemma2's local window cut to 4; 8 experts, MLA ranks
32 and 16) on the reference's weights, carried across by
``lm_params_from_jax`` with random non-zero norm scales.

Tolerance: logits 1e-5 relative (norm of the difference over the norm of
the reference; both sides compute in fp32 and differ by the order of the
sums in the products and in attention, plain ``jnp`` in the reference and
the kernel's plain version in the port).  The training forward on the
same models: every parameter gets a gradient, and ``remat`` changes no
bit (the MoE's aux term carried out of each checkpointed layer).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.models import transformer as tr
from repro_torch.training import train_step as ts
from repro_torch.training.checkpoint import lm_params_from_jax

torch.set_num_threads(1)

RTOL = 1e-5
NEW = ("gemma2-27b", "granite-8b", "stablelm-1.6b")
MOE = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
ALL = ("deepseek-v3-671b", "gemma2-27b", "granite-8b",
       "llama4-maverick-400b-a17b", "qwen3-4b", "recurrentgemma-9b",
       "stablelm-1.6b")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _reference(name, seed=0, **moe):
    """The reduced configs (the MoE's fields replaced by ``moe``) and the
    reference's parameters (immutable, so shared across tests) with random
    non-zero norm scales."""
    jcfg = jmake_reduced(jconfigs.get_config(name))
    cfg = configs.make_reduced(configs.get_config(name))
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    params = jtr.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if "norm" in jax.tree_util.keystr(path) else x),
        params)
    return jcfg, cfg, params


def _models(name, seed=0, **moe):
    """The reference's configs and parameters, and a fresh port model
    carrying them."""
    jcfg, cfg, params = _reference(name, seed, **moe)
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return jcfg, cfg, params, model


def test_list_archs_names_the_five():
    """The five dense and hybrid configurations, and since the MoE slice
    the two MoE ones: seven."""
    assert configs.list_archs() == list(ALL) and len(ALL) == 7
    with pytest.raises(KeyError, match="available"):
        configs.get_config("xlstm-1.3b")


@pytest.mark.parametrize("name", ALL)
def test_config_equals_reference_field_for_field(name):
    port, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for derived in ("n_repeats", "padded_vocab", "q_dim", "kv_dim"):
        assert getattr(port, derived) == getattr(ref, derived), derived
    assert (dataclasses.asdict(configs.make_reduced(port))
            == dataclasses.asdict(jmake_reduced(ref)))
    tr.check_supported(port)
    tr.check_supported(configs.make_reduced(port))


def test_the_dense_configs_use_what_the_port_has():
    g = configs.get_config("gemma2-27b")
    assert (g.attn_softcap, g.logit_softcap, g.act, g.tie_embeddings) == (
        50.0, 30.0, "gelu", True)
    assert [s.window for s in g.pattern] == [4096, None] and g.n_repeats == 23
    k = configs.get_config("granite-8b")
    assert (k.n_heads, k.n_kv_heads, k.rope_theta) == (32, 8, 1e7)
    s = configs.get_config("stablelm-1.6b")
    assert (s.n_heads, s.n_kv_heads, s.head_dim, s.tie_embeddings) == (
        32, 32, 64, False)
    assert s.padded_vocab == 100352 and g.padded_vocab == 256000


@pytest.mark.parametrize("name", ALL)
def test_reduced_forward_matches_reference(name):
    jcfg, cfg, params, model = _models(name)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    fwd = jax.jit(jtr.model_fwd, static_argnums=1)
    ref, _, _ = fwd(params, jcfg, {"tokens": jnp.asarray(toks)})
    out = tr.model_fwd(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert out.shape == ref.shape == (2, 11, cfg.padded_vocab)
    assert _rel(out.numpy(), ref) <= RTOL


@pytest.mark.parametrize("name", NEW)
def test_decode_matches_reference_and_the_forward(name):
    """Token-by-token decode over 12 tokens: each step's logits within
    1e-5 of the reference's decode and of the full forward at that
    position.  gemma2's local layers keep a ring of 4 slots (its reduced
    window), so the ring wraps twice (``tests/test_models.py``'s
    ``test_window_ring_buffer_decode``)."""
    jcfg, cfg, params, model = _models(name, seed=2)
    n = 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, n))
    toks = toks.astype(np.int32)
    full = tr.model_fwd(model, cfg, {"tokens": torch.from_numpy(toks)})
    jcache = jtr.init_model_cache(jcfg, 2, n)
    cache = tr.init_model_cache(cfg, 2, n, device="cpu")
    step = jax.jit(jtr.decode_step, static_argnums=1)
    for t in range(n):
        tok = toks[:, t:t + 1]
        ref, jcache = step(params, jcfg, jcache, jnp.asarray(tok),
                           jnp.int32(t))
        out, cache = tr.decode_step(model, cfg, cache, torch.from_numpy(tok),
                                    t)
        assert _rel(out.numpy(), ref) <= RTOL
        assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL
    lengths = [c["k"].shape[1] for c in cache["layers"]]
    want = [4 if s.window else n for s in tr.layer_specs(cfg)]
    assert lengths == want


def test_gemma2_ring_decode_equals_a_full_cache_decode():
    """The reference's ring-buffer case on the port alone: the local
    layers' 4-slot rings give the full forward's logits at every step."""
    _, cfg, _, model = _models("gemma2-27b", seed=2)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)))
    full = tr.model_fwd(model, cfg, {"tokens": toks})
    cache = tr.init_model_cache(cfg, 2, 12, device="cpu")
    outs = []
    for t in range(12):
        logits, cache = tr.decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        outs.append(logits[:, 0])
    assert _rel(torch.stack(outs, 1).numpy(), full.numpy()) <= RTOL
    assert cache["layers"][0]["k"].shape[1] == 4
    assert cache["layers"][1]["k"].shape[1] == 12


def _batch(cfg, rows=4, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


# (name, MLA absorb, MoE top_k): deepseek's two MLA decode paths; llama4
# at its top-1 (against the reference's decode only) and at top-2 (against
# the forward as well: the reference's test_decode_matches_forward runs
# top-1 MoE at k = 2, since a batch and single tokens may flip a
# knife-edge top-1 routing by their sums' order)
MOE_DECODE = [("deepseek-v3-671b", False, None),
              ("deepseek-v3-671b", True, None),
              ("llama4-maverick-400b-a17b", False, None),
              ("llama4-maverick-400b-a17b", False, 2)]


@pytest.mark.parametrize("name,absorb,top_k", MOE_DECODE,
                         ids=["ds-expand", "ds-absorb", "l4-top1", "l4-top2"])
def test_moe_decode_matches_reference_and_the_forward(name, absorb, top_k):
    """Token-by-token decode over 10 tokens: each step's logits within
    1e-5 of the reference's decode (and of the full forward at that
    position, but at llama4's top-1); MLA's latent cache within 1e-5 of
    the reference's after the last step."""
    jcfg, cfg, params, model = _models(
        name, 3, **({"top_k": top_k} if top_k else {}))
    if absorb:
        jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, absorb=True))
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))
    n = 10
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, n))
    toks = toks.astype(np.int32)
    full = tr.model_fwd(model, cfg, {"tokens": torch.from_numpy(toks)})
    jcache = jtr.init_model_cache(jcfg, 2, n)
    cache = tr.init_model_cache(cfg, 2, n, device="cpu")
    step = jax.jit(jtr.decode_step, static_argnums=1)
    for t in range(n):
        tok = toks[:, t:t + 1]
        ref, jcache = step(params, jcfg, jcache, jnp.asarray(tok),
                           jnp.int32(t))
        out, cache = tr.decode_step(model, cfg, cache, torch.from_numpy(tok),
                                    t)
        assert _rel(out.numpy(), ref) <= RTOL
        if cfg.moe.top_k > 1:
            assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL
    if cfg.mla is not None:
        # the MoE layer is the one pattern slot; the dense layers follow
        assert _rel(cache["layers"][0]["c_kv"].numpy(),
                    jcache["blocks"][0]["c_kv"][0]) <= RTOL
        assert _rel(cache["layers"][1]["k_rope"].numpy(),
                    jcache["rem"][0]["k_rope"]) <= RTOL


@pytest.mark.parametrize("name", ["gemma2-27b", "recurrentgemma-9b", *MOE])
def test_remat_changes_no_bit(name):
    """``remat`` recomputes each layer in the backward pass: the loss and
    every gradient equal the stored-activation run's bit for bit (for the
    MoE models with the aux term, carried out of each checkpointed layer,
    and deepseek's MTP loss)."""
    _, cfg, _, model = _models(name)
    batch = _batch(cfg)
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, parts = ts.make_loss_fn(cfg, remat=remat)(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss.detach(), grads, parts["aux"].detach()))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert torch.equal(out[0][2], out[1][2])
    assert (float(out[1][2]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("name", ALL)
def test_every_parameter_gets_a_gradient(name):
    """Through both kernels' ``autograd.Function``: no parameter of the
    seven reduced models is left without a gradient (the card check holds
    the same on CUDA); the MoE's experts and router, MLA's weights and the
    MTP head included."""
    _, cfg, _, model = _models(name)
    batch = _batch(cfg)
    model.requires_grad_(True)
    loss, _ = ts.make_loss_fn(cfg, remat=False)(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    assert missing == []
    assert all(torch.isfinite(g).all() for g in grads)
