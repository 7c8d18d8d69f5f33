"""The port's encoders and cross-attention (``whisper-medium``'s encoder
over precomputed frames, ``llama-3.2-vision-11b``'s ``ctx_proj`` over
precomputed patches, the cross layers of both) against the JAX package on
the CPU, in fp32 on the reduced configs (``make_reduced``: decoder d_model
64, 4 heads of 16; whisper's encoder 2 layers of width 64 over 16 frames
with 2 heads; vision's context 8 patches of 32), with the reference's
weights carried across by ``lm_params_from_jax`` (random non-zero norm
scales; ``tests/test_torch_lm_train.py``'s ``_models``) and numpy-seeded
tokens and contexts (× 0.1, as the reference's
``tests/test_models.py`` draws them).

Tolerances: activations and logits 1e-5 relative (norm of the difference
over the norm of the reference; both sides compute in fp32 and differ by
the order of the sums), as ``tests/test_torch_lm_models.py``; one train
step at ``tests/test_torch_lm_train.py``'s: the loss and the gradient
norm within ``LOSS_RTOL``, every gradient within ``GRAD_RTOL`` of its
tensor's largest, the parameters after AdamW within ``STEP_SPACINGS``
spacings plus the gradient error Adam's first update propagates.  Weights
and checkpoints cross between the packages bit for bit.
"""
from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.launch import train as jlt
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serving import lm_relay as jrelay
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.launch import train as lt
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.serving.lm_relay import greedy_decode
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from test_torch_lm_train import (GRAD_RTOL, LOSS_RTOL, OPT, SCALAR_ULPS,
                                 _check_params_after_step, _models,
                                 _port_grads, _reference, _rel, _spacing)

torch.set_num_threads(1)

RTOL = 1e-5
NAMES = ("whisper-medium", "llama-3.2-vision-11b")
WHISPER = "whisper-medium"
ARGS = ["--arch", WHISPER, "--batch", "2", "--seq", "16", "--ckpt-every", "4"]


def _ctx(cfg, rows, seed) -> np.ndarray:
    """A context of the config's shape: frames (rows, n_frames, d_enc) for
    an encoder, patches (rows, ctx_len, ctx_dim) otherwise; N(0, 0.1²)."""
    shape = ((rows, cfg.encoder.n_frames, cfg.encoder.d_model)
             if cfg.encoder is not None else (rows, cfg.ctx_len, cfg.ctx_dim))
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.1).astype(np.float32)


def _batch(cfg, rows=4, seq=16, seed=1, ctx=True):
    """The same tokens, labels and context in both frameworks."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)),
            "labels": rng.integers(0, cfg.vocab_size, (rows, seq))}
    arrs = {k: v.astype(np.int32) for k, v in arrs.items()}
    if ctx:
        arrs["ctx"] = _ctx(cfg, rows, seed + 100)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


# ---------------------------------------------------------------------------
# the configurations and the weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference_field_for_field(name):
    port, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for derived in ("n_repeats", "padded_vocab", "q_dim", "kv_dim"):
        assert getattr(port, derived) == getattr(ref, derived), derived
    assert (dataclasses.asdict(configs.make_reduced(port))
            == dataclasses.asdict(jmake_reduced(ref)))
    tr.check_supported(port)
    tr.check_supported(configs.make_reduced(port))


def test_the_configs_read_a_context():
    """whisper: 24 cross layers over a 24-layer encoder of 1,500 frames,
    reduced to 2 layers of width 64 over 16 frames with 2 heads; vision:
    a cross layer every 5th over 1,600 patches of 7,680, reduced to 8 of
    32."""
    w, v = configs.get_config(WHISPER), configs.get_config(NAMES[1])
    assert all(s.cross_attn for s in tr.layer_specs(w)) and w.n_layers == 24
    assert (w.encoder.n_layers, w.encoder.n_frames, w.encoder.d_model,
            w.encoder.n_heads, w.encoder.d_ff) == (24, 1500, 1024, 16, 4096)
    assert (w.ctx_dim, w.tie_embeddings, w.padded_vocab) == (0, True, 51968)
    assert [s.cross_attn for s in tr.layer_specs(v)] == (
        [True, False, False, False, False] * 8)
    assert (v.ctx_len, v.ctx_dim, v.encoder) == (1600, 7680, None)
    rw, rv = configs.make_reduced(w), configs.make_reduced(v)
    assert (rw.encoder.n_layers, rw.encoder.n_frames, rw.encoder.d_model,
            rw.encoder.n_heads, rw.encoder.d_ff) == (2, 16, 64, 2, 128)
    assert (rv.ctx_len, rv.ctx_dim, rw.ctx_len, rw.ctx_dim) == (8, 32, 0, 0)
    assert configs.list_archs() == sorted(configs.list_archs())
    assert {WHISPER, NAMES[1]} <= set(configs.list_archs())


@pytest.mark.parametrize("reduced", [False, True])
def test_encoder_cfg_equals_reference(reduced):
    """``encoder_cfg`` is the reference's ``_encoder_cfg``: RoPE, the
    norms' eps, Q/K norm and the softcap left at their defaults."""
    port, ref = configs.get_config(WHISPER), jconfigs.get_config(WHISPER)
    if reduced:
        port, ref = configs.make_reduced(port), jmake_reduced(ref)
    e, je = tr.encoder_cfg(port), jtr._encoder_cfg(ref)
    assert dataclasses.asdict(e) == dataclasses.asdict(je)
    assert (e.n_kv_heads, e.head_dim, e.vocab_size, e.qk_norm,
            e.attn_softcap) == (e.n_heads, e.d_model // e.n_heads, 256,
                                False, None)


@pytest.mark.parametrize("name", NAMES)
def test_weights_cross_bit_for_bit(name):
    """Every leaf of the reference's ``{"lm", "encoder"}`` tree lands on
    exactly one port parameter (a stacked leaf's repeat r on layer r),
    bit for bit, and ``model_tree_to_jax`` (``lm_tree_to_jax`` on the LM's
    part) gives the tree back."""
    jcfg, cfg, params, model = _models(name)
    named = dict(model.named_parameters())
    ref = ck.flatten(jax.tree.map(np.asarray, params))
    assert sum(a.size for a in ref.values()) == sum(
        p.numel() for p in named.values())
    back = ck.flatten(ck.model_tree_to_jax(
        {n: p.detach() for n, p in named.items()}, cfg))
    assert list(back) == list(ref)
    for key, a in ref.items():
        assert np.array_equal(back[key].numpy(), a), key
    lm = ck.flatten(ck.lm_tree_to_jax(named, cfg))
    assert list(lm) == [k[3:] for k in ref if k.startswith("lm/")]
    if cfg.encoder is not None:
        enc = params["encoder"]
        assert np.array_equal(model.encoder.layers[1].attn.wq.detach().numpy(),
                              np.asarray(enc["blocks"][0]["attn"]["wq"][1]))
        assert np.array_equal(model.encoder.final_norm.detach().numpy(),
                              np.asarray(enc["final_norm"]))
        assert not hasattr(model.encoder.layers[0], "cross")
    else:
        assert np.array_equal(model.ctx_proj.detach().numpy(),
                              np.asarray(params["lm"]["ctx_proj"]))
    cross = params["lm"]["blocks"][0]["cross"]["wk"]
    assert np.array_equal(model.layers[0].cross.wk.detach().numpy(),
                          np.asarray(cross[0]))


@pytest.mark.parametrize("name", NAMES)
def test_leaf_ranks_follow_the_reference_stacking(name):
    """The ranks AdamW's decay reads: an encoder layer's leaves carry the
    encoder's stacked axis (its norm vectors rank 2, decayed), a cross
    layer's the pattern's, ``ctx_proj`` and ``encoder.final_norm`` their
    own; each equal to the reference leaf's rank."""
    _, cfg, params, model = _models(name)
    ranks = ck.lm_leaf_ranks(dict(model.named_parameters()), cfg)
    jranks = ck.model_tree_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    unstack=False)
    assert ranks == {n: np.ndim(a) for n, a in jranks.items()}
    assert ranks["layers.0.norm_cross"] == 2
    if cfg.encoder is not None:
        assert ranks["encoder.layers.1.norm_mix"] == 2
        assert ranks["encoder.final_norm"] == 1
    else:
        assert ranks["ctx_proj"] == 2


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------


def test_encoder_fwd_matches_reference():
    """Bidirectional self-attention with RoPE over 16 frames, 2 layers,
    the final norm."""
    jcfg, cfg, params, model = _models(WHISPER)
    frames = _ctx(cfg, 2, 7)
    ref = jtr.encoder_fwd(params["encoder"], jcfg, jnp.asarray(frames))
    out = tr.encoder_fwd(model.encoder, cfg, torch.from_numpy(frames))
    assert out.shape == ref.shape == (2, 16, 64)
    assert _rel(out.detach().numpy(), ref) <= RTOL


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_cross_gqa_fwd_matches_reference(qk_norm, softcap):
    """``gqa_fwd`` with ``ctx``: K/V from the context by the layer's own
    weights, Q/K norm and the softcap as the reference applies them, no
    RoPE (a position offset changes nothing), every context row attended;
    at 5 query rows and at one (a decode step's), a cache passed along
    left untouched and returned."""
    base = jmake_reduced(jconfigs.get_config(NAMES[1]))
    jcfg = base.replace(qk_norm=qk_norm, attn_softcap=softcap)
    cfg = configs.make_reduced(configs.get_config(NAMES[1])).replace(
        qk_norm=qk_norm, attn_softcap=softcap)
    jp = jattn.init_gqa(jax.random.PRNGKey(3), jcfg, cross=True)
    rng = np.random.default_rng(3)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
              if "norm" in k else v) for k, v in jp.items()}
    p = attn.init_gqa(cfg, torch.Generator().manual_seed(0), "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    ctx = (rng.normal(size=(2, 8, 64)) * 0.5).astype(np.float32)
    for s in (5, 1):
        x = rng.normal(size=(2, s, 64)).astype(np.float32)
        pos = np.arange(s)[None].repeat(2, 0).astype(np.int32)
        ref, _ = jattn.gqa_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               ctx=jnp.asarray(ctx))
        cache = attn.init_gqa_cache(cfg, 2, 4, device="cpu")
        out, c2 = attn.gqa_fwd(p, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos) + 7, cache=cache,
                               cache_pos=2, ctx=torch.from_numpy(ctx))
        assert c2 is cache and not cache["k"].any() and not cache["v"].any()
        assert out.shape == (2, s, 64)
        assert _rel(out.detach().numpy(), ref) <= RTOL


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_ctx", [True, False])
def test_model_fwd_matches_reference(name, with_ctx):
    """The prefill logits with a context (whisper's frames through the
    encoder, vision's patches through ``ctx_proj``) and without one (the
    cross blocks skipped, as the reference skips them)."""
    jcfg, cfg, params, model = _models(name)
    jb, b = _batch(cfg, rows=2, seq=11, seed=4, ctx=with_ctx)
    ref, _, _ = jax.jit(jtr.model_fwd, static_argnums=1)(params, jcfg, jb)
    out = tr.model_fwd(model, cfg, b)
    assert out.shape == ref.shape == (2, 11, cfg.padded_vocab)
    assert _rel(out.detach().numpy(), ref) <= RTOL
    if with_ctx:  # the context reaches the logits
        plain = tr.model_fwd(model, cfg, {"tokens": b["tokens"]})
        assert _rel(out.detach().numpy(), plain.detach().numpy()) > 1e-3


# A bf16 model fed an fp32 context: the port promotes as the reference's
# einsums do (``models/common.py::promoted``): ``ctx_proj``, the cross K/V
# and their attention in fp32, the encoder in fp32 over fp32 frames.  What
# is left is the decoder's own bf16 rounding.  Read over seeds 4-6: the
# port within 5.5-5.8e-3 (whisper-medium) and 0.96-1.37e-2
# (llama-3.2-vision-11b) of the reference's bf16 logits, and 0.97-1.18
# times as far from the fp32 model on the same weights as the reference's
# own bf16 logits are.  (Before the promotion, when the port cast the
# context to bf16 where it entered: 0.78-1.42e-2, and up to 1.9 times.)
BF16_CTX_RTOL = {"whisper-medium": 1.5e-2, "llama-3.2-vision-11b": 2.75e-2}
BF16_CTX_RATIO = 2.35


@pytest.mark.parametrize("name", NAMES)
def test_bf16_model_over_fp32_ctx_stays_near_reference(name):
    """The promoted cross path: the port's bf16 logits within
    ``BF16_CTX_RTOL`` of the reference's and no further from the fp32
    model than ``BF16_CTX_RATIO`` times the reference's own."""
    jcfg, cfg, params = _reference(name)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                       if x.dtype == jnp.float32 else x, params)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), p16)
    model = tr.init_model(cfg16, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(ck.lm_params_from_jax(
        jax.tree.map(np.asarray, p16), cfg16))
    fwd = jax.jit(jtr.model_fwd, static_argnums=1)
    for seed in (4, 5, 6):
        jb, b = _batch(cfg, rows=2, seq=11, seed=seed)
        assert b["ctx"].dtype == torch.float32
        ref16 = np.asarray(fwd(p16, jcfg16, jb)[0], np.float32)
        ref32 = np.asarray(fwd(p32, jcfg, jb)[0])
        out = tr.model_fwd(model, cfg16, b)
        assert out.dtype == torch.bfloat16
        out = out.float().detach().numpy()
        assert np.isfinite(out).all()
        assert _rel(out, ref16) <= BF16_CTX_RTOL[name]
        assert _rel(out, ref32) <= BF16_CTX_RATIO * _rel(ref16, ref32)


def test_bf16_encoder_stays_fp32_over_fp32_frames():
    """whisper-medium's encoder in a bf16 model over fp32 frames: every
    layer's hidden state and the output stay fp32 (the reference's scan
    carries the fp32 frames), and the output is the reference's
    encoder_fwd on the same bf16 weights within 1e-5 (both promote each
    product to fp32)."""
    name = "whisper-medium"
    jcfg, cfg, params = _reference(name)
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                       if x.dtype == jnp.float32 else x, params)
    model = tr.init_model(cfg16, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(ck.lm_params_from_jax(
        jax.tree.map(np.asarray, p16), cfg16))
    jb, b = _batch(cfg, rows=2, seq=11, seed=4)
    assert b["ctx"].dtype == torch.float32
    dtypes = []
    layer_fwd = tr.layer_fwd

    def recording(p, *args, **kw):
        out = layer_fwd(p, *args, **kw)
        dtypes.append(out[0].dtype)
        return out

    tr.layer_fwd = recording
    try:
        out = tr.encoder_fwd(model.encoder, cfg16, b["ctx"])
    finally:
        tr.layer_fwd = layer_fwd
    assert dtypes == [torch.float32] * cfg.encoder.n_layers
    assert out.dtype == torch.float32
    ref = np.asarray(jax.jit(jtr.encoder_fwd, static_argnums=1)(
        p16["encoder"], jcfg16, jb["ctx"]))
    assert ref.dtype == np.float32
    assert _rel(out.detach().numpy(), ref) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference_and_forward(name):
    """A cached decode over 12 tokens with the context at every step (the
    frames re-encoded at each, as the reference does): each step's logits
    within 1e-5 of the reference's decode step and of the full forward at
    that position."""
    jcfg, cfg, params, model = _models(name)
    jb, b = _batch(cfg, rows=2, seq=12, seed=5)
    full = tr.model_fwd(model, cfg, b)
    jcache = jtr.init_model_cache(jcfg, 2, 12)
    cache = tr.init_model_cache(cfg, 2, 12, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: jtr.decode_step(
        p, jcfg, c, t, pos, ctx=jb["ctx"]))
    for t in range(12):
        ref, jcache = jstep(params, jcache, jb["tokens"][:, t:t + 1],
                            jnp.int32(t))
        out, cache = tr.decode_step(model, cfg, cache,
                                    b["tokens"][:, t:t + 1], t, ctx=b["ctx"])
        assert out.shape == (2, 1, cfg.padded_vocab)
        assert _rel(out.detach().numpy(), ref) <= RTOL
        assert _rel(out[:, 0].detach().numpy(),
                    full[:, t].detach().numpy()) <= RTOL


@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_without_ctx_matches_reference(name):
    """The relays' decode, which passes no context: the cross layers are
    skipped and the tokens equal the reference's, token for token."""
    jcfg, cfg, params, model = _models(name)
    prompt = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    ref = jrelay.greedy_decode(params, jcfg, jnp.asarray(prompt), 8)
    out = greedy_decode(model, cfg, prompt, 8, device="cpu")
    assert out.shape == (2, 13)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _step_case(name, ce_chunk=None, accum_steps=1):
    """One train step with a context against the jitted reference: the
    loss, every gradient (none missing: encoder, cross layers and
    ``ctx_proj`` included), ``grad_norm``, the rate and the parameters
    after AdamW."""
    jcfg, cfg, params, model = _models(name)
    jc, c = jopt.OptConfig(**OPT), opt.OptConfig(**OPT)
    jbatch, batch = _batch(cfg)
    if accum_steps == 1:
        jloss = jts.make_loss_fn(jcfg, remat=False, ce_chunk=ce_chunk)
        _, jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params,
                                                                 jbatch)
        want = ck.lm_params_from_jax(jax.tree.map(np.asarray, jg), cfg)
        grads = _port_grads(model, cfg, batch, ce_chunk)
        assert set(grads) == set(want)
        for n, g in grads.items():
            w = want[n].numpy()
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= GRAD_RTOL * np.abs(w).max(), (n, err)
    else:
        grads = _port_grads(model, cfg, batch, ce_chunk)
    jstep = jax.jit(jts.make_train_step(jcfg, jc, remat=False,
                                        ce_chunk=ce_chunk,
                                        accum_steps=accum_steps))
    jp, _, jm = jstep(params, jopt.adamw_init(params, jc), jbatch)
    step = ts.make_train_step(cfg, c, remat=False, ce_chunk=ce_chunk,
                              accum_steps=accum_steps)
    state = opt.adamw_init(dict(model.named_parameters()), c)
    model, state, m = step(model, state, batch)
    assert int(state["count"]) == 1
    assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= LOSS_RTOL
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= (
        LOSS_RTOL)
    assert abs(float(m["lr"]) - float(jm["lr"])) <= (
        SCALAR_ULPS * _spacing(float(jm["lr"])))
    _check_params_after_step(model, cfg, jp, grads, float(m["grad_norm"]), c)
    return m


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ce_chunk", [None, 8])
def test_train_step_with_ctx_matches_the_jitted_reference(name, ce_chunk):
    """The plain loss and the chunked one (the reference's
    ``_encode_ctx`` then ``lm_fwd`` to the final hidden states)."""
    m = _step_case(name, ce_chunk=ce_chunk)
    assert float(m["aux"]) == 0.0 and float(m["ce"]) == float(m["loss"])


def test_accumulated_train_step_splits_the_context():
    """Two micro-batches of 2 rows: the context is split with the tokens."""
    m = _step_case(NAMES[1], accum_steps=2)
    assert set(m) == {"loss", "grad_norm", "lr"}


@pytest.mark.parametrize("name", NAMES)
def test_remat_with_ctx_changes_no_bit(name):
    """``remat`` carries the context into each checkpointed layer: the
    loss and every gradient (the encoder's and ``ctx_proj``'s, reached
    through the recomputed cross layers) equal the stored-activation
    run's bit for bit."""
    _, cfg, _, model = _models(name)
    _, batch = _batch(cfg)
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, _ = ts.make_loss_fn(cfg, remat=remat)(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    names = [n for n, _ in model.named_parameters()]
    reach = ("encoder.layers.0.attn.wq" if cfg.encoder is not None
             else "ctx_proj")
    assert out[1][1][names.index(reach)].abs().max() > 0


# ---------------------------------------------------------------------------
# checkpoints and the driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_checkpoint_bytes_equal_the_reference(name, state_dtype, tmp_path):
    """The reference's init with its zero AdamW state, carried across:
    the same keys (``0/encoder/...`` before ``0/lm/...``, the encoder's
    layers stacked), dtypes and bytes; and the port reads the file back
    into a model and state equal to what it wrote."""
    _, cfg, params, model = _models(name)
    state = jopt.adamw_init(params, jopt.OptConfig(state_dtype=state_dtype))
    pstate = opt.adamw_init(dict(model.named_parameters()),
                            opt.OptConfig(state_dtype=state_dtype))
    meta = {"step": 3, "arch": name}
    ref = jck.save(tmp_path / "j", (params, state), step=3, meta=meta)
    flat = ck.lm_state_to_jax(model, pstate, cfg)
    got = ck.save(tmp_path / "p", flat, meta, step=3)
    assert got.read_bytes() == ref.read_bytes()
    assert any(k.startswith("1/m/") for k in flat)
    other = tr.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    back, _ = ck.restore(tmp_path / "p", flat)
    st2 = ck.lm_state_from_jax(back, other, cfg)
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), n
    again = ck.lm_state_to_jax(other, st2, cfg)
    assert list(again) == list(flat)
    assert all(torch.equal(flat[k], again[k]) for k in flat)


def _jax_like():
    cfg = jmake_reduced(jconfigs.get_config(WHISPER))
    params = jtr.init_model(jax.random.PRNGKey(0), cfg)
    return params, jopt.adamw_init(params, jopt.OptConfig())


def test_jax_restores_and_resumes_a_port_whisper_checkpoint(tmp_path):
    """``repro_torch.launch.train`` on reduced whisper (a zero context of
    16 frames): its step-4 file restores in the reference's
    ``ckpt.restore`` bit for bit, and the reference's driver resumes it to
    the port's own losses of steps 5-8 within 1e-5."""
    full = lt.main(ARGS + ["--steps", "8", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "a")])
    lt.main(ARGS + ["--steps", "4", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "b")])
    path = tmp_path / "b" / WHISPER
    (params, state), meta = jck.restore(path, _jax_like())
    assert meta == {"step": 4, "arch": WHISPER}
    flat = ck.load_flat(path / "step_00000004.ckpt")
    ref = jck._flatten((params, state))
    assert list(flat) == list(ref)
    assert any(k.startswith("0/encoder/blocks/0/attn/") for k in ref)
    for key, a in ref.items():
        assert a.dtype == flat[key].dtype and np.array_equal(a, flat[key])
    losses = jlt.main(ARGS + ["--steps", "8", "--resume",
                              "--ckpt-dir", str(tmp_path / "b")])
    np.testing.assert_allclose(losses, full[4:], rtol=LOSS_RTOL)


def test_port_resumes_a_jax_whisper_checkpoint(tmp_path):
    """The reference's driver writes step 4; the port resumes it to step 8
    with the reference's uninterrupted losses within 1e-5."""
    full = jlt.main(ARGS + ["--steps", "8", "--ckpt-dir",
                            str(tmp_path / "a")])
    jlt.main(ARGS + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    shutil.copytree(tmp_path / "b", tmp_path / "c", symlinks=True)
    losses = lt.main(ARGS + ["--steps", "8", "--resume", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "c")])
    assert len(losses) == 4
    np.testing.assert_allclose(losses, full[4:], rtol=LOSS_RTOL)
    _, meta = jck.restore(tmp_path / "c" / WHISPER, _jax_like())
    assert meta == {"step": 8, "arch": WHISPER}


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where CUDA is absent")
    cfg = configs.make_reduced(configs.get_config(WHISPER))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.main(ARGS + ["--steps", "1"])
