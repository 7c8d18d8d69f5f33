"""The port's LM training (``repro_torch.training.{optimizer,train_step,
fault}`` and the gradients of its two LM kernels) against the JAX package
on the CPU, in fp32.  Inputs come from numpy with a seed; the reduced
models carry the reference's weights (``lm_params_from_jax``, random
non-zero norm scales and RG-LRU biases).

Tolerances, each with its reason:

* scalars of the schedule and the bias corrections: within ``SCALAR_ULPS``
  (2) fp32 spacings of the reference's jitted value (XLA may multiply by
  a reciprocal where the port divides, and its ``pow``/``cos`` differ in
  the last bit);
* the global norm, losses and CE: 1e-6 relative for one sum over fixed
  inputs, 1e-5 for a whole model's loss and gradient norm (sums in
  another order);
* AdamW alone on identical inputs: parameters within ``ADAM_SPACINGS``
  (4) spacings of max(|p|, |p'|) (p − u may cancel; read 2); fp32 moments
  within ``MOMENT_SPACINGS`` (8) spacings of the largest of the two
  results and the two terms b·m and (1 − b)·g (the clip scale comes from
  a norm summed in another order, so the clipped gradient is a few ulps
  off and its square twice that; the terms may cancel; read 5); bf16
  moments within one bf16 spacing (read 0); log8 moments: at most
  ``LOG8_FLIPS`` of the codes ±1 (a moment one ulp off crosses a rounding
  boundary; read 0), the row scales within ``MOMENT_SPACINGS`` spacings;
* parameters after a train step: the gradients differ from the
  reference's by up to ``GRAD_RTOL`` (1e-5) of their tensor's largest
  (sums in another order; read 2.7e-6), and Adam's first update
  lr·g/(|g| + eps) turns a gradient error Δg into lr·eps·Δg/(|g| + eps)²,
  large only where |g| is near eps.  So each element is held within
  ``STEP_SPACINGS`` (4) spacings of its tensor's largest |p| plus that
  propagated error (at most 2·lr), g the port's clipped gradient.
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
from repro.kernels.rglru import ref as jrglru_ref
from repro.models import transformer as jtr
from repro.training import fault as jfault
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import EncoderConfig
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rglru.ops import RGLRUScan, rglru_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import transformer as tr
from repro_torch.training import fault
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training.checkpoint import lm_leaf_ranks, lm_params_from_jax

torch.set_num_threads(1)

DENSE = ("gemma2-27b", "granite-8b", "qwen3-4b", "recurrentgemma-9b",
         "stablelm-1.6b")
NAMES = DENSE + ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
SCALAR_ULPS = 2
ADAM_SPACINGS, MOMENT_SPACINGS = 4, 8
LOG8_FLIPS = 0.01
STEP_SPACINGS, GRAD_RTOL = 4, 1e-5
LOSS_RTOL, CE_RTOL = 1e-5, 1e-6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _spacing(x) -> np.ndarray:
    """fp32 spacing at |x| (the smallest normal's where x is 0)."""
    return np.spacing(np.maximum(np.abs(np.asarray(x, np.float32)),
                                 np.finfo(np.float32).tiny))


@functools.lru_cache(maxsize=None)
def _reference(name, seed=0):
    """The reduced configs and the reference's parameters (immutable, so
    shared across tests) with random non-zero norm scales and biases."""
    jcfg = jmake_reduced(jconfigs.get_config(name))
    cfg = configs.make_reduced(configs.get_config(name))
    params = jtr.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    keys = ("norm", "b_a", "b_i", "conv_b")
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if any(k in jax.tree_util.keystr(path) for k in keys)
                         else x),
        params)
    return jcfg, cfg, params


def _models(name, seed=0):
    """The reference's configs and parameters, and a fresh port model
    carrying them."""
    jcfg, cfg, params = _reference(name, seed)
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return jcfg, cfg, params, model


def _batch(cfg, rows=4, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _unstacked(tree, cfg):
    return lm_params_from_jax(jax.tree.map(np.asarray, tree), cfg)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 55, 99, 100, 150])
def test_schedule_matches_the_jitted_reference(step):
    """Warm-up (0-9), its end, the cosine's middle and end, past it."""
    c = opt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jc = jopt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    ref = float(jax.jit(lambda s: jopt.schedule(jc, s))(jnp.int32(step)))
    got = opt.schedule(c, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= SCALAR_ULPS * _spacing(ref)
    eager = float(jopt.schedule(jc, jnp.int32(step)))
    assert abs(float(got) - eager) <= SCALAR_ULPS * _spacing(eager)


def test_lr_schedule_shape():
    """The reference's own case (``tests/test_training.py``)."""
    c = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(opt.schedule(c, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert lrs[-1] < 0.2
    assert min(lrs) >= 0.1 * 1.0 - 1e-6


@pytest.mark.parametrize("count", [1, 2, 3, 50, 1000])
def test_bias_corrections_match_the_jitted_reference(count):
    for b in (0.9, 0.95):
        ref = float(jax.jit(lambda n: 1 - b ** n.astype(jnp.float32))(
            jnp.int32(count)))
        got = float(opt.bias_correction(b, torch.tensor(float(count))))
        assert abs(got - ref) <= SCALAR_ULPS * _spacing(ref)


def test_grad_clip():
    """The reference's own case."""
    clipped, norm = opt.clip_by_global_norm({"a": torch.full((4,), 100.0)},
                                            1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4
    assert float(norm) == pytest.approx(200.0)


@pytest.mark.parametrize("scale", [0.01, 30.0])
def test_clip_by_global_norm_matches_reference(scale):
    """Under the threshold (no clip) and over it; bf16 gradients come back
    fp32, as in the reference."""
    rng = np.random.default_rng(2)
    grads = {"a": rng.normal(size=(4, 8)), "b": rng.normal(size=(16,)),
             "c": rng.normal(size=(2, 3, 5))}
    grads = {k: (v * scale).astype(np.float32) for k, v in grads.items()}
    ref_c, ref_n = jax.jit(lambda g: jopt.clip_by_global_norm(g, 1.0))(
        {k: jnp.asarray(v) for k, v in grads.items()})
    got_c, got_n = opt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    assert abs(float(got_n) / float(ref_n) - 1) <= CE_RTOL
    for k in grads:
        assert got_c[k].dtype == torch.float32
        np.testing.assert_allclose(got_c[k].numpy(), np.asarray(ref_c[k]),
                                   rtol=CE_RTOL, atol=0)
    half, _ = opt.clip_by_global_norm(
        {"a": torch.from_numpy(grads["a"]).to(torch.bfloat16)}, 1.0)
    assert half["a"].dtype == torch.float32


def _adam_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 8), "t": (2, 3, 4), "b": (8,), "big": (3, 40)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, size=s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_update_matches_the_jitted_reference(state_dtype):
    """Three steps on identical parameters and gradients (rank 1, 2 and 3;
    magnitudes over six decades, so some elements sit near eps): the
    parameters, moments, count, rate and norm after each."""
    kw = dict(OPT, weight_decay=0.1, grad_clip=1.0, state_dtype=state_dtype)
    c, jc = opt.OptConfig(**kw), jopt.OptConfig(**kw)
    params, grads = _adam_inputs(3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.adamw_init(jp, jc)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.adamw_init(pp, c)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jc))
    flips = codes = 0
    for g in grads:
        prev = jstate
        clipped, _ = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        jp, jstate, jm = upd(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             jstate)
        _, state, m = opt.adamw_update(
            pp, {k: torch.from_numpy(v) for k, v in g.items()}, state, c)
        assert int(state["count"]) == int(jstate["count"])
        assert state["count"].dtype == torch.int32
        assert abs(float(m["lr"]) - float(jm["lr"])) <= (
            SCALAR_ULPS * _spacing(float(jm["lr"])))
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= (
            CE_RTOL)
        for k in params:
            a, b = pp[k].numpy(), np.asarray(jp[k])
            tol = ADAM_SPACINGS * _spacing(np.maximum(np.abs(a), np.abs(b)))
            assert (np.abs(a - b) <= tol).all(), k
            gc = np.asarray(clipped[k])
            for mom, beta, term in (("m", c.b1, np.abs(gc)),
                                    ("v", c.b2, gc * gc)):
                got, ref = state[mom][k], jstate[mom][k]
                if state_dtype == "int8":
                    q, jq = got["q"].numpy().astype(int), np.asarray(ref["q"])
                    assert got["q"].dtype == torch.int8
                    assert np.abs(q - jq).max() <= 1
                    flips += int((q != jq).sum())
                    codes += q.size
                    s, js = got["s"].numpy(), np.asarray(ref["s"])
                    assert s.shape == js.shape
                    assert (np.abs(s - js) <= MOMENT_SPACINGS
                            * _spacing(np.maximum(s, js))).all()
                elif state_dtype == "bf16":
                    assert got.dtype == torch.bfloat16
                    a32 = got.float().numpy()
                    b32 = np.asarray(ref.astype(jnp.float32))
                    # one bf16 spacing: 2^-7 of the binade's base
                    tol = np.abs(np.maximum(np.abs(a32), np.abs(b32))) * 2 ** -7
                    assert (np.abs(a32 - b32) <= tol).all()
                else:
                    a32, b32 = got.numpy(), np.asarray(ref)
                    mag = np.maximum.reduce([
                        np.abs(a32), np.abs(b32),
                        beta * np.abs(np.asarray(prev[mom][k])),
                        (1 - beta) * term])
                    assert (np.abs(a32 - b32)
                            <= MOMENT_SPACINGS * _spacing(mag)).all()
    assert flips <= LOG8_FLIPS * max(codes, 1)


def test_none_gradient_is_a_zero_gradient():
    c = opt.OptConfig(**OPT)
    params, grads = _adam_inputs(4)
    a = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    b = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    g = {k: torch.from_numpy(v) for k, v in grads[0].items()}
    _, sa, ma = opt.adamw_update(a, dict(g, b=torch.zeros(8)),
                                 opt.adamw_init(a, c), c)
    _, sb, mb = opt.adamw_update(b, dict(g, b=None), opt.adamw_init(b, c), c)
    for k in params:
        assert torch.equal(a[k], b[k]) and torch.equal(sa["v"][k], sb["v"][k])
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])


def test_weight_decay_follows_the_reference_stacked_ranks():
    """``recurrentgemma-9b``: its pattern (RG-LRU, RG-LRU, attention) is
    stacked in the reference, so every 1-D leaf there (norms, q/k norms
    absent, ``conv_b``, ``b_a``, ``b_i``, ``lam``) has rank 2 and is
    decayed; the two remainder RG-LRU layers' and ``final_norm`` are rank
    1 and are not.  One update with zero gradients is the decay alone:
    the port's parameters equal the reference's."""
    jcfg, cfg, params, model = _models("recurrentgemma-9b")
    ranks = lm_leaf_ranks(dict(model.named_parameters()), cfg)
    n_body = cfg.n_repeats * len(cfg.pattern)
    assert n_body == 3 and len(cfg.remainder) == 2
    for name, p in model.named_parameters():
        layer = int(name.split(".")[1]) if name.startswith("layers.") else None
        want = p.dim() + int(layer is not None and layer < n_body)
        assert ranks[name] == want, name
    assert ranks["layers.0.rglru.lam"] == 2 and ranks["layers.3.rglru.lam"] == 1
    assert ranks["layers.1.norm_mix"] == 2 and ranks["layers.4.norm_mix"] == 1
    assert ranks["final_norm"] == 1 and ranks["embed"] == 2
    # the reference's own ranks, leaf by leaf
    jranks = _unstacked(jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape[:1], x.ndim)
        if "blocks" in jax.tree_util.keystr(path) else np.array(x.ndim),
        params), cfg)
    assert {k: int(v) for k, v in jranks.items()} == ranks

    kw = dict(OPT, weight_decay=0.1)
    jc, c = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jp, _, _ = jax.jit(lambda p, g: jopt.adamw_update(
        p, g, jopt.adamw_init(p, jc), jc))(params, zeros)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pp = dict(model.named_parameters())
    with torch.no_grad():
        opt.adamw_update(pp, {n: None for n in pp}, opt.adamw_init(pp, c), c,
                         ranks=ranks)
    ref = _unstacked(jp, cfg)
    for name, p in pp.items():
        tol = SCALAR_ULPS * _spacing(np.abs(ref[name].numpy()))
        assert (np.abs(p.detach().numpy() - ref[name].numpy()) <= tol).all()
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (ranks[name] >= 2), name


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    ref = float(jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = ts.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) / ref - 1) <= CE_RTOL
    half = ts.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(labels))
    assert half.dtype == torch.float32


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_chunked_ce_matches_reference_and_the_full_ce(tied, softcap):
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 12, 16)).astype(np.float32)
    w = (rng.normal(size=(40, 16) if tied else (16, 40)) * 0.5).astype(
        np.float32)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    ref = float(jts.chunked_ce(jnp.asarray(h), jnp.asarray(w),
                               jnp.asarray(labels), transpose_w=tied,
                               softcap=softcap, chunk=4))
    ht, wt, lt = (torch.from_numpy(x) for x in (h, w, labels))
    got = ts.chunked_ce(ht, wt, lt, transpose_w=tied, softcap=softcap,
                        chunk=4)
    assert abs(float(got) / ref - 1) <= CE_RTOL
    logits = ht @ (wt.t() if tied else wt)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    assert abs(float(got) / float(ts.cross_entropy(logits, lt)) - 1) <= (
        CE_RTOL)
    for chunk in (1, 12):
        other = ts.chunked_ce(ht, wt, lt, transpose_w=tied, softcap=softcap,
                              chunk=chunk)
        assert abs(float(other) / float(got) - 1) <= CE_RTOL
    with pytest.raises(ValueError, match="multiple"):
        ts.chunked_ce(ht, wt, lt, transpose_w=tied, softcap=softcap, chunk=5)


# ---------------------------------------------------------------------------
# one train step of each reduced configuration
# ---------------------------------------------------------------------------


def _port_grads(model, cfg, batch, ce_chunk):
    """The port's gradient of the loss, for the tolerance of a step (zero
    for a parameter the loss does not reach: the MTP head under the
    chunked loss)."""
    model.requires_grad_(True)
    loss, _ = ts.make_loss_fn(cfg, remat=False, ce_chunk=ce_chunk)(model,
                                                                   batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    missing = {n for n, g in zip(names, grads) if g is None}
    assert missing <= {"mtp_norm", "mtp_proj"} and (
        not missing or ce_chunk), missing
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def _check_params_after_step(model, cfg, jparams, grads, grad_norm, c):
    """See the module docstring: spacings of the tensor's largest |p| plus
    the gradient error Adam's first update propagates."""
    ref = _unstacked(jparams, cfg)
    clip = min(1.0, c.grad_clip / (grad_norm + 1e-9))
    for name, p in model.named_parameters():
        a, b = p.detach().numpy(), ref[name].numpy()
        g = np.abs(grads[name].numpy()) * clip
        dg = GRAD_RTOL * g.max()
        tol = (STEP_SPACINGS * _spacing(np.abs(b).max())
               + np.minimum(2 * c.lr, c.lr * c.eps * dg / (g + c.eps) ** 2))
        assert (np.abs(a - b) <= tol).all(), (
            name, float((np.abs(a - b) / tol).max()))


def _step_case(name, state_dtype="fp32", accum_steps=1, ce_chunk=None):
    jcfg, cfg, params, model = _models(name)
    jc = jopt.OptConfig(state_dtype=state_dtype, **OPT)
    c = opt.OptConfig(state_dtype=state_dtype, **OPT)
    jbatch, batch = _batch(cfg)
    jstep = jax.jit(jts.make_train_step(jcfg, jc, remat=False,
                                        ce_chunk=ce_chunk,
                                        accum_steps=accum_steps))
    jp, _, jm = jstep(params, jopt.adamw_init(params, jc), jbatch)
    grads = _port_grads(model, cfg, batch, ce_chunk)
    step = ts.make_train_step(cfg, c, remat=False, ce_chunk=ce_chunk,
                              accum_steps=accum_steps)
    state = opt.adamw_init(dict(model.named_parameters()), c)
    model2, state, m = step(model, state, batch)
    assert model2 is model and int(state["count"]) == 1
    assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= LOSS_RTOL
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= (
        LOSS_RTOL)
    assert abs(float(m["lr"]) - float(jm["lr"])) <= (
        SCALAR_ULPS * _spacing(float(jm["lr"])))
    _check_params_after_step(model, cfg, jp, grads, float(m["grad_norm"]), c)
    return m


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_the_jitted_reference(name):
    """Each reduced configuration; for the MoE models the loss holds the
    aux term (and deepseek's the MTP head's CE), within ``LOSS_RTOL`` of
    the reference's as a whole."""
    m = _step_case(name)
    assert set(m) == {"loss", "grad_norm", "lr", "ce", "aux"}
    if name in DENSE:
        assert float(m["aux"]) == 0.0 and float(m["ce"]) == float(m["loss"])
    else:
        assert float(m["aux"]) > 0.0
        assert float(m["loss"]) > float(m["ce"]) + ts.AUX_WEIGHT * float(
            m["aux"]) * (1 - 1e-6)


@pytest.mark.parametrize("name", ["granite-8b", "stablelm-1.6b"])
@pytest.mark.parametrize("state_dtype", ["bf16", "int8"])
def test_train_step_with_low_precision_states(name, state_dtype):
    _step_case(name, state_dtype)


@pytest.mark.parametrize("name", ["qwen3-4b", "recurrentgemma-9b"])
def test_accumulated_train_step_matches_the_jitted_reference(name):
    """Two micro-batches of 2 rows, gradients summed in fp32."""
    m = _step_case(name, accum_steps=2)
    assert set(m) == {"loss", "grad_norm", "lr"}


@pytest.mark.parametrize("name", ["gemma2-27b", "stablelm-1.6b",
                                  "deepseek-v3-671b"])
def test_chunked_ce_train_step_matches_the_jitted_reference(name):
    """The chunked loss over the tied (gemma2, logit softcap 30) and the
    untied head (stablelm, deepseek), through the final hidden states;
    deepseek's MTP head is left out of it, as the reference leaves it out
    (the loss is the CE and the aux term alone, and the head gets a zero
    gradient)."""
    m = _step_case(name, ce_chunk=8)
    if name == "deepseek-v3-671b":
        want = float(m["ce"]) + ts.AUX_WEIGHT * float(m["aux"])
        assert abs(float(m["loss"]) / want - 1) <= CE_RTOL


def test_train_step_refuses_what_the_port_lacks():
    cfg = configs.make_reduced(configs.get_config("qwen3-4b"))
    with pytest.raises(NotImplementedError, match="encoder"):
        ts.make_loss_fn(cfg.replace(encoder=EncoderConfig()))
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    _, batch = _batch(cfg)
    with pytest.raises(NotImplementedError, match="10\\(c\\)"):
        ts.make_loss_fn(cfg)(model, dict(batch, ctx=torch.zeros(4, 2, 8)))


def test_prefill_and_serve_steps_equal_the_model():
    _, cfg, _, model = _models("granite-8b")
    _, batch = _batch(cfg, rows=2, seq=5)
    model.requires_grad_(True)  # as after training: the steps take none
    logits = ts.make_prefill_step(cfg)(model, batch)
    assert logits.grad_fn is None
    assert torch.equal(logits, tr.model_fwd(model, cfg, batch))
    serve = ts.make_serve_step(cfg)
    cache = tr.init_model_cache(cfg, 2, 5, device="cpu")
    for t in range(5):
        out, cache = serve(model, cache, batch["tokens"][:, t:t + 1], t)
        assert out.grad_fn is None
        assert _rel(out[:, 0].numpy(), logits[:, t].numpy()) <= 1e-5
    with pytest.raises(NotImplementedError, match="context"):
        serve(model, cache, batch["tokens"][:, :1], 0, ctx=torch.zeros(1))


# ---------------------------------------------------------------------------
# the kernels' autograd.Functions
# ---------------------------------------------------------------------------

FLASH_CASES = [
    dict(causal=True, window=None, softcap=None, kv_len=None),
    dict(causal=True, window=2, softcap=None, kv_len=None),
    dict(causal=True, window=None, softcap=0.5, kv_len=None),
    dict(causal=False, window=None, softcap=None, kv_len=3),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["causal", "window", "softcap", "kv_len"])
def test_flash_attention_function_passes_gradcheck(case):
    """fp64, GQA (4 query heads over 2 KV heads), S = 4 over T = 5."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(1, 4, 4, 3, generator=g, dtype=torch.float64)
    k = torch.randn(1, 2, 5, 3, generator=g, dtype=torch.float64)
    v = torch.randn(1, 2, 5, 3, generator=g, dtype=torch.float64)
    kv_len = case["kv_len"] if case["kv_len"] is not None else 5
    ins = tuple(x.requires_grad_() for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda *t: FlashAttention.apply(*t, case["causal"], case["window"],
                                        case["softcap"], kv_len), ins)


def test_rglru_function_passes_gradcheck():
    g = torch.Generator().manual_seed(8)
    a = torch.rand(2, 5, 3, generator=g, dtype=torch.float64)
    b = torch.randn(2, 5, 3, generator=g, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        RGLRUScan.apply, (a.requires_grad_(), b.requires_grad_()))


def test_kernel_gradients_equal_the_plain_versions_under_autograd():
    """fp32: the wrappers' gradients (through the Functions) equal those
    of the plain versions differentiated directly, bit for bit; the
    recurrence's also match the reference's plain scan under ``jax.vjp``
    within 1e-6."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, 4, 6, 8, generator=g)
    k, v = (torch.randn(2, 2, 6, 8, generator=g) for _ in range(2))
    w = torch.randn(2, 4, 6, 8, generator=g)
    kw = dict(causal=True, window=3, softcap=20.0)
    grads = []
    for fn in (flash_attention, flash_attention_ref):
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*ins, **kw)
        grads.append(torch.autograd.grad((out * w).sum(), ins))
    assert all(torch.equal(a, b) for a, b in zip(*grads))

    a = torch.rand(2, 7, 5, generator=g)
    b = torch.randn(2, 7, 5, generator=g)
    w = torch.randn(2, 7, 5, generator=g)
    grads = []
    for fn in (rglru_scan, rglru_scan_ref):
        ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
        grads.append(torch.autograd.grad((fn(*ins) * w).sum(), ins))
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    _, vjp = jax.vjp(jrglru_ref.rglru_scan_ref, jnp.asarray(a.numpy()),
                     jnp.asarray(b.numpy()))
    for got, ref in zip(grads[0], vjp(jnp.asarray(w.numpy()))):
        assert _rel(got.numpy(), ref) <= CE_RTOL


def test_the_functions_record_history_only_when_a_gradient_is_needed():
    q = torch.randn(1, 2, 3, 4)
    a = torch.rand(1, 3, 2)
    assert flash_attention(q, q, q).grad_fn is None
    assert rglru_scan(a, a).grad_fn is None
    qg, ag = q.clone().requires_grad_(), a.clone().requires_grad_()
    assert type(flash_attention(qg, q, q).grad_fn).__name__ == (
        "FlashAttentionBackward")
    assert type(rglru_scan(a, ag).grad_fn).__name__ == "RGLRUScanBackward"
    with torch.no_grad():
        assert flash_attention(qg, qg, qg).grad_fn is None
        assert rglru_scan(ag, ag).grad_fn is None
    # the forward through the Function equals the plain call
    assert torch.equal(flash_attention(qg, q, q).detach(),
                       flash_attention(q, q, q))


# ---------------------------------------------------------------------------
# fault tolerance (copies of tests/test_training.py's cases, and the
# functions against the reference's)
# ---------------------------------------------------------------------------


def test_heartbeat_detects_dead():
    hb = fault.HeartbeatMonitor(timeout_s=5.0)
    hb.beat("w0", now=100.0)
    hb.beat("w1", now=100.0)
    hb.beat("w0", now=110.0)
    assert hb.dead_workers(now=111.0) == ["w1"]
    assert not hb.healthy(now=111.0)


def test_straggler_detector():
    sd = fault.StragglerDetector(factor=2.0)
    for _ in range(5):
        for w in ("w0", "w1", "w2", "w3"):
            sd.record(w, 1.0)
    for _ in range(8):
        sd.record("w3", 5.0)
    assert sd.stragglers() == ["w3"]


@pytest.mark.parametrize("n", [8, 15, 16, 17, 31, 32, 33, 100, 255, 256, 257,
                               383, 511, 512, 513, 600])
def test_elastic_plan_always_runnable(n):
    shape, axes = fault.elastic_plan(n)
    assert len(shape) == len(axes)
    assert np.prod(shape) <= n
    assert np.prod(shape) >= max(1, n // 2)  # wastes < half the fleet


def test_elastic_plan_pod_axis():
    shape, axes = fault.elastic_plan(512)
    assert axes == ("pod", "data", "model") and shape == (2, 16, 16)
    shape, axes = fault.elastic_plan(511)
    assert np.prod(shape) <= 511


def test_fault_machinery_equals_the_reference():
    for n in range(1, 601):
        for mp in (4, 16):
            assert fault.elastic_plan(n, model_parallel=mp) == (
                jfault.elastic_plan(n, model_parallel=mp))
    pair = []
    for mod in (fault, jfault):
        hb, sd = mod.HeartbeatMonitor(timeout_s=2.0), mod.StragglerDetector()
        inj = mod.FaultInjector(kill_at={3: "w1"}, slow_at={4: ("w2", 9.0)})
        for step in range(6):
            for w in ("w0", "w1", "w2"):
                if not (w == "w1" and step >= 3):
                    hb.beat(w, now=float(step))
                sd.record(w, 1.0 + 0.1 * step)
            inj.apply(step, hb, sd)
        pair.append((hb.dead_workers(now=6.0), sd.stragglers(),
                     dict(sd.ewma)))
    assert pair[0] == pair[1]
    assert pair[0][0] == ["w1"] and pair[0][1] == ["w2"]
    for cls in ("HeartbeatMonitor", "StragglerDetector", "FaultInjector"):
        names = [f.name for f in dataclasses.fields(getattr(fault, cls))]
        assert names == [f.name for f in dataclasses.fields(
            getattr(jfault, cls))], cls
