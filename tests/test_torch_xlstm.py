"""The port's xLSTM (``xlstm-1.3b``: the mLSTM and sLSTM cells of
``models/recurrent.py`` and the model around them) against the JAX package
on the CPU.  The reduced configuration (``make_reduced``): one period of 7
mLSTM layers and 1 sLSTM layer, d_model 64, 4 heads, ``rnn_width`` 64
(mLSTM heads of 16), ``conv_width`` 4, vocab 512, fp32.  Inputs come from
numpy with a seed; the reference's weights are carried across by
``lm_params_from_jax``, with random non-zero norm scales, ``gn_scale`` and
conv biases (so that no term is the identity or zero).

Tolerances, norm-wise relative (the norm of the difference over the norm
of the reference), each with its reason:

* fp32, 1e-5 (``RTOL``): both sides compute in fp32 and differ by the
  order of the sums in the products, the cumulative sums and the scans.
  A decode is held over all its steps as one tensor (with these inputs
  at most 3.85e-6 a step, 2.56e-6 over all): a head whose output nearly
  cancels comes out of the per-head group norm with its relative error
  enlarged, on both sides (the conditioning the gradients show, below).
  Each step is also held within 1e-5 of the port's own forward.
* the two forms of the mLSTM (parallel and chunkwise) within 2e-2
  (``FORMS_TOL``), as the reference's ``tests/test_models.py`` holds
  them: their stabilizers differ, so do their ``max(|.|, exp(-m))``
  floors; each port form is held to the same reference form at 1e-5.
* a bf16 model against the reference's bf16 model: see
  :func:`test_bf16_model_follows_the_reference_bf16_model`.
* the train step: as ``tests/test_torch_lm_train.py`` holds it, but the
  gradients within ``XLSTM_GRAD_RTOL`` (1e-4) of their tensor's largest:
  the mLSTM's gradients are ill-conditioned.  Scaling every weight by
  1 + 2^-23·N(0, 1) (about one fp32 ulp) moves the port's own gradients
  by up to 1.19e-4 of their tensor's largest
  (:func:`test_gradients_are_ill_conditioned`); the port's differ from
  the reference's by at most 3.8e-5 (5.3e-5 with ``mlstm_chunk`` 8).
"""
from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.launch import train as jlt
from repro.models import recurrent as jrec
from repro.models import transformer as jtr
from repro.serving import lm_relay as jlr
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.launch import train as lt
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tr
from repro_torch.serving import lm_relay
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from test_torch_lm_train import (GRAD_RTOL, LOSS_RTOL, OPT, SCALAR_ULPS,
                                 _check_params_after_step, _spacing)

torch.set_num_threads(1)

RTOL, FORMS_TOL = 1e-5, 2e-2
LOGP_RTOL = 1e-6
MARGIN_FACTOR = 10.0
NAME = "xlstm-1.3b"
JCFG = jmake_reduced(jconfigs.get_config(NAME))
CFG = configs.make_reduced(configs.get_config(NAME))
S, TOTAL, PROMPT = 3, 8, 6
ARGS = ["--arch", NAME, "--batch", "2", "--seq", "16", "--ckpt-every", "4"]
XLSTM_GRAD_RTOL = 1e-4
#: bf16, the port's layers against the reference's run one by one (each
#: op rounded to bf16, as the port runs them), with the random norm scales
#: above: 2.2x the largest reading (1.36e-2, the logits; the first layer
#: 4.0e-4, growing layer by layer from rounding flips in the norms' fp32
#: means; without the random scales the 7 mLSTM layers read 0)
BF16_LAYER_RTOL = 3e-2
#: bf16, the port's forward and decode against the reference's compiled
#: ``model_fwd`` and ``decode_step``, as a multiple of the distance between
#: the reference's own two executions of the forward (its layers one by
#: one, and its compiled scan, in which XLA keeps fused intermediates in
#: fp32; read 6.90e-2 on the logits): the port read 1.03 (forward) and
#: 1.08 (decode) of it
BF16_REF_FACTOR = 1.5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _reference(seed=0, dtype="float32"):
    """The reference's parameters (immutable, so shared across tests)
    with random non-zero norm scales, ``gn_scale`` and conv biases."""
    jcfg = JCFG.replace(dtype=dtype)
    params = jtr.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    keys = ("norm", "gn_scale", "conv_b")
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if any(k in jax.tree_util.keystr(path) for k in keys)
                         else x),
        params)


def _port(params, cfg=CFG) -> tr.LM:
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(ck.lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return model


def _tokens(seed, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jl, js = _reference(0), _reference(1)
    return dict(jl=jl, js=js, large=_port(jl), small=_port(js))


# ---------------------------------------------------------------------------
# the configuration and the weights
# ---------------------------------------------------------------------------


def test_config_is_the_reference_period():
    """48 layers, 6 periods of 7 mLSTM (no MLP) and 1 sLSTM (a dense
    GeGLU MLP); reduced to one period."""
    full = configs.get_config(NAME)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(NAME))
    specs = tr.layer_specs(full)
    assert len(specs) == 48 and full.n_repeats == 6
    assert [s.mixer for s in specs[:8]] == ["mlstm"] * 7 + ["slstm"]
    assert [s.mlp for s in specs[:8]] == ["none"] * 7 + ["dense"]
    assert (full.d_model, full.n_heads, full.rnn_width, full.vocab_size,
            full.padded_vocab, full.tie_embeddings) == (
                2048, 4, 4096, 50304, 50432, True)
    assert len(tr.layer_specs(CFG)) == 8 and CFG.rnn_width == 64


def test_init_matches_the_reference_layout():
    """Every leaf of the reference's tree, name, shape and dtype, in fp32
    and bf16: the gate weights and biases (``w_if``, ``b_if``,
    ``w_gates``, ``r_gates``, ``b_gates``) stay fp32 in a bf16 model; no
    ``norm_mlp`` on an mLSTM layer (``mlp="none"``)."""
    for dtype in ("float32", "bfloat16"):
        cfg = CFG.replace(dtype=dtype)
        shapes = jax.eval_shape(lambda: jtr.init_model(
            jax.random.PRNGKey(0), JCFG.replace(dtype=dtype)))
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
        want = {n: (tuple(a.shape), str(a.dtype)) for n, a in
                ck.model_tree_from_jax(zeros, cfg).items()}
        model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        got = {n: (tuple(p.shape), str(p.dtype)[6:])
               for n, p in model.named_parameters()}
        assert got == want
    assert not hasattr(model.layers[0], "norm_mlp")
    assert model.layers[7].slstm.r_gates.dtype == torch.float32
    assert model.layers[0].mlstm.w_if.dtype == torch.float32
    assert model.layers[0].mlstm.w_up.dtype == torch.bfloat16


def test_init_draws_the_reference_distributions():
    """The port's own init (its bits differ from ``jax.random``'s): the
    forget-gate biases linspace(3, 6), the head projections N(0, 1/DH),
    the conv N(0, 0.1²), zero ``gn_scale`` and conv bias; at d 256, 4
    heads, ``rnn_width`` 512 (mLSTM heads of 128, sLSTM heads of 64)."""
    cfg = CFG.replace(d_model=256, rnn_width=512, d_ff=512)
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    m, s = model.layers[0].mlstm, model.layers[7].slstm
    np.testing.assert_allclose(_np(m.b_if), [0, 0, 0, 0, 3, 4, 5, 6],
                               rtol=1e-6)
    assert torch.equal(s.b_gates[:256], torch.zeros(256))
    assert float(s.b_gates[256]) == 3.0 and float(s.b_gates[511]) == 6.0
    assert abs(float(m.wq_h.std()) * np.sqrt(128) - 1) < 0.02
    assert abs(float(s.r_gates.std()) * np.sqrt(64) - 1) < 0.02
    assert abs(float(m.conv_w.std()) / 0.1 - 1) < 0.1
    assert not m.gn_scale.any() and not m.conv_b.any()


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cell_inputs(seed, b=2, s=24, nh=4, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    k = k / np.float32(4.0)
    i_raw = rng.normal(size=(b, s, nh)).astype(np.float32)
    f_raw = (rng.normal(size=(b, s, nh)) + 3.0).astype(np.float32)
    log_f = np.array(jax.nn.log_sigmoid(jnp.asarray(f_raw)))
    return q, k, v, i_raw, log_f


def test_log_sigmoid_is_the_reference():
    """``-softplus(-x)`` with ``logaddexp``, as ``jax.nn``: within two
    fp32 spacings (13 of 1,001 values differ, by at most 2 spacings at x =
    0.64: XLA's ``exp`` and ``log1p`` round their last bit differently
    from torch's)."""
    x = np.linspace(-40, 40, 1001).astype(np.float32)
    out = rec.log_sigmoid(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    assert (np.abs(out - ref) <= 2 * _spacing(ref)).all()


def test_mlstm_parallel_matches_reference():
    arrs = _cell_inputs(3, s=13)
    ref = jrec.mlstm_parallel(*map(jnp.asarray, arrs))
    out = rec.mlstm_parallel(*map(torch.from_numpy, arrs))
    assert out.shape == ref.shape == (2, 13, 4, 16)
    assert _rel(out.numpy(), ref) <= RTOL


@pytest.mark.parametrize("chunk", [4, 6, 8, 12])
def test_mlstm_chunkwise_matches_reference(chunk):
    arrs = _cell_inputs(4)
    ref = jrec.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk)
    out = rec.mlstm_chunkwise(*map(torch.from_numpy, arrs), chunk)
    assert _rel(out.numpy(), ref) <= RTOL
    # the port's two forms within the reference's own 2e-2
    par = rec.mlstm_parallel(*map(torch.from_numpy, arrs))
    assert _rel(out.numpy(), par.numpy()) <= FORMS_TOL


def _mlstm_layer(models, i=2):
    return (jax.tree.map(lambda a: a[0], models["jl"]["lm"]["blocks"][i]
                         ["mlstm"]), models["large"].layers[i].mlstm)


@pytest.mark.parametrize("chunk", [None, 8, 5, 24])
def test_mlstm_block_fwd_matches_reference(models, chunk):
    """S = 24: chunks 8 (three chunks) and, through the parallel form, 5
    (does not divide S) and 24 (S is not longer than it)."""
    jp, p = _mlstm_layer(models)
    x = np.random.default_rng(5).normal(size=(2, 24, 64)).astype(np.float32)
    ref, _ = jrec.mlstm_block_fwd(jp, JCFG, jnp.asarray(x), chunk=chunk)
    out, cache = rec.mlstm_block_fwd(p, CFG, torch.from_numpy(x),
                                     chunk=chunk)
    assert cache is None and out.shape == (2, 24, 64)
    assert _rel(out.numpy(), ref) <= RTOL
    if chunk in (5, 24):
        par, _ = rec.mlstm_block_fwd(p, CFG, torch.from_numpy(x))
        assert torch.equal(out, par)


def test_mlstm_block_decode_matches_reference_and_its_forward(models):
    """Ten one-token steps over a cache: each step's output and the new
    cache (C, n, m, conv) against the reference's, the cache updated in
    place and returned; the outputs against the block's forward."""
    jp, p = _mlstm_layer(models)
    x = np.random.default_rng(6).normal(size=(2, 10, 64)).astype(np.float32)
    jcache = jrec.init_mlstm_cache(JCFG, 2)
    cache = rec.init_mlstm_cache(CFG, 2, device="cpu")
    held = dict(cache)
    full, _ = rec.mlstm_block_fwd(p, CFG, torch.from_numpy(x))
    outs, refs = [], []
    for t in range(10):
        xt = jnp.asarray(x[:, t:t + 1])
        ref, jcache = jrec.mlstm_block_fwd(jp, JCFG, xt, cache=jcache)
        out, c2 = rec.mlstm_block_fwd(p, CFG, torch.from_numpy(x[:, t:t + 1]),
                                      cache=cache)
        assert c2 is cache and all(cache[k] is held[k] for k in held)
        for key in ("C", "n", "m", "conv"):
            assert cache[key].dtype == torch.float32
            assert _rel(cache[key].numpy(), jcache[key]) <= RTOL, (t, key)
        outs.append(out.numpy())
        refs.append(np.asarray(ref))
    assert _rel(np.concatenate(outs, 1), np.concatenate(refs, 1)) <= RTOL
    assert _rel(np.concatenate(outs, 1), full.numpy()) <= RTOL


def _slstm_layer(models):
    return (jax.tree.map(lambda a: a[0], models["jl"]["lm"]["blocks"][7]
                         ["slstm"]), models["large"].layers[7].slstm)


def test_slstm_block_scan_matches_reference(models):
    jp, p = _slstm_layer(models)
    x = np.random.default_rng(7).normal(size=(2, 17, 64)).astype(np.float32)
    ref, _ = jrec.slstm_block_fwd(jp, JCFG, jnp.asarray(x))
    out, cache = rec.slstm_block_fwd(p, CFG, torch.from_numpy(x))
    assert cache is None and _rel(out.numpy(), ref) <= RTOL


def test_slstm_block_step_matches_reference_and_the_scan(models):
    jp, p = _slstm_layer(models)
    x = np.random.default_rng(8).normal(size=(2, 10, 64)).astype(np.float32)
    jcache = jrec.init_slstm_cache(JCFG, 2)
    cache = rec.init_slstm_cache(CFG, 2, device="cpu")
    scan, _ = rec.slstm_block_fwd(p, CFG, torch.from_numpy(x))
    outs = []
    for t in range(10):
        xt = jnp.asarray(x[:, t:t + 1])
        ref, jcache = jrec.slstm_block_fwd(jp, JCFG, xt, cache=jcache)
        out, c2 = rec.slstm_block_fwd(p, CFG, torch.from_numpy(x[:, t:t + 1]),
                                      cache=cache)
        assert c2 is cache and _rel(out.numpy(), ref) <= RTOL, t
        for key in ("h", "c", "n", "m"):
            assert _rel(cache[key].numpy(), jcache[key]) <= RTOL, (t, key)
        outs.append(out)
    assert _rel(torch.cat(outs, 1).numpy(), scan.numpy()) <= RTOL


@pytest.mark.parametrize("which", ["mlstm", "slstm", "model"])
def test_init_caches_equal_the_reference_bit_for_bit(which):
    """``init_mlstm_cache``, ``init_slstm_cache`` (m at -1e30, n at 1e-6)
    and the model's cache (layer 8r + j of the port is the reference's
    pattern slot j, repeat r), in fp32 and bf16 (the conv cache in the
    model's dtype)."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = JCFG.replace(dtype=dtype), CFG.replace(dtype=dtype)
        if which == "model":
            jcfg, cfg = (c.replace(n_layers=16) for c in (jcfg, cfg))
            jc = jtr.init_model_cache(jcfg, 3, 5)
            pairs = [(jax.tree.map(lambda a, r=r: a[r], jc["blocks"][j]),
                      tr.init_model_cache(cfg, 3, 5, device="cpu")
                      ["layers"][8 * r + j])
                     for r in range(2) for j in range(8)]
        else:
            fn = {"mlstm": (jrec.init_mlstm_cache, rec.init_mlstm_cache),
                  "slstm": (jrec.init_slstm_cache, rec.init_slstm_cache)}
            jfn, fn = fn[which]
            pairs = [(jfn(jcfg, 3), fn(cfg, 3, device="cpu"))]
        for ref, got in pairs:
            assert set(ref) == set(got)
            for key, a in ref.items():
                t = got[key]
                assert str(t.dtype)[6:] == str(a.dtype), (key, t.dtype)
                assert np.array_equal(_np(t), np.asarray(a, np.float32)), key


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 8])
def test_model_fwd_matches_reference(models, chunk):
    toks = _tokens(9, (2, 32))
    ref, _, _ = jtr.model_fwd(models["jl"], JCFG,
                              {"tokens": jnp.asarray(toks)}, mlstm_chunk=chunk)
    out = tr.model_fwd(models["large"], CFG,
                       {"tokens": torch.from_numpy(toks)}, mlstm_chunk=chunk)
    assert out.shape == ref.shape == (2, 32, CFG.padded_vocab)
    assert _rel(out.numpy(), ref) <= RTOL


def test_port_chunkwise_within_the_reference_tolerance_of_parallel(models):
    """The port's own two forms at S = 32, chunk 8, at the reference's
    2e-2 (``tests/test_models.py::test_mlstm_chunkwise_matches_parallel``);
    the prefill step takes the chunk too."""
    toks = torch.from_numpy(_tokens(10, (2, 32)))
    par = tr.model_fwd(models["large"], CFG, {"tokens": toks})
    chunked = ts.make_prefill_step(CFG, mlstm_chunk=8)(models["large"],
                                                       {"tokens": toks})
    assert not torch.equal(par, chunked)
    assert _rel(chunked.numpy(), par.numpy()) <= FORMS_TOL


def test_decode_matches_reference_and_the_forward(models):
    """12 one-token steps: the logits over all steps within 1e-5 of the
    reference's decode (see the module docstring), each step within 1e-5
    of the port's forward at that position; every layer's state against
    the reference's at the end."""
    jl, large = models["jl"], models["large"]
    n = 12
    toks = _tokens(11, (2, n))
    jcache = jtr.init_model_cache(JCFG, 2, n)
    cache = tr.init_model_cache(CFG, 2, n, device="cpu")
    full = tr.model_fwd(large, CFG, {"tokens": torch.from_numpy(toks)})
    outs, refs = [], []
    for t in range(n):
        tok = toks[:, t:t + 1]
        ref, jcache = jtr.decode_step(jl, JCFG, jcache, jnp.asarray(tok),
                                      jnp.int32(t))
        out, cache = tr.decode_step(large, CFG, cache, torch.from_numpy(tok),
                                    t)
        assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL, t
        outs.append(out.numpy())
        refs.append(np.asarray(ref))
    assert _rel(np.concatenate(outs, 1), np.concatenate(refs, 1)) <= RTOL
    for j in range(8):
        ref = jax.tree.map(lambda a: a[0], jcache["blocks"][j])
        for key, a in ref.items():
            assert _rel(cache["layers"][j][key].numpy(), a) <= RTOL, (j, key)


def _check_margins(model, params, seq: np.ndarray, first: int,
                   last: int) -> None:
    """The top-2 margin of the port's logits that chose tokens [first,
    last) of ``seq`` against the frameworks' logit difference there."""
    logits = tr.model_fwd(model, CFG, {"tokens": torch.from_numpy(seq)})
    ref, _, _ = jtr.model_fwd(params, JCFG, {"tokens": jnp.asarray(seq)})
    window = slice(first - 1, last - 1)
    out = logits[:, window, :CFG.vocab_size]
    diff = np.abs(out.numpy() - np.asarray(ref)[:, window, :CFG.vocab_size])
    top2 = torch.topk(out, 2).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    ties = np.argwhere(margin <= MARGIN_FACTOR * diff.max(-1))
    assert ties.size == 0, (f"top-2 tie at (row, step) {ties.tolist()}: "
                            f"margins {margin.tolist()}")


@pytest.fixture(scope="module")
def relay(models):
    """Both packages' relay at s = 3 of 8 new tokens on a (2, 6) prompt."""
    prompt = _tokens(12, (2, PROMPT))
    ref_seq, ref_info = jlr.relay_decode(models["jl"], JCFG, models["js"],
                                         JCFG, jnp.asarray(prompt), S, TOTAL)
    seq, info = lm_relay.relay_decode(models["large"], CFG, models["small"],
                                      CFG, prompt, S, TOTAL, device="cpu")
    return dict(prompt=prompt, ref_seq=np.asarray(ref_seq),
                ref_info=ref_info, seq=seq, info=info)


def test_relay_decode_tokens_and_info_equal_reference(models, relay):
    seq = relay["seq"].numpy()
    _check_margins(models["large"], models["jl"], seq, PROMPT, PROMPT + S)
    _check_margins(models["small"], models["js"], seq, PROMPT + S,
                   PROMPT + TOTAL)
    np.testing.assert_array_equal(seq, relay["ref_seq"])
    assert relay["info"] == dict(relay["ref_info"])
    assert relay["info"]["transfer_bytes"] == 2 * (PROMPT + S) * 4


def test_greedy_decode_equals_reference(models, relay):
    prompt = relay["prompt"]
    seq = lm_relay.greedy_decode(models["large"], CFG, prompt, TOTAL,
                                 device="cpu")
    ref = jlr.greedy_decode(models["jl"], JCFG, jnp.asarray(prompt), TOTAL)
    _check_margins(models["large"], models["jl"], seq.numpy(), PROMPT,
                   PROMPT + TOTAL)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(seq[:, :PROMPT + S].numpy(),
                                  relay["seq"][:, :PROMPT + S].numpy())


def test_sequence_logprob_matches_reference(models, relay):
    seq = relay["ref_seq"]
    for key, jkey in (("large", "jl"), ("small", "js")):
        ref = jlr.sequence_logprob(models[jkey], JCFG, jnp.asarray(seq))
        out = lm_relay.sequence_logprob(models[key], CFG, seq, device="cpu")
        assert np.isfinite(out) and abs(out - ref) <= LOGP_RTOL * abs(ref)


def test_bf16_model_follows_the_reference_bf16_model():
    """The reduced model in bf16 on the reference's bf16 weights (the gate
    weights fp32), 12 tokens.  (1) Layer by layer against the reference's
    ``layer_fwd`` run one at a time: every hidden state and the logits
    within ``BF16_LAYER_RTOL``.  (2) The forward and a 12-step decode
    against the reference's compiled ``model_fwd`` and ``decode_step``
    within ``BF16_REF_FACTOR`` times the distance between the reference's
    two executions of its forward."""
    from repro.models import common as jcm

    jl = _reference(0, "bfloat16")
    jcfg, cfg = JCFG.replace(dtype="bfloat16"), CFG.replace(dtype="bfloat16")
    model = _port(jl, cfg)
    assert model.layers[0].mlstm.w_if.dtype == torch.float32
    toks = _tokens(13, (2, 12))
    lm = jl["lm"]
    jh = lm["embed"][jnp.asarray(toks)] * jnp.asarray(8.0, jnp.bfloat16)
    h = model.embed[torch.from_numpy(toks).long()] * float(
        tr.embed_scale(cfg))
    pos = jnp.arange(12)[None].repeat(2, 0)
    tpos = torch.arange(12)[None].expand(2, 12)
    layers = []
    for i, spec in enumerate(tr.layer_specs(cfg)):
        lp = jax.tree.map(lambda a: a[0], lm["blocks"][i])
        jh, _, _ = jtr.layer_fwd(lp, jcfg, spec, jh, positions=pos)
        h, _, _ = tr.layer_fwd(model.layers[i], cfg, spec, h, positions=tpos)
        layers.append(_rel(_np(h), np.asarray(jh, np.float32)))
    layered = np.asarray(jnp.einsum(
        "bsd,vd->bsv", jcm.rms_norm(jh, lm["final_norm"], jcfg.norm_eps),
        lm["embed"]), np.float32)
    out = tr.model_fwd(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.bfloat16
    layers.append(_rel(_np(out), layered))
    assert max(layers) <= BF16_LAYER_RTOL, layers

    ref, _, _ = jtr.model_fwd(jl, jcfg, {"tokens": jnp.asarray(toks)})
    ref = np.asarray(ref, np.float32)
    spread = _rel(layered, ref)
    jcache = jtr.init_model_cache(jcfg, 2, 12)
    cache = tr.init_model_cache(cfg, 2, 12, device="cpu")
    outs, refs = [], []
    for t in range(12):
        tok = toks[:, t:t + 1]
        r, jcache = jtr.decode_step(jl, jcfg, jcache, jnp.asarray(tok),
                                    jnp.int32(t))
        o, cache = tr.decode_step(model, cfg, cache, torch.from_numpy(tok), t)
        outs.append(_np(o))
        refs.append(np.asarray(r, np.float32))
    fwd_rel = _rel(_np(out), ref)
    dec_rel = _rel(np.concatenate(outs, 1), np.concatenate(refs, 1))
    assert max(fwd_rel, dec_rel) <= BF16_REF_FACTOR * spread, (
        fwd_rel, dec_rel, spread)
    assert cache["layers"][0]["C"].dtype == torch.float32
    assert cache["layers"][0]["conv"].dtype == torch.bfloat16


def test_a_cached_call_of_several_tokens_raises(models):
    x = torch.zeros(2, 3, 64)
    with pytest.raises(NotImplementedError, match="more than one token"):
        rec.mlstm_block_fwd(models["large"].layers[0].mlstm, CFG, x,
                            cache=rec.init_mlstm_cache(CFG, 2, device="cpu"))
    with pytest.raises(NotImplementedError, match="more than one token"):
        rec.slstm_block_fwd(models["large"].layers[7].slstm, CFG, x,
                            cache=rec.init_slstm_cache(CFG, 2, device="cpu"))


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


def _batch(rows=4, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    arrs = {k: rng.integers(0, CFG.vocab_size, (rows, seq)).astype(np.int32)
            for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("mlstm_chunk", [None, 8])
def test_train_step_matches_the_jitted_reference(mlstm_chunk):
    """One train step against the jitted reference, with and without
    ``mlstm_chunk`` (16 tokens: two chunks of 8): the loss, every
    gradient within ``XLSTM_GRAD_RTOL`` of its tensor's largest,
    ``grad_norm``,
    the rate and the parameters after AdamW (which decays every leaf:
    each carries the reference's stacked axis)."""
    params = _reference(0)
    model = _port(params)
    jc, c = jopt.OptConfig(**OPT), opt.OptConfig(**OPT)
    jbatch, batch = _batch()
    jloss = jts.make_loss_fn(JCFG, remat=False, mlstm_chunk=mlstm_chunk)
    _, jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, jbatch)
    want = ck.lm_params_from_jax(jax.tree.map(np.asarray, jg), CFG)
    model.requires_grad_(True)
    loss, _ = ts.make_loss_fn(CFG, remat=False, mlstm_chunk=mlstm_chunk)(
        model, batch)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = want[n].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= XLSTM_GRAD_RTOL * np.abs(w).max(), (n, err)
    jstep = jax.jit(jts.make_train_step(JCFG, jc, remat=False,
                                        mlstm_chunk=mlstm_chunk))
    jp, _, jm = jstep(params, jopt.adamw_init(params, jc), jbatch)
    step = ts.make_train_step(CFG, c, remat=False, mlstm_chunk=mlstm_chunk)
    state = opt.adamw_init(dict(model.named_parameters()), c)
    model, state, m = step(model, state, batch)
    assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= LOSS_RTOL
    assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= (
        LOSS_RTOL)
    assert abs(float(m["lr"]) - float(jm["lr"])) <= (
        SCALAR_ULPS * _spacing(float(jm["lr"])))
    _check_params_after_step(model, CFG, jp, grads, float(m["grad_norm"]), c,
                             grad_rtol=XLSTM_GRAD_RTOL)


def test_gradients_are_ill_conditioned():
    """The reason for ``XLSTM_GRAD_RTOL``: scaling every weight by 1 +
    2^-23·N(0, 1) (about one fp32 ulp) moves some gradient by more than
    ``GRAD_RTOL`` (1e-5, the other LMs' tolerance) of its tensor's
    largest, on the port alone (read 1.19e-4, ``layers.2.mlstm.b_if``),
    and by no more than 3 x ``XLSTM_GRAD_RTOL``."""
    _, batch = _batch()

    def grads(model):
        model.requires_grad_(True)
        loss, _ = ts.make_loss_fn(CFG, remat=False)(model, batch)
        names, ps = zip(*model.named_parameters())
        return dict(zip(names, torch.autograd.grad(loss, ps)))

    base = _port(_reference(0))
    nudged = _port(_reference(0))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=gen))
    g0, g1 = grads(base), grads(nudged)
    moved = max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max())
                for n in g0)
    assert GRAD_RTOL < moved <= 3 * XLSTM_GRAD_RTOL, moved


def test_remat_changes_no_bit():
    model = _port(_reference(0))
    _, batch = _batch()
    model.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss, _ = ts.make_loss_fn(CFG, remat=remat, mlstm_chunk=8)(model,
                                                                   batch)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_weights_and_ranks_cross_bit_for_bit():
    """Every leaf of the reference's tree lands on exactly one port
    parameter by name (``layers.{i}.mlstm.wq_h``, ``layers.7.slstm.r_gates``,
    ...), bit for bit, and ``model_tree_to_jax`` gives the tree back; each
    leaf's rank (AdamW's decay) is the reference's stacked rank."""
    params = _reference(0)
    model = _port(params)
    named = dict(model.named_parameters())
    ref = ck.flatten(jax.tree.map(np.asarray, params))
    back = ck.flatten(ck.model_tree_to_jax(
        {n: p.detach() for n, p in named.items()}, CFG))
    assert list(back) == list(ref)
    for key, a in ref.items():
        assert np.array_equal(back[key].numpy(), a), key
    assert "lm/blocks/7/slstm/r_gates" in ref
    ranks = ck.lm_leaf_ranks(named, CFG)
    jranks = ck.model_tree_from_jax(jax.tree.map(np.asarray, params), CFG,
                                    unstack=False)
    assert ranks == {n: np.ndim(a) for n, a in jranks.items()}
    assert ranks["layers.0.mlstm.b_if"] == 2
    assert ranks["layers.7.slstm.r_gates"] == 5


def test_checkpoint_bytes_equal_the_reference(tmp_path):
    """The reference's init with its zero AdamW state, carried across:
    the same keys, dtypes and bytes; read back into a model and state
    equal to what was written."""
    params = _reference(0)
    model = _port(params)
    state = jopt.adamw_init(params, jopt.OptConfig())
    pstate = opt.adamw_init(dict(model.named_parameters()), opt.OptConfig())
    meta = {"step": 3, "arch": NAME}
    ref = jck.save(tmp_path / "j", (params, state), step=3, meta=meta)
    flat = ck.lm_state_to_jax(model, pstate, CFG)
    got = ck.save(tmp_path / "p", flat, meta, step=3)
    assert got.read_bytes() == ref.read_bytes()
    other = tr.init_model(CFG, torch.Generator().manual_seed(1), "cpu")
    back, _ = ck.restore(tmp_path / "p", flat)
    ck.lm_state_from_jax(back, other, CFG)
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), n


def _jax_like():
    params = jtr.init_model(jax.random.PRNGKey(0), JCFG)
    return params, jopt.adamw_init(params, jopt.OptConfig())


def test_jax_resumes_a_port_xlstm_checkpoint(tmp_path):
    """``repro_torch.launch.train --arch xlstm-1.3b`` (reduced) on the
    CPU: its step-4 file restores in the reference's ``ckpt.restore`` bit
    for bit, and the reference's driver resumes it to the port's own
    losses of steps 5-8 within 1e-5."""
    full = lt.main(ARGS + ["--steps", "8", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 8 and all(np.isfinite(full))
    lt.main(ARGS + ["--steps", "4", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "b")])
    path = tmp_path / "b" / NAME
    (params, state), meta = jck.restore(path, _jax_like())
    assert meta == {"step": 4, "arch": NAME}
    flat = ck.load_flat(path / "step_00000004.ckpt")
    ref = jck._flatten((params, state))
    assert list(flat) == list(ref)
    for key, a in ref.items():
        assert a.dtype == flat[key].dtype and np.array_equal(a, flat[key])
    losses = jlt.main(ARGS + ["--steps", "8", "--resume",
                              "--ckpt-dir", str(tmp_path / "b")])
    np.testing.assert_allclose(losses, full[4:], rtol=LOSS_RTOL)


def test_port_resumes_a_jax_xlstm_checkpoint(tmp_path):
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
