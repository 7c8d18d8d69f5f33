"""The port's RecurrentGemma (``recurrentgemma-9b``) against the JAX package
on the CPU, in fp32 at the reduced size of ``make_reduced``: 5 layers
(RG-LRU, RG-LRU, local attention with a window of 4, then RG-LRU,
RG-LRU), d_model 64, MQA with 4 heads over 1 KV head of 16, ``rnn_width``
64, ``conv_width`` 4, vocab 512.  The reference's weights are carried
across by ``lm_params_from_jax``.

Tolerances: logits 1e-5 relative (norm of the difference over the norm of
the reference; both sides compute in fp32 and differ by the order of the
sums in the products and by the scan, a tree in the reference and a loop
in the port), ``sequence_logprob`` 1e-6 relative, tokens equal with every
greedy choice held to its top-2 margin as ``test_torch_lm_relay.py``
does.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.models import transformer as jtr
from repro.serving import lm_relay as jlr
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.models import transformer as tr
from repro_torch.serving import lm_relay
from repro_torch.training.checkpoint import lm_params_from_jax

torch.set_num_threads(1)

RTOL, LOGP_RTOL = 1e-5, 1e-6
MARGIN_FACTOR = 10.0
NAME = "recurrentgemma-9b"
JCFG = jmake_reduced(jconfigs.get_config(NAME))
CFG = configs.make_reduced(configs.get_config(NAME))
S, TOTAL, PROMPT = 3, 8, 6  # 14 positions: the 4-slot ring wraps


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _init(seed):
    """The reference's parameters with random non-zero norm scales and
    biases (so that no term is the identity or zero)."""
    params = jtr.init_model(jax.random.PRNGKey(seed), JCFG)
    rng = np.random.default_rng(seed)
    keys = ("norm", "b_a", "b_i", "conv_b")
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if any(k in jax.tree_util.keystr(path) for k in keys)
                         else x),
        params)


def _port(params, cfg=CFG) -> tr.LM:
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def models():
    jl, js = _init(0), _init(1)
    return dict(jl=jl, js=js, large=_port(jl), small=_port(js))


@pytest.fixture(scope="module")
def relay(models):
    """Both packages' relay at s = 3 of 8 new tokens on a (2, 6) prompt."""
    prompt = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, PROMPT))
    prompt = prompt.astype(np.int32)
    ref_seq, ref_info = jlr.relay_decode(models["jl"], JCFG, models["js"],
                                         JCFG, jnp.asarray(prompt), S, TOTAL)
    seq, info = lm_relay.relay_decode(models["large"], CFG, models["small"],
                                      CFG, prompt, S, TOTAL, device="cpu")
    return dict(prompt=prompt, ref_seq=np.asarray(ref_seq),
                ref_info=ref_info, seq=seq, info=info)


def _fields(cfg) -> dict:
    """The configuration as plain values (the two packages' dataclasses
    are different classes)."""
    out = dataclasses.asdict(cfg)
    out.update(padded_vocab=cfg.padded_vocab, n_repeats=cfg.n_repeats)
    return out


def test_port_config_equals_reference():
    """The copied config and its ``make_reduced`` cut equal the
    reference's, field for field."""
    full, ref = configs.get_config(NAME), jconfigs.get_config(NAME)
    assert _fields(full) == _fields(ref)
    assert full.padded_vocab == 256000 and full.n_repeats == 12
    assert _fields(CFG) == _fields(JCFG)
    assert CFG.n_layers == 5 and CFG.pattern[2].window == 4
    small = full.replace(n_layers=11)  # the relay's small model
    assert small.n_repeats == 3 and len(tr.layer_specs(small)) == 11


def test_weight_carry_keeps_lam_fp32(models):
    jl, large = models["jl"], models["large"]
    blocks = jl["lm"]["blocks"]
    np.testing.assert_array_equal(large.layers[1].rglru.w_a.numpy(),
                                  np.asarray(blocks[1]["rglru"]["w_a"][0]))
    np.testing.assert_array_equal(large.layers[3].rglru.lam.numpy(),
                                  np.asarray(jl["lm"]["rem"][0]["rglru"]["lam"]))
    np.testing.assert_array_equal(large.layers[2].attn.wk.numpy(),
                                  np.asarray(blocks[2]["attn"]["wk"][0]))
    assert not hasattr(large.layers[0], "attn")
    # in a bf16 model the carried lam stays fp32, the weights become bf16
    bf = _port(jl, CFG.replace(dtype="bfloat16"))
    for i in (0, 1, 3, 4):
        assert bf.layers[i].rglru.lam.dtype == torch.float32
        assert bf.layers[i].rglru.w_x.dtype == torch.bfloat16
        np.testing.assert_array_equal(bf.layers[i].rglru.lam.numpy(),
                                      large.layers[i].rglru.lam.numpy())


def test_model_fwd_logits_match_reference(models):
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 13))
    toks = toks.astype(np.int32)
    ref, _, _ = jtr.model_fwd(models["jl"], JCFG, {"tokens": jnp.asarray(toks)})
    out = tr.model_fwd(models["large"], CFG, {"tokens": torch.from_numpy(toks)})
    assert out.shape == (2, 13, CFG.padded_vocab) == ref.shape
    assert _rel(out.numpy(), ref) <= RTOL


def test_decode_wraps_the_ring_and_matches_reference(models):
    """14 one-token steps: the attention layer's 4-slot ring wraps three
    times.  Every step's logits within 1e-5 of the reference's step and of
    the full forward at that position; the ring, h and conv states match
    the reference's at the end."""
    jl, large = models["jl"], models["large"]
    n = 14
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, n))
    toks = toks.astype(np.int32)
    jcache = jtr.init_model_cache(JCFG, 2, n)
    cache = tr.init_model_cache(CFG, 2, n, device="cpu")
    assert cache["layers"][2]["k"].shape == (2, 4, 1, 16)
    full = tr.model_fwd(large, CFG, {"tokens": torch.from_numpy(toks)})
    for t in range(n):
        tok = toks[:, t:t + 1]
        ref, jcache = jtr.decode_step(jl, JCFG, jcache, jnp.asarray(tok),
                                      jnp.int32(t))
        out, cache = tr.decode_step(large, CFG, cache, torch.from_numpy(tok), t)
        assert _rel(out.numpy(), ref) <= RTOL, t
        assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL, t
    ring = cache["layers"][2]
    for kv in ("k", "v"):
        assert _rel(ring[kv].numpy(), jcache["blocks"][2][kv][0]) <= RTOL
    for layer, ref in ((0, jax.tree.map(lambda a: a[0], jcache["blocks"][0])),
                       (4, jcache["rem"][1])):
        assert cache["layers"][layer]["h"].dtype == torch.float32
        assert _rel(cache["layers"][layer]["h"].numpy(), ref["h"]) <= RTOL
        assert _rel(cache["layers"][layer]["conv"].numpy(), ref["conv"]) <= RTOL


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


def test_relay_decode_tokens_and_info_equal_reference(models, relay):
    seq = relay["seq"].numpy()
    _check_margins(models["large"], models["jl"], seq, PROMPT, PROMPT + S)
    _check_margins(models["small"], models["js"], seq, PROMPT + S,
                   PROMPT + TOTAL)
    np.testing.assert_array_equal(seq, relay["ref_seq"])
    assert seq.shape == (2, PROMPT + TOTAL)
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
    # the relay's large segment is the prefix of the large-only decode
    np.testing.assert_array_equal(seq[:, :PROMPT + S].numpy(),
                                  relay["seq"][:, :PROMPT + S].numpy())


def test_sequence_logprob_matches_reference(models, relay):
    seq = relay["ref_seq"]
    ref = jlr.sequence_logprob(models["jl"], JCFG, jnp.asarray(seq))
    out = lm_relay.sequence_logprob(models["large"], CFG, seq, device="cpu")
    assert np.isfinite(out)
    assert abs(out - ref) <= LOGP_RTOL * abs(ref)


def test_scan_runs_only_in_the_full_forward(models):
    """On the CPU the wrappers count nothing (they run the plain version);
    the call structure is what the card's launch counts follow: the scan
    once per RG-LRU layer in a full forward, never in a decode step."""
    from repro_torch.models import recurrent as rec

    calls = []
    scan = rec.rglru_scan
    rec.rglru_scan = lambda a, b: calls.append(a.shape) or scan(a, b)
    try:
        build.reset_launches()
        toks = torch.zeros((2, 5), dtype=torch.long)
        tr.model_fwd(models["large"], CFG, {"tokens": toks})
        assert calls == [(2, 5, 64)] * 4
        cache = tr.init_model_cache(CFG, 2, 3, device="cpu")
        tr.decode_step(models["large"], CFG, cache, toks[:, :1], 0)
        assert len(calls) == 4
        assert build.LAUNCHES["rglru_scan"] == 0
    finally:
        rec.rglru_scan = scan


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["ring read one key short",
                                   "h not carried", "conv not carried"])
def test_bf16_card_check_catches_a_wrong_carry_or_ring_read(fault):
    """``chip_smoke.py``'s bf16 RecurrentGemma check (phase 13) compares
    every layer's mixer output at every decode step, card against CPU,
    within ``RG_BF16_RTOL``.  Here, on the CPU in bf16, at phase 13's
    depth and window (5 layers, a ring of 16 that wraps in 32 steps) at a
    narrow width, one fault moves those outputs by more than that
    tolerance."""
    from repro_torch.models import attention as attn
    from repro_torch.models import recurrent as rec

    cs = _chip_smoke()
    cfg = cs.rg_check_config(configs.get_config(NAME)).replace(
        d_model=256, rnn_width=256, n_heads=4, head_dim=64, d_ff=512,
        vocab_size=1024)
    assert cfg.pattern[2].window == cs.RG_CHECK_WINDOW == 16
    model = tr.init_model(cfg, torch.Generator().manual_seed(15), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))

    def mixer_outputs():
        seen, gqa, block = [], attn.gqa_fwd, rec.rglru_block_fwd

        def record(fn):
            def wrapped(*args, **kw):
                y, c = fn(*args, **kw)
                seen.append(y.float())
                return y, c
            return wrapped
        attn.gqa_fwd, rec.rglru_block_fwd = record(gqa), record(block)
        try:
            cache = tr.init_model_cache(cfg, 2, 32, device="cpu")
            for t in range(32):
                tr.decode_step(model, cfg, cache, toks[:, t:t + 1], t)
        finally:
            attn.gqa_fwd, rec.rglru_block_fwd = gqa, block
        return seen

    right = mixer_outputs()
    flash, block = attn.flash_attention, rec.rglru_block_fwd

    def short_read(*args, kv_len=None, **kw):
        return flash(*args, kv_len=kv_len - 1 if kv_len > 1 else kv_len, **kw)

    def forget(key):
        def fwd(p, cfg, x, *, cache=None):
            if cache is not None:
                cache[key].zero_()
            return block(p, cfg, x, cache=cache)
        return fwd

    patch = {"ring read one key short": (attn, "flash_attention", short_read),
             "h not carried": (rec, "rglru_block_fwd", forget("h")),
             "conv not carried": (rec, "rglru_block_fwd", forget("conv"))}
    mod, name, fn = patch[fault]
    original = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        wrong = mixer_outputs()
    finally:
        setattr(mod, name, original)
    moved = max(cs.norm_rel(a, b) for a, b in zip(wrong, right))
    assert moved > cs.RG_BF16_RTOL, (fault, moved)
