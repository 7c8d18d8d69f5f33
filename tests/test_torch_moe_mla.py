"""The port's mixture of experts and MLA (``repro_torch.models.mlp``,
``repro_torch.models.attention``) against the JAX package on the CPU, in
fp32 at the reduced widths of ``make_reduced`` (d_model 64; 8 experts of
width 64, one shared; MLA ranks 32 and 16, head dims 16 + 8 and 16), on
the reference's weights.

Tolerances: the expert count, the capacity, the chosen experts, the slot
assignment and which assignments are dropped are exact; the routing
probabilities and the aux term within 1e-6 (one softmax and one sum over
fixed inputs); outputs within 1e-5 relative, norm-wise (the order of the
sums in the products); the batch against the tokens one at a time bit for
bit, as the reference's ``test_moe_batched_equals_pertoken``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import make_reduced as jmake_reduced
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.configs.base import MoEConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import lm_leaf_ranks, lm_params_from_jax

torch.set_num_threads(1)

RTOL, PTOL = 1e-5, 1e-6
DS, L4 = "deepseek-v3-671b", "llama4-maverick-400b-a17b"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(name, **moe):
    """The reduced config of ``name`` in both packages, the MoE's fields
    replaced by ``moe``."""
    jcfg = jmake_reduced(jconfigs.get_config(name))
    cfg = configs.make_reduced(configs.get_config(name))
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.tensor(np.asarray(v, np.float32))
    return out


def _moe_pair(jcfg, cfg, seed=0):
    """The reference's MoE weights and a port ``MoE`` carrying them."""
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), jcfg)
    p = mlp_mod.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    p.load_state_dict(_flat(jp))
    return jp, p


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _ref_keep(top_idx, capacity, n_experts):
    """The reference's drop decision (``repro/models/mlp.py:88-99``, one
    block of all experts) in the flat (token, k) order."""
    flat_e = top_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = jnp.bincount(se, length=n_experts)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat_e.shape[0]) - starts[se]
    keep = np.zeros(flat_e.shape[0], bool)
    keep[np.asarray(order)] = np.asarray(pos < capacity)
    return keep


def _port_keep(top_idx, capacity, n_experts):
    order, _, keep = mlp_mod._dispatch(top_idx, capacity, n_experts)
    flat = torch.zeros_like(keep)
    flat[order] = keep
    return flat.numpy()


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------


def test_the_moe_configs_use_what_the_port_has():
    d = configs.get_config(DS)
    assert (d.moe.n_experts, d.moe.top_k, d.moe.n_shared, d.mtp) == (
        256, 8, 1, True)
    assert d.mla.kv_lora_rank == 512 and d.n_repeats == 58
    assert [s.mlp for s in tr.layer_specs(d)] == ["moe"] * 58 + ["dense"] * 3
    m = configs.get_config(L4)
    assert (m.n_heads, m.n_kv_heads, m.moe.n_experts, m.moe.top_k) == (
        40, 8, 128, 1)
    assert [s.mlp for s in m.pattern] == ["dense", "moe"] and m.mla is None


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------

MOE_GRID = [MoEConfig(n_experts=256, top_k=8, capacity_factor=1.25),
            MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25),
            MoEConfig(n_experts=8, top_k=2, capacity_factor=4.0),
            MoEConfig(n_experts=8, top_k=1, capacity_factor=0.5),
            MoEConfig(n_experts=16, top_k=8, capacity_factor=0.5)]


@pytest.mark.parametrize("m", MOE_GRID, ids=lambda m: f"E{m.n_experts}k"
                         f"{m.top_k}cf{m.capacity_factor}")
def test_capacity_equals_the_reference(m):
    jm = JMoEConfig(**dataclasses.asdict(m))
    for n in (1, 2, 7, 8, 9, 16, 31, 64, 100, 128, 256, 257, 1000, 4096):
        assert mlp_mod._capacity(n, m) == jmlp._capacity(n, jm), n
    # every decode step of 8 or fewer tokens gets 8 slots
    assert {mlp_mod._capacity(n, m) for n in range(1, 9)} == {8}


@pytest.mark.parametrize("k", [1, 2, 8])
def test_route_matches_the_reference(k):
    """16 experts: the experts equal, the renormalized probabilities and
    the aux term within 1e-6."""
    m = MoEConfig(n_experts=16, top_k=k)
    jm = JMoEConfig(n_experts=16, top_k=k)
    x, router = _x((40, 32)), _x((32, 16), seed=2, scale=0.5)
    tp, ti, aux = mlp_mod._route(torch.from_numpy(router),
                                 torch.from_numpy(x), m)
    jtp, jti, jaux = jmlp._route(jnp.asarray(router), jnp.asarray(x), jm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    assert np.abs(tp.numpy() - np.asarray(jtp)).max() <= PTOL
    assert abs(float(aux) - float(jaux)) <= PTOL
    assert tp.dtype == aux.dtype == torch.float32
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router columns give equal probabilities: ``jax.lax.top_k``
    takes the lower index first, and so must the port."""
    m, jm = MoEConfig(n_experts=8, top_k=3), JMoEConfig(n_experts=8, top_k=3)
    router = np.repeat(_x((16, 2), seed=3), 4, axis=1)  # columns in fours
    x = _x((24, 16), seed=4)
    _, ti, _ = mlp_mod._route(torch.from_numpy(router), torch.from_numpy(x), m)
    _, jti, _ = jmlp._route(jnp.asarray(router), jnp.asarray(x), jm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    assert (np.diff(ti.numpy(), axis=1) > 0).all()


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("n_shared", [1, 0])
@pytest.mark.parametrize("name", [DS, L4])
def test_moe_fwd_matches_the_reference(name, n_shared, cf):
    """At a capacity factor of 4 nothing is dropped; at 0.5 the same
    assignments as the reference's are dropped, and some are."""
    jcfg, cfg = _cfgs(name, n_shared=n_shared, capacity_factor=cf)
    jp, p = _moe_pair(jcfg, cfg)
    x = _x((3, 13, cfg.d_model))
    out, aux = mlp_mod.moe_fwd(p, cfg, torch.from_numpy(x))
    ref, jaux = jmlp.moe_fwd(jp, jcfg, jnp.asarray(x))
    assert out.shape == (3, 13, cfg.d_model) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= RTOL
    assert abs(float(aux) - float(jaux)) <= PTOL
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    _, ti, _ = mlp_mod._route(p.router, xf, cfg.moe)
    cap = mlp_mod._capacity(xf.shape[0], cfg.moe)
    keep = _port_keep(ti, cap, cfg.moe.n_experts)
    _, jti, _ = jmlp._route(jp["router"], jnp.asarray(xf.numpy()), jcfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
    np.testing.assert_array_equal(keep, _ref_keep(jti, cap,
                                                  cfg.moe.n_experts))
    dropped = int((~keep).sum())
    assert (dropped == 0) if cf == 4.0 else (dropped > 0), dropped


def test_moe_batch_equals_the_tokens_one_at_a_time():
    """The reference's ``test_moe_batched_equals_pertoken`` on the port:
    the sort-based dispatch is exactly batch-invariant."""
    jcfg, cfg = _cfgs(L4)
    _, p = _moe_pair(jcfg, cfg, seed=5)
    x = torch.from_numpy(_x((2, 16, cfg.d_model), seed=5, scale=0.5))
    full, _ = mlp_mod.moe_fwd(p, cfg, x)
    per = torch.cat([mlp_mod.moe_fwd(p, cfg, x[:, t:t + 1])[0]
                     for t in range(16)], dim=1)
    assert float((full - per).abs().max()) == 0.0


def test_moe_combine_sums_each_token_in_expert_order():
    """A token's kept contributions add one after another in the order of
    their expert ids, the reference's scatter-add order: the port's
    combine equals that sum, bit for bit, in bf16."""
    _, cfg = _cfgs(DS)
    cfg = cfg.replace(dtype="bfloat16")
    p = mlp_mod.init_moe(cfg, torch.Generator().manual_seed(6), "cpu")
    xf = torch.from_numpy(_x((10, cfg.d_model), seed=6)).to(torch.bfloat16)
    tp, ti, _ = mlp_mod._route(p.router, xf, cfg.moe)
    act = torch.nn.functional.silu
    out = mlp_mod._dispatch_compute(xf, p.we_gate, p.we_up, p.we_down, ti,
                                    tp, 8, act)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in torch.argsort(ti[t], stable=True).tolist():
            e = int(ti[t, j])
            y = (act(xf[t:t + 1] @ p.we_gate[e]) * (xf[t:t + 1] @ p.we_up[e])
                 ) @ p.we_down[e]
            want[t] = want[t] + y[0] * tp[t, j].to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def test_moe_weights_keep_the_reference_layout_and_dtypes():
    """A bf16 model keeps the router fp32; experts stack on the first
    axis; the draw is the reference's truncated normal over √fan_in."""
    cfg = configs.get_config(DS).replace(
        d_model=256, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                                   n_shared=1))
    p = mlp_mod.init_moe(cfg, torch.Generator().manual_seed(7), "cpu")
    assert p.router.dtype == torch.float32 and p.router.shape == (256, 4)
    assert p.we_gate.dtype == torch.bfloat16
    assert p.we_gate.shape == p.we_up.shape == (4, 256, 128)
    assert p.we_down.shape == (4, 128, 256)
    assert p.shared.w_gate.shape == (256, 128)
    for w, fan_in in ((p.we_gate, 256), (p.we_down, 128)):
        z = w.float().numpy() * np.sqrt(fan_in)
        assert np.abs(z).max() <= 2.0 + 1e-2
        assert abs(z.std() - 0.8796) < 0.03
        assert not torch.equal(w[0], w[1])


def test_sharded_moe_raises():
    jcfg, cfg = _cfgs(DS)
    _, p = _moe_pair(jcfg, cfg)
    with pytest.raises(NotImplementedError, match="11\\(c\\)"):
        mlp_mod.moe_fwd(p, cfg, torch.zeros(1, 2, cfg.d_model), mesh=object())


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair(absorb, seed=0):
    jcfg, cfg = _cfgs(DS)
    jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, absorb=absorb))
    cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=absorb))
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
              if "norm" in k else v) for k, v in jp.items()}
    p = attn.init_mla(cfg, torch.Generator().manual_seed(0), "cpu")
    p.load_state_dict(_flat(jp))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_full_sequence_matches_the_reference(absorb):
    jcfg, cfg, jp, p = _mla_pair(absorb)
    x = _x((2, 9, cfg.d_model), seed=8)
    pos = np.arange(9)[None].repeat(2, 0)
    out, cache = attn.mla_fwd(p, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    ref, _ = jattn.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    assert cache is None and out.shape == (2, 9, cfg.d_model)
    assert _rel(out.numpy(), ref) <= RTOL


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_decode_matches_the_reference_and_its_cache(absorb):
    """Token by token over 7 positions of a cache of 8: each step's output
    and the latent cache within 1e-5 of the reference's; the steps equal
    the full sequence's rows."""
    jcfg, cfg, jp, p = _mla_pair(absorb, seed=1)
    x = _x((2, 7, cfg.d_model), seed=9)
    full, _ = attn.mla_fwd(p, cfg, torch.from_numpy(x),
                           torch.arange(7)[None].expand(2, 7))
    cache = attn.init_mla_cache(cfg, 2, 8, device="cpu")
    jcache = jattn.init_mla_cache(jcfg, 2, 8)
    assert cache["c_kv"].shape == (2, 8, 16) and cache["k_rope"].shape == (
        2, 8, 8)
    for t in range(7):
        pos = np.full((2, 1), t)
        out, c2 = attn.mla_fwd(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                               torch.from_numpy(pos), cache=cache,
                               cache_pos=t)
        ref, jcache = jattn.mla_fwd(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                    jnp.asarray(pos), cache=jcache,
                                    cache_pos=jnp.int32(t))
        assert c2 is cache
        assert _rel(out.numpy(), ref) <= RTOL
        assert _rel(out[:, 0].numpy(), full[:, t].numpy()) <= RTOL
    for key in ("c_kv", "k_rope"):
        assert _rel(cache[key].numpy(), jcache[key]) <= RTOL
        assert not cache[key][:, 7].any()


def test_mla_absorb_matches_expand():
    """The two decode paths compute the same attention (the reference's
    ``test_mla_absorb_matches_expand``, here in fp32 at 1e-5)."""
    _, cfg, _, p = _mla_pair(False, seed=2)
    x = torch.from_numpy(_x((2, 6, cfg.d_model), seed=10))
    pos = torch.arange(6)[None].expand(2, 6)
    a, _ = attn.mla_fwd(p, cfg, x, pos)
    b, _ = attn.mla_fwd(p, cfg.replace(
        mla=dataclasses.replace(cfg.mla, absorb=True)), x, pos)
    assert _rel(b.numpy(), a.numpy()) <= RTOL


# ---------------------------------------------------------------------------
# the model: MTP head, aux, carried weights and ranks
# ---------------------------------------------------------------------------


def _model_pair(name, seed=0):
    jcfg, cfg = _cfgs(name)
    params = jtr.init_model(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape) * 0.3, x.dtype)
                         if "norm" in jax.tree_util.keystr(path) else x),
        params)
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return jcfg, cfg, params, model


@pytest.mark.parametrize("name", [DS, L4])
def test_train_forward_gives_the_reference_aux_and_mtp_logits(name):
    jcfg, cfg, params, model = _model_pair(name)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": jnp.asarray(toks.astype(np.int32))}
    logits, aux, extras = jax.jit(jtr.model_fwd, static_argnums=1)(
        params, jcfg, batch)
    out, paux, pextras = tr.train_fwd(model, cfg,
                                      {"tokens": torch.from_numpy(toks)})
    assert _rel(out.numpy(), logits) <= RTOL
    assert abs(float(paux) / float(aux) - 1) <= RTOL and float(aux) > 0
    assert set(pextras) == set(extras) == (
        {"mtp_logits"} if cfg.mtp else set())
    if cfg.mtp:
        assert pextras["mtp_logits"].shape == (2, 12, cfg.padded_vocab)
        assert _rel(pextras["mtp_logits"].numpy(),
                    extras["mtp_logits"]) <= RTOL
        # the chunked loss's path leaves MTP out, as the reference's
        _, _, none = tr.train_fwd(model, cfg, {"tokens": torch.from_numpy(
            toks)}, return_hidden=True)
        assert none == {}


def test_decode_computes_no_mtp_logits():
    _, cfg, _, model = _model_pair(DS)
    cache = tr.init_model_cache(cfg, 2, 4, device="cpu")
    logits, cache = tr.decode_step(model, cfg, cache,
                                   torch.zeros(2, 1, dtype=torch.long), 0)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert set(cache["layers"][0]) == {"c_kv", "k_rope"}


@pytest.mark.parametrize("name", [DS, L4])
def test_weight_decay_ranks_are_the_reference_stacked_ranks(name):
    """Each leaf's rank in the reference's stacked tree, which AdamW's
    decay rule reads: the expert stacks 4 in a pattern layer, the router
    3, ``mtp_proj`` 2, ``mtp_norm`` 1."""
    _, cfg, params, model = _model_pair(name)
    ranks = lm_leaf_ranks(dict(model.named_parameters()), cfg)
    jranks = lm_params_from_jax(jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape[:1], x.ndim)
        if "blocks" in jax.tree_util.keystr(path) else np.array(x.ndim),
        jax.tree.map(np.asarray, params)), cfg)
    assert {k: int(v.reshape(-1)[0]) for k, v in jranks.items()} == ranks
    moe = next(i for i, s in enumerate(tr.layer_specs(cfg)) if s.mlp == "moe")
    assert ranks[f"layers.{moe}.moe.we_gate"] == 4
    assert ranks[f"layers.{moe}.moe.router"] == 3
    assert ranks[f"layers.{moe}.moe.shared.w_down"] == 3
    if cfg.mtp:
        assert ranks["mtp_proj"] == 2 and ranks["mtp_norm"] == 1


# ---------------------------------------------------------------------------
# the LM relay's entry points on both models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,absorb", [(DS, False), (DS, True), (L4, False)],
                         ids=["ds-expand", "ds-absorb", "l4"])
def test_relay_runs_the_moe_models_as_the_reference(name, absorb):
    """``relay_decode`` (s = 3 of 6 new tokens on a (2, 4) prompt, large
    and small from two seeds), ``greedy_decode`` and ``sequence_logprob``
    on the reduced models: the reference's tokens, each greedy choice's
    top-2 margin over ten times the frameworks' logit difference (as
    ``tests/test_torch_lm_relay.py`` holds it), the log-probability within
    1e-5 relative."""
    from repro.serving import lm_relay as jlr
    from repro_torch.serving import lm_relay

    pairs = [_model_pair(name, seed) for seed in (0, 1)]
    if absorb:
        pairs = [(j.replace(mla=dataclasses.replace(j.mla, absorb=True)),
                  c.replace(mla=dataclasses.replace(c.mla, absorb=True)), p, m)
                 for j, c, p, m in pairs]
    (jcfg, cfg, jl, large), (_, _, js, small) = pairs
    prompt = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 4))
    prompt = prompt.astype(np.int32)
    ref, ref_info = jlr.relay_decode(jl, jcfg, js, jcfg, jnp.asarray(prompt),
                                     3, 6)
    seq, info = lm_relay.relay_decode(large, cfg, small, cfg, prompt, 3, 6,
                                      device="cpu")
    for model, params, lo, hi in ((large, jl, 4, 7), (small, js, 7, 10)):
        logits = tr.model_fwd(model, cfg, {"tokens": seq.long()})
        jlog, _, _ = jtr.model_fwd(params, jcfg, {"tokens": jnp.asarray(
            seq.numpy())})
        out = logits[:, lo - 1:hi - 1, :cfg.vocab_size]
        diff = np.abs(out.numpy() - np.asarray(jlog)[:, lo - 1:hi - 1,
                                                     :cfg.vocab_size])
        top2 = torch.topk(out, 2).values
        margin = (top2[..., 0] - top2[..., 1]).numpy()
        assert (margin > 10.0 * diff.max(-1)).all(), margin
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref))
    assert info == dict(ref_info)
    greedy = lm_relay.greedy_decode(large, cfg, prompt, 6, device="cpu")
    assert torch.equal(greedy[:, :7], seq[:, :7])
    lp = lm_relay.sequence_logprob(large, cfg, seq, device="cpu")
    jlp = jlr.sequence_logprob(jl, jcfg, jnp.asarray(seq.numpy()))
    assert abs(lp / float(jlp) - 1) <= RTOL
