"""The port's scheduler against the reference on the same numpy inputs:
the context vector, the dynamic reward, the latency model, LinUCB (Eqs.
7–11) and the five policies; and the cases of ``tests/test_core.py``
(LinUCB, reward shaping) run on the port.

Tolerances:
* ``context_vector``, ``compute_reward``, ``dynamic_weights`` and every
  ``serving/latency.py`` function (numpy in both): equal floats;
* LinUCB ``update`` against the reference's function: ``A``, ``b`` and
  ``counts`` bit for bit.  The reference's ``RisePolicy`` jits it, and XLA
  contracts the diagonal's ``c_i·c_i + λ`` into one fused multiply-add, so
  against the jitted update each step is within 1 ulp, on the diagonal
  only;
* ``scores`` within 1e-5 of the largest score's magnitude (``A⁻¹`` by
  LAPACK in both, in another order);
* ``select``'s forced branch equal; its sampled branch by distribution
  (the port draws from a ``torch.Generator``, not JAX's PRNG);
* RR and Greedy equal; PPO and SAC on carried weights: logits within 1e-6
  relative, a batch's gradients within 1e-5, and after ``train_offline``
  the weights within 1e-4 (norm-wise relative per tensor) with equal
  held-out selections.
"""
from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import context as jctx
from repro.core import linucb as jl
from repro.core import policies as jpol
from repro.core import program as jprog
from repro.core import reward as jrew
from repro.serving import arms as jarms
from repro.serving import latency as jlat
from repro_torch.core import context as tctx
from repro_torch.core import linucb as tl
from repro_torch.core import policies as tpol
from repro_torch.core import program as tprog
from repro_torch.core import reward as trew
from repro_torch.serving import arms as tarms
from repro_torch.serving import latency as tlat
from repro_torch.training.checkpoint import (linucb_state_from_jax,
                                             mlp_params_from_jax)

torch.set_num_threads(1)


def _j_int8():
    """The reference's 11 arms with every hop on the int8 wire (its
    ``build_action_space`` has no ``compress``)."""
    return tuple(
        jarms.Arm(a.idx, dataclasses.replace(a.program, handoffs=tuple(
            dataclasses.replace(h, compress=True) for h in a.program.handoffs)),
            a.label + ("|int8" if a.program.is_relay else ""))
        for a in jarms.build_action_space())


SPACES = {
    "table2": (jarms.build_action_space, tarms.build_action_space),
    "int8": (_j_int8, lambda: tarms.build_action_space(compress=True)),
    "cascade": (jarms.cascade_action_space, tarms.cascade_action_space),
    "dag": (jarms.dag_action_space, tarms.dag_action_space),
}


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _requests(n, seed, module):
    rng = np.random.default_rng(seed)
    return [module.Request(
        rid=i, arrival=float(i), complexity=float(rng.uniform(-0.2, 1.2)),
        wants_text=bool(rng.uniform() < 0.35),
        rtt_ms=float(rng.lognormal(np.log(80), 1.5)),
        battery=float(rng.uniform()), pref_speed=float(rng.uniform(-0.2, 1.2)),
        prompt_seed=i) for i in range(n)]


def _contexts(n, seed, d=8):
    rng = np.random.default_rng(seed)
    return rng.random((n, d)).astype(np.float32)


def _jstate(state):
    return jl.LinUCBState(*(jnp.asarray(x.numpy()) for x in state))


def _walk(steps, seed=0, k=11, d=8):
    """The same ``steps`` random observations through the reference's
    ``update`` and the port's; returns both final states."""
    rng = np.random.default_rng(seed)
    js, ts = jl.init_state(k, d), tl.init_state(k, d, "cpu")
    p, tp = jl.LinUCBParams(), tl.LinUCBParams()
    for _ in range(steps):
        c = rng.random(d).astype(np.float32)
        a, r = int(rng.integers(k)), float(np.float32(rng.normal()))
        js = jl.update(js, a, jnp.asarray(c), r, p)
        ts = tl.update(ts, a, torch.from_numpy(c), r, tp)
    return js, ts


# ---------------------------------------------------------------------------
# context and reward
# ---------------------------------------------------------------------------


def test_context_vector_equals_reference():
    rng = np.random.default_rng(1)
    for jr, tr in zip(_requests(200, 0, jctx), _requests(200, 0, tctx)):
        occ = {k: float(rng.uniform()) for k in ("vega", "sdxl", "sd3")
               if rng.uniform() < 0.8}
        extra = rng.random(2).astype(np.float32) if rng.uniform() < 0.5 else None
        a = tctx.context_vector(tr, occ, extra)
        b = jctx.context_vector(jr, occ, extra)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert tctx.CTX_DIM == jctx.CTX_DIM


# each flag on exactly at its threshold, off just under it (c_pref's test
# is strict, the others are not: 0.5 turns txt and bat on, pref off)
FLAG_VALUES = {"c_txt": (0.4999, 0.5), "c_pref": (0.5, 0.5001),
               "c_bat": (0.4999, 0.5)}


@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                         repeat=3)))
def test_reward_equals_reference(flags, dynamic):
    ctx = {k: v[on] for (k, v), on in zip(FLAG_VALUES.items(), flags)}
    assert trew.dynamic_weights(**ctx) == jrew.dynamic_weights(**ctx)
    rng = np.random.default_rng(sum(f << i for i, f in enumerate(flags)))
    for _ in range(20):
        q = {k: float(rng.normal()) for k in trew.BASE_WEIGHTS
             if rng.uniform() < 0.9}
        args = dict(quality=q, t_total=float(rng.uniform(0, 60)),
                    m_vram=float(rng.uniform(0, 24)),
                    l_dev=float(rng.uniform()), **ctx)
        got = trew.compute_reward(trew.RewardInputs(**args), dynamic=dynamic)
        want = jrew.compute_reward(jrew.RewardInputs(**args), dynamic=dynamic)
        assert got == want


# ---------------------------------------------------------------------------
# the latency model
# ---------------------------------------------------------------------------


def test_latency_constants_and_scalar_functions_equal_reference():
    for name in ("STEP_COST", "VRAM_GB", "LATENT_BYTES", "LATENT_CHANNELS",
                 "T_FULL", "SCALE_BYTES", "HBM_GBPS"):
        assert getattr(tlat, name) == getattr(jlat, name), name
    for fam in (None, "XL", "F3"):
        for comp in (False, True):
            assert (tlat.latent_wire_bytes(fam, comp)
                    == jlat.latent_wire_bytes(fam, comp))
            for bw in (5.0, 20.0):
                assert (tlat.wire_seconds(fam, bw, comp)
                        == jlat.wire_seconds(fam, bw, comp))
                assert (tlat.transfer_time(fam, 80.0, bw, comp)
                        == jlat.transfer_time(fam, 80.0, bw, comp))
                for fused in (False, True):
                    assert (tlat.handoff_seconds(fam, 37.5, bw, comp, fused)
                            == jlat.handoff_seconds(fam, 37.5, bw, comp, fused))
            for fused in (False, True):
                assert (tlat.boundary_compute_seconds(fam, comp, fused)
                        == jlat.boundary_compute_seconds(fam, comp, fused))
    for pool in tlat.STEP_COST:
        assert tlat.full_model_latency(pool) == jlat.full_model_latency(pool)
        for b in (1, 3, 8):
            assert (tlat.batch_service_time(pool, 17, b, 0.35)
                    == jlat.batch_service_time(pool, 17, b, 0.35))
    for nominal, reissue in ((1.7, 0.5), (1.7, 1.0), (2.3, 2.5)):
        assert (tlat.reissue_latency(nominal, reissue)
                == jlat.reissue_latency(nominal, reissue))


@pytest.mark.parametrize("space", sorted(SPACES))
def test_latency_over_arms_equals_reference(space):
    """Every arm-level function, the same numpy jitter seed: equal floats
    (the jitter draws consume the generator in the same order)."""
    j_arms, t_arms = (f() for f in SPACES[space])
    assert [a.label for a in t_arms] == [a.label for a in j_arms]
    for ja, ta in zip(j_arms, t_arms):
        for comp in (None, False, True):
            seed = 7 * ta.idx + (comp is None)
            got = tlat.program_latency(ta.program, 55.0,
                                       np.random.default_rng(seed),
                                       compressed=comp, bw_mbps=12.0)
            want = jlat.program_latency(ja.program, 55.0,
                                        np.random.default_rng(seed),
                                        compressed=comp, bw_mbps=12.0)
            assert (got.segment_s, got.hop_s) == (want.segment_s, want.hop_s)
            assert (got.edge_s, got.device_s, got.transfer_s, got.total) == (
                want.edge_s, want.device_s, want.transfer_s, want.total)
            assert (tlat.program_wire_bytes(ta.program, comp)
                    == jlat.program_wire_bytes(ja.program, comp))
        got = tlat.arm_latency(ta, None, 80.0, np.random.default_rng(ta.idx),
                               compressed=True)
        want = jlat.arm_latency(ja, None, 80.0, np.random.default_rng(ta.idx),
                                compressed=True)
        assert (got.segment_s, got.hop_s) == (want.segment_s, want.hop_s)
        assert tlat.program_vram(ta.program) == jlat.program_vram(ja.program)
        assert tlat.arm_vram(ta) == jlat.arm_vram(ja)

        tplan = tprog.compile_plan(tprog.as_graph(ta.program))
        jplan = jprog.compile_plan(jprog.as_graph(ja.program))
        for rng_seed in (None, ta.idx):
            node_s = tlat.graph_node_seconds(
                tplan, None if rng_seed is None
                else np.random.default_rng(rng_seed))
            assert node_s == jlat.graph_node_seconds(
                jplan, None if rng_seed is None
                else np.random.default_rng(rng_seed))
        for comp in (None, True):
            hop_s = tlat.graph_hop_seconds(tplan, 55.0, bw_mbps=12.0,
                                           compressed=comp)
            want_hops = jlat.graph_hop_seconds(jplan, 55.0, bw_mbps=12.0,
                                               compressed=comp)
            assert hop_s == want_hops
            assert (tlat.graph_critical_seconds(tplan, node_s, hop_s)
                    == jlat.graph_critical_seconds(jplan, node_s, want_hops))
            assert (tlat.graph_ideal_seconds(tplan, 55.0, bw_mbps=12.0,
                                             compressed=comp)
                    == jlat.graph_ideal_seconds(jplan, 55.0, bw_mbps=12.0,
                                                compressed=comp))


# ---------------------------------------------------------------------------
# LinUCB against the reference
# ---------------------------------------------------------------------------


def test_linucb_update_bit_for_bit():
    js, ts = _walk(200)
    for name, a, b in zip(ts._fields, ts, js):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_linucb_update_against_the_jitted_policy_within_one_ulp():
    """The reference's RisePolicy jits ``update``; XLA fuses c_i·c_i + λ
    into one FMA, so each step's A is within 1 ulp on the diagonal and
    equal elsewhere; b and counts stay equal."""
    pol = jpol.RisePolicy(seed=0)
    rng = np.random.default_rng(3)
    ts, tp = tl.init_state(11, 8, "cpu"), tl.LinUCBParams()
    fused = 0
    for _ in range(200):
        c = rng.random(8).astype(np.float32)
        a, r = int(rng.integers(11)), float(np.float32(rng.normal()))
        js = pol._update(_jstate(ts), jnp.int32(a), jnp.asarray(c),
                         jnp.float32(r))
        ts = tl.update(ts, a, torch.from_numpy(c), r, tp)
        d = _ulps(ts.A.numpy(), js.A)
        assert d.max() <= 1
        assert not d[:, ~np.eye(8, dtype=bool)].any()
        fused += int(d.any())
        np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    assert fused > 0  # the contraction shows; a change in XLA would too


@pytest.mark.parametrize("steps", [0, 30, 200, 700])
def test_linucb_scores_match_reference(steps):
    """Eq. 7 with α, β past their warm-up and decay (n = 700 > N_w + K)."""
    js, ts = _walk(steps, seed=steps)
    p, tp = jl.LinUCBParams(), tl.LinUCBParams()
    for c in _contexts(10, 99):
        got = tl.scores(ts, torch.from_numpy(c), tp).numpy()
        want = np.asarray(jl.scores(js, jnp.asarray(c), p))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for n in (0.0, 59.0, 61.0, 460.0, 5000.0):
        got = tl._decayed(tp, torch.tensor(n))
        want = jl._decayed(p, jnp.float32(n))
        np.testing.assert_allclose([float(x) for x in got],
                                   [float(x) for x in want], rtol=1e-6)


def test_linucb_forced_branch_equals_reference():
    rng = np.random.default_rng(4)
    p, tp = jl.LinUCBParams(n_min=3), tl.LinUCBParams(n_min=3)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    n_forced = 0
    for _ in range(200):
        counts = rng.integers(0, 5, size=11).astype(np.float32)
        avail = rng.uniform(size=11) < 0.7
        avail[rng.integers(11)] = True
        js = jl.init_state(11, 8)._replace(counts=jnp.asarray(counts))
        ts = tl.init_state(11, 8, "cpu")._replace(counts=torch.from_numpy(counts))
        c = rng.random(8).astype(np.float32)
        if not (avail & (counts < 3)).any():
            continue
        key, sub = jax.random.split(key)
        want = int(jl.select(js, jnp.asarray(c), sub, p, jnp.asarray(avail)))
        got = tl.select(ts, torch.from_numpy(c), gen, tp,
                        torch.from_numpy(avail))
        assert got.dtype == torch.int64 and got.ndim == 0
        assert int(got) == want
        n_forced += 1
    assert n_forced > 100


def test_linucb_sampled_branch_by_distribution():
    """4,000 draws on a fixed state against softmax(s/τ) of the
    reference's scores (chi-square, p > 1e-3); a masked arm is never
    drawn."""
    js, ts = _walk(90, seed=5)
    js = js._replace(counts=js.counts + 3.0)
    ts = ts._replace(counts=ts.counts + 3.0)
    p, tp = jl.LinUCBParams(tau0=3.0), tl.LinUCBParams(tau0=3.0)
    c = _contexts(1, 6)[0]
    avail = np.ones(11, bool)
    avail[4] = False
    s = np.asarray(jl.scores(js, jnp.asarray(c), p), np.float64)
    tau = float(jl._decayed(p, jnp.sum(js.counts))[2])
    z = np.where(avail, s / tau, -np.inf)
    prob = np.exp(z - z.max())
    prob /= prob.sum()
    gen = torch.Generator().manual_seed(11)
    draws = [int(tl.select(ts, torch.from_numpy(c), gen, tp,
                           torch.from_numpy(avail))) for _ in range(4000)]
    hist = np.bincount(draws, minlength=11)
    assert hist[4] == 0
    keep = avail & (prob * 4000 >= 5)
    assert keep.sum() >= 3
    expected = prob[keep] / prob[keep].sum() * hist[keep].sum()
    assert stats.chisquare(hist[keep], expected).pvalue > 1e-3


def test_linucb_state_carries_across():
    js, _ = _walk(120, seed=8)
    ts = linucb_state_from_jax(*(np.asarray(x) for x in js), "cpu")
    for a, b in zip(ts, js):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# tests/test_core.py's LinUCB cases, on the port
# ---------------------------------------------------------------------------


def test_linucb_learns_linear_bandit():
    """3 arms with linear rewards θ_a·c: LinUCB should pick the best arm for
    each context most of the time after training."""
    d, k = 8, 3
    rng = np.random.default_rng(0)
    thetas = rng.normal(size=(k, d)).astype(np.float32)
    p = tl.LinUCBParams(warmup=30, decay_k=150.0, n_min=2)
    state = tl.init_state(k, d, "cpu")
    gen = torch.Generator().manual_seed(0)
    for t in range(400):
        c = rng.normal(size=d).astype(np.float32)
        c /= np.linalg.norm(c)
        arm = int(tl.select(state, torch.from_numpy(c), gen, p))
        r = float(thetas[arm] @ c + 0.05 * rng.normal())
        state = tl.update(state, arm, torch.from_numpy(c), r, p)
    correct = 0
    trials = 100
    for t in range(trials):
        c = rng.normal(size=d).astype(np.float32)
        c /= np.linalg.norm(c)
        arm = int(tl.select(state, torch.from_numpy(c), gen, p))
        correct += arm == int(np.argmax(thetas @ c))
    assert correct / trials > 0.7, f"accuracy {correct/trials}"


@pytest.mark.parametrize("example", range(25))
def test_linucb_update_keeps_A_pd(example):
    """A stays symmetric positive definite under arbitrary updates (a
    seeded sweep of the reference's hypothesis ranges: ctx in [-1, 1]^8,
    reward in [-5, 5], arm in 0..10)."""
    rng = np.random.default_rng(example)
    ctx = rng.uniform(-1, 1, size=8).astype(np.float32)
    reward, arm = float(rng.uniform(-5, 5)), int(rng.integers(0, 11))
    p = tl.LinUCBParams()
    state = tl.init_state(11, 8, "cpu")
    c = torch.from_numpy(ctx)
    state = tl.update(state, arm, c, reward, p)
    A = state.A.numpy()
    for a in range(11):
        assert np.allclose(A[a], A[a].T, atol=1e-5)
        assert np.linalg.eigvalsh(A[a]).min() > 0
    s = tl.scores(state, c, p).numpy()
    assert np.all(np.isfinite(s))


def test_forced_exploration_visits_all_arms():
    p = tl.LinUCBParams(n_min=2)
    state = tl.init_state(5, 8, "cpu")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    for t in range(5 * 2):
        c = torch.from_numpy(rng.normal(size=8).astype(np.float32))
        arm = int(tl.select(state, c, gen, p))
        state = tl.update(state, arm, c, 0.0, p)
    assert np.all(state.counts.numpy() >= 2)


def test_availability_mask_respected():
    p = tl.LinUCBParams(n_min=0)
    state = tl.init_state(4, 8, "cpu")
    avail = torch.tensor([False, True, False, False])
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        arm = int(tl.select(state, torch.ones(8) / 8, gen, p, avail))
        assert arm == 1


# ---------------------------------------------------------------------------
# tests/test_core.py's reward cases, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("example", range(10))
def test_reward_bounded(example):
    """A seeded sweep of the reference's hypothesis ranges, 5 draws per
    case."""
    rng = np.random.default_rng(example)
    for _ in range(5):
        q, t, vram, l_dev = (float(rng.uniform(0, m)) for m in (1, 60, 24, 1))
        txt, bat = (bool(rng.integers(2)) for _ in range(2))
        pref = float(rng.uniform())
        r = trew.compute_reward(trew.RewardInputs(
            quality={"clip": q, "ir": q, "pick": 0.2 + 0.03 * q,
                     "aes": 5 + q, "ocr": q},
            t_total=t, m_vram=vram, l_dev=l_dev,
            c_txt=float(txt), c_pref=pref, c_bat=float(bat)))
        assert -trew.ETA < r < trew.ETA


def test_dynamic_weights_rules():
    w0, t0, c0, _ = trew.dynamic_weights(0.0, 0.0, 0.0)
    w_txt, _, _, _ = trew.dynamic_weights(1.0, 0.0, 0.0)
    assert w_txt["ocr"] > w0["ocr"] and w_txt["clip"] < w0["clip"]
    _, t_speed, _, _ = trew.dynamic_weights(0.0, 1.0, 0.0)
    assert t_speed > t0
    _, t_bat, c_bat, _ = trew.dynamic_weights(0.0, 0.0, 1.0)
    assert c_bat > c0 and t_bat > t0


def test_reward_prefers_fast_when_speed_requested():
    q = {"clip": 0.5, "ir": 0.5, "pick": 0.22, "aes": 5.5, "ocr": 0.0}
    slow = trew.compute_reward(trew.RewardInputs(q, 30.0, 8.0, 0.2, c_pref=1.0))
    fast = trew.compute_reward(trew.RewardInputs(q, 2.0, 8.0, 0.2, c_pref=1.0))
    assert fast > slow


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [tpol.RisePolicy, tpol.PPOPolicy,
                                 tpol.SACPolicy])
def test_policies_default_to_the_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()
    assert cls(device="cpu").device == torch.device("cpu")


def test_rise_policy_equals_reference_on_the_forced_phase():
    """The first 33 decisions are forced (11 arms × N_min = 3), so the
    arms are the reference's whatever the generator; the states after
    them are equal but for the jitted update's diagonal FMA: up to 1 ulp
    per update of an arm, so at most 3 after its 3 forced updates (read:
    1 ulp at most, on 12 of the 88 diagonal entries, none elsewhere)."""
    jp, tp = jpol.RisePolicy(seed=1), tpol.RisePolicy(seed=1, device="cpu")
    ctxs = _contexts(33, 12)
    avail = np.ones(11, bool)
    for i, c in enumerate(ctxs):
        a = tp.select(c, avail)
        assert a == jp.select(c, avail)
        tp.update(c, a, float(i % 5) - 2.0)
        jp.update(c, a, float(i % 5) - 2.0)
    np.testing.assert_array_equal(tp.state.counts.numpy(),
                                  np.asarray(jp.state.counts))
    np.testing.assert_array_equal(tp.state.b.numpy(), np.asarray(jp.state.b))
    d = _ulps(tp.state.A.numpy(), jp.state.A)
    assert d.max() <= 3
    assert not d[:, ~np.eye(d.shape[1], dtype=bool)].any()


@pytest.mark.parametrize("kw", [{"use_context": False},
                                {"fixed_relay_step": 15},
                                {"forced_exploration": False},
                                {"arms": "dag", "ctx_dim": 10}])
def test_rise_ablation_switches_equal_reference(kw):
    kw_t, kw_j = dict(kw), dict(kw)
    if kw.get("arms") == "dag":
        kw_t["arms"], kw_j["arms"] = (tarms.dag_action_space(),
                                      jarms.dag_action_space())
    tp, jp = tpol.RisePolicy(device="cpu", **kw_t), jpol.RisePolicy(**kw_j)
    assert tp.p == tl.LinUCBParams(**jp.p.__dict__)
    assert tp.state.A.shape == jp.state.A.shape
    rng = np.random.default_rng(2)
    d = tp.state.b.shape[1]
    for _ in range(20):
        c = rng.random(d).astype(np.float32)
        avail = rng.uniform(size=len(tp.arms)) < 0.6
        np.testing.assert_array_equal(tp._mask(avail), jp._mask(avail))
        np.testing.assert_array_equal(tp._ctx(c).numpy(),
                                      np.asarray(jp._ctx(c), np.float32))


def test_round_robin_and_greedy_equal_reference():
    rng = np.random.default_rng(5)
    pairs = [(tpol.RoundRobinPolicy(), jpol.RoundRobinPolicy()),
             (tpol.GreedyPolicy(), jpol.GreedyPolicy())]
    for _ in range(200):
        c = rng.random(8).astype(np.float32)
        avail = rng.uniform(size=11) < rng.uniform()
        for t, j in pairs:
            assert t.select(c, avail) == j.select(c, avail)


def _carry_ppo(seed=0):
    jp = jpol.PPOPolicy(seed=seed)
    tp = tpol.PPOPolicy(seed=seed, device="cpu")
    mlp_params_from_jax(jax.tree.map(np.asarray, jp.pi), tp.pi)
    mlp_params_from_jax(jax.tree.map(np.asarray, jp.v), tp.v)
    return jp, tp


def _carry_sac(seed=0):
    jp = jpol.SACPolicy(seed=seed)
    tp = tpol.SACPolicy(seed=seed, device="cpu")
    mlp_params_from_jax(jax.tree.map(np.asarray, jp.q1), tp.q1)
    mlp_params_from_jax(jax.tree.map(np.asarray, jp.q2), tp.q2)
    return jp, tp


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _layers(mlp):
    return [{"w": w.detach().numpy(), "b": b.detach().numpy()}
            for w, b in zip(mlp.w, mlp.b)]


def test_ppo_and_sac_logits_and_grads_on_carried_weights():
    ctx = _contexts(32, 20)
    rng = np.random.default_rng(21)
    arm = rng.integers(0, 11, size=32)
    reward = rng.normal(size=32).astype(np.float32)
    logp_old = np.log(rng.uniform(0.05, 0.3, size=32)).astype(np.float32)

    jp, tp = _carry_ppo()
    want = np.asarray(jp._logits(jp.pi, jnp.asarray(ctx)))
    got = tp.logits(ctx)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    g_pi, g_v = jp._grad(jp.pi, jp.v, jnp.asarray(ctx), jnp.asarray(arm),
                         jnp.asarray(reward), jnp.asarray(logp_old))
    t_pi, t_v = tp.grad(*(torch.from_numpy(a) for a in (ctx, arm, reward,
                                                         logp_old)))
    for jg, tg, mlp in ((g_pi, t_pi, tp.pi), (g_v, t_v, tp.v)):
        n = len(mlp.w)
        for i, layer in enumerate(jg):
            assert _rel(tg[i].numpy(), layer["w"]) <= 1e-5
            assert _rel(tg[n + i].numpy(), layer["b"]) <= 1e-5

    js, ts = _carry_sac()
    for jq, tq in ((js.q1, ts.q1), (js.q2, ts.q2)):
        want = np.asarray(js._qf(jq, jnp.asarray(ctx)))
        with torch.no_grad():
            got = tq(torch.from_numpy(ctx)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        g = js._qgrad(jq, jnp.asarray(ctx), jnp.asarray(arm),
                      jnp.asarray(reward))
        tg = ts.qgrad(tq, torch.from_numpy(ctx), torch.from_numpy(arm),
                      torch.from_numpy(reward))
        n = len(tq.w)
        for i, layer in enumerate(g):
            assert _rel(tg[i].numpy(), layer["w"]) <= 1e-5
            assert _rel(tg[n + i].numpy(), layer["b"]) <= 1e-5


@pytest.mark.parametrize("which", ["PPO", "SAC"])
def test_train_offline_matches_reference(which):
    """48 contexts × 2 epochs (batch 16): the same rng.choice draws on
    near-equal probabilities, so the same arms, and weights within 1e-4."""
    ctxs = _contexts(48, 30)
    table = np.random.default_rng(31).normal(size=(48, 11))
    reward_fn = lambda i, a: float(table[i, a])
    held = _contexts(32, 32)
    if which == "PPO":
        jp, tp = _carry_ppo(3)
        nets = (("pi", "pi"), ("v", "v"))
    else:
        jp, tp = _carry_sac(3)
        nets = (("q1", "q1"), ("q2", "q2"))
    jp.train_offline(ctxs, reward_fn, epochs=2, batch=16)
    tp.train_offline(ctxs, reward_fn, epochs=2, batch=16)
    for jn, tn in nets:
        for layer, want in zip(_layers(getattr(tp, tn)),
                               jax.tree.map(np.asarray, getattr(jp, jn))):
            assert _rel(layer["w"], want["w"]) <= 1e-4
            assert _rel(layer["b"], want["b"]) <= 1e-4
    rng = np.random.default_rng(33)
    for c in held:
        avail = rng.uniform(size=11) < 0.8
        avail[0] = True
        assert tp.select(c, avail) == jp.select(c, avail)
