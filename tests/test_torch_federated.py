"""The port's federated LinUCB (``serving/fleet/federated.py``): the
merge-math cases of ``tests/test_fleet.py`` run on the port, and its
``centralized_reference`` against the reference's on the same
observations.

With at most one observation per cluster per gossip round the merged
state equals a centralized policy's bit for bit (delta accumulators start
at zero, and IEEE ``0 + x == x``, so the fold replays the centralized
summation order); with more it holds to float tolerance.  The reference's
``centralized_reference`` applies its ``update`` unjitted, so the port's
equals it bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linucb as jl
from repro.serving.fleet import federated as jfed
from repro_torch.core import linucb as tl
from repro_torch.core.policies import RisePolicy
from repro_torch.serving.fleet import (FederatedRisePolicy, LinUCBFederation,
                                       add_states, centralized_reference,
                                       zero_state)

torch.set_num_threads(1)

D = 8  # base context dim
N_ARMS = 11


def _states_equal(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b)
    )


def _fed(seed, **kw):
    return FederatedRisePolicy(seed=seed, device="cpu", **kw)


# ---------------------------------------------------------------------------
# federated merge math (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def _merge_scenario(seed: int, n_clusters: int, rounds: int,
                    per_round: int) -> None:
    """Clusters observe ``per_round`` samples each per gossip round; after
    every round the federation merges.  The merged state must equal a
    centralized policy fed the same observations in round-major /
    cluster-index order — bitwise when per_round == 1, to float tolerance
    otherwise."""
    rng = np.random.default_rng(seed)
    pols = [_fed(5) for _ in range(n_clusters)]
    fed = LinUCBFederation(pols)
    central = RisePolicy(seed=5, device="cpu")
    for _ in range(rounds):
        for p in pols:
            for _ in range(per_round):
                ctx = rng.random(D, dtype=np.float64).astype(np.float32)
                arm = int(rng.integers(0, N_ARMS))
                r = float(rng.normal())
                p.update(ctx, arm, r)
                central.update(ctx, arm, r)
        fed.gossip()
    for p in pols:  # every cluster holds the merged state
        assert _states_equal(p.state, pols[0].state)
    if per_round == 1:
        assert _states_equal(pols[0].state, central.state), f"seed={seed}"
    else:
        for x, y in zip(pols[0].state, central.state):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-5
            )
    # counts are whole numbers either way: exact regardless of per_round
    assert np.array_equal(
        np.asarray(pols[0].state.counts), np.asarray(central.state.counts)
    )


@pytest.mark.parametrize("seed", range(20))
def test_merge_of_deltas_equals_centralized_bitwise(seed):
    """≤1 observation per cluster per round → bitwise equality."""
    rng = np.random.default_rng(seed + 1000)
    _merge_scenario(
        seed,
        n_clusters=int(rng.integers(2, 5)),
        rounds=int(rng.integers(1, 6)),
        per_round=1,
    )


@pytest.mark.parametrize("seed", range(5))
def test_merge_multi_update_matches_centralized_to_tolerance(seed):
    """Many observations between gossips → equal up to summation order."""
    _merge_scenario(seed, n_clusters=3, rounds=3, per_round=7)


def test_gossip_without_observations_is_a_noop():
    """Deltas zero on read: double gossip cannot double-count."""
    pols = [_fed(2) for _ in range(3)]
    fed = LinUCBFederation(pols)
    rng = np.random.default_rng(0)
    for p in pols:
        p.update(rng.random(D).astype(np.float32), 4, 1.0)
    merged = fed.gossip()
    again = fed.gossip()  # no updates in between
    assert _states_equal(merged, again)
    for p in pols:
        assert _states_equal(p.state, merged)


def test_federation_rejects_mismatched_initial_state():
    a = _fed(0)
    b = _fed(0, ctx_dim=D + 2)
    with pytest.raises(ValueError, match="identical state"):
        LinUCBFederation([a, b])
    with pytest.raises(ValueError, match="at least one policy"):
        LinUCBFederation([])


def test_federated_policy_selects_like_plain_rise():
    """Same seed, same observations → same decisions (the delta mirror
    must not perturb the live state or the generator stream)."""
    rng = np.random.default_rng(3)
    fed, plain = _fed(9), RisePolicy(seed=9, device="cpu")
    avail = np.ones(N_ARMS, bool)
    for _ in range(40):
        ctx = rng.random(D).astype(np.float32)
        a1, a2 = fed.select(ctx, avail), plain.select(ctx, avail)
        assert a1 == a2
        r = float(rng.normal())
        fed.update(ctx, a1, r)
        plain.update(ctx, a2, r)
    assert _states_equal(fed.state, plain.state)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _observations(n, seed, k=N_ARMS, d=D):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(k)), rng.random(d).astype(np.float32),
             float(rng.normal())) for _ in range(n)]


@pytest.mark.parametrize("n", [0, 1, 40])
def test_centralized_reference_equals_reference(n):
    obs = _observations(n, seed=n)
    got = centralized_reference(obs, N_ARMS, D, device="cpu")
    want = jfed.centralized_reference(obs, N_ARMS, D)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.device == torch.device("cpu")
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_zero_state_and_add_states_equal_reference():
    z, zj = zero_state(4, 3, "cpu"), jfed.zero_state(4, 3)
    assert _states_equal(z, zj)
    obs = _observations(6, seed=7, k=4, d=3)
    a = centralized_reference(obs, 4, 3, device="cpu")
    aj = jfed.centralized_reference(obs, 4, 3)
    assert _states_equal(add_states(a, a), jfed.add_states(aj, aj))
    assert _states_equal(add_states(z, a), a)


def test_delta_holds_the_increments_bits():
    """A delta after one observation is the reference update applied to a
    zero state, bit for bit."""
    p = _fed(1)
    arm, ctx, r = _observations(1, seed=4)[0]
    p.update(ctx, arm, r)
    want = jl.update(jfed.zero_state(N_ARMS, D), arm, jnp.asarray(ctx),
                     float(np.float32(r)), jl.LinUCBParams())
    assert _states_equal(p.take_delta(), want)
    assert _states_equal(p.delta, zero_state(N_ARMS, D, "cpu"))
    assert isinstance(p.delta, tl.LinUCBState)


def test_centralized_reference_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        centralized_reference([], N_ARMS, D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedRisePolicy()
