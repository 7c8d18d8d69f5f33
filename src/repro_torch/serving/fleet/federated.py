"""Federated LinUCB: periodic exact merge of per-cluster scheduler state
(port of ``repro/serving/fleet/federated.py``).

LinUCB's sufficient statistics are *additive*: every observation
contributes an independent increment ``ΔA = ccᵀ + λI``, ``Δb = r·c``,
``Δcounts = 1`` to its arm's slice, so the union of N clusters'
observations is exactly the sum of their increments over a shared prior.
Each :class:`FederatedRisePolicy` therefore accumulates a *delta* state —
the same ``linucb.update`` applied to a zero-initialized accumulator, so a
delta is bitwise the sum of the cluster's increments (IEEE ``0 + x == x``)
— and the :class:`LinUCBFederation` folds the deltas into a common base on
each gossip tick:

    merged = base (+) delta_0 (+) delta_1 (+) … (+) delta_{N-1}

``take_delta`` zeroes the accumulator on read, so an increment is folded
into the base exactly once (a second gossip with no new observations is a
no-op, bit for bit).  With at most one observation per cluster per gossip
round the merged state is *bitwise equal* to a centralized policy fed the
union of observations in round-major / cluster-index order; with more,
float non-associativity makes it equal only up to summation order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import linucb
from repro_torch.core.linucb import LinUCBState
from repro_torch.core.policies import RisePolicy
from repro_torch.device import resolve_device


def zero_state(n_arms: int, d: int, device) -> LinUCBState:
    """All-zeros LinUCB accumulator (note: NOT ``init_state``, whose A
    carries the identity prior — a delta must hold increments only, so
    folding it onto a base never re-adds the prior)."""
    return LinUCBState(
        A=torch.zeros((n_arms, d, d), dtype=torch.float32, device=device),
        b=torch.zeros((n_arms, d), dtype=torch.float32, device=device),
        counts=torch.zeros((n_arms,), dtype=torch.float32, device=device),
    )


def add_states(a: LinUCBState, b: LinUCBState) -> LinUCBState:
    """Elementwise sum of two LinUCB states (the federation fold step)."""
    return LinUCBState(A=a.A + b.A, b=a.b + b.b, counts=a.counts + b.counts)


def _zero_like(state: LinUCBState) -> LinUCBState:
    return zero_state(state.A.shape[0], state.A.shape[1], state.A.device)


class FederatedRisePolicy(RisePolicy):
    """RisePolicy that mirrors every update into a delta accumulator.

    ``select``/``update`` behave exactly like :class:`RisePolicy` (same
    state, same generator stream for a given seed); additionally each
    ``update`` applies the identical ``linucb.update`` to ``self.delta``,
    a zero-initialized state, so the delta is bitwise the sum of this
    cluster's increments since the last :meth:`take_delta`."""

    name = "RISE-fed"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.delta = _zero_like(self.state)

    def update(self, ctx, arm, reward):
        """One observation: updates the live state AND the gossip delta
        with the same function (so both see identical increments)."""
        super().update(ctx, arm, reward)
        self.delta = linucb.update(self.delta, int(arm), self._ctx(ctx),
                                   float(np.float32(reward)), self.p)

    def take_delta(self) -> LinUCBState:
        """Return the accumulated delta and zero it — each increment can
        therefore be folded into the federation base exactly once."""
        d = self.delta
        self.delta = _zero_like(d)
        return d


def _states_equal(a: LinUCBState, b: LinUCBState) -> bool:
    return all(x.shape == y.shape and x.device == y.device and torch.equal(x, y)
               for x, y in zip(a, b))


class LinUCBFederation:
    """Gossip coordinator over N :class:`FederatedRisePolicy` instances.

    All member policies must start from the same initial state (the
    shared prior becomes the federation ``base``).  :meth:`gossip` pulls
    every cluster's delta (zeroing it), folds them onto the base in
    cluster-index order, and installs the merged state everywhere — after
    which every cluster schedules with the union of all observations."""

    def __init__(self, policies: Sequence[FederatedRisePolicy]):
        self.policies: List[FederatedRisePolicy] = list(policies)
        if not self.policies:
            raise ValueError("federation needs at least one policy")
        base = self.policies[0].state
        for p in self.policies[1:]:
            if not _states_equal(base, p.state):
                raise ValueError(
                    "federated policies must start from identical state "
                    "(same ctx_dim, arms, prior and device)"
                )
        self.base = base
        self.n_gossips = 0

    def gossip(self) -> LinUCBState:
        """One merge round: fold every cluster's delta onto the base (in
        cluster-index order — the documented, deterministic summation
        order) and install the result as every cluster's live state and
        as the new base.  Returns the merged state."""
        merged = self.base
        for p in self.policies:
            merged = add_states(merged, p.take_delta())
        self.base = merged
        for p in self.policies:
            p.state = merged
        self.n_gossips += 1
        return merged


def centralized_reference(observations, n_arms: int, d: int,
                          params: Optional[linucb.LinUCBParams] = None,
                          device=None) -> LinUCBState:
    """Single-policy reference: apply ``(arm, ctx, reward)`` observations
    in sequence to one fresh state on ``device`` (the card unless the
    caller passes ``"cpu"``) — what the federation's merged state is
    compared against."""
    p = params or linucb.LinUCBParams()
    dev = resolve_device(device)
    st = linucb.init_state(n_arms, d, dev)
    for arm, ctx, reward in observations:
        st = linucb.update(
            st, int(arm), torch.as_tensor(np.asarray(ctx, np.float32),
                                          device=dev),
            float(np.float32(reward)), p,
        )
    return st
