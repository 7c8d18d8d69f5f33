"""Scheduler introspection: what the LinUCB bandit has learned (port of
``repro/serving/obs/sched.py``).

Two complementary reads, both pure (no policy mutation, no clock/RNG
contact):

* :func:`linucb_snapshot` — per-arm pulls, ridge-regression point
  estimates θ̂ and the Eq. 7 confidence width √(cᵀA⁻¹c) at a reference
  context, straight from a ``RisePolicy``'s sufficient statistics;
* :class:`SchedulerIntrospection` — an accumulator over completed
  records (any objects with ``.rid``, ``.arm`` and ``.reward``, such as
  the serving engine's ``Record``): per-arm pulls / reward
  means and the cumulative regret trajectory vs the offline-best arm
  (hindsight-best mean realized reward), decimated to a bounded curve.

``scheduler_report`` combines the two into the JSON blob the fig6 sweep
exports per policy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MAX_CURVE_POINTS = 256


class SchedulerIntrospection:
    """Per-arm pull/reward bookkeeping plus a cumulative-regret curve.

    Regret is measured vs the *offline-best arm*: the arm with the highest
    mean realized reward over the whole run (hindsight), so the per-step
    reward sequence is retained until :meth:`regret_curve` decimates it —
    this is an offline sweep-analysis tool, not fleet telemetry (the
    bounded-memory path is ``obs.stats``)."""

    def __init__(self, n_arms: int):
        self.n_arms = n_arms
        self.pulls = np.zeros(n_arms, np.int64)
        self.reward_sum = np.zeros(n_arms, np.float64)
        self._rewards: List[float] = []
        self._arms: List[int] = []

    def record(self, arm: int, reward: float) -> None:
        """Account one scheduling decision and its realized reward."""
        self.pulls[arm] += 1
        self.reward_sum[arm] += reward
        self._arms.append(arm)
        self._rewards.append(reward)

    @classmethod
    def from_records(cls, records: Sequence, n_arms: int
                     ) -> "SchedulerIntrospection":
        """Build from a finished run's Records (replayed in rid order)."""
        intro = cls(n_arms)
        for r in sorted(records, key=lambda r: r.rid):
            intro.record(r.arm, r.reward)
        return intro

    def reward_means(self) -> np.ndarray:
        """Per-arm mean realized reward (0-pull arms read 0)."""
        return self.reward_sum / np.maximum(self.pulls, 1)

    @property
    def best_arm(self) -> int:
        """Hindsight-best arm: highest mean reward among pulled arms."""
        means = np.where(self.pulls > 0, self.reward_means(), -np.inf)
        return int(np.argmax(means))

    def cumulative_regret(self) -> float:
        """Σ_t (μ* − r_t) where μ* is the offline-best arm's mean reward."""
        if not self._rewards:
            return 0.0
        best = self.reward_means()[self.best_arm]
        return float(np.sum(best - np.asarray(self._rewards)))

    def regret_curve(self, max_points: int = MAX_CURVE_POINTS
                     ) -> List[List[float]]:
        """Decimated cumulative-regret trajectory: [[t, regret], ...]."""
        if not self._rewards:
            return []
        best = self.reward_means()[self.best_arm]
        curve = np.cumsum(best - np.asarray(self._rewards))
        idx = np.unique(np.linspace(0, len(curve) - 1,
                                    min(max_points, len(curve))).astype(int))
        return [[int(i + 1), float(curve[i])] for i in idx]

    def summary(self, labels: Optional[Sequence[str]] = None) -> dict:
        """JSON-ready digest: per-arm pulls/means plus run-level regret
        (``labels`` attaches arm display names)."""
        means = self.reward_means()
        per_arm = []
        for a in range(self.n_arms):
            d = {"arm": a, "pulls": int(self.pulls[a]),
                 "reward_mean": float(means[a]) if self.pulls[a] else None}
            if labels is not None:
                d["label"] = labels[a]
            per_arm.append(d)
        return {
            "n_decisions": len(self._rewards),
            "best_arm": self.best_arm,
            "cumulative_regret": self.cumulative_regret(),
            "per_arm": per_arm,
        }


def _host64(x) -> np.ndarray:
    """A state field (a tensor on any device, or an array) as fp64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def linucb_snapshot(policy, ctx: Optional[np.ndarray] = None) -> dict:
    """Read a ``RisePolicy``'s LinUCB state: per-arm pulls, θ̂ (A⁻¹b) and
    the Eq. 7 confidence width at ``ctx`` (default: the unit-norm constant
    context the w/o-Context ablation uses).  The state may live on any
    device: it is copied to the host and the algebra runs in fp64 numpy,
    so equal fp32 states give equal snapshots bit for bit."""
    state = getattr(policy, "state", None)
    if state is None:
        return {}
    A = _host64(state.A)
    b = _host64(state.b)
    counts = _host64(state.counts)
    d = A.shape[-1]
    if ctx is None:
        ctx = np.ones(d) / np.sqrt(d)
    ctx = np.asarray(ctx, np.float64)
    A_inv = np.linalg.inv(A)
    theta = np.einsum("kde,ke->kd", A_inv, b)
    width = np.sqrt(np.clip(
        np.einsum("d,kde,e->k", ctx, A_inv, ctx), 0.0, None
    ))
    return {
        "n_arms": int(A.shape[0]),
        "ctx_dim": int(d),
        "pulls": counts.astype(int).tolist(),
        "theta_norm": np.linalg.norm(theta, axis=1).tolist(),
        "expected_reward_at_ctx": (theta @ ctx).tolist(),
        "confidence_width_at_ctx": width.tolist(),
    }


def scheduler_report(policy, records: Sequence, arms,
                     ctx: Optional[np.ndarray] = None) -> dict:
    """The fig6-sweep export: decision-level introspection from the run's
    records plus (for LinUCB policies) the learned-state snapshot."""
    intro = SchedulerIntrospection.from_records(records, len(arms))
    out = intro.summary(labels=[a.label for a in arms])
    out["regret_curve"] = intro.regret_curve()
    snap = linucb_snapshot(policy, ctx)
    if snap:
        out["linucb"] = snap
    return out
