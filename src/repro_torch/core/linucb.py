"""LinUCB contextual-bandit scheduler state + Algorithm 1 (arm selection),
in PyTorch on an explicit device (port of ``repro/core/linucb.py``).

Scoring (Eq. 7):  p_a = θ̂_aᵀc + α·√(cᵀA_a⁻¹c) + β·√(ln(n+1)/(1+n_a))
Sampling (Eq. 8): softmax over p_a with temperature τ (Eq. 9, decaying).
Update (Eq. 10):  A_a += ccᵀ + λI;  b_a += r·c   (per-step λI shrinkage).
Decay (Eq. 11):   α, β decay linearly after the warm-up period N_w.

Vectorized over arms, fp32 throughout, as the reference computes it.  No
function here waits for the device: ``select`` returns a 0-d tensor, and
the caller's ``int(arm)`` is the one host sync of a decision.

* The sampled arm is a Gumbel-max draw, ``argmax(s/τ + g)`` with ``g``
  Gumbel noise from the caller's ``torch.Generator`` on the state's device
  — the construction ``jax.random.categorical`` uses, but not its PRNG
  bits, so the sampled branch matches the reference in distribution.
* ``A⁻¹`` comes from ``torch.linalg.inv_ex``, which neither raises on a
  singular ``A`` nor checks for one on the host (``A`` holds the identity
  prior plus λI per pull, so it stays positive definite).
* ``update`` adds the one-hot outer product to every arm's slice, as the
  reference does: the untouched slices gain exact zeros, so a zero-started
  accumulator holds the increments' bits (``serving/fleet/federated.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch


@dataclass(frozen=True)
class LinUCBParams:
    alpha0: float = 1.0
    alpha_min: float = 0.05
    beta0: float = 0.5
    beta_min: float = 0.02
    tau0: float = 0.35
    tau_min: float = 0.02
    warmup: int = 60  # N_w
    decay_k: float = 400.0  # shared decay constant K
    lam: float = 1e-3  # per-step ridge increment λ
    n_min: int = 3  # forced-exploration minimum pulls (Alg. 2)


class LinUCBState(NamedTuple):
    A: torch.Tensor  # (K, d, d) fp32
    b: torch.Tensor  # (K, d) fp32
    counts: torch.Tensor  # (K,) fp32


def init_state(n_arms: int, d: int, device) -> LinUCBState:
    return LinUCBState(
        A=torch.eye(d, dtype=torch.float32, device=device).repeat(n_arms, 1, 1),
        b=torch.zeros((n_arms, d), dtype=torch.float32, device=device),
        counts=torch.zeros((n_arms,), dtype=torch.float32, device=device),
    )


def _decayed(p: LinUCBParams, n: torch.Tensor):
    prog = torch.clamp_min(n - p.warmup, 0.0) / p.decay_k
    alpha = torch.clamp_min(p.alpha0 - prog, p.alpha_min)
    beta = torch.clamp_min(p.beta0 * (1.0 - prog), p.beta_min)
    tau = torch.clamp_min(p.tau0 * (1.0 - prog), p.tau_min)
    return alpha, beta, tau


def scores(state: LinUCBState, ctx: torch.Tensor,
           p: LinUCBParams) -> torch.Tensor:
    """Eq. 7 UCB scores for every arm (K,)."""
    n = torch.sum(state.counts)
    alpha, beta, _ = _decayed(p, n)
    A_inv = torch.linalg.inv_ex(state.A).inverse  # (K, d, d)
    theta = torch.einsum("kde,ke->kd", A_inv, state.b)
    exploit = theta @ ctx
    explore_ctx = torch.sqrt(torch.clamp_min(
        torch.einsum("d,kde,e->k", ctx, A_inv, ctx), 0.0))
    explore_freq = torch.sqrt(torch.log(n + 1.0) / (1.0 + state.counts))
    return exploit + alpha * explore_ctx + beta * explore_freq


def select(state: LinUCBState, ctx: torch.Tensor, generator: torch.Generator,
           p: LinUCBParams,
           avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Algorithm 1 + forced exploration (Alg. 2 line 8): returns the arm
    index as a 0-d tensor on the state's device.

    ``avail``: boolean (K,) mask of currently-available arms."""
    k = state.A.shape[0]
    dev = state.A.device
    avail = torch.ones(k, dtype=torch.bool, device=dev) if avail is None else avail
    n = torch.sum(state.counts)
    _, _, tau = _decayed(p, n)

    s = torch.where(avail, scores(state, ctx, p), -torch.inf)
    u = torch.rand(k, generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(torch.clamp_min(
        u, torch.finfo(torch.float32).tiny)))
    soft_arm = torch.argmax(s / tau + gumbel)

    # forced exploration: any available arm with counts < N_min →
    # least-pulled (the first such index on ties)
    under = avail & (state.counts < p.n_min)
    forced_arm = torch.argmin(torch.where(under, state.counts, torch.inf))
    return torch.where(torch.any(under), forced_arm, soft_arm)


def update(state: LinUCBState, arm, ctx: torch.Tensor, reward,
           p: LinUCBParams) -> LinUCBState:
    """Eq. 10 with per-step λI shrinkage (only the pulled arm).  ``arm``
    is an int or a 0-d integer tensor, ``reward`` a float or a 0-d fp32
    tensor."""
    k, d = state.A.shape[0], ctx.shape[0]
    dev = state.A.device
    outer = torch.outer(ctx, ctx) + p.lam * torch.eye(d, dtype=torch.float32,
                                                      device=dev)
    one_hot = (torch.arange(k, device=dev) == arm).to(torch.float32)
    A = state.A + one_hot[:, None, None] * outer[None]
    b = state.b + one_hot[:, None] * (reward * ctx)[None]
    return LinUCBState(A=A, b=b, counts=state.counts + one_hot)
