"""Scheduling policies (port of ``repro/core/policies.py``): RISE-LinUCB
(paper Alg. 1+2) and the four baselines from §V-D — Round-Robin, Greedy
(makespan heuristic, fixed mid relay step), PPO and SAC (offline-trained
on the same data, per the paper's protocol).

Every policy keeps the reference's numpy-facing interface,
``select(ctx, avail) -> int`` and ``update(ctx, arm, reward)``.  RISE,
PPO and SAC hold their state on a device: the card unless the caller
passes ``device="cpu"``.  Weights and LinUCB state carry across from the
reference with ``repro_torch.training.checkpoint.mlp_params_from_jax`` and
``linucb_state_from_jax``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core import linucb
from repro_torch.core.context import CTX_DIM
from repro_torch.device import resolve_device
from repro_torch.serving.arms import ARMS, N_ARMS
from repro_torch.serving.latency import STEP_COST, T_FULL


class Policy:
    name = "policy"

    def select(self, ctx: np.ndarray, avail: np.ndarray) -> int:
        raise NotImplementedError

    def update(self, ctx: np.ndarray, arm: int, reward: float) -> None:
        pass


# ---------------------------------------------------------------------------
# RISE (LinUCB) + its ablation variants
# ---------------------------------------------------------------------------


class RisePolicy(Policy):
    """LinUCB over ``arms``; the state lives on ``device``, and the arm
    sampling draws from a ``torch.Generator`` there, seeded with
    ``seed``."""

    name = "RISE"

    def __init__(
        self,
        seed: int = 0,
        params: Optional[linucb.LinUCBParams] = None,
        *,
        use_context: bool = True,  # ablation: w/o Context
        forced_exploration: bool = True,  # ablation: w/o Forced Exploration
        fixed_relay_step: Optional[int] = None,  # ablation: Fixed Relay Step
        ctx_dim: int = CTX_DIM,  # 8 base dims (+2 with telemetry_context)
        arms=None,  # action space (program-template arms); default Table II
        device=None,
    ):
        self.p = params or linucb.LinUCBParams()
        if not forced_exploration:
            self.p = linucb.LinUCBParams(**{**self.p.__dict__, "n_min": 0})
        self.arms = tuple(arms) if arms is not None else ARMS
        self.device = resolve_device(device)
        self.state = linucb.init_state(len(self.arms), ctx_dim, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.use_context = use_context
        self.fixed_relay_step = fixed_relay_step

    def _ctx(self, ctx) -> torch.Tensor:
        if not self.use_context:
            ctx = np.ones_like(ctx) / np.sqrt(len(ctx))
        return torch.as_tensor(np.asarray(ctx, np.float32), device=self.device)

    def _mask(self, avail):
        if self.fixed_relay_step is None:
            return avail
        keep = np.array(
            [a.relay_step in (None, self.fixed_relay_step) for a in self.arms]
        )
        out = avail & keep
        return out if out.any() else avail

    def select(self, ctx, avail):
        mask = torch.as_tensor(np.asarray(self._mask(avail), bool),
                               device=self.device)
        return int(linucb.select(self.state, self._ctx(ctx), self.generator,
                                 self.p, mask))

    def update(self, ctx, arm, reward):
        self.state = linucb.update(self.state, int(arm), self._ctx(ctx),
                                   float(np.float32(reward)), self.p)


# ---------------------------------------------------------------------------
# Round-Robin
# ---------------------------------------------------------------------------


class RoundRobinPolicy(Policy):
    name = "RR"

    def __init__(self):
        self.i = 0

    def select(self, ctx, avail):
        n = len(avail)
        for _ in range(n):
            arm = self.i % n
            self.i += 1
            if avail[arm]:
                return arm
        return int(np.argmax(avail))


# ---------------------------------------------------------------------------
# Greedy: least-loaded pool, fixed mid-range relay step
# ---------------------------------------------------------------------------


class GreedyPolicy(Policy):
    name = "Greedy"
    MID = 15

    def select(self, ctx, avail):
        # candidates: standalone + the two s=15 relays; pick min expected
        # makespan using the occupancy features in the context tail
        l_vega, l_sdxl, l_sd3 = ctx[5], ctx[6], ctx[7]
        cands = []
        for a in ARMS:
            if not avail[a.idx]:
                continue
            if a.relay_step not in (None, self.MID):
                continue
            if a.family is None:
                t = STEP_COST["vega"] * T_FULL["vega"] * (1 + 2 * l_vega)
            elif a.family == "XL":
                t = (
                    STEP_COST["sdxl"] * self.MID
                    + STEP_COST["vega"] * 17
                ) * (1 + 2 * max(l_sdxl, l_vega))
            else:
                t = (
                    STEP_COST["sd3l"] * self.MID
                    + STEP_COST["sd3m"] * 35
                ) * (1 + 2 * l_sd3)
            cands.append((t, a.idx))
        if not cands:
            return int(np.argmax(avail))
        return min(cands)[1]


# ---------------------------------------------------------------------------
# PPO (offline-trained, discrete)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The reference's ``_mlp``: ``x @ w + b`` per layer, tanh between
    layers and none after the last.  ``w[i]`` is the reference's ``"w"``
    itself, (fan_in, fan_out), not transposed; default weights are
    N(0, 1/fan_in) draws from ``generator`` and zero biases."""

    def __init__(self, sizes: Sequence[int], generator: torch.Generator,
                 device):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(torch.randn((a, b), generator=generator,
                                     device=device) / math.sqrt(a))
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros((b,), device=device)) for b in sizes[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < len(self.w) - 1:
                x = torch.tanh(x)
        return x


def _sgd(module: nn.Module, grads, lr: float) -> None:
    """The reference's plain ``p - lr·g`` on every parameter."""
    with torch.no_grad():
        for p, g in zip(module.parameters(), grads):
            p.copy_(p - lr * g)


class PPOPolicy(Policy):
    name = "PPO"

    def __init__(self, seed: int = 0, lr: float = 3e-3, clip: float = 0.2, *,
                 device=None):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pi = MLP([CTX_DIM, 64, 64, N_ARMS], gen, self.device)
        self.v = MLP([CTX_DIM, 64, 1], gen, self.device)
        self.lr, self.clip = lr, clip

    def loss(self, ctx, arm, reward, logp_old):
        """The clipped surrogate + 0.5·value loss − 0.01·entropy; the
        advantage's value is detached (the reference's stop_gradient)."""
        logits = self.pi(ctx)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all[torch.arange(ctx.shape[0], device=ctx.device), arm]
        val = self.v(ctx)[:, 0]
        adv = reward - val.detach()
        ratio = torch.exp(logp - logp_old)
        pg = -torch.mean(torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv))
        vf = torch.mean((val - reward) ** 2)
        ent = -torch.mean(torch.sum(torch.softmax(logits, -1) * logp_all, -1))
        return pg + 0.5 * vf - 0.01 * ent

    def grad(self, ctx, arm, reward, logp_old):
        """Gradients of :meth:`loss` w.r.t. ``pi``'s then ``v``'s
        parameters (the reference's ``jax.grad(argnums=(0, 1))``)."""
        params = list(self.pi.parameters()) + list(self.v.parameters())
        grads = torch.autograd.grad(self.loss(ctx, arm, reward, logp_old),
                                    params)
        n_pi = len(list(self.pi.parameters()))
        return grads[:n_pi], grads[n_pi:]

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def logits(self, ctx: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.pi(self._t(ctx)).cpu().numpy()

    def train_offline(self, contexts, reward_fn, *, epochs=12, batch=64, seed=1):
        """reward_fn(i, arm) → reward for training context i."""
        rng = np.random.default_rng(seed)
        n = len(contexts)
        for ep in range(epochs):
            idx = rng.permutation(n)
            for lo in range(0, n, batch):
                sel = idx[lo : lo + batch]
                logits = self.logits(contexts[sel])
                probs = np.exp(logits - logits.max(-1, keepdims=True))
                probs /= probs.sum(-1, keepdims=True)
                arms = np.array([rng.choice(N_ARMS, p=p) for p in probs])
                rewards = np.array([reward_fn(i, a) for i, a in zip(sel, arms)])
                logp_old = np.log(probs[np.arange(len(sel)), arms] + 1e-9)
                g_pi, g_v = self.grad(
                    self._t(contexts[sel]), self._t(arms, torch.long),
                    self._t(rewards), self._t(logp_old))
                _sgd(self.pi, g_pi, self.lr)
                _sgd(self.v, g_v, self.lr)

    def select(self, ctx, avail):
        logits = self.logits(ctx[None])[0]
        logits[~avail] = -np.inf
        return int(np.argmax(logits))


# ---------------------------------------------------------------------------
# SAC (discrete, offline-trained)
# ---------------------------------------------------------------------------


class SACPolicy(Policy):
    name = "SAC"

    def __init__(self, seed: int = 0, lr: float = 3e-3, alpha: float = 0.25,
                 *, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.q1 = MLP([CTX_DIM, 64, 64, N_ARMS], gen, self.device)
        self.q2 = MLP([CTX_DIM, 64, 64, N_ARMS], gen, self.device)
        self.alpha, self.lr = alpha, lr

    @staticmethod
    def q_loss(q: MLP, ctx, arm, reward):
        qv = q(ctx)[torch.arange(ctx.shape[0], device=ctx.device), arm]
        return torch.mean((qv - reward) ** 2)

    def qgrad(self, q: MLP, ctx, arm, reward):
        return torch.autograd.grad(self.q_loss(q, ctx, arm, reward),
                                   list(q.parameters()))

    def q_min(self, ctx: np.ndarray) -> np.ndarray:
        """min(Q1, Q2) on a numpy batch of contexts."""
        with torch.no_grad():
            c = torch.as_tensor(ctx, device=self.device)
            return np.minimum(self.q1(c).cpu().numpy(),
                              self.q2(c).cpu().numpy())

    def train_offline(self, contexts, reward_fn, *, epochs=12, batch=64, seed=2):
        rng = np.random.default_rng(seed)
        n = len(contexts)
        for ep in range(epochs):
            idx = rng.permutation(n)
            for lo in range(0, n, batch):
                sel = idx[lo : lo + batch]
                q = self.q_min(contexts[sel])
                # entropy-regularized softmax policy over Q
                p = np.exp((q - q.max(-1, keepdims=True)) / self.alpha)
                p /= p.sum(-1, keepdims=True)
                arms = np.array([rng.choice(N_ARMS, p=pi) for pi in p])
                rewards = torch.as_tensor(
                    [reward_fn(i, a) for i, a in zip(sel, arms)],
                    dtype=torch.float32, device=self.device)
                ctx = torch.as_tensor(contexts[sel], device=self.device)
                arms_t = torch.as_tensor(arms, device=self.device)
                for q_net in (self.q1, self.q2):
                    _sgd(q_net, self.qgrad(q_net, ctx, arms_t, rewards),
                         self.lr)

    def select(self, ctx, avail):
        q = self.q_min(ctx[None])[0]
        q[~avail] = -np.inf
        return int(np.argmax(q))
