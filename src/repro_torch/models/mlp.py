"""MLPs (port of ``repro/models/mlp.py``): the gated dense MLP
``act(x @ w_gate) * (x @ w_up) @ w_down`` and the mixture of experts with
sort-based dispatch (the reference's local path, ``mesh=None``).

The MoE routes each token to its ``top_k`` experts (softmax over the fp32
router, the kept probabilities renormalized), sorts the flat (token-major,
k-minor) assignments by expert, stably, and gives each the rank within its
expert as its slot; an expert holds ``capacity`` slots, and the
assignments past them are dropped, as the reference drops them.  The
experts run as three batched products over the (E, capacity, D) buffer,
plain matrix products as the reference's ``jnp.einsum``.  A token's kept
contributions are summed in a fixed order, one add after another in the
order of their expert ids (the order of the reference's scatter-add), with
no atomic add: on the card ``index_add_`` would sum them in a different
order from run to run.

With a mesh whose ``model`` dim has more than one rank, the MoE runs the
reference's expert-parallel path: one ``shard_map``
(``distributed/compat.py``) over the ``model`` dim, each rank holding
``E / tp`` experts (``expert_lo`` the first); routing is recomputed on
every rank, the assignments to other ranks' experts drop, and the shared
expert's F-chunk joins the same ``psum``.  Within a rank a token's
experts add in expert-id order as above; across ranks the partial sums
add by one all-reduce (``compat.psum``), in the tokens' dtype.  ``aux`` is
``pmean``'d over the batch axes.  Capacity comes from the tokens of one
data shard, as the reference sizes it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed import compat
from repro_torch.distributed.sharding import P, batch_axes, mesh_shape
from repro_torch.models import common as cm


class MLP(nn.Module):
    """Weights ``w_gate``/``w_up`` (d, f) and ``w_down`` (f, d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        dt = cm.dtype_of(cfg)
        f = d_ff or cfg.d_ff
        g = generator
        for name, fan_in, out in (("w_gate", cfg.d_model, f),
                                  ("w_up", cfg.d_model, f),
                                  ("w_down", f, cfg.d_model)):
            setattr(self, name,
                    cm.param(cm.dense_init(g, fan_in, (out,), dt, device)))


def init_mlp(cfg: ArchConfig, generator: torch.Generator, device,
             d_ff: Optional[int] = None) -> MLP:
    return MLP(cfg, generator, device, d_ff)


def mlp_fwd(p: MLP, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = cm.act_fn(cfg.act)
    return cm.mm(act(cm.mm(x, p.w_gate)) * cm.mm(x, p.w_up), p.w_down)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _stack_init(generator: torch.Generator, n: int, fan_in: int, out: int,
                dtype, device) -> torch.Tensor:
    """``n`` truncated-normal fan-in weights (fan_in, out) stacked in
    ``dtype``, drawn one at a time: the fp32 transient is one expert's,
    not the stack's (15 GB for deepseek-v3's (256, 7168, 2048)).  On the
    ``meta`` device (shapes only) nothing is drawn."""
    w = torch.empty((n, fan_in, out), dtype=dtype, device=device)
    if w.is_meta:  # shapes only: nothing to draw
        return w
    for i in range(n):
        w[i] = cm.dense_init(generator, fan_in, (out,), dtype, device)
    return w


class MoE(nn.Module):
    """``router`` (d, E), kept fp32 in a bf16 model as the reference draws
    it; the expert stacks ``we_gate``/``we_up`` (E, d, f) and ``we_down``
    (E, f, d); ``shared``, a dense :class:`MLP` of width f·n_shared, when
    the config has shared experts."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        m: MoEConfig = cfg.moe
        dt = cm.dtype_of(cfg)
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        g = generator
        self.router = cm.param(cm.dense_init(g, d, (e,), torch.float32,
                                             device))
        for name, fan_in, out in (("we_gate", d, f), ("we_up", d, f),
                                  ("we_down", f, d)):
            setattr(self, name, cm.param(
                _stack_init(g, e, fan_in, out, dt, device)))
        if m.n_shared:
            self.shared = MLP(cfg, g, device, d_ff=f * m.n_shared)


def init_moe(cfg: ArchConfig, generator: torch.Generator, device) -> MoE:
    return MoE(cfg, generator, device)


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots per expert: at least 8, at most the token count."""
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, min(c, n_tokens))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(router: torch.Tensor, xf: torch.Tensor, m: MoEConfig):
    """``(top_p, top_idx, aux)`` of the tokens ``xf`` (T, D): the kept
    probabilities (T, k) renormalized to sum 1, the experts (T, k) and the
    Switch-style balance term ``E · Σ_e mean(probs_e) · mean(count_e)``."""
    logits = xf.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = _top_k(probs, m.top_k)
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                min=1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(top_idx, m.n_experts)
                    .sum(dim=1).to(torch.float32), dim=0)
    aux = m.n_experts * torch.sum(me * ce)
    return top_p, top_idx, aux


def _dispatch(top_idx: torch.Tensor, capacity: int, n_experts: int,
              expert_lo: int = 0):
    """The reference's slot assignment: ``(order, slot, keep)`` over the
    flat (token-major, k-minor) assignments sorted stably by expert —
    ``order`` the sort, ``slot`` each sorted assignment's row ``e ·
    capacity + rank within e`` of the expert buffer (``E · capacity``, the
    extra row, where it is dropped), ``keep`` whether its rank is under
    ``capacity``.  The buffer holds the ``n_experts`` experts from
    ``expert_lo`` on; assignments to other experts sort last and drop."""
    flat_e = top_idx.reshape(-1) - expert_lo
    valid = (flat_e >= 0) & (flat_e < n_experts)
    key = torch.where(valid, flat_e, n_experts)
    order = torch.argsort(key, stable=True)
    se = key[order]
    # each expert's first sorted position (the reference's cumsum of the
    # counts less the counts; a search needs no count sized on the host)
    starts = torch.searchsorted(
        se, torch.arange(n_experts + 1, device=se.device, dtype=se.dtype))
    pos = torch.arange(se.numel(), device=se.device) - starts[se]
    keep = valid[order] & (pos < capacity)
    slot = torch.where(keep, se * capacity + pos, n_experts * capacity)
    return order, slot, keep


def _dispatch_compute(xf, we_gate, we_up, we_down, top_idx, top_p,
                      capacity: int, act, expert_lo: int = 0) -> torch.Tensor:
    """Sort-based dispatch, the experts' products and the combine; ``xf``
    (T, D), ``we_*`` (E_blk, ...) the experts from ``expert_lo`` on,
    ``top_idx``/``top_p`` (T, k) over all experts.  Returns the combined
    (T, D) in ``xf``'s dtype."""
    t, d = xf.shape
    e = we_gate.shape[0]
    k = top_idx.shape[1]
    order, slot, keep = _dispatch(top_idx, capacity, e, expert_lo)
    st = order // k  # the sorted assignments' tokens
    rows = e * capacity
    # scatter the kept tokens into their slots; every dropped assignment
    # lands on the extra row, which is cut off
    buf = xf.new_zeros(rows + 1, d).index_copy(0, slot, xf[st])
    buf = buf[:rows].view(e, capacity, d)
    h = act(torch.bmm(buf, we_gate)) * torch.bmm(buf, we_up)
    out_buf = torch.bmm(h, we_down).reshape(rows, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(1, d)])
    w = torch.where(keep, top_p.reshape(-1)[order], 0.0)
    contrib = out_buf[slot] * w[:, None].to(out_buf.dtype)
    # each token's k contributions in the order the sort by expert gave
    # them (increasing expert id), added one after another
    c = contrib[torch.argsort(st, stable=True)].view(t, k, d)
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]
    return out


def moe_fwd(p: MoE, cfg: ArchConfig, x: torch.Tensor, *, mesh=None,
            axis: str = "model"):
    """Returns ``(out, aux)``; ``x`` (B, S, D).  The shared experts, when
    the config has them, are added to the routed ones.  With ``mesh``
    (``axis`` of more than one rank) the expert-parallel path, its
    results DTensors."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    act = cm.act_fn(cfg.act)
    if mesh is not None and mesh_shape(mesh).get(axis, 1) > 1:
        out, aux = _moe_sharded(p, cfg, xf, mesh, axis, act)
        return out.reshape(b, s, d), aux
    top_p, top_idx, aux = _route(p.router, xf, m)
    out = _dispatch_compute(xf, p.we_gate, p.we_up, p.we_down, top_idx,
                            top_p, _capacity(b * s, m), act)
    if m.n_shared:
        out = out + mlp_fwd(p.shared, cfg, xf)
    return out.reshape(b, s, d), aux


def _moe_sharded(p: MoE, cfg: ArchConfig, xf, mesh, axis: str, act):
    """The reference's ``shard_fn`` under ``compat.shard_map`` with its
    ``in_specs``/``out_specs``: ``xf`` split over the batch axes, the
    expert stacks over ``axis``, the shared expert's F dim over
    ``axis``; ``(out (T, D), aux)``."""
    m: MoEConfig = cfg.moe
    t = xf.shape[0]
    tp = mesh_shape(mesh)[axis]
    e_blk = m.n_experts // tp
    ba = batch_axes(mesh)
    n_batch = 1
    for a in ba:
        n_batch *= mesh_shape(mesh)[a]
    # capacity per data shard: the body sees t / n_batch tokens
    capacity = _capacity(t // n_batch if t % n_batch == 0 else t, m)

    def shard_fn(xf_l, router, wg, wu, wd, shared=None):
        top_p, top_idx, aux = _route(router, xf_l, m)
        out_l = _dispatch_compute(
            xf_l, wg, wu, wd, top_idx, top_p, capacity, act,
            expert_lo=compat.axis_index(mesh, axis) * e_blk)
        if shared is not None:
            # this rank's F-chunk of the shared expert, in the same psum
            g = act(xf_l @ shared["w_gate"]) * (xf_l @ shared["w_up"])
            out_l = out_l + (g.to(xf_l.dtype) @ shared["w_down"]).to(
                out_l.dtype)
        out_l = compat.psum(out_l, axis, mesh)
        # aux is the same on every rank of `axis`: its cotangent counts
        # once in the sum over `axis` that the replicated inputs receive
        aux = compat.invariant(aux, axis, mesh)
        if ba:
            aux = compat.pmean(aux, ba, mesh)
        return out_l, aux

    args = [xf, p.router, p.we_gate, p.we_up, p.we_down]
    in_specs = [P(ba, None), P(None, None), P(axis, None, None),
                P(axis, None, None), P(axis, None, None)]
    if m.n_shared:
        args.append({"w_gate": p.shared.w_gate, "w_up": p.shared.w_up,
                     "w_down": p.shared.w_down})
        in_specs.append({"w_gate": P(None, axis), "w_up": P(None, axis),
                         "w_down": P(axis, None)})
    out, aux = compat.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                out_specs=(P(ba, None), P()))(*args)
    return out, aux
