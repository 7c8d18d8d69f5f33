"""Relay inference (paper §III) over N-hop programs and DAG plans (port
of ``repro/core/relay.py``): the large edge model runs the first s
steps, the latent crosses a segment boundary — raw, int8 round-tripped,
or fused into the boundary steps — and the next model resumes from its
Eq. 4 sigma-matched entry.  :func:`execute_program` folds a linear
program; :func:`execute_graph` walks a DAG plan with its Select and
Merge joins."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import torch

from repro_torch.core import boundary, samplers
from repro_torch.core.program import (MERGE_NODE, ROLES, SEGMENT_NODE,
                                      CompiledPlan, Handoff, RelayGraph,
                                      RelayProgram, RelaySegment, as_graph,
                                      compile_plan, phase_name,
                                      select_bound_pct)
from repro_torch.core.schedules import sigma_match
from repro_torch.quantization import latent_roundtrip, relative_deviation


@dataclass(frozen=True)
class FamilySpec:
    """One relay family: models sharing a latent space, keyed by role.
    Ladders are fp32 host tensors."""

    name: str  # "XL" (UNet/DDIM/Karras) or "F3" (MMDiT/RF/linear)
    kind: str  # "ddim" | "rf"
    sigmas_edge: torch.Tensor  # noise ladder of M_L (length T_e+1)
    sigmas_device: torch.Tensor  # noise ladder of M_S (length T_d+1)
    latent_shape: tuple = (8, 8, 4)
    sigmas_mid: Optional[torch.Tensor] = None  # ladder of M_mid (cascades)

    @property
    def t_edge(self) -> int:
        return len(self.sigmas_edge) - 1

    @property
    def t_device(self) -> int:
        return len(self.sigmas_device) - 1

    @property
    def t_mid(self) -> int:
        if self.sigmas_mid is None:
            raise ValueError(f"family {self.name} has no mid-size ladder")
        return len(self.sigmas_mid) - 1

    def ladder(self, role: str) -> torch.Tensor:
        """Sigma ladder of a model role ("large" | "mid" | "small")."""
        if role not in ROLES:
            raise KeyError(f"unknown model role {role!r}; expected one of {ROLES}")
        if role == "large":
            return self.sigmas_edge
        if role == "small":
            return self.sigmas_device
        if self.sigmas_mid is None:
            raise ValueError(f"family {self.name} has no mid-size ladder")
        return self.sigmas_mid


@dataclass(frozen=True)
class RelayPlan:
    """Two-hop view of a relay: the first handoff of a two-segment program."""

    family: str
    s: int  # edge handoff step
    s_prime: int  # device start step (sigma-matched)
    sigma_handoff: float
    sigma_resume: float

    @property
    def noise_gap(self) -> float:
        return abs(self.sigma_handoff - self.sigma_resume)


def make_relay_plan(spec: FamilySpec, s: int) -> RelayPlan:
    """Sigma-match the handoff (Eq. 4)."""
    sp = sigma_match(spec.sigmas_edge, s, spec.sigmas_device)
    return RelayPlan(
        family=spec.name,
        s=s,
        s_prime=sp,
        sigma_handoff=float(spec.sigmas_edge[s]),
        sigma_resume=float(spec.sigmas_device[sp]),
    )


def plan_view(program: RelayProgram) -> Optional[RelayPlan]:
    """The two-hop plan of a program's first hop (None for a standalone
    one-segment program)."""
    if program.n_segments < 2:
        return None
    return RelayPlan(
        family=program.family,
        s=program.segments[0].stop,
        s_prime=program.segments[1].start,
        sigma_handoff=program.handoffs[0].sigma_out,
        sigma_resume=program.handoffs[0].sigma_in,
    )


def execute_program(
    spec: FamilySpec,
    program: RelayProgram,
    models: Mapping[str, Tuple[Callable, object]],
    x_init: torch.Tensor,
    cond,
    *,
    uncond=None,
    capture_traj: bool = False,
    fused_boundary: bool = False,
):
    """Fold the latent through a program's segments with Eq. 4 handoffs and
    per-hop Eq. 1 deviation accounting.

    ``models`` maps each segment's role to ``(fn, params)``; ``cond`` (and
    ``uncond``) is one tensor for every segment or a dict keyed by role.
    Compressed hops send the latent through the registered int8 quantizer
    and the next model resumes from the dequantized latent.  With
    ``fused_boundary`` a compressed hop's last upstream step emits the
    payload and the first downstream step consumes it
    (:mod:`repro_torch.core.boundary`); its hop dict carries
    ``x_out=None``.  A 1-step segment cannot both consume and emit fused.

    Returns ``(x_final, info)`` with per-segment ``trajs`` (when
    ``capture_traj``), per-hop dicts (``hops``: latent, bytes on the wire,
    deviation percentage, sigmas), ``transfer_bytes`` and
    ``handoff_deviation_pct`` (the worst hop)."""
    if fused_boundary and capture_traj:
        raise ValueError(
            "fused_boundary is incompatible with capture_traj: boundary "
            "steps run outside the recorded loop"
        )
    sample = samplers.sampler_for(spec.kind)

    def _for(role, v):
        return v[role] if isinstance(v, dict) else v

    x = x_init
    pending = None  # (wire payload, quantizer) emitted by the previous hop
    trajs, hops = [], []
    total_bytes = 0
    worst_dev = torch.zeros((), device=x_init.device)
    for k, seg in enumerate(program.segments):
        fn, params = models[seg.model]
        sigmas = spec.ladder(seg.model)
        seg_cond = _for(seg.model, cond)
        seg_uncond = _for(seg.model, uncond) if uncond is not None else None
        lo, hi = seg.start, seg.stop
        fuse_out = (fused_boundary and k < program.n_hops
                    and program.handoffs[k].compress)
        if pending is not None:
            qs, pq = pending
            x = boundary.dequant_step(
                spec.kind, fn, params, qs, spec.latent_shape, sigmas,
                lo, seg_cond, seg_uncond, seg.guidance, quantizer=pq,
            )
            pending = None
            lo = lo + 1
        if fuse_out:
            hi = hi - 1
            if lo > hi:
                raise ValueError(
                    f"segment {k} of {program.family} has too few steps to "
                    "both consume and emit a fused boundary (needs >= 2)"
                )
        x, traj = sample(fn, params, x, sigmas, seg_cond, start=lo, stop=hi,
                         uncond=seg_uncond, guidance=seg.guidance,
                         capture_traj=capture_traj)
        trajs.append(traj)
        if k == program.n_hops:
            break
        h = program.handoffs[k]
        x_out = x
        if fuse_out:
            res = boundary.quant_step(
                spec.kind, fn, params, x, sigmas, hi, seg_cond, seg_uncond,
                seg.guidance, quantizer=h.quantizer, flavor="wire_dev",
            )
            pending = (res["wire"], h.quantizer)
            nbytes = res["bytes"]
            dev = res["dev_pct"]
            x_out = None  # never materialized
        elif h.compress:
            rec, nbytes = latent_roundtrip(x, h.quantizer)
            dev = relative_deviation(x, rec) * 100.0
            x = rec
        else:
            nbytes = x.numel() * x.element_size()
            dev = torch.zeros((), device=x.device)
        total_bytes += nbytes
        worst_dev = torch.maximum(worst_dev, dev)
        hops.append({
            "x_out": x_out,
            "transfer_bytes": nbytes,
            "deviation_pct": dev,
            "sigma_out": h.sigma_out,
            "sigma_in": h.sigma_in,
        })
    info = {
        "trajs": trajs,
        "hops": hops,
        "segment_steps": [seg.steps for seg in program.segments],
        "phases": [phase_name(program, k) for k in range(program.n_segments)],
        "transfer_bytes": total_bytes,
        "handoff_deviation_pct": worst_dev,
    }
    return x, info


def fused_emits(plan: CompiledPlan):
    """The fused-boundary analysis of a DAG plan: ``(fused_edges,
    emit_cfg)``.  Each segment node with compressed out-edges into segment
    nodes emits the wire payload once from its last step, with the first
    such edge's quantizer; ``fused_edges`` are the edges whose dst's first
    step reads it (any edge of another quantizer round-trips unfused), and
    ``emit_cfg[nid] = (quantizer, need_latent)`` — ``need_latent`` when the
    node is the sink or another out-edge reads the latent itself."""
    kind_of = {n.nid: n.kind for n in plan.nodes}
    fused_edges, emit_cfg = set(), {}
    for node in plan.nodes:
        if node.kind != SEGMENT_NODE:
            continue
        succs = plan.succs[node.nid]
        wire_succ = [e for e in succs
                     if e.handoff is not None and e.handoff.compress
                     and kind_of[e.dst] == SEGMENT_NODE]
        if not wire_succ:
            continue
        q0 = wire_succ[0].handoff.quantizer
        matched = [e for e in wire_succ if e.handoff.quantizer == q0]
        fused_edges.update(matched)
        emit_cfg[node.nid] = (q0, node.nid == plan.sink
                              or len(matched) < len(succs))
    return frozenset(fused_edges), emit_cfg


def hop_roundtrip(x: torch.Tensor, quantizer: str):
    """A compressed hop edge: ``(reconstruction, payload bytes, Eq. 1
    deviation in percent)``."""
    rec, nbytes = latent_roundtrip(x, quantizer)
    return rec, nbytes, relative_deviation(x, rec) * 100.0


def merge_latents(xs):
    """A Merge node's latent: the branch latents summed in predecessor
    order, then divided by their count — the reference's order, so the
    bits match (a stacked mean sums in another order)."""
    return sum(xs[1:], xs[0]) / float(len(xs))


def execute_graph(
    spec: FamilySpec,
    graph: "RelayGraph | CompiledPlan",
    models: Mapping[str, Tuple[Callable, object]],
    x_init: torch.Tensor,
    cond,
    *,
    uncond=None,
    capture_traj: bool = False,
    fused_boundary: bool = False,
):
    """The flow coordinator: execute a DAG plan over real latents.

    Walks the compiled plan in canonical topological order.  Each segment
    node's input is resolved from its predecessor edge (compressed hop
    edges round-trip through the wire quantizer with Eq. 1 deviation
    accounting, as :func:`execute_program` does per hop); ``Merge`` nodes
    average their incoming branch latents; ``Select`` nodes measure the
    candidate branch's Eq. 1 deviation against the reference branch over
    the whole batch and keep the candidate iff it is within the node's
    bound.  The reference branch is always computed (it is the
    measurement baseline).  A chain graph performs the op sequence of
    :func:`execute_program` on the bridged program: the same bits.

    With ``fused_boundary`` compressed hop edges into segment nodes go
    through :mod:`repro_torch.core.boundary`: a node with compressed
    out-edges emits the wire payload once from its last step (shared by
    every consumer with the same quantizer; any other quantizer's edge
    round-trips unfused), and each consuming node's first step reads it.
    A node whose other consumers need the latent (joins, the sink, mixed
    edges) keeps it beside the payload.  Nothing writes into a shared
    input: ``x_init`` and a shared payload keep their bits.

    Returns ``(x_final, info)``: ``trajs`` (with ``capture_traj``),
    ``hops`` (one dict per hop edge, with its ``edge``), ``joins`` (one
    dict per join node: a Merge's inputs; a Select's winner, accept flag,
    measured deviation and bound), ``segment_steps``, ``phases`` (node ids
    in canonical order), and ``transfer_bytes`` / ``handoff_deviation_pct``
    over the surviving path."""
    if fused_boundary and capture_traj:
        raise ValueError(
            "fused_boundary is incompatible with capture_traj: boundary "
            "steps run outside the recorded loop"
        )
    plan = (graph if isinstance(graph, CompiledPlan)
            else compile_plan(as_graph(graph)))
    sample = samplers.sampler_for(spec.kind)
    zero = torch.zeros((), device=x_init.device)

    def _for(role, v):
        return v[role] if isinstance(v, dict) else v

    fused_edges, emit_cfg = (fused_emits(plan) if fused_boundary
                             else (frozenset(), {}))

    out: dict = {}  # nid -> output latent
    wire: dict = {}  # nid -> (payload, dev_pct, bytes) of a fused emit
    path_dev: dict = {}  # nid -> worst hop deviation on the path into nid
    path_bytes: dict = {}  # nid -> wire bytes on the path into nid
    trajs, hops, joins = [], [], []

    def _cross(edge, x):
        """Deliver a latent across an edge, round-tripping hop edges."""
        if edge.handoff is None or not edge.handoff.compress:
            # a handoff-free edge is a zero-cost continuation or join input
            raw = x.numel() * x.element_size()
            return x, 0 if edge.handoff is None else raw, zero
        return hop_roundtrip(x, edge.handoff.quantizer)

    def _hop(e, x_out, nbytes, dev):
        hops.append({
            "x_out": x_out,
            "transfer_bytes": nbytes,
            "deviation_pct": dev,
            "sigma_out": e.handoff.sigma_out,
            "sigma_in": e.handoff.sigma_in,
            "edge": (e.src, e.dst),
        })

    for node in plan.nodes:
        pe = plan.preds[node.nid]
        if node.kind == SEGMENT_NODE:
            seg = node.segment
            fn, params = models[seg.model]
            sigmas = spec.ladder(seg.model)
            seg_cond = _for(seg.model, cond)
            seg_uncond = (_for(seg.model, uncond)
                          if uncond is not None else None)
            lo, hi = seg.start, seg.stop
            consumed = False
            if not pe:
                x_in, dev_in, bytes_in = x_init, zero, 0
            elif pe[0] in fused_edges:
                # fused consume: step `start` reads the shared payload
                e = pe[0]
                qs, dev, nbytes = wire[e.src]
                x_in = boundary.dequant_step(
                    spec.kind, fn, params, qs, spec.latent_shape, sigmas,
                    lo, seg_cond, seg_uncond, seg.guidance,
                    quantizer=e.handoff.quantizer,
                )
                _hop(e, None, nbytes, dev)
                dev_in = torch.maximum(path_dev[e.src], dev)
                bytes_in = path_bytes[e.src] + nbytes
                lo += 1
                consumed = True
            else:
                e = pe[0]
                x_up = out[e.src]
                x_in, nbytes, dev = _cross(e, x_up)
                if e.handoff is not None:
                    _hop(e, x_up, nbytes, dev)
                dev_in = torch.maximum(path_dev[e.src], dev)
                bytes_in = path_bytes[e.src] + nbytes
            emits = emit_cfg.get(node.nid)
            if emits is not None:
                hi -= 1
                if lo > hi:
                    raise ValueError(
                        f"graph node {node.nid} has too few steps to "
                        f"{'both consume and ' if consumed else ''}emit a "
                        "fused boundary"
                    )
            x, traj = sample(fn, params, x_in, sigmas, seg_cond, start=lo,
                             stop=hi, uncond=seg_uncond,
                             guidance=seg.guidance,
                             capture_traj=capture_traj)
            trajs.append(traj)
            if emits is not None:
                q0, need_latent = emits
                res = boundary.quant_step(
                    spec.kind, fn, params, x, sigmas, hi, seg_cond,
                    seg_uncond, seg.guidance, quantizer=q0,
                    flavor="wire_dev_latent" if need_latent else "wire_dev",
                )
                wire[node.nid] = (res["wire"], res["dev_pct"], res["bytes"])
                if need_latent:
                    out[node.nid] = res["latent"]
            else:
                out[node.nid] = x
            path_dev[node.nid] = dev_in
            path_bytes[node.nid] = bytes_in
        elif node.kind == MERGE_NODE:
            out[node.nid] = merge_latents([out[e.src] for e in pe])
            # every branch's wire crossed; deviation follows the worst one
            path_dev[node.nid] = max((path_dev[e.src] for e in pe), key=float)
            path_bytes[node.nid] = sum(path_bytes[e.src] for e in pe)
            joins.append({"node": node.nid, "kind": MERGE_NODE,
                          "inputs": [e.src for e in pe]})
        else:  # SELECT_NODE: one decision over the whole batch
            sel = plan.selects[node.nid]
            ref, cand = sel.reference, sel.candidates[0]
            dev_cand = relative_deviation(out[ref], out[cand]) * 100.0
            base = float(path_dev[ref])
            bound = select_bound_pct(node, base if base > 0.0 else 1.0)
            accept = bool(float(dev_cand) <= bound)
            winner = cand if accept else ref
            out[node.nid] = out[winner]
            # an accepted candidate adds its measured deviation, as the
            # reference's execute_graph does (its executor keeps the
            # winner's own: the two coordinators differ, each ported as is)
            path_dev[node.nid] = torch.maximum(
                path_dev[winner], dev_cand if accept else zero)
            path_bytes[node.nid] = path_bytes[winner]
            joins.append({
                "node": node.nid, "kind": node.kind, "winner": winner,
                "accepted": accept, "deviation_pct": float(dev_cand),
                "bound_pct": bound,
            })

    sink = plan.sink
    info = {
        "trajs": trajs,
        "hops": hops,
        "joins": joins,
        "segment_steps": [n.segment.steps for n in plan.nodes
                          if n.kind == SEGMENT_NODE],
        "phases": [n.nid for n in plan.nodes],
        "transfer_bytes": int(path_bytes[sink]),
        "handoff_deviation_pct": path_dev[sink],
    }
    return out[sink], info


def relay_generate(
    spec: FamilySpec,
    plan: RelayPlan,
    large_fn: Callable,
    large_params,
    small_fn: Callable,
    small_params,
    x_init: torch.Tensor,
    cond_large: torch.Tensor,
    cond_small: torch.Tensor,
    *,
    guidance: float = 1.0,
    uncond_large=None,
    uncond_small=None,
    compress_handoff: bool = False,
    capture_traj: bool = True,
):
    """The paper's two-hop relay — M_L for [0, s), handoff, M_S for
    [s', T_d) — as a two-segment program run by :func:`execute_program`.
    Returns ``(x_final, info)`` with the handoff latent, both trajectories,
    the bytes on the wire and the handoff deviation."""
    program = RelayProgram(
        family=spec.name,
        segments=(
            RelaySegment("large", None, 0, plan.s, guidance),
            RelaySegment("small", None, plan.s_prime, spec.t_device, guidance),
        ),
        handoffs=(
            Handoff(plan.sigma_handoff, plan.sigma_resume,
                    compress=compress_handoff),
        ),
    )
    x_final, pinfo = execute_program(
        spec, program,
        {"large": (large_fn, large_params), "small": (small_fn, small_params)},
        x_init,
        {"large": cond_large, "small": cond_small},
        uncond=(
            {"large": uncond_large, "small": uncond_small}
            if (uncond_large is not None or uncond_small is not None) else None
        ),
        capture_traj=capture_traj,
    )
    hop = pinfo["hops"][0]
    info = {
        "x_handoff": hop["x_out"],
        "traj_edge": pinfo["trajs"][0],
        "traj_device": pinfo["trajs"][1],
        "edge_steps": plan.s,
        "device_steps": spec.t_device - plan.s_prime,
        "transfer_bytes": pinfo["transfer_bytes"],
        "handoff_deviation_pct": pinfo["handoff_deviation_pct"],
    }
    return x_final, info
