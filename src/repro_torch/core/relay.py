"""Relay inference (paper §III) over N-hop programs (port of the linear
half of ``repro/core/relay.py``): the large edge model runs the first s
steps, the latent crosses a segment boundary — raw, int8 round-tripped,
or fused into the boundary steps — and the next model resumes from its
Eq. 4 sigma-matched entry.  ``execute_graph`` is not ported yet."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import torch

from repro_torch.core import boundary, samplers
from repro_torch.core.program import (ROLES, Handoff, RelayProgram,
                                      RelaySegment, phase_name)
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
