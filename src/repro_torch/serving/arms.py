"""Action space as relay-program templates (port of
``repro/serving/arms.py``).  The paper's Table II space — Vega
standalone, SDXL+Vega relay × s∈{5,10,15,20,25}, SD3.5-L+M relay ×
s∈{5,10,15,20,25} — is :func:`build_action_space` with its defaults;
``compress=True`` gives the same routes with int8 wire handoffs (the
compressed twins).  :func:`cascade_action_space` appends the 3-hop
L→M→S arms and :func:`dag_action_space` the DAG arms: speculative
twin-hop programs (a Select node) and latent-averaging ensembles (a
Merge node)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

from repro_torch.core.program import (MERGE_NODE, SELECT_NODE, GraphEdge,
                                      GraphNode, Handoff, RelayGraph,
                                      RelayProgram, RelaySegment,
                                      make_program)
from repro_torch.core.schedules import sigma_match

RELAY_STEPS = (5, 10, 15, 20, 25)

#: replica pool of each (family, role) model
FAMILY_POOLS = {
    "XL": {"large": "sdxl", "mid": "ssd1b", "small": "vega"},
    "F3": {"large": "sd3l", "mid": "sd3lt", "small": "sd3m"},
}

#: the shipped 3-hop L→M→S program set: (family, edge steps, mid steps)
DEFAULT_CASCADES = (
    ("XL", 5, 10),
    ("XL", 10, 10),
    ("XL", 10, 15),
    ("F3", 5, 10),
    ("F3", 10, 10),
    ("F3", 10, 15),
)


@dataclass(frozen=True)
class Arm:
    """One scheduler action: a relay-program template plus its action-space
    index and display label, with two-hop views of the program."""

    idx: int
    program: RelayProgram  # or a RelayGraph: both plan currencies work
    label: str

    @property
    def family(self) -> Optional[str]:
        """Relay family, or None for a standalone (single-segment) arm."""
        return self.program.family if self.program.is_relay else None

    @property
    def relay_step(self) -> Optional[int]:
        """s of the first handoff (None for standalone arms)."""
        return self.program.segments[0].stop if self.program.is_relay else None

    @property
    def edge_pool(self) -> Optional[str]:
        return self.program.segments[0].pool if self.program.is_relay else None

    @property
    def device_pool(self) -> str:
        return self.program.segments[-1].pool

    @property
    def plan(self):
        """Two-hop :class:`repro_torch.core.relay.RelayPlan` view (None for
        standalone arms)."""
        from repro_torch.core.relay import plan_view

        return plan_view(self.program)

    @property
    def n_hops(self) -> int:
        return self.program.n_hops


@lru_cache(maxsize=None)
def _spec(family: str):
    from repro_torch.diffusion.families import SPECS

    return SPECS[family]()


def standalone_program(family: str = "XL", role: str = "small") -> RelayProgram:
    """A single-segment program: the family's ``role`` model alone."""
    return make_program(_spec(family),
                        [(role, FAMILY_POOLS[family][role], None)])


def relay_program(family: str, s: int, *,
                  compress: bool = False) -> RelayProgram:
    """The paper's two-hop relay: large runs s steps, small finishes from
    the Eq. 4 sigma-matched entry."""
    pools = FAMILY_POOLS[family]
    return make_program(
        _spec(family),
        [("large", pools["large"], s), ("small", pools["small"], None)],
        compress=compress,
    )


def cascade_program(family: str, s_large: int, s_mid: int, *,
                    compress: bool = False) -> RelayProgram:
    """A 3-hop L→M→S cascade, both handoffs sigma-matched per Eq. 4."""
    pools = FAMILY_POOLS[family]
    return make_program(
        _spec(family),
        [("large", pools["large"], s_large), ("mid", pools["mid"], s_mid),
         ("small", pools["small"], None)],
        compress=compress,
    )


def build_action_space(
    relay_steps: Sequence[int] = RELAY_STEPS,
    families: Sequence[str] = ("XL", "F3"),
    cascades: Sequence[Tuple[str, int, int]] = (),
    *,
    compress: bool = False,
) -> Tuple[Arm, ...]:
    """The arm space; the defaults give the paper's 11 arms in the
    reference's order and labels.  ``compress`` puts every relay hop on
    the int8 wire (labels gain ``|int8``)."""
    tag = "|int8" if compress else ""
    arms = [Arm(0, standalone_program(), "vega-standalone")]
    for family in families:
        name = "sdxl+vega" if family == "XL" else "sd35L+M"
        for s in relay_steps:
            arms.append(Arm(len(arms), relay_program(family, s,
                                                     compress=compress),
                            f"{name}@s={s}{tag}"))
    for family, s_large, s_mid in cascades:
        name = "sdxl+ssd1b+vega" if family == "XL" else "sd35L+mid+M"
        arms.append(Arm(len(arms),
                        cascade_program(family, s_large, s_mid,
                                        compress=compress),
                        f"{name}@s={s_large}+{s_mid}{tag}"))
    return tuple(arms)


def speculative_program(family: str, s: int, s_spec: int,
                        bound_pct: Optional[float] = None) -> RelayGraph:
    """Speculative twin-hop DAG: the device branch starts from a compressed
    early handoff at ``s_spec`` while the edge model finishes the remaining
    ``s − s_spec`` steps; the Select node's Eq. 1 deviation bound decides
    which handoff survives.  Accept: the speculative device branch is the
    result.  Reject: the reference hop at ``s`` stands, as in the fixed
    two-hop arm.  ``bound_pct=None`` is relative mode: accept within
    ``SPEC_BOUND_REL ×`` the wire's measured roundtrip deviation."""
    if not 0 < s_spec < s:
        raise ValueError(f"need 0 < s_spec < s, got s={s}, s_spec={s_spec}")
    spec = _spec(family)
    pools = FAMILY_POOLS[family]
    ladder_e, ladder_d = spec.ladder("large"), spec.ladder("small")
    t_d = len(ladder_d) - 1
    sp = sigma_match(ladder_e, s, ladder_d)
    sp_spec = sigma_match(ladder_e, s_spec, ladder_d)
    nodes = (
        GraphNode("edge", segment=RelaySegment("large", pools["large"],
                                               0, s_spec)),
        GraphNode("edge+", segment=RelaySegment("large", pools["large"],
                                                s_spec, s), branch="ref"),
        GraphNode("device~spec",
                  segment=RelaySegment("small", pools["small"], sp_spec, t_d),
                  branch="spec"),
        GraphNode("device",
                  segment=RelaySegment("small", pools["small"], sp, t_d),
                  branch="ref"),
        GraphNode("select", kind=SELECT_NODE, reference="device",
                  gate="edge+", bound_pct=bound_pct),
    )
    edges = (
        GraphEdge("edge", "edge+"),
        GraphEdge("edge", "device~spec",
                  handoff=Handoff(float(ladder_e[s_spec]),
                                  float(ladder_d[sp_spec]),
                                  compress=True)),
        GraphEdge("edge+", "device",
                  handoff=Handoff(float(ladder_e[s]), float(ladder_d[sp]),
                                  compress=True)),
        GraphEdge("device~spec", "select"),
        GraphEdge("device", "select"),
    )
    return RelayGraph(family, nodes, edges)


def ensemble_program(family: str, s: int) -> RelayGraph:
    """Ensemble DAG: one edge prefix fans out to the small and the mid
    model (each resuming from its own Eq. 4 sigma-matched entry over a
    compressed handoff); a Merge node averages the branch latents."""
    spec = _spec(family)
    pools = FAMILY_POOLS[family]
    ladder_e = spec.ladder("large")
    ladder_d, ladder_m = spec.ladder("small"), spec.ladder("mid")
    sp = sigma_match(ladder_e, s, ladder_d)
    spm = sigma_match(ladder_e, s, ladder_m)
    nodes = (
        GraphNode("edge", segment=RelaySegment("large", pools["large"], 0, s)),
        GraphNode("device",
                  segment=RelaySegment("small", pools["small"], sp,
                                       len(ladder_d) - 1),
                  branch="a"),
        GraphNode("refine",
                  segment=RelaySegment("mid", pools["mid"], spm,
                                       len(ladder_m) - 1),
                  branch="b"),
        GraphNode("merge", kind=MERGE_NODE),
    )
    edges = (
        GraphEdge("edge", "device",
                  handoff=Handoff(float(ladder_e[s]), float(ladder_d[sp]),
                                  compress=True)),
        GraphEdge("edge", "refine",
                  handoff=Handoff(float(ladder_e[s]), float(ladder_m[spm]),
                                  compress=True)),
        GraphEdge("device", "merge"),
        GraphEdge("refine", "merge"),
    )
    return RelayGraph(family, nodes, edges)


#: the shipped speculative arms: (family, s, s_spec)
DEFAULT_SPECULATIVE = (("XL", 20, 10), ("XL", 25, 15), ("F3", 20, 10))
#: the shipped ensemble arms: (family, s)
DEFAULT_ENSEMBLES = (("XL", 10),)


def cascade_action_space() -> Tuple[Arm, ...]:
    """The 11 arms plus the shipped 3-hop L→M→S program set."""
    return build_action_space(cascades=DEFAULT_CASCADES)


def dag_action_space() -> Tuple[Arm, ...]:
    """The 11 arms plus DAG-program arms: speculative twin-hop arms
    (``<tag>@s=S|spec=s`` — the fixed 2-hop arm at ``S`` with a speculative
    early handoff at ``s``) and ensemble arms (``<tag>@s=S&mid``)."""
    arms = list(build_action_space())
    for family, s, s_spec in DEFAULT_SPECULATIVE:
        tag = "sdxl+vega" if family == "XL" else "sd35L+M"
        arms.append(
            Arm(len(arms), speculative_program(family, s, s_spec),
                f"{tag}@s={s}|spec={s_spec}")
        )
    for family, s in DEFAULT_ENSEMBLES:
        tag = "sdxl+vega" if family == "XL" else "sd35L+M"
        arms.append(
            Arm(len(arms), ensemble_program(family, s), f"{tag}@s={s}&mid")
        )
    return tuple(arms)


ARMS = build_action_space()
N_ARMS = len(ARMS)

# pool replica counts (the paper's testbed: 4 pools × 2 replicas, plus the
# mid-size cascade stages)
POOL_REPLICAS = {
    "sdxl": 2, "ssd1b": 2, "vega": 2,
    "sd3l": 2, "sd3lt": 2, "sd3m": 2,
}


def pools_used(arm: Arm) -> Tuple[str, ...]:
    """Distinct pools an arm's program occupies, in execution order."""
    return arm.program.pools
