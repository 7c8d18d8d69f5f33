"""Action space as relay-program templates (port of the linear half of
``repro/serving/arms.py``).  The paper's Table II space — Vega
standalone, SDXL+Vega relay × s∈{5,10,15,20,25}, SD3.5-L+M relay ×
s∈{5,10,15,20,25} — is :func:`build_action_space` with its defaults;
``compress=True`` gives the same routes with int8 wire handoffs (the
compressed twins)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

from repro_torch.core.program import RelayProgram, make_program

RELAY_STEPS = (5, 10, 15, 20, 25)

#: replica pool of each (family, role) model
FAMILY_POOLS = {
    "XL": {"large": "sdxl", "mid": "ssd1b", "small": "vega"},
    "F3": {"large": "sd3l", "mid": "sd3lt", "small": "sd3m"},
}


@dataclass(frozen=True)
class Arm:
    """One scheduler action: a relay-program template plus its action-space
    index and display label, with two-hop views of the program."""

    idx: int
    program: RelayProgram
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


ARMS = build_action_space()
N_ARMS = len(ARMS)
