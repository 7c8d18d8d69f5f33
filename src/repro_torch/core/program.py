"""Segmented relay-program IR (port of the linear half of
``repro/core/program.py``): :class:`RelaySegment` — one model over a
slice of its sigma ladder; :class:`Handoff` — the Eq. 4 sigma-matched
edge between two segments with its wire-compression choice;
:class:`RelayProgram` — segments joined by handoffs.  The DAG IR
(``RelayGraph``) is not ported yet."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core.schedules import sigma_match

#: model roles within a relay family, largest to smallest
ROLES = ("large", "mid", "small")


@dataclass(frozen=True)
class RelaySegment:
    """One model denoising the latent over ladder entries [start, stop)."""

    model: str  # role within the family: "large" | "mid" | "small"
    pool: Optional[str]  # replica pool executing this segment (None: unplaced)
    start: int  # first sigma-ladder entry this segment denoises from
    stop: int  # ladder entry reached at the handoff (exclusive step range)
    guidance: float = 1.0

    @property
    def steps(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class Handoff:
    """The edge joining two segments: the latent leaves the upstream model
    at ``sigma_out`` and the downstream model resumes at its ladder's
    closest entry ``sigma_in`` (Eq. 4).  ``compress`` selects the int8
    wire format for this hop."""

    sigma_out: float
    sigma_in: float
    compress: bool = False
    quantizer: str = "rowwise"

    @property
    def noise_gap(self) -> float:
        return abs(self.sigma_out - self.sigma_in)


@dataclass(frozen=True)
class RelayProgram:
    """Ordered segments joined by handoffs; ``len(handoffs) ==
    len(segments) - 1``.  A standalone model is a one-segment program."""

    family: str
    segments: Tuple[RelaySegment, ...]
    handoffs: Tuple[Handoff, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("a RelayProgram needs at least one segment")
        if len(self.handoffs) != len(self.segments) - 1:
            raise ValueError(
                f"{len(self.segments)} segments need "
                f"{len(self.segments) - 1} handoffs, got {len(self.handoffs)}"
            )
        for seg in self.segments:
            if not 0 <= seg.start < seg.stop:
                raise ValueError(f"empty or negative segment slice: {seg}")

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_hops(self) -> int:
        return len(self.handoffs)

    @property
    def is_relay(self) -> bool:
        return self.n_segments > 1

    @property
    def pools(self) -> Tuple[str, ...]:
        """Distinct pools in execution order."""
        return tuple(dict.fromkeys(s.pool for s in self.segments))

    @property
    def total_steps(self) -> int:
        return sum(s.steps for s in self.segments)

    def shape_key(self) -> tuple:
        """Identity of the pipeline modulo segment bounds: same family,
        role sequence, guidance and per-hop compression."""
        return (
            self.family,
            tuple((s.model, s.guidance) for s in self.segments),
            tuple(
                (h.compress, h.quantizer if h.compress else None)
                for h in self.handoffs
            ),
        )


def phase_name(program: RelayProgram, k: int) -> str:
    """Trace name of segment ``k``: the last segment is "device", the
    first segment of a relay "edge", interior cascade segments "mid<k>"."""
    if k == program.n_segments - 1:
        return "device"
    if k == 0:
        return "edge"
    return f"mid{k}"


def make_program(
    spec,
    route: Sequence[Tuple[str, Optional[str], Optional[int]]],
    *,
    guidance: float = 1.0,
    compress: bool = False,
    quantizer: str = "rowwise",
) -> RelayProgram:
    """Build a program over a family spec from a route of
    ``(role, pool, steps)`` hops, sigma-matching every handoff (Eq. 4).
    ``steps=None`` (mandatory for the last segment) runs to the end of
    that model's ladder."""
    segments, handoffs = [], []
    start = 0
    for k, (role, pool, steps) in enumerate(route):
        ladder = spec.ladder(role)
        t = len(ladder) - 1
        last = k == len(route) - 1
        if last:
            if steps is not None:
                raise ValueError("the final segment runs to its ladder end; "
                                 "pass steps=None")
            stop = t
        else:
            if steps is None:
                raise ValueError("interior segments need an explicit steps")
            stop = start + steps
        if not 0 <= start < stop <= t:
            raise ValueError(
                f"segment {k} ({role}) slice [{start}, {stop}) outside its "
                f"ladder of {t} steps"
            )
        segments.append(RelaySegment(role, pool, start, stop, guidance))
        if not last:
            next_ladder = spec.ladder(route[k + 1][0])
            nxt = sigma_match(ladder, stop, next_ladder)
            handoffs.append(
                Handoff(
                    sigma_out=float(ladder[stop]),
                    sigma_in=float(next_ladder[nxt]),
                    compress=compress,
                    quantizer=quantizer,
                )
            )
            start = nxt
    return RelayProgram(spec.name, tuple(segments), tuple(handoffs))
