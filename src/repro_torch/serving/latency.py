"""Service latency model (port of ``repro/serving/latency.py``, numpy
only): the reference's *simulated* service model, calibrated to the
paper's measured per-image denoise times (Table III, the paper's own
testbed GPUs):

  SDXL 50 steps = 6.87 s → 137.4 ms/step        Vega: 71.3 ms/step
  SD3.5-L 50 steps = 30.19 s → 603.8 ms/step    SD3.5-M: 229.7 ms/step

plus interpolated mid-size cascade stages (SSD-1B-like for XL, a distilled
mid SD3.5 for F3).  None of these constants (``STEP_COST``, ``VRAM_GB``,
``HBM_GBPS``) is a reading of the H100 the port runs on: they price the
simulated edge and device pools the scheduler learns over, and the port
keeps them so that its rewards equal the reference's.  Latency is derived
*per program segment*:

  t(program) = Σ_k steps_k · step_cost(pool_k) · jitter_k  +  Σ_hops transfer

with independent jitter draws per segment (each segment runs on its own
replica), drawn from the caller's numpy generator.  Network and battery
are simulated (as in the paper's own testbed).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.program import SEGMENT_NODE, RelayProgram
from repro_torch.serving.arms import Arm

STEP_COST = {  # seconds per denoising step
    "sdxl": 0.1374,
    "ssd1b": 0.0982,  # mid XL cascade stage
    "vega": 0.0713,
    "sd3l": 0.6038,
    "sd3lt": 0.3810,  # mid F3 cascade stage
    "sd3m": 0.2297,
}

VRAM_GB = {"sdxl": 8.5, "ssd1b": 5.8, "vega": 3.2,
           "sd3l": 19.0, "sd3lt": 12.0, "sd3m": 6.5}

LATENT_BYTES = {"XL": 128 * 128 * 4 * 2, "F3": 128 * 128 * 16 * 2}  # fp16 @1024²
LATENT_CHANNELS = {"XL": 4, "F3": 16}

T_FULL = {"sdxl": 50, "ssd1b": 40, "vega": 25,
          "sd3l": 50, "sd3lt": 50, "sd3m": 50}

SCALE_BYTES = 4  # fp32 quantizer scale, one per channel row


def latent_wire_bytes(family: Optional[str], compressed: bool = False) -> int:
    """Bytes on the wire for one inter-segment latent handoff.

    Uncompressed: the fp16 latent as-is.  Compressed: the row-wise int8
    payload (one byte per element) plus one fp32 scale per channel row —
    the layout produced by the handoff transport's channel-wise
    ``quant_rowwise`` (≈2× smaller than fp16)."""
    if family is None:
        return 0
    if not compressed:
        return LATENT_BYTES[family]
    elems = LATENT_BYTES[family] // 2  # fp16 → element count
    return elems + LATENT_CHANNELS[family] * SCALE_BYTES


@dataclass(frozen=True)
class LatencyBreakdown:
    """Per-segment denoise times and per-hop transfer times of one program
    execution.  The legacy two-pool fields (``edge_s`` / ``device_s`` /
    ``transfer_s``) are views: first segment / last segment / total wire."""

    segment_s: Tuple[float, ...]
    hop_s: Tuple[float, ...] = ()

    @property
    def edge_s(self) -> float:
        """First-segment denoise seconds (0.0 for standalone arms)."""
        return self.segment_s[0] if len(self.segment_s) > 1 else 0.0

    @property
    def device_s(self) -> float:
        """Final-segment denoise seconds."""
        return self.segment_s[-1]

    @property
    def transfer_s(self) -> float:
        """Total latent-handoff wire+RTT seconds across all hops."""
        return sum(self.hop_s)

    @property
    def total(self) -> float:
        """End-to-end seconds: every segment plus every hop."""
        return sum(self.segment_s) + sum(self.hop_s)


def wire_seconds(family: Optional[str], bw_mbps: float = 20.0,
                 compressed: bool = False) -> float:
    """RTT-free serialization time of one latent handoff payload.

    Split out of :func:`transfer_time` so hot paths can precompute it per
    (family, transport) once and add only the per-request RTT term."""
    if family is None:
        return 0.0
    payload = latent_wire_bytes(family, compressed=compressed)
    return payload * 8 / (bw_mbps * 1e6)


def transfer_time(family: Optional[str], rtt_ms: float, bw_mbps: float = 20.0,
                  compressed: bool = False) -> float:
    """Seconds for one latent handoff: per-request RTT plus the
    family-sized serialization term (:func:`wire_seconds`); 0.0 for
    standalone arms (no hop)."""
    if family is None:
        return 0.0
    return rtt_ms / 1000.0 + wire_seconds(family, bw_mbps, compressed)


# HBM roofline for the *unfused* boundary's extra memory traffic: the
# standalone quantize dispatch reads the fp16 latent and writes the int8
# payload, the standalone dequantize reads the payload and writes the
# latent back.  A fused boundary elides all four (the payload is produced
# by the last sampler step's write and consumed by the first step's read),
# so its handoff costs the wire+RTT alone.
HBM_GBPS = 100.0


def boundary_compute_seconds(family: Optional[str], compressed: bool = True,
                             fused: bool = False) -> float:
    """Roofline seconds of the quant/dequant dispatches bracketing one
    compressed handoff: ``(2·latent + 2·payload) / HBM bandwidth``.  Zero
    when the boundary is fused into the sampler steps (nothing extra moves
    through HBM) or when the hop ships the raw fp16 latent (nothing to
    quantize)."""
    if family is None or fused or not compressed:
        return 0.0
    traffic = 2 * LATENT_BYTES[family] + 2 * latent_wire_bytes(family, True)
    return traffic / (HBM_GBPS * 1e9)


def handoff_seconds(family: Optional[str], rtt_ms: float,
                    bw_mbps: float = 20.0, compressed: bool = False,
                    fused: bool = True) -> float:
    """Full cost of one segment boundary: the wire+RTT transfer
    (:func:`transfer_time`) plus, for an *unfused* compressed hop, the
    quant/dequant roofline term (:func:`boundary_compute_seconds`).  The
    fused default prices the boundary at wire time alone — the invariant
    ``benchmarks/bench_handoff.py`` gates (fused ≤ 1.1× wire)."""
    return (transfer_time(family, rtt_ms, bw_mbps=bw_mbps,
                          compressed=compressed)
            + boundary_compute_seconds(family, compressed, fused))


def _jitter(rng: Optional[np.random.Generator]) -> float:
    if rng is None:
        return 1.0
    return float(np.clip(rng.normal(1.0, 0.03), 0.9, 1.15))


def program_latency(program: RelayProgram, rtt_ms: float,
                    rng: Optional[np.random.Generator] = None, *,
                    compressed: Optional[bool] = None,
                    bw_mbps: float = 20.0) -> LatencyBreakdown:
    """Denoise + transfer latency of one program execution (no queueing).

    Each segment draws its own jitter (it runs on its own replica); each
    hop is priced at the latent wire size.  ``compressed=None`` honors
    every handoff's own per-hop compression choice; a bool overrides all
    hops (how the engines apply their transport configuration)."""
    segs = tuple(
        STEP_COST[seg.pool] * seg.steps * _jitter(rng)
        for seg in program.segments
    )
    fam = program.family if program.is_relay else None
    hops = tuple(
        transfer_time(
            fam, rtt_ms, bw_mbps=bw_mbps,
            compressed=h.compress if compressed is None else compressed,
        )
        for h in program.handoffs
    )
    return LatencyBreakdown(segs, hops)


def program_wire_bytes(program: RelayProgram,
                       compressed: Optional[bool] = None) -> int:
    """Total bytes-on-wire of a program's handoffs (0 for standalone)."""
    fam = program.family if program.is_relay else None
    return sum(
        latent_wire_bytes(
            fam, compressed=h.compress if compressed is None else compressed
        )
        for h in program.handoffs
    )


@lru_cache(maxsize=None)
def program_vram(program: RelayProgram) -> float:
    """Peak model VRAM across the program's segments (segments hold their
    pools one at a time, so the peak is the max, not the sum).  Cached —
    programs are frozen and the reward path asks per completion."""
    return max(VRAM_GB[seg.pool] for seg in program.segments)


def graph_node_seconds(plan, rng: Optional[np.random.Generator] = None):
    """Jittered denoise seconds per segment node of a compiled DAG plan.

    Jitter draws happen in canonical topological order, so a chain graph
    consumes the RNG stream exactly as :func:`program_latency` does on the
    bridged linear program — draw-for-draw."""
    return {
        n.nid: STEP_COST[n.segment.pool] * n.segment.steps * _jitter(rng)
        for n in plan.nodes if n.kind == SEGMENT_NODE
    }


def graph_hop_seconds(plan, rtt_ms: float, *, bw_mbps: float = 20.0,
                      compressed: Optional[bool] = None):
    """Wire+RTT seconds per edge of a compiled DAG plan: handoff edges are
    priced like linear hops (:func:`transfer_time`), zero-cost edges
    (same-pool continuations, join inputs) are free."""
    fam = plan.graph.family if plan.graph.is_relay else None
    out = {}
    for e in plan.edge_order:
        if e.handoff is None:
            out[(e.src, e.dst)] = 0.0
        else:
            out[(e.src, e.dst)] = transfer_time(
                fam, rtt_ms, bw_mbps=bw_mbps,
                compressed=e.handoff.compress if compressed is None
                else compressed,
            )
    return out


def graph_critical_seconds(plan, node_s, hop_s) -> float:
    """Critical-path seconds of a DAG plan (no queueing): longest
    arrival→sink path over per-node denoise seconds and per-edge hop
    seconds.  This replaces the linear sum — speculative branches overlap
    the edge tail, so their work does not appear unless they *are* the
    longest path."""
    done = {}
    for n in plan.nodes:
        start = 0.0
        for e in plan.preds[n.nid]:
            start = max(start, done[e.src] + hop_s[(e.src, e.dst)])
        done[n.nid] = start + node_s.get(n.nid, 0.0)
    return done[plan.sink]


def graph_ideal_seconds(plan, rtt_ms: float, *, bw_mbps: float = 20.0,
                        compressed: Optional[bool] = None) -> float:
    """Zero-queue critical-path latency of a DAG plan at nominal (jitter
    free) segment costs — the graph analogue of the engines' per-arm ideal
    baseline that ``wait_s`` measures against."""
    return graph_critical_seconds(
        plan,
        graph_node_seconds(plan, rng=None),
        graph_hop_seconds(plan, rtt_ms, bw_mbps=bw_mbps,
                          compressed=compressed),
    )


def arm_latency(arm: Arm, plan=None, rtt_ms: float = 0.0,
                rng: Optional[np.random.Generator] = None,
                compressed: bool = False) -> LatencyBreakdown:
    """Denoise + transfer latency for one arm (no queueing).  ``plan`` is
    accepted for backwards compatibility and ignored — the arm's program
    already carries the sigma-matched segment bounds."""
    return program_latency(arm.program, rtt_ms, rng, compressed=compressed)


def batch_service_time(pool: str, steps: int, batch: int,
                       growth: float) -> float:
    """Nominal service time of a padded micro-batch:
    ``t(b) = steps · step_cost · (1 + growth·(b−1))`` — denoising at moderate
    batch sizes amortizes weight streaming, so per-item cost shrinks toward
    ``growth · t₁`` (calibrated by ``scripts/calibrate_batch_cost.py``)."""
    return steps * STEP_COST[pool] * (1.0 + growth * (batch - 1))


def reissue_latency(nominal_s: float, reissue: float) -> float:
    """Dispatch-to-completion latency of a straggling batch mitigated by
    twin re-issue of the same shape: the detector trips once the batch has
    exceeded ``(reissue − 1) ×`` its nominal service time, then the
    re-issued copy needs one more nominal service time on the twin — the
    ``reissue ×`` cap (the sequential engine's singleton-batch semantics,
    and the continuous runtime's whole-batch mode).  Per-item re-issue
    re-runs only the straggling samples at their own, smaller,
    :func:`batch_service_time`, so its completion lands under this cap."""
    return nominal_s * max(reissue - 1.0, 0.0) + nominal_s


def full_model_latency(pool: str) -> float:
    """Seconds for a full standalone denoise on ``pool`` (all T steps)."""
    return STEP_COST[pool] * T_FULL[pool]


def arm_vram(arm: Arm) -> float:
    """Peak VRAM bytes of the arm's program (max over its segments)."""
    return program_vram(arm.program)
