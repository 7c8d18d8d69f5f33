"""The relay runtime's configuration (port of
``repro/serving/runtime/engine.py``'s ``RuntimeConfig``).

The continuous-batching engine that the reference defines beside it is
not ported yet (ROADMAP queue 1, item 8(b)2).  Until it is, the one
reader is the sequential :class:`repro_torch.serving.engine.ServingEngine`:
it maps ``compress_handoff``, ``bw_mbps`` and ``quality_sensitivity`` onto
its :class:`HandoffTransport` (``HandoffTransport.for_runtime``) and
leaves the other fields unread, as the reference's sequential engine
does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .batching import DEFAULT_BUCKETS


@dataclass
class RuntimeConfig:
    """Continuous-runtime knobs: micro-batching, transport, observability.

    Every default is the reference's.  ``autoscaler`` (None by default)
    attaches a replica autoscaler, whose evaluation ticks may emit the
    ordinary REPLICA_FAIL / REPLICA_RECOVER pool-membership events.  Times
    are simulated seconds, bandwidth is Mbit/s."""

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    linger_s: float = 0.25  # max wait for batch companions
    batch_cost_growth: float = 0.3  # t(b) = t1·(1 + growth·(b−1))
    compress_handoff: bool = True
    bw_mbps: float = 20.0
    quality_sensitivity: float = 1.0
    # span tracing (repro_torch.serving.obs.tracer): structured per-request
    # spans on the simulated clock — never perturbs decisions, quality or
    # faults
    trace: bool = True
    # optional obs.profiler.EventLoopProfiler wall-clock hooks around the
    # event loop's handler dispatch
    profiler: Optional[object] = None
    # optional replica autoscaler: telemetry-driven replica scale-up/down
    # through the REPLICA_FAIL/RECOVER events
    autoscaler: Optional[object] = None
