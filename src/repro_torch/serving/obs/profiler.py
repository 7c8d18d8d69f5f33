"""Wall-clock event-loop profiler for the continuous runtime (a copy of
``repro/serving/obs/profiler.py``).

The discrete-event loop must replay ~10⁶ requests in reasonable
wall-clock, which means knowing where the loop spends its time *before*
vectorizing it.  This profiler hooks the
:class:`~repro_torch.serving.runtime.engine.ContinuousRuntime` dispatch
loop (attach via ``RuntimeConfig(profiler=EventLoopProfiler())``) and
measures:

* events processed per kind and wall seconds per kind (perf_counter
  around each handler dispatch);
* heap operations (pushes / pops / peak size) from the
  :class:`~repro_torch.serving.runtime.events.EventQueue` counters;
* end-to-end events/sec over the run.

Only *wall* clocks are touched: it never synchronizes the card, and the
simulated clock, RNG streams and every scheduler-visible quantity are
bit-identical with the profiler on or off.
"""
from __future__ import annotations

import time
from typing import Dict, Optional


class EventLoopProfiler:
    """Per-event-kind wall-time and count accumulator."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.wall_s: Dict[str, float] = {}
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.heap: Dict[str, int] = {}
        self.stale: Dict[str, int] = {}

    # engine-facing hooks -------------------------------------------------

    def start(self) -> None:
        """Mark the loop's wall-clock start (perf_counter)."""
        self.t_start = time.perf_counter()

    def record(self, kind: str, wall_s: float) -> None:
        """Account one handled event of ``kind`` costing ``wall_s``
        wall seconds."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.wall_s[kind] = self.wall_s.get(kind, 0.0) + wall_s

    def record_stale(self, kind: str) -> None:
        """An event popped but discarded without running its handler (e.g.
        a FLUSH superseded by a later deadline for the same pool).  Counted
        separately so ``events``/``events_per_s`` keep measuring *handled*
        work and stale volume is visible in the report."""
        self.stale[kind] = self.stale.get(kind, 0) + 1

    def stop(self, evq=None) -> None:
        """Mark the loop's wall-clock end and capture the event queue's
        heap-op counters (pushes/pops/peak size) if one is given."""
        self.t_stop = time.perf_counter()
        if evq is not None:
            self.heap = {
                "pushes": evq.n_pushed,
                "pops": evq.n_popped,
                "peak_size": evq.peak_size,
            }

    # reporting -----------------------------------------------------------

    @property
    def n_events(self) -> int:
        """Total handled events (stale pops counted separately)."""
        return sum(self.counts.values())

    @property
    def loop_wall_s(self) -> float:
        """Wall seconds between :meth:`start` and :meth:`stop` (0.0 if
        the loop never ran)."""
        if self.t_start is None or self.t_stop is None:
            return 0.0
        return self.t_stop - self.t_start

    def report(self) -> dict:
        """The baseline profile the vectorization work optimizes against:
        total events/sec plus the per-event-type breakdown (count, wall
        seconds, mean µs per event, share of handler time)."""
        total_handler_s = sum(self.wall_s.values())
        wall = self.loop_wall_s
        per_kind = {}
        for kind in sorted(self.counts):
            n, w = self.counts[kind], self.wall_s[kind]
            per_kind[kind] = {
                "count": n,
                "wall_s": w,
                "mean_us": 1e6 * w / n if n else 0.0,
                "share": w / total_handler_s if total_handler_s else 0.0,
            }
        return {
            "events": self.n_events,
            "loop_wall_s": wall,
            "events_per_s": self.n_events / wall if wall else 0.0,
            "handler_wall_s": total_handler_s,
            # loop overhead = pop + dispatch machinery outside the handlers
            "loop_overhead_s": max(wall - total_handler_s, 0.0),
            "per_event_type": per_kind,
            "stale_events": dict(sorted(self.stale.items())),
            "heap_ops": self.heap,
        }
