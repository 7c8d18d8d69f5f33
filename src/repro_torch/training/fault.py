"""Fault-tolerance machinery for the training loop (simulated single-host,
API-shaped for a real multi-host deployment):

* HeartbeatMonitor — workers beat every step; silence past a timeout marks
  the worker dead and triggers the restart/elastic path.
* StragglerDetector — per-worker step-duration EWMAs; a worker slower than
  ``factor``× the fleet median is flagged (real deployment: evict + re-slice).
* elastic_plan — maps a surviving-device count to the nearest runnable mesh
  and the checkpoint-reshard instructions (restore handles the placement).

Copy of ``repro/training/fault.py``, which imports no framework.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    last_beat: Dict[str, float] = field(default_factory=dict)

    def beat(self, worker: str, now: Optional[float] = None):
        self.last_beat[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return [
            w for w, t in self.last_beat.items() if now - t > self.timeout_s
        ]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_workers(now)


@dataclass
class StragglerDetector:
    factor: float = 2.0
    alpha: float = 0.3  # EWMA coefficient
    ewma: Dict[str, float] = field(default_factory=dict)

    def record(self, worker: str, duration_s: float):
        prev = self.ewma.get(worker, duration_s)
        self.ewma[worker] = (1 - self.alpha) * prev + self.alpha * duration_s

    def stragglers(self) -> List[str]:
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        return [w for w, v in self.ewma.items() if v > self.factor * median]


def elastic_plan(n_devices: int, *, model_parallel: int = 16) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest runnable mesh ≤ n_devices keeping the model axis intact.
    Returns (shape, axis_names). A 512-chip job losing a host re-slices to
    the biggest (pod, data, model) grid that still divides."""
    if n_devices >= 2 * model_parallel:
        data = n_devices // model_parallel
        # prefer a pod axis when ≥2 full 256-chip pods survive
        if data % 16 == 0 and data // 16 >= 2:
            return ((data // 16, 16, model_parallel), ("pod", "data", "model"))
        return ((data, model_parallel), ("data", "model"))
    if n_devices >= model_parallel:
        return ((n_devices // model_parallel, model_parallel), ("data", "model"))
    # degenerate: shrink model axis to what's left (reduced TP)
    mp = 1
    while mp * 2 <= n_devices:
        mp *= 2
    return ((n_devices // mp, mp), ("data", "model"))


@dataclass
class FaultInjector:
    """Deterministic failure script for tests: {step: event}."""

    kill_at: Dict[int, str] = field(default_factory=dict)  # step → worker id
    slow_at: Dict[int, Tuple[str, float]] = field(default_factory=dict)

    def apply(self, step: int, hb: HeartbeatMonitor, sd: StragglerDetector):
        if step in self.kill_at:
            # worker stops beating from this step (simply never beats again)
            hb.last_beat.setdefault(self.kill_at[step], -1e9)
            hb.last_beat[self.kill_at[step]] = -1e9
        if step in self.slow_at:
            w, f = self.slow_at[step]
            sd.record(w, f)
