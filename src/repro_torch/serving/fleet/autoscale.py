"""Telemetry-driven replica autoscaling with hysteresis (port of
``repro/serving/fleet/autoscale.py``).

The autoscaler attaches to a runtime via ``RuntimeConfig.autoscaler``;
the runtime then fires AUTOSCALE evaluation ticks every ``interval_s``
simulated seconds and hands :meth:`ReplicaAutoscaler.decide` one view per
pool (live/parked/total replica counts, queue depth, backlog seconds,
occupancy).  Decisions are applied through the *existing* pool-membership
events — scale-down pushes REPLICA_FAIL (the replica drains exactly like
an outage: in-flight work finishes, no new batches) and scale-up pushes
REPLICA_RECOVER for a parked replica — so fault handling, span structure
and the dispatch path are reused unchanged.  Autoscale actions count in
``RuntimeTelemetry.autoscale`` (:class:`AutoscaleCounters`), never in the
fault counters the golden/parity suites compare exactly.

Flap protection is threefold:

* **sustain** — a breach must persist for ``up_sustain`` (resp.
  ``down_sustain``) consecutive ticks before an action fires;
* **cooldown** — after any action on a pool, that pool is quiet for
  ``cooldown_s`` seconds;
* **bounds** — a pool never drops below ``min_replicas`` live replicas
  and scale-up only revives replicas the autoscaler itself parked (the
  physical inventory is the hard ceiling).

All state is per-pool and deterministic: a given tick/view sequence
always yields the same actions (the hysteresis case of
tests/test_torch_fleet.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple


@dataclass(frozen=True)
class AutoscaleConfig:
    """Autoscaler thresholds.  Times are simulated seconds.

    Scale-up triggers on sustained backlog (``backlog_s ≥ up_backlog_s``);
    scale-down on sustained idleness (``occupancy ≤ down_occupancy`` AND
    an empty queue).  ``max_replicas`` (None → the pool's physical
    inventory) bounds live replicas from above; the autoscaler can only
    revive replicas it previously parked, so the inventory is always the
    hard ceiling."""

    interval_s: float = 5.0
    up_backlog_s: float = 20.0
    down_occupancy: float = 0.25
    up_sustain: int = 2
    down_sustain: int = 4
    cooldown_s: float = 15.0
    min_replicas: int = 1
    max_replicas: Optional[int] = None


class ReplicaAutoscaler:
    """Per-pool hysteresis controller; one instance per runtime (its
    streak/cooldown state is cluster-local, so fleet runs give each
    cluster its own instance)."""

    def __init__(self, cfg: Optional[AutoscaleConfig] = None):
        self.cfg = cfg or AutoscaleConfig()
        self._up_streak: Dict[str, int] = {}
        self._down_streak: Dict[str, int] = {}
        self._last_action: Dict[str, float] = {}

    def decide(self, now: float,
               views: Mapping[str, Mapping[str, float]]
               ) -> List[Tuple[str, int]]:
        """One evaluation tick → ``[(pool, ±1), …]`` actions (at most one
        per pool per tick).  ``views`` maps pool → dict with ``n_alive``,
        ``n_parked``, ``n_total``, ``depth``, ``backlog_s``,
        ``occupancy`` (see ``ContinuousRuntime._on_autoscale``)."""
        cfg = self.cfg
        actions: List[Tuple[str, int]] = []
        for pool, v in views.items():
            up = self._up_streak.get(pool, 0)
            down = self._down_streak.get(pool, 0)
            if v["backlog_s"] >= cfg.up_backlog_s:
                up, down = up + 1, 0
            elif v["occupancy"] <= cfg.down_occupancy and v["depth"] == 0:
                up, down = 0, down + 1
            else:
                up = down = 0
            self._up_streak[pool], self._down_streak[pool] = up, down

            last = self._last_action.get(pool)
            if last is not None and now - last < cfg.cooldown_s:
                continue  # cooling down: keep counting, act later
            ceiling = v["n_total"] if cfg.max_replicas is None else min(
                cfg.max_replicas, v["n_total"]
            )
            if up >= cfg.up_sustain and v["n_parked"] > 0 \
                    and v["n_alive"] < ceiling:
                actions.append((pool, +1))
            elif down >= cfg.down_sustain and v["n_alive"] > cfg.min_replicas:
                actions.append((pool, -1))
            else:
                continue
            self._last_action[pool] = now
            self._up_streak[pool] = self._down_streak[pool] = 0
        return actions
