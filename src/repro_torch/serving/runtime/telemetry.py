"""Per-pool runtime telemetry: queue depth, batch occupancy, wire bytes,
fault counters (replica failures, straggler re-issues); a copy of
``repro/serving/runtime/telemetry.py``.

Collected by the continuous-batching engine and summarized through
``repro_torch.serving.obs.export.export_runtime_telemetry`` for benchmarks
and dashboards.  Everything is plain Python counters — telemetry must never
perturb the simulated clock.

:class:`FaultCounters` is shared by the sequential and the continuous
engine (``serving/engine.py``, ``serving/runtime/engine.py``): both
expose it as ``engine.fault_counters``, and the two must agree for
identical workloads and fault regimes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.serving.obs.stats import DepthSeries


@dataclass
class FaultCounters:
    """Fault bookkeeping common to both runtimes.

    Straggler counters are per *request* (not per batch) and derive from
    the deterministic per-request draw in ``repro_torch.serving.context`` —
    that is what makes them comparable across runtimes whose batch
    compositions differ."""

    replica_failures: int = 0  # injected replica outages
    replica_recoveries: int = 0  # outages that healed within the run
    stragglers_injected: int = 0  # edge-phase requests slowed > 1×
    stragglers_reissued: int = 0  # requests past the re-issue threshold
    # mitigation split (per request, like the counters above — the mechanism
    # that re-ran each straggling request, set by SimConfig.straggler_mode):
    reissued_per_item: int = 0  # re-run as a partial sub-batch on the twin
    reissued_whole_batch: int = 0  # re-run by re-issuing its whole batch

    def note_straggler(self, tripped: bool, per_item: bool) -> None:
        """Account one straggling request (draw > 1×); ``tripped`` when its
        slowdown exceeds the re-issue threshold, ``per_item`` for the
        partial-batch mitigation mode.  Both engines route through this so
        the split stays parity-comparable."""
        self.stragglers_injected += 1
        if tripped:
            self.stragglers_reissued += 1
            if per_item:
                self.reissued_per_item += 1
            else:
                self.reissued_whole_batch += 1

    def as_dict(self) -> Dict[str, int]:
        """Exact integer counter dict — the golden/parity suites compare
        this with strict equality, so keys and semantics are frozen."""
        return {
            "replica_failures": self.replica_failures,
            "replica_recoveries": self.replica_recoveries,
            "stragglers_injected": self.stragglers_injected,
            "stragglers_reissued": self.stragglers_reissued,
            "reissued_per_item": self.reissued_per_item,
            "reissued_whole_batch": self.reissued_whole_batch,
        }


@dataclass
class AutoscaleCounters:
    """Autoscaler action bookkeeping, kept SEPARATE from
    :class:`FaultCounters` on purpose: the golden/parity suites compare
    ``FaultCounters.as_dict()`` with exact equality, so autoscale activity
    must never leak into it.  Per-pool action counts live in
    ``scale_ups_by_pool`` / ``scale_downs_by_pool``."""

    ticks: int = 0  # AUTOSCALE evaluation events handled
    scale_ups: int = 0  # replicas returned to service by the policy
    scale_downs: int = 0  # replicas parked (drained) by the policy
    scale_ups_by_pool: Dict[str, int] = field(default_factory=dict)
    scale_downs_by_pool: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready counter dict (per-pool dicts copied)."""
        return {
            "ticks": self.ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_ups_by_pool": dict(self.scale_ups_by_pool),
            "scale_downs_by_pool": dict(self.scale_downs_by_pool),
        }


@dataclass
class PoolStats:
    """Per-pool serving counters: queue depth, batching efficiency,
    handoff bytes, replica-busy seconds and fault/re-issue tallies."""

    # queue-depth distribution as bounded streaming stats (exact mean/max +
    # reservoir quantiles) — the old per-sample list grew O(requests) and
    # would OOM the ROADMAP's 10⁶-request fleet-scale replay
    depth: DepthSeries = field(default_factory=DepthSeries)
    n_batches: int = 0
    batched_items: int = 0
    padded_slots: int = 0  # bucket capacity left empty by padding
    bytes_out: int = 0  # latent handoff bytes leaving this pool
    busy_s: float = 0.0  # replica-seconds spent serving batches
    forced_flushes: int = 0  # sub-maximal batches dispatched at linger deadline
    failures: int = 0  # replica outages injected on this pool
    reissued_batches: int = 0  # whole batches re-issued on the twin replica
    reissued_partial_batches: int = 0  # straggler-only sub-batches re-issued
    reissued_items: int = 0  # samples re-run on a twin (whole or partial)

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched bucket slots holding real work."""
        cap = self.batched_items + self.padded_slots
        return self.batched_items / cap if cap else 0.0

    @property
    def mean_batch(self) -> float:
        """Mean real items per dispatched batch (0.0 before any batch)."""
        return self.batched_items / self.n_batches if self.n_batches else 0.0


class RuntimeTelemetry:
    """Aggregates per-pool stats plus fault and autoscale counters for one
    runtime instance; read via :meth:`summary` (pools), ``.faults`` and
    ``.autoscale``.  Pure Python counters — never perturbs the clock."""

    def __init__(self):
        self.pools: Dict[str, PoolStats] = {}
        self.faults = FaultCounters()
        self.autoscale = AutoscaleCounters()

    def _pool(self, pool: str) -> PoolStats:
        # not setdefault: that would construct (and discard) a PoolStats —
        # including its reservoir buffer — on every hot-path call
        p = self.pools.get(pool)
        if p is None:
            p = self.pools[pool] = PoolStats()
        return p

    def record_depth(self, pool: str, t: float, depth: int) -> None:
        """Sample ``pool``'s queue depth at simulated time ``t``."""
        self._pool(pool).depth.add(t, depth)

    def record_batch(self, pool: str, n_items: int, bucket: int,
                     duration_s: float, forced: bool) -> None:
        """Account one dispatched batch: real items, padded bucket size,
        replica-busy seconds and whether the linger deadline forced it."""
        p = self._pool(pool)
        p.n_batches += 1
        p.batched_items += n_items
        p.padded_slots += bucket - n_items
        p.busy_s += duration_s
        if forced:
            p.forced_flushes += 1

    def record_transfer(self, pool: str, n_bytes: int, n_items: int = 1) -> None:
        """Account ``n_items`` equal-sized latent handoffs leaving ``pool``
        (one telemetry call per completed batch, not per item)."""
        self._pool(pool).bytes_out += n_bytes * n_items

    def record_failure(self, pool: str, recovers: bool) -> None:
        """Account one injected replica outage on ``pool`` (``recovers``
        when a REPLICA_RECOVER is scheduled)."""
        self._pool(pool).failures += 1
        self.faults.replica_failures += 1
        if recovers:
            self.faults.replica_recoveries += 1

    def record_autoscale_tick(self) -> None:
        """Account one handled AUTOSCALE evaluation event."""
        self.autoscale.ticks += 1

    def record_scale(self, pool: str, up: bool) -> None:
        """Account one applied autoscaler action on ``pool`` (scale-up
        returns a parked replica; scale-down parks one)."""
        a = self.autoscale
        if up:
            a.scale_ups += 1
            a.scale_ups_by_pool[pool] = a.scale_ups_by_pool.get(pool, 0) + 1
        else:
            a.scale_downs += 1
            a.scale_downs_by_pool[pool] = (
                a.scale_downs_by_pool.get(pool, 0) + 1
            )

    def record_straggler(self, reissued: bool, per_item: bool = False) -> None:
        """Account one straggling request (see FaultCounters.note_straggler)."""
        self.faults.note_straggler(tripped=reissued, per_item=per_item)

    def record_reissue(self, pool: str, n_items: int = 0,
                       partial: bool = False) -> None:
        """Account a straggler re-issue on ``pool``: a whole batch or a
        ``partial`` straggler-only sub-batch of ``n_items`` samples."""
        p = self._pool(pool)
        if partial:
            p.reissued_partial_batches += 1
        else:
            p.reissued_batches += 1
        p.reissued_items += n_items

    def summary(self) -> Dict[str, dict]:
        """Per-pool JSON-ready digest (queue depth, occupancy, batches,
        bytes, busy seconds, faults); pools sorted by name."""
        out = {}
        for pool, p in sorted(self.pools.items()):
            out[pool] = {
                "mean_queue_depth": p.depth.mean,
                "max_queue_depth": p.depth.max,
                "p95_queue_depth": p.depth.p95(),
                "batch_occupancy": p.occupancy,
                "mean_batch_size": p.mean_batch,
                "n_batches": p.n_batches,
                "forced_flushes": p.forced_flushes,
                "bytes_transferred": p.bytes_out,
                "busy_s": p.busy_s,
                "failures": p.failures,
                "reissued_batches": p.reissued_batches,
                "reissued_partial_batches": p.reissued_partial_batches,
                "reissued_items": p.reissued_items,
            }
        return out
