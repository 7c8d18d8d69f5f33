"""Fleet driver: N interleaved cluster runtimes on one global clock (port
of ``repro/serving/fleet/engine.py``).

Each cluster is a full :class:`repro_torch.serving.runtime.engine
.ContinuousRuntime` (its own pools, aggregators, policy, telemetry and
tracer) built from a per-cluster ``SimConfig`` — ``ClusterSpec.
pool_replicas`` overrides the inventory and the seed is offset per
cluster so service-jitter streams are independent.  The driver merges
three time sources and always advances the globally earliest:

* the next unrouted arrival (the fleet-wide Poisson stream) — routed by
  :class:`repro_torch.serving.fleet.router.WorkloadRouter` over fresh
  ``load_snapshot`` views and injected into the chosen cluster;
* the next LinUCB gossip tick (``FleetConfig.gossip_period_s``) — a
  :class:`repro_torch.serving.fleet.federated.LinUCBFederation` merge;
* each cluster's earliest queued event (``peek_time``) — stepped one
  event at a time (``step``), ties by cluster index.

Determinism: the driver itself draws no randomness, so a (workload,
fleet config, policies) triple replays identically.  A single-cluster
fleet reproduces the standalone runtime's records bit-for-bit except at
measure-zero exact-time ties (injected arrivals take fresh heap seqs;
tests/test_torch_fleet.py asserts the equality on the golden workload).

The driver, the router and the autoscaler are host Python on the
simulated clock, as in the reference, and read only host numbers.  The
card does three things: each cluster's policy (on the device its caller
built it on), the federation's gossip adds (on the policies' device), and
each cluster's transport, which warms before the loop with one int8 round
trip per family of the action space — a ``quant_int8`` and a
``dequant_int8`` launch per family per cluster when compressed.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.runtime.engine import (ContinuousRuntime,
                                                RuntimeConfig)

from .autoscale import AutoscaleConfig, ReplicaAutoscaler
from .federated import LinUCBFederation
from .router import WorkloadRouter
from .topology import FleetConfig

#: per-cluster SimConfig seed offset (cluster 0 keeps the base seed, so a
#: one-cluster fleet matches the standalone runtime's RNG streams)
SEED_STRIDE = 101


@dataclass
class FleetResult:
    """Outcome of one fleet run.

    ``records`` is the rid-sorted union of every cluster's Records (the
    same currency as single-cluster runs — ``summarize`` works on it);
    ``per_cluster`` keeps each cluster's completion-ordered list;
    ``assignments`` maps rid → cluster index; ``telemetry`` is each
    cluster's RuntimeTelemetry (pool stats + fault + autoscale counters)."""

    records: List = field(default_factory=list)
    per_cluster: List[List] = field(default_factory=list)
    assignments: Dict[int, int] = field(default_factory=dict)
    telemetry: List = field(default_factory=list)
    n_gossips: int = 0

    def cumulative_reward(self) -> float:
        """Sum of per-request rewards across the fleet (the federated-vs-
        isolated benchmark metric, benchmarks/bench_fleet.py)."""
        return float(sum(r.reward for r in self.records))


class FleetEngine:
    """Build and drive one fleet run.

    ``policies`` is one scheduler policy per cluster (index-aligned with
    ``fleet.clusters``).  When ``fleet.gossip_period_s`` is set, every
    policy must be a ``FederatedRisePolicy`` (anything exposing
    ``take_delta``/``state``) and they are wrapped in a
    :class:`LinUCBFederation`.  ``autoscale`` attaches a per-cluster
    :class:`ReplicaAutoscaler` (one instance each — hysteresis state is
    cluster-local).  ``region_of`` maps a request to its home region for
    the locality router (e.g. ``lambda req: regions[req.rid % 3]``).
    ``device`` is every cluster's transport's: the card unless the caller
    passes ``"cpu"`` (raises when CUDA is absent); the policies stay on
    the device they were built on."""

    def __init__(
        self,
        fleet: FleetConfig,
        cfg,  # SimConfig template (per-cluster copies derive from it)
        quality_table,
        policies: Sequence,
        *,
        rt_cfg: Optional[RuntimeConfig] = None,
        autoscale: Optional[AutoscaleConfig] = None,
        dynamic_reward: bool = True,
        arms=None,
        region_of: Optional[Callable] = None,
        device=None,
    ):
        if len(policies) != fleet.n_clusters:
            raise ValueError(
                f"need one policy per cluster: got {len(policies)} for "
                f"{fleet.n_clusters} clusters"
            )
        self.fleet = fleet
        self.router = WorkloadRouter(fleet)
        self.policies = list(policies)
        self._region_of = region_of
        self.federation: Optional[LinUCBFederation] = None
        if fleet.gossip_period_s is not None:
            missing = [
                spec.name for spec, p in zip(fleet.clusters, self.policies)
                if not hasattr(p, "take_delta")
            ]
            if missing:
                raise ValueError(
                    f"gossip needs FederatedRisePolicy instances; clusters "
                    f"{missing} have none"
                )
            self.federation = LinUCBFederation(self.policies)
        base_rt = rt_cfg or RuntimeConfig()
        self.runtimes: List[ContinuousRuntime] = []
        for k, spec in enumerate(fleet.clusters):
            c_cfg = replace(
                cfg,
                seed=cfg.seed + SEED_STRIDE * k,
                pool_replicas=(
                    spec.pool_replicas if spec.pool_replicas is not None
                    else cfg.pool_replicas
                ),
            )
            c_rt = replace(
                base_rt,
                profiler=None,  # stepping bypasses the profiled loop
                autoscaler=(
                    ReplicaAutoscaler(autoscale) if autoscale is not None
                    else base_rt.autoscaler
                ),
            )
            self.runtimes.append(ContinuousRuntime(
                self.policies[k], quality_table, c_cfg, c_rt,
                dynamic_reward=dynamic_reward, arms=arms, device=device,
            ))

    def run(self, requests) -> FleetResult:
        """Route and serve ``requests`` to completion on the fleet-wide
        global clock; returns a :class:`FleetResult`."""
        arrivals = sorted(requests, key=lambda r: r.arrival)
        for rt in self.runtimes:
            rt.begin([])
        assignments: Dict[int, int] = {}
        i = 0
        period = self.fleet.gossip_period_s
        next_gossip = (
            arrivals[0].arrival + period
            if (self.federation is not None and arrivals) else None
        )
        inf = float("inf")
        while True:
            t_arr = arrivals[i].arrival if i < len(arrivals) else inf
            t_evt, k_evt = inf, -1
            for k, rt in enumerate(self.runtimes):
                t = rt.peek_time()
                if t is not None and t < t_evt:
                    t_evt, k_evt = t, k
            if t_arr == inf and t_evt == inf:
                break  # drained: no more arrivals, no queued events
            if next_gossip is not None and next_gossip <= min(t_arr, t_evt):
                self.federation.gossip()
                next_gossip += period
                continue
            if t_arr <= t_evt:
                # all clusters have advanced past t_arr: snapshots are
                # current, route and admit (ties: arrival first, matching
                # the standalone engine's reserved-seq arrival ordering)
                req = arrivals[i]
                i += 1
                snaps = [rt.load_snapshot(t_arr) for rt in self.runtimes]
                region = self._region_of(req) if self._region_of else None
                k = self.router.route(req, snaps, region=region)
                assignments[req.rid] = k
                self.runtimes[k].inject(req, t_arr)
                continue
            self.runtimes[k_evt].step()
        per_cluster = [list(rt.records) for rt in self.runtimes]
        merged = sorted(
            (r for recs in per_cluster for r in recs), key=lambda r: r.rid
        )
        return FleetResult(
            records=merged,
            per_cluster=per_cluster,
            assignments=assignments,
            telemetry=[rt.telemetry for rt in self.runtimes],
            n_gossips=(
                self.federation.n_gossips if self.federation is not None else 0
            ),
        )
