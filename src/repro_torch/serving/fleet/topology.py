"""Fleet topology: the static description of a multi-cluster deployment
(port of ``repro/serving/fleet/topology.py``).

A *fleet* is N edge clusters, each a full single-cluster serving stack
(scheduler policy + continuous runtime + replica pools) with its own —
possibly heterogeneous — replica inventory.  :class:`ClusterSpec` pins
one cluster's inventory, region and router weight; :class:`FleetConfig`
collects the specs plus the fleet-wide knobs (router policy, LinUCB
gossip period, locality spill threshold).

The topology layer is pure data: validation happens here, behavior lives
in :mod:`repro_torch.serving.fleet.router`,
:mod:`~repro_torch.serving.fleet.federated` and
:mod:`~repro_torch.serving.fleet.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

#: router policy names accepted by FleetConfig / WorkloadRouter
ROUTER_POLICIES = ("least_loaded", "locality", "weighted")


@dataclass(frozen=True)
class ClusterSpec:
    """One cluster of the fleet.

    ``pool_replicas`` overrides the per-pool replica counts
    (``SimConfig.pool_replicas`` → ``serving.context.pool_inventory``);
    None keeps the testbed default inventory — and with it the
    bit-identical single-cluster golden path.  ``region`` is the locality
    key the "locality" router matches request regions against.
    ``weight`` biases the "weighted" router; None defaults to the
    cluster's total replica count, so bigger clusters draw
    proportionally more traffic."""

    name: str
    pool_replicas: Optional[Dict[str, int]] = None
    region: str = "default"
    weight: Optional[float] = None

    def total_replicas(self) -> int:
        """Total replica count across pools (the default router weight)."""
        from repro_torch.serving.arms import POOL_REPLICAS

        inv = self.pool_replicas or POOL_REPLICAS
        return int(sum(inv.values()))


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-wide wiring: cluster specs plus router/gossip knobs.

    ``gossip_period_s`` (simulated seconds) turns on federated LinUCB:
    every period the per-cluster policies' accumulated (A, b, counts)
    deltas merge into the shared statistics
    (:class:`repro_torch.serving.fleet.federated.LinUCBFederation`); None
    keeps each cluster learning in isolation.  ``spill_score`` is the locality
    router's home-cluster load score above which a request spills to the
    fleet-wide least-loaded cluster."""

    clusters: Tuple[ClusterSpec, ...]
    router: str = "least_loaded"
    gossip_period_s: Optional[float] = None
    spill_score: float = 1.5

    def __post_init__(self):
        if not self.clusters:
            raise ValueError("FleetConfig needs at least one cluster")
        names = [c.name for c in self.clusters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cluster names: {names}")
        if self.router not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router {self.router!r}; expected one of "
                f"{ROUTER_POLICIES}"
            )
        if self.gossip_period_s is not None and self.gossip_period_s <= 0:
            raise ValueError("gossip_period_s must be positive (or None)")

    @property
    def n_clusters(self) -> int:
        """Number of clusters in the fleet."""
        return len(self.clusters)

    def weights(self) -> Tuple[float, ...]:
        """Resolved router weights, one per cluster (explicit ``weight``
        or the cluster's total replica count)."""
        return tuple(
            float(c.weight) if c.weight is not None else float(c.total_replicas())
            for c in self.clusters
        )
