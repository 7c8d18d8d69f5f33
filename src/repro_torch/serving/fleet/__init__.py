"""Fleet-scale serving: multi-cluster topology, workload routing,
federated LinUCB gossip, and telemetry-driven replica autoscaling (port of
``repro/serving/fleet``).

The fleet layer composes N single-cluster stacks (each a
``ContinuousRuntime`` with its own pools and scheduler policy) behind a
deterministic front-end router, on one global simulated clock.
Single-cluster code paths are untouched: a fleet of one reproduces the
standalone runtime bit-for-bit (tests/test_torch_fleet.py).
"""
from repro_torch.serving.fleet.autoscale import (AutoscaleConfig,
                                                 ReplicaAutoscaler)
from repro_torch.serving.fleet.engine import FleetEngine, FleetResult
from repro_torch.serving.fleet.federated import (FederatedRisePolicy,
                                                 LinUCBFederation, add_states,
                                                 centralized_reference,
                                                 zero_state)
from repro_torch.serving.fleet.router import WorkloadRouter, load_score
from repro_torch.serving.fleet.topology import (ROUTER_POLICIES, ClusterSpec,
                                                FleetConfig)

__all__ = [
    "AutoscaleConfig",
    "ReplicaAutoscaler",
    "FleetEngine",
    "FleetResult",
    "FederatedRisePolicy",
    "LinUCBFederation",
    "add_states",
    "centralized_reference",
    "zero_state",
    "WorkloadRouter",
    "load_score",
    "ROUTER_POLICIES",
    "ClusterSpec",
    "FleetConfig",
]
