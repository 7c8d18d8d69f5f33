"""Federated LinUCB gossip (port of ``repro/serving/fleet/federated.py``).
The fleet's topology, router, autoscaler and engine are not ported yet."""
from repro_torch.serving.fleet.federated import (FederatedRisePolicy,
                                                 LinUCBFederation, add_states,
                                                 centralized_reference,
                                                 zero_state)

__all__ = ["FederatedRisePolicy", "LinUCBFederation", "add_states",
           "centralized_reference", "zero_state"]
