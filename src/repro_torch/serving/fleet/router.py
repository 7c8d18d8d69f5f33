"""Front-end workload router: assigns each arriving request to a cluster
(port of ``repro/serving/fleet/router.py``).

The router consumes the per-cluster load snapshots the vectorized runtime
already exposes (``ContinuousRuntime.load_snapshot``: grouped occupancy,
per-pool backlog seconds, queued/in-flight counts, live capacity) and is
fully deterministic — ties break by cluster index and the weighted policy
is smooth weighted round-robin, so a fleet run replays bit-identically
for a given workload.  Pure Python on host numbers: the snapshots are
host floats and ints, never tensors.

Three policies (:data:`repro_torch.serving.fleet.topology.ROUTER_POLICIES`):

* ``least_loaded`` — send to the cluster with the lowest load score
  (queued + in-flight work normalized by live replica capacity);
* ``locality`` — prefer the request's home-region cluster unless its
  load score exceeds ``FleetConfig.spill_score``, then fall back to
  least-loaded (QoS-aware spill, the EAT-style dispatch);
* ``weighted`` — smooth weighted round-robin over
  ``FleetConfig.weights()`` (default ∝ total replicas), ignoring load.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .topology import FleetConfig


def load_score(snapshot: Dict[str, object]) -> float:
    """Deterministic scalar load of one cluster snapshot: queued plus
    in-flight requests per live replica (lower is better; a fully-dead
    cluster scores +inf so no router ever picks it while an alternative
    exists)."""
    cap = snapshot["capacity"]
    if cap <= 0:
        return float("inf")
    return (snapshot["queued"] + snapshot["inflight"]) / cap


class WorkloadRouter:
    """Stateful router for one fleet run (the weighted policy carries
    smooth-WRR counters; the others are pure functions of the snapshots).

    ``route`` returns a cluster index into ``FleetConfig.clusters``."""

    def __init__(self, fleet: FleetConfig):
        self.fleet = fleet
        self.policy = fleet.router
        self._weights = list(fleet.weights())
        self._wrr_current = [0.0] * fleet.n_clusters
        self._home = {}
        for k, spec in enumerate(fleet.clusters):
            # first cluster of each region is its home (deterministic)
            self._home.setdefault(spec.region, k)

    def _least_loaded(self, snapshots: Sequence[Dict[str, object]]) -> int:
        scores = [load_score(s) for s in snapshots]
        best = min(range(len(scores)), key=lambda k: (scores[k], k))
        return best

    def _locality(self, snapshots: Sequence[Dict[str, object]],
                  region: Optional[str]) -> int:
        home = self._home.get(region) if region is not None else None
        if home is not None and load_score(snapshots[home]) <= self.fleet.spill_score:
            return home
        return self._least_loaded(snapshots)

    def _weighted(self) -> int:
        # smooth weighted round-robin: add each weight to its running
        # counter, pick the max, subtract the weight total from the pick —
        # the spread is maximally even for any weight vector
        cur, w = self._wrr_current, self._weights
        total = sum(w)
        for k in range(len(cur)):
            cur[k] += w[k]
        best = max(range(len(cur)), key=lambda k: (cur[k], -k))
        cur[best] -= total
        return best

    def route(self, req, snapshots: Sequence[Dict[str, object]],
              region: Optional[str] = None) -> int:
        """Pick the cluster index for ``req`` given one load snapshot per
        cluster (index-aligned with ``FleetConfig.clusters``).  ``region``
        is the request's home region (locality policy only; the request
        object itself carries no fleet placement fields)."""
        if self.policy == "weighted":
            return self._weighted()
        if self.policy == "locality":
            return self._locality(snapshots, region)
        return self._least_loaded(snapshots)
