"""Continuous-batching relay runtime (port of ``repro/serving/runtime``):
discrete-event N-segment execution with micro-batch aggregation, the
compressed latent handoff transport and fault injection (replica
failure/failover, straggler re-issue), and the parts it stands on — the
event queue and work items, the per-pool micro-batch aggregator and the
runtime telemetry."""
from repro_torch.serving.runtime.batching import (BatchKey,
                                                  MicroBatchAggregator,
                                                  batch_key_for, bucketize)
from repro_torch.serving.runtime.engine import (ContinuousRuntime,
                                                RuntimeConfig)
from repro_torch.serving.runtime.events import (DEVICE, EDGE, REPLICA_FAIL,
                                                REPLICA_RECOVER, STRAGGLER,
                                                STRAGGLER_PARTIAL, EventQueue,
                                                WorkItem)
from repro_torch.serving.runtime.telemetry import (FaultCounters,
                                                   RuntimeTelemetry)
from repro_torch.serving.runtime.transport import (HandoffTransport,
                                                   TransportConfig,
                                                   channelwise_roundtrip)

__all__ = [
    "BatchKey", "MicroBatchAggregator", "batch_key_for", "bucketize",
    "ContinuousRuntime", "RuntimeConfig", "EventQueue", "WorkItem",
    "EDGE", "DEVICE", "REPLICA_FAIL", "REPLICA_RECOVER", "STRAGGLER",
    "STRAGGLER_PARTIAL", "FaultCounters", "RuntimeTelemetry",
    "HandoffTransport", "TransportConfig", "channelwise_roundtrip",
]
