"""The relay runtime's parts (port of ``repro/serving/runtime``): the
latent handoff transport, the discrete-event queue and work items, the
per-pool micro-batch aggregator, the runtime telemetry and the
``RuntimeConfig`` that the sequential engine reads for its transport.
The continuous-batching engine is not ported yet (ROADMAP queue 1, item
8(b)2)."""
from repro_torch.serving.runtime.batching import (BatchKey,
                                                  MicroBatchAggregator,
                                                  batch_key_for, bucketize)
from repro_torch.serving.runtime.engine import RuntimeConfig
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
    "RuntimeConfig", "EventQueue", "WorkItem",
    "EDGE", "DEVICE", "REPLICA_FAIL", "REPLICA_RECOVER", "STRAGGLER",
    "STRAGGLER_PARTIAL", "FaultCounters", "RuntimeTelemetry",
    "HandoffTransport", "TransportConfig", "channelwise_roundtrip",
]
