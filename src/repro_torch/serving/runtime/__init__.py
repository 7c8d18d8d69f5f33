"""The relay runtime's latent handoff transport (port of
``repro/serving/runtime/transport.py``).  The runtime's engine, batching,
events and telemetry are not ported yet."""
from repro_torch.serving.runtime.transport import (HandoffTransport,
                                                   TransportConfig,
                                                   channelwise_roundtrip)

__all__ = ["HandoffTransport", "TransportConfig", "channelwise_roundtrip"]
