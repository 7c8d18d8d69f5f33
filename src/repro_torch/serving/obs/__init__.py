"""Observability for the serving stack (port of ``repro/serving/obs``).

Everything here observes without perturbing: spans are stamped on a
*simulated* or logical clock (``obs.tracer``), streaming stats are
bounded-memory (``obs.stats``), the event-loop profiler measures wall
time only (``obs.profiler``), and scheduler introspection is a pure read
of policy state plus completed records (``obs.sched``).  Exporters
(``obs.export``) turn a finished tracer into Chrome trace-event JSON
(loads in Perfetto: pools as tracks, requests as flows) or JSONL.  None
of it launches a kernel; only ``linucb_snapshot`` reads a tensor, and
copies it to the host.
"""
from repro_torch.serving.obs.export import (export_runtime_telemetry,
                                            to_chrome_trace,
                                            validate_chrome_trace,
                                            write_chrome_trace,
                                            write_spans_jsonl)
from repro_torch.serving.obs.profiler import EventLoopProfiler
from repro_torch.serving.obs.sched import (SchedulerIntrospection,
                                           linucb_snapshot, scheduler_report)
from repro_torch.serving.obs.stats import (DepthSeries, ReservoirSample,
                                           StreamingQuantiles,
                                           attribution_residual,
                                           latency_attribution)
from repro_torch.serving.obs.tracer import (HOP, QUEUE, REISSUE, SEGMENT,
                                            RequestTrace, Span, SpanTracer,
                                            span_structure)

__all__ = [
    "Span", "SpanTracer", "RequestTrace", "span_structure",
    "SEGMENT", "HOP", "QUEUE", "REISSUE",
    "to_chrome_trace", "write_chrome_trace", "write_spans_jsonl",
    "validate_chrome_trace", "export_runtime_telemetry",
    "StreamingQuantiles", "ReservoirSample", "DepthSeries",
    "latency_attribution", "attribution_residual",
    "SchedulerIntrospection", "linucb_snapshot", "scheduler_report",
    "EventLoopProfiler",
]
