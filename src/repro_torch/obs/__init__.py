"""Serving-tier observability: request-lifecycle tracing, always-on
metrics, and the Perfetto/Chrome and Prometheus exports (copies of
``repro.obs.trace``, ``repro.obs.metrics`` and ``repro.obs.export``)."""

from repro_torch.obs.trace import (NULL_TRACE, NullRecorder, TraceRecorder,
                                   TRACE_ENV_VAR, recorder_from_env, trace_of)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, registry_of)
from repro_torch.obs.export import (chrome_trace_events, chrome_trace_json,
                                    prometheus_text, queue_depth_timeline,
                                    write_chrome_trace)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACE",
    "NullRecorder",
    "TRACE_ENV_VAR",
    "TraceRecorder",
    "chrome_trace_events",
    "chrome_trace_json",
    "prometheus_text",
    "queue_depth_timeline",
    "recorder_from_env",
    "registry_of",
    "trace_of",
    "write_chrome_trace",
]
