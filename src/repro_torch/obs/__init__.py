"""Serving-tier observability: request-lifecycle tracing and always-on
metrics (copies of ``repro.obs.trace`` and ``repro.obs.metrics``; the
Perfetto export waits for a later slice)."""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, registry_of)
from repro_torch.obs.trace import (NULL_TRACE, NullRecorder, TRACE_ENV_VAR,
                                   TraceRecorder, recorder_from_env, trace_of)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACE",
    "NullRecorder", "TRACE_ENV_VAR", "TraceRecorder", "recorder_from_env",
    "registry_of", "trace_of",
]
