"""Run observability, the port of ``repro.obs``: structured JSONL round
telemetry, nested host span tracing (Chrome trace-event / Perfetto) and
the training-health scalars the supervised round bodies return."""
from repro_torch.obs.health import HEALTH_KEYS, cohort_health, host_health
from repro_torch.obs.metrics import (SCHEMA_VERSION, RunTelemetry, TelemetryConfig,
                                     canonical_stream, read_events, validate_events)
from repro_torch.obs.trace import (SpanTracer, close_run, open_run, torch_profile_start,
                                   torch_profile_stop)

__all__ = [
    "SCHEMA_VERSION", "RunTelemetry", "TelemetryConfig",
    "canonical_stream", "read_events", "validate_events",
    "SpanTracer", "torch_profile_start", "torch_profile_stop", "open_run", "close_run",
    "HEALTH_KEYS", "cohort_health", "host_health",
]
