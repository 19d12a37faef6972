"""Flight-recorder observability layer (docs/observability.md), disarmed
by default:

* :mod:`repro_torch.obs.trace`: phase spans with JSONL output, per-thread
  nesting, driver and wave attribution, and a ``torch.profiler``
  passthrough;
* :mod:`repro_torch.obs.metrics`: the process-wide metrics registry and
  per-round streaming sinks driven off the ``RoundEvent`` observer chain;
* :mod:`repro_torch.obs.history`: the versioned perf-history record.
"""
from repro_torch.obs.history import (SCHEMA_VERSION, append, latest, load,
                                     machine_fingerprint, make_record,
                                     validate_record)
from repro_torch.obs.metrics import (REGISTRY, Counter, CSVSink, Gauge,
                                     Histogram, JSONLSink, MemorySink,
                                     MetricsObserver, MetricsRegistry,
                                     device_memory_watermark)
from repro_torch.obs.trace import (FlightRecorder, arm, disarm, load_spans,
                                   recorder, set_context, span)

__all__ = [
    "SCHEMA_VERSION", "append", "latest", "load", "machine_fingerprint",
    "make_record", "validate_record",
    "REGISTRY", "Counter", "CSVSink", "Gauge", "Histogram", "JSONLSink",
    "MemorySink", "MetricsObserver", "MetricsRegistry",
    "device_memory_watermark",
    "FlightRecorder", "arm", "disarm", "load_spans", "recorder",
    "set_context", "span",
]
