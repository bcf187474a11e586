"""dmlc_tpu_torch.obs — tracing, metrics and the warn channel.

Counterpart of ``dmlc_tpu/obs``; the ported part of it:

- :mod:`~dmlc_tpu_torch.obs.trace` — thread-aware span/instant/counter
  ring buffer, near-zero cost when off; the port's ONE span API (the
  ``utils.profiler`` shim sits over it), the named-stage ``Profiler``,
  ``trace_if_env`` for gang workers, and ``cuda_trace``, the device
  timeline hook (``torch.profiler`` and NVTX);
- :mod:`~dmlc_tpu_torch.obs.export` — Chrome/Perfetto trace-event JSON
  export + gang trace merging;
- :mod:`~dmlc_tpu_torch.obs.metrics` — counters/gauges/histograms plus
  the registered ``stats()`` surfaces, one versioned ``snapshot()``;
- :mod:`~dmlc_tpu_torch.obs.log` — the rate-limited, gang-deduplicated
  warn channel.

Not ported yet: the stall watchdog, the flight recorder, the live status
server, the sampling profiler and its renderers, the control plane,
SLOs, gang aggregation, the time series, the bottleneck analysis and
the RPC trace-context plane.
"""

from dmlc_tpu_torch.obs.export import (
    chrome_events, merge_chrome_files, write_chrome,
)
from dmlc_tpu_torch.obs.log import warn_limited, warn_once
from dmlc_tpu_torch.obs.metrics import (
    METRICS_SCHEMA, REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    merge_snapshots,
)
from dmlc_tpu_torch.obs.trace import (
    Profiler, StageStats, TraceRecorder, counter, cuda_trace, instant,
    profiler, span, start, stop, trace_to,
)

__all__ = [
    "TraceRecorder", "span", "instant", "counter", "start", "stop",
    "trace_to", "Profiler", "StageStats", "profiler", "cuda_trace",
    "chrome_events", "write_chrome", "merge_chrome_files",
    "MetricsRegistry", "REGISTRY", "Counter", "Gauge", "Histogram",
    "merge_snapshots", "METRICS_SCHEMA",
    "warn_once", "warn_limited",
]
