"""dmlc_tpu_torch.obs — unified observability: tracing, metrics, watchdog.

Counterpart of ``dmlc_tpu/obs``, every module of it:

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
  warn channel;
- :mod:`~dmlc_tpu_torch.obs.watchdog` — the stall watchdog: every
  pipeline pull and blocked queue wait registers while it blocks, and a
  wait past the threshold gives one diagnosis report;
- :mod:`~dmlc_tpu_torch.obs.flight` — the crash flight recorder: an
  always-on trace ring and a post-mortem bundle on an uncaught
  exception, a fatal signal, an injected crash or a confirmed stall;
- :mod:`~dmlc_tpu_torch.obs.rpc` — the RPC trace-context plane: client
  and server spans of the object-store wire calls, the status server's
  requests and the rendezvous line protocol, and the per-edge latency
  table (the ``rpc`` collector);
- :mod:`~dmlc_tpu_torch.obs.serve` — the LIVE plane: per-rank in-process
  HTTP status server (/metrics Prometheus exposition, /metrics.json,
  /healthz, /stacks, /trace, /rpc, /history, /gang, /tenants, /slo,
  /analyze, /control, /profile, /shuffle, and /pages, the objstore peer
  tier's data plane), ``scrape`` and ``scrape_gang`` (the ``obs.scrape``
  retry site);
- :mod:`~dmlc_tpu_torch.obs.timeseries` — the ANALYSIS substrate: a
  bounded, downsampling ring of periodic metric samples shared by
  /history, stall reports, and crash bundles;
- :mod:`~dmlc_tpu_torch.obs.aggregate` — rank-0 gang aggregation onto
  one wall-anchored timeline (per-rank series, rollups, explicit
  unreachable-rank gaps; served at /gang);
- :mod:`~dmlc_tpu_torch.obs.analyze` — bottleneck attribution (the
  structured bound verdict /analyze serves) and band-aware
  BENCH-to-BENCH regression comparison;
- :mod:`~dmlc_tpu_torch.obs.profile` — the continuous sampling profiler:
  merged Python+native flamegraphs (sys._current_frames + the engine's
  phase beacons) in a byte-budgeted coarsening trie, served at
  /profile, attached to stall reports and crash bundles, and the
  ``hot_frames`` evidence in the analyze verdict;
- :mod:`~dmlc_tpu_torch.obs.slo` and :mod:`~dmlc_tpu_torch.obs.control`
  — declared objectives with burn alerts, and the verdict-driven
  controller with its decision ledger.
"""

from dmlc_tpu_torch.obs.aggregate import GangAggregator
from dmlc_tpu_torch.obs.analyze import attribute, compare, gauge_band
from dmlc_tpu_torch.obs.export import (
    chrome_events, merge_chrome_files, write_chrome,
)
from dmlc_tpu_torch.obs.profile import FrameTrie, StackProfiler
from dmlc_tpu_torch.obs.timeseries import TimeSeriesRing
from dmlc_tpu_torch.obs.log import warn_limited, warn_once
from dmlc_tpu_torch.obs.metrics import (
    METRICS_SCHEMA, REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    merge_snapshots,
)
from dmlc_tpu_torch.obs.serve import (
    StatusServer, render_prometheus, scrape_gang, serve,
)
from dmlc_tpu_torch.obs.trace import (
    Profiler, StageStats, TraceRecorder, counter, cuda_trace, instant,
    profiler, span, start, stop, trace_to,
)
from dmlc_tpu_torch.obs.watchdog import Watchdog
from dmlc_tpu_torch.obs.flight import FlightRecorder

__all__ = [
    "TraceRecorder", "span", "instant", "counter", "start", "stop",
    "trace_to", "Profiler", "StageStats", "profiler", "cuda_trace",
    "chrome_events", "write_chrome", "merge_chrome_files",
    "MetricsRegistry", "REGISTRY", "Counter", "Gauge", "Histogram",
    "merge_snapshots", "METRICS_SCHEMA",
    "warn_once", "warn_limited", "Watchdog", "FlightRecorder",
    "StatusServer", "serve", "render_prometheus", "scrape_gang",
    "TimeSeriesRing", "GangAggregator",
    "attribute", "compare", "gauge_band",
    "StackProfiler", "FrameTrie",
]
