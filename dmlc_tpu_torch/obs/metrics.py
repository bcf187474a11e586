"""Process-wide metrics registry: counters, gauges, histograms, and
registered ``stats()`` collectors under ONE versioned snapshot schema.

Copy of ``dmlc_tpu/obs/metrics.py``, whole: the port's trace plane
(``obs.export``, ``obs.log``, ``obs.trace``) reads the gang rank and
registers the profiler here, as the reference's does.

- **Counter / Gauge / Histogram** — the primitive instruments (monotonic
  count, last-set value, log2-bucketed distribution);
- **collectors** — weakly-held objects with a dict-returning stats
  function, polled at snapshot time. Weak registration means an
  iterator that gets garbage-collected silently leaves the registry;
  ``destroy()``-style teardown can also unregister eagerly.

``snapshot()`` returns a plain-JSON dict with a versioned schema
(:data:`METRICS_SCHEMA`), pid/rank-tagged so per-worker snapshots from a
gang can be merged side-by-side with :func:`merge_snapshots` (the
metrics analogue of merged trace files).
"""

from __future__ import annotations

import itertools
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "merge_snapshots", "worker_rank",
           "METRICS_SCHEMA"]

# bump when snapshot()'s top-level shape changes incompatibly
METRICS_SCHEMA = 1


def worker_rank() -> Optional[int]:
    """This process's gang rank under the parallel.launch env contract
    (DMLC_TPU_TASK_ID, reference-name alias accepted); None standalone
    or when the var is malformed. The ONE implementation — obs.export
    and obs.log read rank through here."""
    for name in ("DMLC_TPU_TASK_ID", "DMLC_TASK_ID"):
        v = os.environ.get(name)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return None


class Counter:
    """Monotonic count (events, bytes, items)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-set value; numeric or a small state string (e.g. the
    replay tier serving the current epoch)."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value: Any = None

    def set(self, value: Any) -> None:
        self._value = value

    @property
    def value(self) -> Any:
        return self._value


class Histogram:
    """Bucketed distribution summary (count/sum/min/max + bucket counts
    keyed by upper bound). Default buckets are log2-doubling from 1e-6
    — cheap enough for per-pull waits; pass explicit ``bounds`` (sorted
    positive upper bounds) when judgment
    accuracy at a specific value matters more than range: observations
    past the last bound land in a ``float("inf")`` overflow bucket."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_buckets",
                 "_bounds", "_lower")

    def __init__(self, bounds: Optional[List[float]] = None):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets: Dict[float, int] = {}
        if bounds is not None:
            bounds = [float(b) for b in bounds]
            if (not bounds or bounds[0] <= 0
                    or any(b >= a for b, a in zip(bounds, bounds[1:]))):
                raise ValueError(
                    "Histogram bounds must be positive and strictly "
                    f"increasing, got {bounds!r}")
            self._bounds: Optional[List[float]] = bounds
            # per-bucket lower edge for quantile interpolation (log2
            # buckets derive it as ub/2; explicit bounds can't)
            self._lower: Optional[Dict[float, float]] = {
                ub: (bounds[i - 1] if i else 0.0)
                for i, ub in enumerate(bounds)}
            self._lower[float("inf")] = bounds[-1]
        else:
            self._bounds = None
            self._lower = None

    def _bucket(self, v: float) -> float:
        if self._bounds is not None:
            for ub in self._bounds:
                if v <= ub:
                    return ub
            return float("inf")
        if v <= 0:
            return 0.0
        b = 1e-6
        while b < v:
            b *= 2
        return b

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            b = self._bucket(v)
            self._buckets[b] = self._buckets.get(b, 0) + 1

    def _quantile_locked(self, q: float) -> Optional[float]:
        """Estimate the q-quantile from the log2 buckets: walk the
        cumulative counts to the target bucket, interpolate linearly
        inside it (bucket lower bound = upper/2 for log2 buckets),
        clamp to the observed min/max. Called with the lock held."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for ub, n in sorted(self._buckets.items()):
            prev = cum
            cum += n
            if cum >= target:
                if self._lower is not None:
                    lo = self._lower.get(ub, 0.0)
                else:
                    lo = 0.0 if ub <= 0 else ub / 2.0
                if ub == float("inf"):
                    # overflow bucket has no upper edge to interpolate
                    # toward; the observed max is the best estimate
                    est = self.max if self.max is not None else lo
                else:
                    est = lo + (ub - lo) * ((target - prev) / n)
                if self.min is not None:
                    est = max(est, self.min)
                if self.max is not None:
                    est = min(est, self.max)
                return round(est, 9)
        return self.max

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self.count, "sum": round(self.total, 9),
                    "min": self.min, "max": self.max,
                    # bucket-walk estimates (exact only at bucket
                    # edges; clamped to min/max) — the at-a-glance
                    # latency numbers /metrics renders per histogram
                    "p50": self._quantile_locked(0.5),
                    "p99": self._quantile_locked(0.99),
                    "buckets": {repr(k): v for k, v in
                                sorted(self._buckets.items())}}


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of collector output to plain JSON."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return {f: _jsonable(getattr(v, f)) for f in v.__dataclass_fields__}
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    if hasattr(v, "item"):  # numpy scalar
        try:
            return v.item()
        except Exception:  # noqa: BLE001
            return repr(v)
    return repr(v)


class MetricsRegistry:
    """get-or-create instruments + weakly-registered collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # name -> (weakref to owner, fn(owner) -> dict)
        self._collectors: Dict[str, tuple] = {}
        self._seq = itertools.count(2)

    # -- instruments

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  bounds: Optional[List[float]] = None) -> Histogram:
        """Get-or-create. ``bounds`` applies only when this call
        CREATES the histogram — an existing instrument keeps its
        buckets (re-bucketing live counts would corrupt them), so
        declare bounds before the first observation."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds=bounds)
            return h

    def peek_histogram(self, name: str) -> Optional[Histogram]:
        """The histogram if it exists, else None — a reader (e.g. the
        SLO engine judging a declared metric) must never materialize
        an empty instrument onto /metrics."""
        with self._lock:
            return self._histograms.get(name)

    # -- collectors (the existing stats() surfaces)

    def register(self, name: str, owner: Any,
                 fn: Callable[[Any], Dict[str, Any]]) -> str:
        """Register ``fn(owner)`` as a snapshot collector. ``owner`` is
        held WEAKLY: a collected owner drops out of snapshots on its
        own. Name collisions get a ``#N`` suffix; the actual name is
        returned (pass it to :meth:`unregister`)."""
        with self._lock:
            self._prune_locked()
            actual = name
            while actual in self._collectors:
                actual = f"{name}#{next(self._seq)}"
            self._collectors[actual] = (weakref.ref(owner), fn)
            return actual

    def unregister(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def _prune_locked(self) -> None:
        dead = [n for n, (ref, _) in self._collectors.items()
                if ref() is None]
        for n in dead:
            del self._collectors[n]

    # -- snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Freeze everything into the versioned plain-JSON shape. A
        collector that raises reports ``None`` instead of killing the
        snapshot (telemetry must never take down the pipeline)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: _jsonable(g.value)
                      for n, g in self._gauges.items()}
            hists = {n: h.summary() for n, h in self._histograms.items()}
            collectors = dict(self._collectors)
        polled: Dict[str, Any] = {}
        for name, (ref, fn) in sorted(collectors.items()):
            owner = ref()
            if owner is None:
                continue
            try:
                polled[name] = _jsonable(fn(owner))
            except Exception:  # noqa: BLE001 — a torn-down owner
                polled[name] = None
        return {
            "schema": METRICS_SCHEMA,
            "pid": os.getpid(),
            "rank": worker_rank(),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "collectors": polled,
        }

    def reset(self) -> None:
        """Drop every instrument and collector (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._collectors.clear()


REGISTRY = MetricsRegistry()  # the process-global registry


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Combine per-worker snapshots into one gang view, keyed by rank
    (falling back to pid) — the report shape for multiprocess runs."""
    workers: Dict[str, Any] = {}
    for s in snaps:
        key = (f"rank{s['rank']}" if s.get("rank") is not None
               else f"pid{s.get('pid')}")
        while key in workers:
            key += "'"
        workers[key] = s
    return {"schema": METRICS_SCHEMA, "workers": workers}
