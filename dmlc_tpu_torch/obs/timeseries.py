"""Time-series history: a bounded, downsampling ring of metrics samples.

Copy of ``dmlc_tpu/obs/timeseries.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Everything the obs plane served before this module answers "what is
happening RIGHT NOW" — ``/metrics`` renders one
:meth:`~dmlc_tpu_torch.obs.metrics.MetricsRegistry.snapshot`, a stall report
freezes one moment. The analysis half (gang aggregation, bottleneck
attribution, regression judgment) needs HISTORY: how the pull waits
decayed INTO the stall, what the credit gauge did across an epoch, how
rank 3's queue depth diverged from the gang.

:class:`TimeSeriesRing` keeps periodic samples of the NUMERIC leaves of
a registry snapshot (counters, numeric gauges, histogram count/sum and
p50/p99 estimates, collector numeric leaves — strings carry no
timeline) under a fixed byte budget. When the ring fills it COARSENS
instead of truncating: every other sample is dropped across the whole
history and the keep-stride doubles, so 10 seconds and 2 hours of run
both fit the same budget — old history gets coarser, it never
disappears. The oldest sample always survives a coarsening pass, so
``samples[-1].t - samples[0].t`` spans the whole recording.

One ring per process (``install()`` / ``install_if_env()`` under
``DMLC_TPU_HISTORY_S``, set per worker by
``launch_local(history_s=...)`` like the serve/flight contracts). The
shared ring is read by:

- ``StatusServer`` ``GET /history`` (live queries),
- the crash flight recorder (``history.json`` in every bundle — the
  same samples a live query would have seen, not a private sampler),
- watchdog stall reports (the decay INTO the stall),
- :mod:`dmlc_tpu_torch.obs.aggregate` reuses the ring mechanics per rank.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from dmlc_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

__all__ = ["TimeSeriesRing", "numeric_leaves", "install", "uninstall",
           "active", "install_if_env", "ENV_HISTORY_S",
           "ENV_HISTORY_BYTES", "TIMESERIES_SCHEMA"]

# bump when to_dict()'s top-level shape changes incompatibly
TIMESERIES_SCHEMA = 1

ENV_HISTORY_S = "DMLC_TPU_HISTORY_S"          # sample period (enables)
ENV_HISTORY_BYTES = "DMLC_TPU_HISTORY_BYTES"  # ring byte budget

DEFAULT_PERIOD_S = 15.0
DEFAULT_BUDGET_BYTES = 256 << 10


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def numeric_leaves(snap: Dict[str, Any]) -> Dict[str, float]:
    """Flatten one registry snapshot to its numeric leaves, keyed by
    section-prefixed dotted path (``counters.rows``,
    ``gauges.queue.depth``, ``histograms.wait_s.p99``,
    ``collectors.pipeline.wall_s``). Strings/None/structures are
    dropped — a timeline of reprs is noise, and the CURRENT snapshot
    still carries them for anyone who asks."""
    out: Dict[str, float] = {}
    for name, v in (snap.get("counters") or {}).items():
        out[f"counters.{name}"] = v
    for name, v in (snap.get("gauges") or {}).items():
        if _is_num(v):
            out[f"gauges.{name}"] = v
    for name, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            continue
        for k in ("count", "sum", "p50", "p99"):
            v = h.get(k)
            if _is_num(v):
                out[f"histograms.{name}.{k}"] = v
    stack: List[tuple] = [(f"collectors.{n}", v) for n, v in
                          (snap.get("collectors") or {}).items()]
    while stack:
        prefix, v = stack.pop()
        if isinstance(v, dict):
            stack.extend((f"{prefix}.{k}", x) for k, x in v.items())
        elif isinstance(v, (list, tuple)):
            stack.extend((f"{prefix}.{i}", x) for i, x in enumerate(v))
        elif _is_num(v):
            out[prefix] = v
    return out


def _sample_bytes(leaves: Dict[str, float]) -> int:
    """Approximate in-memory/JSON cost of one sample: key text + one
    number per leaf + per-sample framing. An estimate, but a STABLE
    one — the budget check and the soak-test assertion use the same
    arithmetic."""
    return 32 + sum(len(k) + 16 for k in leaves)


class TimeSeriesRing:
    """Bounded, coarsening history of numeric metric samples.

    ``append(t, leaves)`` is the primitive (the gang aggregator feeds
    REMOTE snapshots through it); ``sample_now()`` appends the local
    registry's leaves; ``start()``/``stop()`` run a daemon sampler at
    ``period_s``. Appends honor the current keep-stride: after K
    coarsening passes only every ``2**K``-th offered sample is stored,
    which holds both memory AND per-sample cost flat on very long runs.
    """

    def __init__(self, period_s: float = DEFAULT_PERIOD_S,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 registry: Optional[MetricsRegistry] = None):
        self.period_s = max(0.01, float(period_s))
        self.budget_bytes = max(4 << 10, int(budget_bytes))
        self.registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        # [(wall_time, leaves, est_bytes)], oldest first
        self._samples: List[tuple] = []
        self._bytes = 0
        self._stride = 1
        self._tick = 0      # offered samples (for stride skipping)
        self._offered = 0   # total offered over the ring's life
        self._coarsenings = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- appends

    def append(self, t: float, leaves: Dict[str, float],
               force: bool = False) -> bool:
        """Offer one sample at wall time ``t``. Returns True when it
        was stored (False: skipped by the current stride).
        ``force=True`` bypasses the stride — crash/stall dumps force a
        final sample so the black box carries the actual end state
        even after the ring has coarsened to a multi-minute stride."""
        with self._lock:
            self._offered += 1
            keep = force or self._tick % self._stride == 0
            self._tick += 1
            if not keep:
                return False
            est = _sample_bytes(leaves)
            self._samples.append((t, leaves, est))
            self._bytes += est
            while self._bytes > self.budget_bytes and \
                    len(self._samples) >= 8:
                self._coarsen_locked()
            return True

    def sample_now(self, t: Optional[float] = None,
                   force: bool = False) -> bool:
        """Append the local registry's numeric leaves (the sampler
        thread's body; also callable directly from tests/tools —
        pass ``force=True`` from dump paths, see :meth:`append`)."""
        try:
            leaves = numeric_leaves(self.registry.snapshot())
        except Exception:  # noqa: BLE001 — telemetry must never raise
            return False
        return self.append(time.time() if t is None else t, leaves,
                           force=force)

    def _coarsen_locked(self) -> None:
        """Halve resolution: drop every other sample across the WHOLE
        history (even indices survive, so the oldest sample — the
        run's span anchor — is never lost) and double the keep-stride
        for future appends."""
        kept = self._samples[::2]
        self._bytes = sum(s[2] for s in kept)
        self._samples = kept
        self._stride *= 2
        self._coarsenings += 1

    # -- reads

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"t": t, "v": leaves}
                    for t, leaves, _ in self._samples]

    def last(self, seconds: float) -> List[Dict[str, Any]]:
        """The samples from the trailing ``seconds`` of wall time."""
        cutoff = time.time() - max(0.0, float(seconds))
        with self._lock:
            return [{"t": t, "v": leaves}
                    for t, leaves, _ in self._samples if t >= cutoff]

    def approx_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def to_dict(self, last_s: Optional[float] = None) -> Dict[str, Any]:
        """The /history payload (and the flight bundle's
        ``history.json``)."""
        samples = (self.last(last_s) if last_s is not None
                   else self.samples())
        with self._lock:
            return {
                "schema": TIMESERIES_SCHEMA,
                "period_s": self.period_s,
                # effective spacing of NEW samples after coarsening
                "resolution_s": self.period_s * self._stride,
                "stride": self._stride,
                "coarsenings": self._coarsenings,
                "offered": self._offered,
                "kept": len(self._samples),
                "approx_bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "samples": samples,
            }

    # -- the sampler thread

    def start(self) -> "TimeSeriesRing":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="dmlc_tpu_torch.obs.TimeSeriesRing")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        # first sample immediately: a short-lived worker still leaves
        # at least one point of history in its crash bundle
        self.sample_now()
        while not self._stop.wait(self.period_s):
            self.sample_now()


_ring: Optional[TimeSeriesRing] = None


def active() -> Optional[TimeSeriesRing]:
    return _ring


def install(period_s: float = DEFAULT_PERIOD_S,
            budget_bytes: int = DEFAULT_BUDGET_BYTES,
            registry: Optional[MetricsRegistry] = None) -> TimeSeriesRing:
    """Install + start the process history ring (idempotent: a second
    call returns the running ring — the flight recorder and an explicit
    install must share ONE ring, that is the point)."""
    global _ring
    if _ring is not None:
        return _ring
    _ring = TimeSeriesRing(period_s=period_s, budget_bytes=budget_bytes,
                           registry=registry).start()
    return _ring


def uninstall() -> None:
    global _ring
    ring, _ring = _ring, None
    if ring is not None:
        ring.stop()


def install_if_env() -> Optional[TimeSeriesRing]:
    """Gang-worker hook (one line, like serve_if_env): start the
    history ring when ``DMLC_TPU_HISTORY_S`` is set —
    ``launch_local(history_s=...)`` sets it per worker — else no-op."""
    raw = os.environ.get(ENV_HISTORY_S)
    if not raw:
        return None
    try:
        period = float(raw)
        budget = int(os.environ.get(ENV_HISTORY_BYTES,
                                    str(DEFAULT_BUDGET_BYTES)))
    except ValueError as e:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("history-env-failed",
                  f"obs.timeseries: bad {ENV_HISTORY_S}={raw!r}: {e}",
                  all_ranks=True)
        return None
    return install(period_s=period, budget_bytes=budget)
