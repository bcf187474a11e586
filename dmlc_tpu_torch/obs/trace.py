"""Low-overhead, thread-aware trace recorder (span ring buffer).

Copy of ``dmlc_tpu/obs/trace.py``, with :func:`cuda_trace` in place of
the reference's ``jax_trace``. The port's ONE span API. A
:class:`TraceRecorder` is a bounded ring buffer of trace events —
complete spans ("X"), instants ("i"), and counter samples ("C") — each
stamped with the recording thread. The hot-path contract is:

- **off by default, near-zero cost when off**: instrumented code reads
  the module-global ``_recorder`` once (``rec = active()``) and skips
  all timing when it is None. The pipeline's stage probes go further
  and reuse the perf_counter pair they already measure, so a span
  costs one tuple-append beyond the telemetry the probe keeps anyway;
- **ring, not list**: a capped ``deque`` — a week-long run can leave
  tracing on and keep the LAST ``capacity`` events (``dropped`` counts
  the overwritten ones);
- **wall-anchored timestamps**: ts = wall-clock at recorder start plus
  a perf_counter delta, so traces from different processes of one gang
  merge onto a single timeline (``obs.export.merge_chrome_files``).

Export to Chrome/Perfetto trace-event JSON lives in
:mod:`dmlc_tpu_torch.obs.export`; ``trace_to(path)`` is the one-liner.

:class:`Profiler` is the named-stage accumulator (calls/seconds/bytes);
every ``stage()`` ALSO emits a span into the active recorder, so there
is one span vocabulary, not two. ``utils/profiler.py`` is a deprecation
shim over it. :func:`cuda_trace` adds the device timeline: a
``torch.profiler`` trace of CPU and CUDA activity written as Chrome JSON
into a directory, or a ``record_function`` and NVTX range around the
region.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "TraceRecorder", "active", "start", "stop", "trace_to",
    "trace_if_env", "span", "instant", "counter",
    "set_fallback", "clear_fallback", "fallback",
    "CAT_RPC_CLIENT", "CAT_RPC_SERVER",
    "Profiler", "StageStats", "profiler", "cuda_trace",
]

# span categories of the reference's cross-process RPC plane: a client
# span is one attempt observed from the calling side, a server span is
# the serving handler's half. Both carry the serialized trace context
# in args — obs.export matches the pair into Perfetto flow events.
CAT_RPC_CLIENT = "rpc.client"
CAT_RPC_SERVER = "rpc.server"

# event tuples: (ph, name, cat, t_s, dur_s, tid, args)
#   ph "X": t_s = span start (perf_counter), dur_s = duration
#   ph "i": instant at t_s
#   ph "C": counter sample at t_s, args = {series: number}
_Event = Tuple[str, str, str, float, float, int, Optional[dict]]


class TraceRecorder:
    """Bounded ring buffer of trace events, thread-aware."""

    def __init__(self, capacity: int = 1 << 20):
        self._events: deque = deque(maxlen=int(capacity))
        self.capacity = int(capacity)
        self.recorded = 0          # total ever recorded (>=len => drops)
        # wall anchor: ts_us(e) = (wall0 + (t - perf0)) * 1e6 — stable
        # across processes on one host, perf_counter resolution within
        self.wall0_s = time.time()
        self.perf0_s = time.perf_counter()
        self._threads: Dict[int, str] = {}
        self._lock = threading.Lock()

    # -- recording (hot path: one counted append per event; the lock
    # guards only the `recorded` read-modify-write — `+= 1` from
    # concurrent producer/consumer threads would lose increments and
    # under-report `dropped`, making a truncated trace look complete)

    def _note_thread(self) -> int:
        t = threading.current_thread()
        ident = t.ident or 0
        if ident not in self._threads:
            with self._lock:
                self._threads[ident] = t.name
        return ident

    def _count(self) -> None:
        with self._lock:
            self.recorded += 1

    def complete(self, name: str, t0_s: float, dur_s: float,
                 cat: str = "", args: Optional[dict] = None) -> None:
        """One finished span: t0_s is perf_counter() at span start."""
        self._count()
        self._events.append(
            ("X", name, cat, t0_s, dur_s, self._note_thread(), args))

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None) -> None:
        self._count()
        self._events.append(("i", name, cat, time.perf_counter(), 0.0,
                             self._note_thread(), args))

    def counter(self, name: str, values: Dict[str, Any],
                cat: str = "") -> None:
        """One sample of a counter track (numeric series only)."""
        nums = {k: v for k, v in values.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if not nums:
            return
        self._count()
        self._events.append(("C", name, cat, time.perf_counter(), 0.0,
                             self._note_thread(), nums))

    # -- recording on behalf of NON-Python threads (the native engine's
    # span ring drains through here: events carry the engine's own small
    # thread ids, far below any pthread ident, so tracks never collide)

    def complete_at(self, name: str, t0_s: float, dur_s: float, tid: int,
                    cat: str = "", args: Optional[dict] = None) -> None:
        """One finished span attributed to an explicit thread id."""
        self._count()
        self._events.append(("X", name, cat, t0_s, dur_s, int(tid), args))

    def instant_at(self, name: str, t_s: float, tid: int, cat: str = "",
                   args: Optional[dict] = None) -> None:
        """One instant event attributed to an explicit thread id."""
        self._count()
        self._events.append(("i", name, cat, t_s, 0.0, int(tid), args))

    def name_thread(self, tid: int, name: str) -> None:
        """Register a display name for an explicit thread id (first
        registration wins, matching _note_thread's behavior)."""
        with self._lock:
            self._threads.setdefault(int(tid), name)

    # -- reading

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - len(self._events))

    def events(self) -> List[_Event]:
        return list(self._events)

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._threads)

    def ts_us(self, t_s: float) -> float:
        """perf_counter time → wall-anchored microseconds."""
        return (self.wall0_s + (t_s - self.perf0_s)) * 1e6


# module-global active recorder: None = tracing off. Hot paths read
# this ONCE per operation (`rec = active()`); everything else no-ops.
_recorder: Optional[TraceRecorder] = None
# the always-on FALLBACK ring (the reference's flight recorder installs
# its small crash ring here): it serves as the active recorder whenever no explicit
# trace is running, so instrumented sites still read ONE global —
# start() displaces it for the explicit trace, stop() restores it
_fallback: Optional[TraceRecorder] = None


def active() -> Optional[TraceRecorder]:
    """The installed recorder, or None when tracing is off."""
    return _recorder


def fallback() -> Optional[TraceRecorder]:
    """The installed always-on fallback ring, if any."""
    return _fallback


def _sync_native(on: bool) -> None:
    """Mirror the Python tracing on/off global into the native engine's
    span-ring flag — only when the engine library is ALREADY loaded
    (tracing must never trigger a native build/load)."""
    try:
        from dmlc_tpu_torch.native import bindings
        if bindings._lib is not None:
            bindings._lib.dtp_trace_set_enabled(1 if on else 0)
    except Exception:  # noqa: BLE001 — telemetry must not raise
        pass


def set_fallback(rec: TraceRecorder) -> None:
    """Install ``rec`` as the always-on fallback ring. It becomes the
    active recorder immediately unless an explicit trace is running
    (that trace keeps recording; ``rec`` takes over at its stop())."""
    global _recorder, _fallback
    if _recorder is None or _recorder is _fallback:
        _recorder = rec
    _fallback = rec
    _sync_native(_recorder is not None)


def clear_fallback() -> Optional[TraceRecorder]:
    """Remove the fallback ring; returns it."""
    global _recorder, _fallback
    rec, _fallback = _fallback, None
    if _recorder is rec:
        _recorder = None
    _sync_native(_recorder is not None)
    return rec


def start(capacity: int = 1 << 20) -> TraceRecorder:
    """Install a fresh global recorder. Replacing a live one discards
    everything it held — say so, because the outer ``trace_to`` will
    then skip its export and the silent combination reads as "the
    trace was empty" instead of "two tracers fought". (Displacing the
    always-on fallback ring is the designed interplay, not a fight:
    no warning, and stop() reinstates it.)"""
    global _recorder
    if _recorder is not None and _recorder is not _fallback:
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            "trace-recorder-replaced",
            f"obs.trace.start(): replacing an active recorder "
            f"({len(_recorder.events())} buffered events discarded; "
            "an enclosing trace_to() will not export) — nest trace "
            "scopes, don't overlap them", min_interval_s=60.0,
            all_ranks=True)
    _recorder = TraceRecorder(capacity)
    _sync_native(True)
    return _recorder


def stop() -> Optional[TraceRecorder]:
    """Uninstall and return the active EXPLICIT recorder, reinstating
    the always-on fallback ring (if one is installed). When only the
    fallback is active it stays installed and None is returned — use
    :func:`clear_fallback` to take it down."""
    global _recorder
    rec = _recorder
    if rec is None or rec is _fallback:
        return None
    _recorder = _fallback
    _sync_native(_recorder is not None)
    return rec


@contextlib.contextmanager
def trace_to(path: str, capacity: int = 1 << 20) -> Iterator[TraceRecorder]:
    """Record for the duration of the block and export Chrome
    trace-event JSON to ``path`` on exit (even on error)."""
    from dmlc_tpu_torch.obs.export import write_chrome
    rec = start(capacity)
    try:
        yield rec
    finally:
        if stop() is rec:
            write_chrome(rec, path)


@contextlib.contextmanager
def span(name: str, cat: str = "",
         args: Optional[dict] = None) -> Iterator[None]:
    """Record the block as one complete span (no-op when tracing is
    off — the recorder check costs one global read)."""
    rec = _recorder
    if rec is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec.complete(name, t0, time.perf_counter() - t0, cat, args)


def instant(name: str, cat: str = "", args: Optional[dict] = None) -> None:
    rec = _recorder
    if rec is not None:
        rec.instant(name, cat, args)


def counter(name: str, values: Dict[str, Any], cat: str = "") -> None:
    rec = _recorder
    if rec is not None:
        rec.counter(name, values, cat)


# ---------------------------------------------------------------- profiler
# The named-stage aggregation surface; its spans flow through the
# recorder above.

@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    items: int = 0

    @property
    def gb_per_sec(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0


class Profiler:
    """Named-stage accumulator; thread-safe. Each ``stage()`` also
    emits a span into the active TraceRecorder (cat "profiler")."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = {}
        self.enabled = True

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0,
              items: int = 0) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        rec = _recorder
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rec is not None:
                rec.complete(name, t0, dt, "profiler",
                             {"bytes": nbytes, "items": items}
                             if nbytes or items else None)
            self.add(name, seconds=dt, nbytes=nbytes, items=items,
                     _calls=1)

    def add(self, name: str, seconds: float = 0.0, nbytes: int = 0,
            items: int = 0, _calls: int = 1) -> None:
        with self._lock:
            st = self._stages.setdefault(name, StageStats())
            st.calls += _calls
            st.seconds += seconds
            st.bytes += nbytes
            st.items += items

    def stats(self) -> Dict[str, StageStats]:
        with self._lock:
            return dict(self._stages)

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()

    def report(self) -> str:
        lines = [f"{'stage':<24}{'calls':>8}{'sec':>10}{'GB':>10}"
                 f"{'GB/s':>10}{'items':>10}"]
        for name, st in sorted(self.stats().items()):
            lines.append(
                f"{name:<24}{st.calls:>8}{st.seconds:>10.3f}"
                f"{st.bytes / 1e9:>10.3f}{st.gb_per_sec:>10.3f}"
                f"{st.items:>10}")
        return "\n".join(lines)


profiler = Profiler()  # process-global default instance

# the profiler's named-stage aggregates join the one metrics snapshot
from dmlc_tpu_torch.obs.metrics import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("profiler", profiler, Profiler.stats)


@contextlib.contextmanager
def trace_if_env(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Gang-worker tracing hook: when ``DMLC_TPU_TRACE_DIR`` is set
    (``parallel.launch.launch_local(trace_dir=...)`` sets it for every
    worker) — or a dir is passed explicitly — record for the duration
    of the block and export a rank-tagged trace file into that dir;
    otherwise a no-op. ``merge_gang_traces`` stitches the files."""
    import os
    d = trace_dir or os.environ.get("DMLC_TPU_TRACE_DIR")
    if not d:
        yield
        return
    from dmlc_tpu_torch.obs.export import worker_rank
    rank = worker_rank()
    tag = f"rank{rank}" if rank is not None else f"pid{os.getpid()}"
    os.makedirs(d, exist_ok=True)
    with trace_to(os.path.join(d, f"trace-{tag}.json")):
        yield


def _annotated(name: str, on_cuda: bool) -> contextlib.ExitStack:
    """A ``record_function`` span named ``name`` and, on the card, an
    NVTX range of the same name."""
    import torch
    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if on_cuda:
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


@contextlib.contextmanager
def cuda_trace(name: str, log_dir: Optional[str] = None,
               device=None) -> Iterator[None]:
    """Wrap a region in a torch.profiler trace (device timeline) when
    ``log_dir`` is given, else a named ``record_function`` annotation;
    always also feeds the process profiler (and through it the active
    recorder).

    With ``log_dir`` the region runs under ``torch.profiler.profile``
    over CPU and CUDA activity, annotated with ``name``, and its Chrome
    trace is written into ``log_dir`` on exit (even on error) as
    ``<name>.<pid>.<ns>.pt.trace.json``. Without it the region is a
    ``record_function`` span and, on the card, an NVTX range.
    ``device`` defaults to ``cuda``; ``"cpu"`` records CPU activity only
    and pushes no NVTX range. Asking for ``cuda`` with no card raises."""
    import os

    import torch
    from dmlc_tpu_torch.utils.logging import DMLCError
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise DMLCError(f"cuda_trace runs on cuda or cpu, got {dev}")
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise DMLCError("cuda_trace(device='cuda') needs a CUDA card "
                        "(pass device='cpu' to trace the host only)")
    with profiler.stage(name):
        if log_dir is None:
            with _annotated(name, on_cuda):
                yield
            return
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if on_cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            with prof, _annotated(name, on_cuda):
                yield
        finally:
            prof.export_chrome_trace(os.path.join(
                log_dir, f"{name}.{os.getpid()}.{time.time_ns()}"
                ".pt.trace.json"))
