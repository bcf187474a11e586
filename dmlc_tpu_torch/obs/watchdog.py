"""Stall watchdog: turn a wedged pull into a diagnosis report.

Copy of ``dmlc_tpu/obs/watchdog.py`` with its imports rewritten to
``dmlc_tpu_torch``. A blocked queue pull looks exactly like a slow one
from the outside. Every instrumented wait (ThreadedIter producer/consumer
blocking, pipeline stage pulls) registers with this module while it
blocks: :func:`begin_wait`/:func:`end_wait` cost one dict write when a
watchdog is installed and a single global read when none is.

A running :class:`Watchdog` polls the registered waits; any wait older
than ``threshold_s`` produces ONE diagnosis report per stall naming
the blocked stage(s), how long each has been blocked, the live detail
each wait carries (queue occupancy/capacity, producer counters, replay
tier), a full metrics-registry snapshot (spill state, engine stats —
whatever the process registered), the trailing ``history_s`` of
time-series samples when a shared ``obs.timeseries`` ring is installed
(the decay INTO the stall, not just the frozen end state; that plane is
not ported yet, so ``history`` is empty until it is), and
``faulthandler`` stacks of every thread. The report lands as JSON at
``report_path`` (plus a warning through obs.log) and in ``self.reports``
for tests/tooling.

Trimmed from the reference: the sampling profiler's collapsed stacks
(``profile`` is always None: ``obs.profile`` is not ported).
"""

from __future__ import annotations

import faulthandler
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Watchdog", "begin_wait", "end_wait", "active",
           "current_waits", "set_escalation"]

_lock = threading.Lock()
_seq = itertools.count(1)
# key -> (name, t0_perf, detail_fn, thread_name)
_waits: Dict[int, tuple] = {}
_active: Optional["Watchdog"] = None
# stall-escalation hook (obs.flight): called with every delivered
# report, AFTER the per-watchdog on_stall callback — the flight
# recorder uses it to dump a post-mortem bundle when a run wedges
_escalation: Optional[Callable[[Dict[str, Any]], None]] = None


def active() -> Optional["Watchdog"]:
    return _active


def set_escalation(
        fn: Optional[Callable[[Dict[str, Any]], None]]) -> None:
    """Install (or clear, with None) the process-wide stall-escalation
    hook. One hook: the flight recorder owns it when installed."""
    global _escalation
    _escalation = fn


def current_waits() -> List[Dict[str, Any]]:
    """The instrumented pulls blocked RIGHT NOW (name, seconds blocked,
    thread) — the /healthz wait-state surface. Readable with or without
    a running watchdog (waits only REGISTER while one is installed, so
    without one this is empty)."""
    now = time.perf_counter()
    with _lock:
        entries = list(_waits.values())
    return [{"name": name, "blocked_s": round(now - t0, 3),
             "thread": tname}
            for name, t0, _fn, tname in entries]


def begin_wait(name: str,
               detail_fn: Optional[Callable[[], Dict[str, Any]]] = None
               ) -> Optional[int]:
    """Register a (potentially) blocking pull. Returns a token for
    :func:`end_wait`, or None (free) when no watchdog is installed."""
    if _active is None:
        return None
    key = next(_seq)
    entry = (name, time.perf_counter(), detail_fn,
             threading.current_thread().name)
    with _lock:
        _waits[key] = entry
    return key


def end_wait(key: Optional[int]) -> None:
    if key is None:
        return
    with _lock:
        _waits.pop(key, None)


def _thread_stacks() -> str:
    """All-thread stacks via faulthandler (needs a real fd).

    faulthandler writes at most 100 threads, newest first, and ends with
    "..." past them: in a process with more live threads the dumping
    thread (often the oldest, the main one) is cut off. Its own stack is
    then appended under faulthandler's "Current thread" header, so every
    dump shows the thread that asked for it."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            out = f.read()
            if "Current thread " in out:
                return out
            f.seek(0)
            f.truncate()
            faulthandler.dump_traceback(file=f, all_threads=False)
            f.seek(0)
            own = f.read().split("\n", 1)[-1]  # drop "Stack (...):"
        return (f"{out}\nCurrent thread 0x{threading.get_ident():016x} "
                f"(most recent call first):\n{own}")
    except Exception as e:  # noqa: BLE001 — diagnostics must not raise
        return f"<stack dump failed: {e}>"


class Watchdog:
    """Poll instrumented waits; report any that block past the
    threshold. One report per stall instance: a wait keeps its token
    for its whole blocked life, so a reported token is remembered and
    not re-reported while it stays blocked."""

    def __init__(self, threshold_s: float = 30.0,
                 interval_s: Optional[float] = None,
                 report_path: Optional[str] = None,
                 on_stall: Optional[Callable[[Dict[str, Any]], None]]
                 = None, keep_reports: int = 8,
                 history_s: float = 120.0):
        self.threshold_s = float(threshold_s)
        # how much time-series history to attach to each report (the
        # decay INTO the stall; needs the shared obs.timeseries ring)
        self.history_s = float(history_s)
        self.interval_s = (interval_s if interval_s is not None
                           else max(0.05, min(1.0, threshold_s / 4)))
        self.report_path = report_path
        self.on_stall = on_stall
        # history retention next to report_path: report_path itself
        # always holds the LATEST report, and each report also lands
        # as a timestamped sibling — a long soak used to either
        # overwrite its history (one path) or grow without bound
        self.keep_reports = max(1, int(keep_reports))
        self.reports: List[Dict[str, Any]] = []
        self._reported: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle

    def start(self) -> "Watchdog":
        global _active
        if self._thread is not None:
            return self
        # ONE watchdog owns the shared wait registry: stopping a still-
        # running predecessor here prevents its poll thread from
        # double-reporting every stall next to ours
        prev = _active
        if prev is not None and prev is not self:
            prev.stop()
        _active = self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dmlc_tpu_torch.obs.Watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop polling. The shared wait registry is NOT cleared:
        entries remove themselves via end_wait when their pull
        unblocks, and a pull that is STILL blocked must stay visible
        to a successor watchdog (blocked waits never re-register — a
        clear here would permanently blind the successor to exactly
        the stall it was started to catch)."""
        global _active
        if _active is self:
            _active = None
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- polling

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check()

    def check(self) -> Optional[Dict[str, Any]]:
        """One poll: report if any registered wait exceeds the
        threshold (also callable directly from tests)."""
        now = time.perf_counter()
        with _lock:
            stalled = [(k, e) for k, e in _waits.items()
                       if now - e[1] >= self.threshold_s
                       and k not in self._reported]
        if not stalled:
            return None
        blocked = []
        for key, (name, t0, detail_fn, tname) in stalled:
            detail = None
            if detail_fn is not None:
                try:
                    detail = detail_fn()
                except Exception as e:  # noqa: BLE001
                    detail = {"error": repr(e)}
            blocked.append({"name": name,
                            "blocked_s": round(now - t0, 3),
                            "thread": tname,
                            "detail": detail})
            self._reported.add(key)
        report = self._build_report(blocked)
        self.reports.append(report)
        self._deliver(report)
        return report

    def _build_report(self, blocked: List[Dict[str, Any]]
                      ) -> Dict[str, Any]:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        try:
            metrics = REGISTRY.snapshot()
        except Exception as e:  # noqa: BLE001
            metrics = {"error": repr(e)}
        # the trailing history_s of time-series samples: the frozen
        # end state (metrics above) shows WHERE it stalled, the decay
        # into it shows WHEN the rates started dying — empty when no
        # shared ring is installed
        history: List[Dict[str, Any]] = []
        try:
            from dmlc_tpu_torch.obs import timeseries as _ts
            ring = _ts.active()
            if ring is not None:
                ring.sample_now(force=True)
                history = ring.last(self.history_s)
        except Exception:  # noqa: BLE001 — diagnostics must not raise
            history = []
        return {
            "kind": "dmlc_tpu_stall_report",
            "time": time.time(),
            "pid": os.getpid(),
            "threshold_s": self.threshold_s,
            "blocked": blocked,
            "metrics": metrics,
            "history": history,
            "history_s": self.history_s,
            "profile": None,
            "stacks": _thread_stacks(),
        }

    def _deliver(self, report: Dict[str, Any]) -> None:
        names = ", ".join(b["name"] for b in report["blocked"])
        path_note = ""
        if self.report_path:
            try:
                tmp = self.report_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(report, f, indent=1)
                os.replace(tmp, self.report_path)
                self._write_history(report)
                path_note = f" — report: {self.report_path}"
            except Exception as e:  # noqa: BLE001
                path_note = f" — report write failed: {e}"
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            "watchdog-stall",
            f"Watchdog: pull(s) blocked > {self.threshold_s}s: "
            f"{names}{path_note}", min_interval_s=self.interval_s,
            all_ranks=True)
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except Exception:  # noqa: BLE001 — user callback
                pass
        if _escalation is not None:
            try:
                _escalation(report)
            except Exception:  # noqa: BLE001 — escalation hook
                pass

    def _write_history(self, report: Dict[str, Any]) -> None:
        """Timestamped sibling of report_path + bounded retention:
        ``stall.json`` keeps the latest, ``stall.20260803-101502-417.json``
        (..517, ...) keep the last ``keep_reports`` stalls of a soak."""
        import glob
        root, ext = os.path.splitext(self.report_path)
        ext = ext or ".json"
        t = report.get("time", time.time())
        stamp = (time.strftime("%Y%m%d-%H%M%S", time.localtime(t))
                 + f"-{int(t * 1000) % 1000:03d}")
        hist = f"{root}.{stamp}{ext}"
        tmp = hist + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, hist)
        kept = sorted(p for p in glob.glob(f"{root}.*{ext}")
                      if p != self.report_path
                      and not p.endswith(".tmp"))
        for stale in kept[:-self.keep_reports]:
            try:
                os.remove(stale)
            except OSError:
                pass
