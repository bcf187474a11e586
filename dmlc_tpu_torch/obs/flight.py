"""Always-on crash flight recorder: a black box for the data plane.

Copy of ``dmlc_tpu/obs/flight.py`` with its imports rewritten to
``dmlc_tpu_torch``. A crash — uncaught exception, fatal signal, a
watchdog-confirmed wedge — leaves nothing but whatever stderr survived
unless something kept the telemetry. The flight recorder keeps a SMALL
always-on telemetry tail and dumps a self-contained post-mortem bundle
when the process dies badly:

- a dedicated :class:`~dmlc_tpu_torch.obs.trace.TraceRecorder` ring
  (default 4096 events) installed as the trace module's FALLBACK
  recorder: instrumented sites still read one global, an explicit
  ``trace_to``/``start()`` displaces it for the explicit trace's
  duration and ``stop()`` reinstates it — always-on costs one branch
  plus one ring append per event, exactly the tracing-on price;
- the SHARED time-series ring (:mod:`dmlc_tpu_torch.obs.timeseries`): the
  recorder installs the process history ring when none is running yet
  (period ``metrics_interval_s``), so the bundle's ``history.json``
  shows the minutes BEFORE the crash — the SAME samples a live
  ``GET /history`` query would have returned, not a private sampler's
  parallel universe;
- crash hooks: ``sys.excepthook`` + ``threading.excepthook`` (dump on
  uncaught exceptions), ``faulthandler`` writing fatal-signal stacks
  into the bundle dir (SIGSEGV leaves ``fatal.txt`` even though no
  Python can run), an ``atexit`` sweep that dumps if an error was seen
  but no bundle landed (and removes the empty pending dir on a clean
  exit), and the watchdog escalation hook (a confirmed stall dumps a
  bundle while the process is still alive to inspect).

Bundle layout (one timestamped dir per process under ``out_dir``)::

    flight-20260803-101502-pid4242/
      MANIFEST.json   # reason, time, pid/rank, what else is here
      trace.json      # Chrome/Perfetto export of the active ring
      metrics.json    # current snapshot + the periodic history
      history.json    # the shared time-series ring's full dump
      watchdog.json   # live blocked waits + past stall reports
      stacks.txt      # all-thread Python stacks at dump time
      env.json        # argv, python, platform, DMLC_*/CUDA_*/NCCL_*/
                      # TORCH_* env
      error.txt       # the traceback (exception dumps)
      fatal.txt       # faulthandler output (fatal-signal deaths)
      faults.json     # armed fault plan + injected-fault log (only
                      # when dmlc_tpu_torch.resilience.inject chaos
                      # was on)
      profile.txt     # sampling profiler's collapsed stacks — forced
                      # final sample + everything accumulated (only
                      # when dmlc_tpu_torch.obs.profile is installed)
      control.json    # the verdict-driven controller's decision
                      # ledger + knob state (only when
                      # dmlc_tpu_torch.obs.control is installed)
      rpc.json        # the RPC edge table: per-(peer, verb) latency
                      # attribution (only when dmlc_tpu_torch.obs.rpc
                      # recorded at least one edge)
      slo.json        # declared SLO objectives judged at dump time:
                      # attainment, budget remaining, burn alerts
                      # (only when dmlc_tpu_torch.obs.slo has
                      # objectives)

A dump reads host state only: it makes no CUDA call, since an injected
crash dumps from inside ``os._exit``'s caller in a process that holds a
CUDA context, where a device sync can hang.

Wiring: ``install()`` / ``uninstall()`` directly, or
:func:`install_if_env` under ``DMLC_TPU_FLIGHT_DIR`` (set per worker
by ``launch_local(flight_dir=...)``).
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, Optional

from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.obs import watchdog as _watchdog
from dmlc_tpu_torch.obs.metrics import REGISTRY, worker_rank

__all__ = ["FlightRecorder", "install", "uninstall", "install_if_env",
           "active", "ENV_FLIGHT_DIR"]

ENV_FLIGHT_DIR = "DMLC_TPU_FLIGHT_DIR"


def default_flight_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dmlc_tpu_torch_flight")


class FlightRecorder:
    """See the module docstring. One instance per process (install())."""

    def __init__(self, out_dir: Optional[str] = None,
                 ring_capacity: int = 4096,
                 metrics_interval_s: float = 15.0,
                 keep_bundles: int = 5):
        self.out_dir = out_dir or default_flight_dir()
        self.ring = _trace.TraceRecorder(ring_capacity)
        self.metrics_interval_s = float(metrics_interval_s)
        # the shared obs.timeseries ring this recorder installed (None
        # when one was already running: that one is read, not owned)
        self._owned_history = None
        self.keep_bundles = max(1, int(keep_bundles))
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.bundle_dir = os.path.join(
            self.out_dir, f"flight-{stamp}-pid{os.getpid()}")
        self.dumped = False
        self._error_seen = False
        self._lock = threading.Lock()
        self._installed = False
        self._fatal_file = None
        self._prev_excepthook = None
        self._prev_threading_hook = None

    # -- lifecycle

    def install(self) -> "FlightRecorder":
        if self._installed:
            return self
        os.makedirs(self.bundle_dir, exist_ok=True)
        self._prune_old_bundles()
        # fatal-signal stacks can only go to a pre-opened fd: no Python
        # runs during a SIGSEGV, so the bundle dir and file exist NOW
        try:
            self._fatal_file = open(
                os.path.join(self.bundle_dir, "fatal.txt"), "w")
            faulthandler.enable(file=self._fatal_file,
                                all_threads=True)
        except OSError:
            self._fatal_file = None
        _trace.set_fallback(self.ring)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._on_thread_exception
        _watchdog.set_escalation(self._on_stall)
        atexit.register(self._at_exit)
        # the black box needs history: join the process time-series
        # ring, installing one (at this recorder's interval) only when
        # none is running — crash bundles and live /history queries
        # must read the SAME ring
        from dmlc_tpu_torch.obs import timeseries as _ts
        if _ts.active() is None:
            self._owned_history = _ts.install(
                period_s=self.metrics_interval_s)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        from dmlc_tpu_torch.obs import timeseries as _ts
        if (self._owned_history is not None
                and _ts.active() is self._owned_history):
            _ts.uninstall()
        self._owned_history = None
        if sys.excepthook is self._on_exception:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if threading.excepthook is self._on_thread_exception:
            threading.excepthook = (self._prev_threading_hook
                                    or threading.__excepthook__)
        _watchdog.set_escalation(None)
        if _trace.fallback() is self.ring:
            _trace.clear_fallback()
        try:
            atexit.unregister(self._at_exit)
        except Exception:  # noqa: BLE001
            pass
        self._close_fatal_file()
        if not self.dumped:
            self._remove_empty_bundle()

    def _close_fatal_file(self) -> None:
        if self._fatal_file is not None:
            try:
                faulthandler.disable()
                self._fatal_file.close()
            except Exception:  # noqa: BLE001
                pass
            self._fatal_file = None

    def _remove_empty_bundle(self) -> None:
        """Clean exit: a bundle holding only an empty fatal.txt is
        noise, not a post-mortem."""
        try:
            fatal = os.path.join(self.bundle_dir, "fatal.txt")
            if os.path.exists(fatal) and os.path.getsize(fatal) == 0:
                os.remove(fatal)
            if not os.listdir(self.bundle_dir):
                os.rmdir(self.bundle_dir)
        except OSError:
            pass

    def _prune_old_bundles(self) -> None:
        """Bounded retention over past runs' bundles in out_dir."""
        try:
            bundles = sorted(
                d for d in os.listdir(self.out_dir)
                if d.startswith("flight-")
                and os.path.isdir(os.path.join(self.out_dir, d)))
        except OSError:
            return
        import shutil
        for stale in bundles[:-self.keep_bundles]:
            try:
                shutil.rmtree(os.path.join(self.out_dir, stale))
            except OSError:
                pass

    # -- crash hooks

    def _on_exception(self, exc_type, exc, tb) -> None:
        self._error_seen = True
        try:
            self.dump("uncaught_exception", exc_info=(exc_type, exc, tb))
        except Exception:  # noqa: BLE001 — crashing the crash handler
            pass           # would eat the original traceback
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _on_thread_exception(self, args) -> None:
        if args.exc_type is SystemExit:
            return
        self._error_seen = True
        try:
            self.dump("thread_exception",
                      exc_info=(args.exc_type, args.exc_value,
                                args.exc_traceback),
                      thread=getattr(args.thread, "name", None))
        except Exception:  # noqa: BLE001
            pass
        prev = self._prev_threading_hook or threading.__excepthook__
        prev(args)

    def _on_stall(self, report: Dict[str, Any]) -> None:
        """Watchdog escalation: a CONFIRMED stall dumps a bundle while
        the process is alive (the dump is refreshed per stall report —
        the last state before a kill -9 is the one that matters)."""
        self._error_seen = True
        self.dump("watchdog_stall", stall_report=report)

    def _at_exit(self) -> None:
        if self._error_seen and not self.dumped:
            try:
                self.dump("atexit_after_error")
            except Exception:  # noqa: BLE001
                pass
        self._close_fatal_file()
        if not self.dumped:
            self._remove_empty_bundle()

    # -- the dump itself

    def dump(self, reason: str, exc_info=None, thread: Optional[str] = None,
             stall_report: Optional[Dict[str, Any]] = None) -> str:
        """Write the post-mortem bundle; returns the bundle dir. Safe
        to call repeatedly (each call refreshes the same dir); every
        file is written independently so a failure in one section
        still leaves the others."""
        with self._lock:
            d = self.bundle_dir
            os.makedirs(d, exist_ok=True)
            wrote: Dict[str, str] = {}

            def _write_json(name: str, payload: Any) -> None:
                try:
                    with open(os.path.join(d, name), "w") as f:
                        json.dump(payload, f, indent=1, default=repr)
                    wrote[name] = "ok"
                except Exception as e:  # noqa: BLE001
                    wrote[name] = f"failed: {e!r}"

            # the ring that actually recorded: an explicit trace (if
            # one is running) supersedes the fallback for the bundle
            rec = _trace.active() or self.ring
            try:
                from dmlc_tpu_torch.obs.export import chrome_events
                _write_json("trace.json", {
                    "traceEvents": chrome_events(rec),
                    "displayTimeUnit": "ms",
                    "otherData": {"recorded": rec.recorded,
                                  "dropped": rec.dropped,
                                  "flight_reason": reason},
                })
            except Exception as e:  # noqa: BLE001
                wrote["trace.json"] = f"failed: {e!r}"
            try:
                snap = REGISTRY.snapshot()
            except Exception as e:  # noqa: BLE001
                snap = {"error": repr(e)}
            # history comes from the SHARED time-series ring (one
            # last sample is forced so even a crash early in a period
            # window carries the final state)
            history = None
            try:
                from dmlc_tpu_torch.obs import timeseries as _ts
                ring = _ts.active()
                if ring is not None:
                    ring.sample_now(force=True)
                    history = ring.to_dict()
            except Exception:  # noqa: BLE001 — optional section
                history = None
            _write_json("metrics.json", {
                "current": snap,
                "history": (history or {}).get("samples") or [],
                "interval_s": self.metrics_interval_s,
            })
            if history is not None:
                _write_json("history.json", history)
            # the sampling profiler's collapsed stacks (forced sample
            # first — the period bypass — so even a fresh profiler
            # carries the dying state): absent when none is installed,
            # so clean/unprofiled runs leave nothing extra
            try:
                from dmlc_tpu_torch.obs import profile as _prof
                prof_lines = _prof.dump_collapsed()
            except Exception:  # noqa: BLE001 — optional section
                prof_lines = None
            if prof_lines is not None:
                try:
                    with open(os.path.join(d, "profile.txt"), "w") as f:
                        f.write("\n".join(prof_lines) + "\n")
                    wrote["profile.txt"] = "ok"
                except Exception as e:  # noqa: BLE001
                    wrote["profile.txt"] = f"failed: {e!r}"
            # the control plane's decision ledger: a post-mortem that
            # says WHICH knob moved on WHAT evidence before the death.
            # to_dict() runs user knob closures — guarded, because a
            # raising knob must cost this SECTION, never the bundle
            try:
                from dmlc_tpu_torch.obs import control as _control
                ctl = _control.active()
                control_doc = (ctl.to_dict() if ctl is not None
                               else None)
            except Exception as e:  # noqa: BLE001 — optional section
                control_doc = None
                wrote["control.json"] = f"failed: {e!r}"
            if control_doc is not None:
                _write_json("control.json", control_doc)
            # the RPC edge table: who this process was talking to and
            # where its wire wait went, at the moment of death
            try:
                from dmlc_tpu_torch.obs import rpc as _rpc
                rpc_doc = _rpc.view()
                if not rpc_doc.get("edges"):
                    rpc_doc = None
            except Exception as e:  # noqa: BLE001 — optional section
                rpc_doc = None
                wrote["rpc.json"] = f"failed: {e!r}"
            if rpc_doc is not None:
                _write_json("rpc.json", rpc_doc)
            # declared objectives at the moment of death: was the
            # process keeping its promises when it went down, and
            # which budget was burning
            try:
                from dmlc_tpu_torch.obs import slo as _slo
                eng = _slo.active()
                slo_doc = (eng.view()
                           if eng is not None and eng.objectives()
                           else None)
            except Exception as e:  # noqa: BLE001 — optional section
                slo_doc = None
                wrote["slo.json"] = f"failed: {e!r}"
            if slo_doc is not None:
                _write_json("slo.json", slo_doc)
            try:
                from dmlc_tpu_torch.resilience import inject as _inject
                plan = _inject.active()
            except Exception:  # noqa: BLE001 — optional section
                plan = None
            if plan is not None:
                # the chaos that was armed when the process died: a
                # post-mortem of an injected crash names its fault
                _write_json("faults.json", {
                    "plan": plan.spec(),
                    "seed": plan.seed,
                    "injected": plan.injected,
                    "events": plan.events(),
                })
            wd = _watchdog.active()
            _write_json("watchdog.json", {
                "installed": wd is not None,
                "threshold_s": wd.threshold_s if wd else None,
                "waits": _watchdog.current_waits(),
                "reports": list(wd.reports) if wd else [],
                "escalating_report": stall_report,
            })
            try:
                with open(os.path.join(d, "stacks.txt"), "w") as f:
                    f.write(_watchdog._thread_stacks())
                wrote["stacks.txt"] = "ok"
            except Exception as e:  # noqa: BLE001
                wrote["stacks.txt"] = f"failed: {e!r}"
            _write_json("env.json", {
                "argv": sys.argv,
                "executable": sys.executable,
                "python": sys.version,
                "platform": sys.platform,
                "cwd": os.getcwd(),
                "env": {k: v for k, v in sorted(os.environ.items())
                        if k.startswith(("DMLC_", "CUDA_", "NCCL_",
                                         "TORCH_"))},
            })
            if exc_info is not None:
                try:
                    with open(os.path.join(d, "error.txt"), "w") as f:
                        if thread:
                            f.write(f"in thread {thread}:\n")
                        traceback.print_exception(*exc_info, file=f)
                    wrote["error.txt"] = "ok"
                except Exception as e:  # noqa: BLE001
                    wrote["error.txt"] = f"failed: {e!r}"
            _write_json("MANIFEST.json", {
                "kind": "dmlc_tpu_flight_bundle",
                "reason": reason,
                "time": time.time(),
                "pid": os.getpid(),
                "rank": worker_rank(),
                "files": wrote,
            })
            self.dumped = True
            return d


_flight: Optional[FlightRecorder] = None


def active() -> Optional[FlightRecorder]:
    return _flight


def install(out_dir: Optional[str] = None,
            **kwargs: Any) -> FlightRecorder:
    """Install the process flight recorder (idempotent)."""
    global _flight
    if _flight is not None:
        return _flight
    _flight = FlightRecorder(out_dir=out_dir, **kwargs).install()
    return _flight


def uninstall() -> None:
    global _flight
    fl, _flight = _flight, None
    if fl is not None:
        fl.uninstall()


def install_if_env() -> Optional[FlightRecorder]:
    """Gang-worker hook (one line, like trace_if_env): install the
    flight recorder when ``DMLC_TPU_FLIGHT_DIR`` is set —
    ``launch_local(flight_dir=...)`` sets it per worker — else no-op.
    An unwritable dir degrades to a warning, not a worker crash: the
    telemetry opt-in must never take down the job it watches."""
    d = os.environ.get(ENV_FLIGHT_DIR)
    if not d:
        return None
    try:
        return install(out_dir=d)
    except OSError as e:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("flight-dir-failed",
                  f"obs.flight: could not install under "
                  f"{ENV_FLIGHT_DIR}={d!r}: {e}", all_ranks=True)
        return None
