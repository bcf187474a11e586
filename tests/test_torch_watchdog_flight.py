"""The port's stall watchdog (``dmlc_tpu_torch/obs/watchdog.py``) and
crash flight recorder (``dmlc_tpu_torch/obs/flight.py``) on the CPU.

Twins of the reference's ``tests/test_obs.py::TestWatchdog``,
``tests/test_obs_live.py::TestFlightRecorder`` and
``::TestWatchdogReportRetention``, and of the two
``tests/test_obs_history.py::TestWatchdogHistory`` cases, run against the
port with its own time-series ring: a flight bundle carries the ring's
``history.json``. Beside them: a stall report and a flight bundle carry
the reference's keys for the same stall, and a dump makes no CUDA call.
"""

import glob
import json
import os
import sys
import threading
import time

import pytest
import torch

from dmlc_tpu.data.threaded_iter import ThreadedIter as RefThreadedIter
from dmlc_tpu.obs import watchdog as ref_watchdog
from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.obs import flight as obs_flight
from dmlc_tpu_torch.obs import log as obs_log
from dmlc_tpu_torch.obs import metrics as obs_metrics
from dmlc_tpu_torch.obs import trace as obs_trace
from dmlc_tpu_torch.obs import watchdog as obs_watchdog
from dmlc_tpu_torch.obs.metrics import REGISTRY
from dmlc_tpu_torch.obs.watchdog import Watchdog

CHROME_REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_clean():
    """Tracing off, no flight recorder, fresh log state per test."""
    obs_flight.uninstall()
    obs_trace.stop()
    obs_trace.clear_fallback()
    obs_log.reset()
    yield
    obs_flight.uninstall()
    obs_trace.stop()
    obs_trace.clear_fallback()
    obs_log.reset()


def _write_libsvm(tmp_path, rows=600, name="obs.libsvm"):
    lines = [f"{i % 2} 1:0.5 7:1.25 9:{i}.0" for i in range(rows)]
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _assert_chrome_golden(doc):
    assert "traceEvents" in doc and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        for key in CHROME_REQUIRED_KEYS:
            assert key in ev, (key, ev)
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            assert "dur" in ev, ev


def _stall(ti_cls, wd_cls, name):
    """One stall report of a consumer blocked on an empty ``name``
    queue of ``ti_cls``, caught by a ``wd_cls`` watchdog."""
    release = threading.Event()
    ti = ti_cls(max_capacity=2, name=name)
    ti.init(lambda: (release.wait(30.0), None)[1])
    consumer = threading.Thread(target=ti.next, daemon=True)
    wd = wd_cls(threshold_s=0.1, interval_s=0.03)
    try:
        with wd:
            consumer.start()
            deadline = time.time() + 5.0
            while not wd.reports and time.time() < deadline:
                time.sleep(0.02)
    finally:
        release.set()
        consumer.join(timeout=5.0)
        ti.destroy()
    assert wd.reports, "watchdog never fired"
    return wd.reports[0]


def test_stall_report_shape_matches_reference():
    port = _stall(ThreadedIter, Watchdog, "shape.port")
    ref = _stall(RefThreadedIter, ref_watchdog.Watchdog, "shape.ref")
    assert set(port) == set(ref)
    assert port["kind"] == ref["kind"] == "dmlc_tpu_stall_report"
    assert [b["name"] for b in port["blocked"]] == ["shape.port.consumer_wait"]
    assert [b["name"] for b in ref["blocked"]] == ["shape.ref.consumer_wait"]
    pb, rb = port["blocked"][0], ref["blocked"][0]
    assert set(pb) == set(rb)
    assert set(pb["detail"]) == set(rb["detail"])
    assert {k: pb["detail"][k] for k in ("qsize", "capacity", "produced")} \
        == {k: rb["detail"][k] for k in ("qsize", "capacity", "produced")}
    assert port["history"] == [] and port["profile"] is None


class TestWatchdog:
    def test_stall_produces_diagnosis_report(self, tmp_path):
        """A deliberate stall yields ONE report naming the blocked stage
        and its queue state, with metrics + stacks."""
        release = threading.Event()

        def blocked_next():
            release.wait(30.0)  # deliberate wedge
            return None

        ti = ThreadedIter(max_capacity=2, name="stalled.stage")
        ti.init(blocked_next)
        report_path = str(tmp_path / "stall.json")
        wd = Watchdog(threshold_s=0.15, interval_s=0.05,
                      report_path=report_path)
        consumer = threading.Thread(target=ti.next, daemon=True)
        with wd:
            consumer.start()
            deadline = time.time() + 5.0
            while not wd.reports and time.time() < deadline:
                time.sleep(0.02)
        release.set()
        consumer.join(timeout=5.0)
        ti.destroy()
        assert wd.reports, "watchdog never fired"
        report = wd.reports[0]
        blocked = report["blocked"]
        names = [b["name"] for b in blocked]
        assert "stalled.stage.consumer_wait" in names, names
        entry = [b for b in blocked
                 if b["name"] == "stalled.stage.consumer_wait"][0]
        assert entry["blocked_s"] >= 0.15
        assert entry["detail"]["qsize"] == 0
        assert entry["detail"]["capacity"] == 2
        assert report["metrics"]["schema"] == obs_metrics.METRICS_SCHEMA
        assert "Thread" in report["stacks"]
        on_disk = json.load(open(report_path))
        assert on_disk["kind"] == "dmlc_tpu_stall_report"
        assert on_disk["blocked"][0]["name"] == entry["name"]

    def test_stage_exception_leaves_no_phantom_wait(self, tmp_path):
        """A raising stage must unregister its watchdog wait."""
        from dmlc_tpu_torch.pipeline import Pipeline
        from dmlc_tpu_torch.utils.logging import DMLCError
        uri = _write_libsvm(tmp_path, rows=300, name="boom.libsvm")

        def boom(item):
            raise DMLCError("deliberate stage failure")

        built = (Pipeline.from_uri(uri)
                 .parse(format="libsvm", engine="python")
                 .map(boom)
                 .build())
        with Watchdog(threshold_s=0.1, interval_s=0.03) as wd:
            with pytest.raises(DMLCError):
                for _ in built:
                    pass
            time.sleep(0.3)  # several polls past the threshold
            assert wd.reports == [], wd.reports
            assert obs_watchdog.current_waits() == []
        built.close()

    def test_pipeline_pull_registers_with_stage_detail(self, tmp_path):
        """A pull blocked on a stage registers as ``pull/<stage>``,
        with the runner's detail (kind, items, queue state)."""
        from dmlc_tpu_torch.pipeline import Pipeline
        uri = _write_libsvm(tmp_path, rows=50, name="slow.libsvm")
        release = threading.Event()

        def slow(item):
            release.wait(30.0)
            return item

        built = (Pipeline.from_uri(uri)
                 .parse(format="libsvm", engine="python")
                 .map(slow)
                 .build())
        out = []
        puller = threading.Thread(target=lambda: out.extend(built),
                                  daemon=True)
        try:
            with Watchdog(threshold_s=0.1, interval_s=0.03) as wd:
                puller.start()
                deadline = time.time() + 5.0
                while not wd.reports and time.time() < deadline:
                    time.sleep(0.02)
        finally:
            release.set()
            puller.join(timeout=10.0)
            built.close()
        assert not puller.is_alive() and out
        blocked = {b["name"]: b for b in wd.reports[0]["blocked"]}
        pulls = [n for n in blocked if n.startswith("pull/")]
        assert pulls, list(blocked)
        detail = blocked[pulls[0]]["detail"]
        assert {"kind", "items"} <= set(detail)

    def test_no_report_below_threshold(self):
        ti = ThreadedIter(max_capacity=2, name="quick.stage")
        src = iter(range(5))
        ti.init(lambda: next(src, None))
        with Watchdog(threshold_s=5.0, interval_s=0.05) as wd:
            while ti.next() is not None:
                pass
            time.sleep(0.2)
        ti.destroy()
        assert wd.reports == []

    def test_replacing_watchdog_inherits_blocked_waits(self):
        release = threading.Event()
        ti = ThreadedIter(max_capacity=2, name="handover")
        ti.init(lambda: (release.wait(30.0), None)[1])
        a = Watchdog(threshold_s=0.15, interval_s=0.04).start()
        consumer = threading.Thread(target=ti.next, daemon=True)
        consumer.start()
        time.sleep(0.05)          # the wait registers under A
        b = Watchdog(threshold_s=0.15, interval_s=0.04).start()
        a.stop()                  # late stop must not blind B
        deadline = time.time() + 5.0
        while not b.reports and time.time() < deadline:
            time.sleep(0.02)
        b.stop()
        release.set()
        consumer.join(timeout=5.0)
        ti.destroy()
        assert a.reports == []    # predecessor was stopped, not racing
        assert b.reports, "successor never saw the inherited stall"
        assert [x["name"] for x in b.reports[0]["blocked"]] \
            == ["handover.consumer_wait"]

    def test_one_report_per_stall(self, tmp_path):
        release = threading.Event()

        def blocked_next():
            release.wait(30.0)
            return None

        ti = ThreadedIter(max_capacity=2)
        ti.init(blocked_next)
        wd = Watchdog(threshold_s=0.1, interval_s=0.03)
        consumer = threading.Thread(target=ti.next, daemon=True)
        with wd:
            consumer.start()
            deadline = time.time() + 5.0
            while not wd.reports and time.time() < deadline:
                time.sleep(0.02)
            time.sleep(0.3)  # several more polls over the SAME stall
            n = len(wd.reports)
        release.set()
        consumer.join(timeout=5.0)
        ti.destroy()
        assert n == 1

    def test_producer_wait_registers_while_full(self):
        """A producer blocked on a full queue is a watched wait too."""
        ti = ThreadedIter(max_capacity=1, name="full.stage")
        src = iter(range(100))
        try:
            # waits register only while a watchdog is installed: start
            # it before the producer can fill the queue and block
            with Watchdog(threshold_s=0.1, interval_s=0.03) as wd:
                ti.init(lambda: next(src, None))
                deadline = time.time() + 5.0
                while not wd.reports and time.time() < deadline:
                    time.sleep(0.02)
        finally:
            ti.destroy()
        assert [b["name"] for b in wd.reports[0]["blocked"]] \
            == ["full.stage.producer_wait"]
        assert wd.reports[0]["blocked"][0]["detail"]["qsize"] == 1


class TestFlightRecorder:
    def test_fallback_ring_interplay(self):
        ring = obs_trace.TraceRecorder(100)
        obs_trace.set_fallback(ring)
        assert obs_trace.active() is ring
        obs_trace.instant("background-event")
        assert ring.recorded == 1
        rec = obs_trace.start()
        assert obs_trace.active() is rec
        obs_trace.instant("foreground-event")
        assert ring.recorded == 1  # explicit trace owns the window
        assert obs_trace.stop() is rec
        assert obs_trace.active() is ring
        assert obs_trace.stop() is None  # fallback not removable here
        assert obs_trace.active() is ring
        assert obs_trace.clear_fallback() is ring
        assert obs_trace.active() is None

    def test_install_dump_uninstall(self, tmp_path):
        fl = obs_flight.FlightRecorder(
            out_dir=str(tmp_path / "flight"),
            metrics_interval_s=0.05).install()
        try:
            with obs_trace.span("flight-covered-work"):
                pass
            REGISTRY.counter("flight.test_events").inc(3)
            time.sleep(0.15)  # let the sampler take a history snapshot
            d = fl.dump("unit_test")
            assert os.path.isdir(d)
            manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
            assert manifest["kind"] == "dmlc_tpu_flight_bundle"
            assert manifest["reason"] == "unit_test"
            doc = json.load(open(os.path.join(d, "trace.json")))
            _assert_chrome_golden(doc)
            assert any(e.get("name") == "flight-covered-work"
                       for e in doc["traceEvents"])
            metrics = json.load(open(os.path.join(d, "metrics.json")))
            assert metrics["current"]["counters"][
                "flight.test_events"] == 3
            # the recorder's own time-series ring: the periodic history
            # and the ring's full dump beside it
            assert len(metrics["history"]) >= 1
            assert metrics["interval_s"] == 0.05
            hist = json.load(open(os.path.join(d, "history.json")))
            assert hist["period_s"] == 0.05 and hist["samples"]
            # faulthandler names the dumping thread "Current thread"
            # (others "Thread"): the one line every dump has
            stacks = open(os.path.join(d, "stacks.txt")).read()
            assert "Current thread" in stacks
            env = json.load(open(os.path.join(d, "env.json")))
            assert env["argv"]
        finally:
            fl.uninstall()
        assert obs_trace.active() is None

    def test_stacks_keep_the_dumping_thread_past_100_threads(self,
                                                             tmp_path):
        """faulthandler writes at most 100 threads, newest first: with
        more alive (threads other tests of the same process left), the
        dumping thread fell off ``stacks.txt`` and the test above failed
        in a full run. The dump now appends it."""
        release = threading.Event()
        extra = [threading.Thread(target=release.wait, daemon=True)
                 for _ in range(110)]
        for t in extra:
            t.start()
        fl = obs_flight.FlightRecorder(
            out_dir=str(tmp_path / "flight")).install()
        try:
            d = fl.dump("many_threads")
            stacks = open(os.path.join(d, "stacks.txt")).read()
            assert "Current thread" in stacks
            assert "test_stacks_keep_the_dumping_thread" in stacks
        finally:
            fl.uninstall()
            release.set()
            for t in extra:
                t.join(timeout=5)

    def test_clean_uninstall_leaves_no_bundle(self, tmp_path):
        out = str(tmp_path / "flight")
        fl = obs_flight.FlightRecorder(out_dir=out).install()
        fl.uninstall()
        assert glob.glob(os.path.join(out, "flight-*")) == []

    def test_dump_makes_no_cuda_call(self, tmp_path, monkeypatch):
        """An injected crash dumps in a process that may hold a CUDA
        context: every section must come from host state alone."""
        def refuse(*a, **k):
            raise AssertionError("flight dump called into CUDA")

        for name in ("synchronize", "is_available", "device_count",
                     "current_device", "memory_allocated",
                     "get_device_name", "mem_get_info"):
            monkeypatch.setattr(torch.cuda, name, refuse)
        from dmlc_tpu_torch.resilience import inject
        inject.install("site=x,fault=ioerror,nth=9")
        fl = obs_flight.FlightRecorder(out_dir=str(tmp_path / "f")).install()
        try:
            d = fl.dump("no_cuda")
            manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
            assert all(v == "ok" for v in manifest["files"].values()), \
                manifest["files"]
            faults = json.load(open(os.path.join(d, "faults.json")))
            assert faults["plan"] == "site=x,fault=ioerror,nth=9"
        finally:
            fl.uninstall()
            inject.uninstall()

    def test_worker_crash_leaves_loadable_bundle(self, tmp_path):
        """A provoked launch_local worker crash leaves a bundle whose
        trace file passes the Perfetto golden-key check."""
        from dmlc_tpu_torch.parallel.launch import launch_local
        from dmlc_tpu_torch.utils.logging import DMLCError
        out = str(tmp_path / "flight")
        script = tmp_path / "crash.py"
        script.write_text(
            "from dmlc_tpu_torch.obs.flight import install_if_env\n"
            "fl = install_if_env()\n"
            "assert fl is not None\n"
            "from dmlc_tpu_torch.obs.metrics import REGISTRY\n"
            "from dmlc_tpu_torch.obs.trace import span\n"
            "REGISTRY.counter('doomed.rows').inc(42)\n"
            "with span('doomed-work'):\n"
            "    pass\n"
            "raise RuntimeError('deliberate flight-recorder crash')\n"
        )
        env = {"PYTHONPATH": os.pathsep.join(
            [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
        with pytest.raises(DMLCError):
            launch_local(1, [sys.executable, str(script)], env=env,
                         flight_dir=out, timeout=120)
        bundles = glob.glob(os.path.join(out, "flight-*"))
        assert len(bundles) == 1, bundles
        d = bundles[0]
        manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
        assert manifest["reason"] == "uncaught_exception"
        doc = json.load(open(os.path.join(d, "trace.json")))
        _assert_chrome_golden(doc)
        assert any(e.get("name") == "doomed-work"
                   for e in doc["traceEvents"])
        metrics = json.load(open(os.path.join(d, "metrics.json")))
        assert metrics["current"]["counters"]["doomed.rows"] == 42
        error = open(os.path.join(d, "error.txt")).read()
        assert "deliberate flight-recorder crash" in error
        assert "Current thread" in open(os.path.join(d,
                                                     "stacks.txt")).read()

    def test_injected_crash_leaves_faults_bundle(self, tmp_path):
        """A crash fault dumps the installed recorder's bundle before
        its hard exit, naming the armed plan and the fault."""
        from dmlc_tpu_torch.parallel.launch import launch_local
        from dmlc_tpu_torch.resilience import CRASH_EXIT
        from dmlc_tpu_torch.utils.logging import DMLCError
        out = str(tmp_path / "flight")
        script = tmp_path / "crash.py"
        script.write_text(
            "from dmlc_tpu_torch.obs.flight import install_if_env\n"
            "from dmlc_tpu_torch.resilience import inject\n"
            "install_if_env()\n"
            "inject.install_if_env()\n"
            "inject.fire('work.step')\n")
        env = {"PYTHONPATH": REPO}
        with pytest.raises(DMLCError, match=f"\\[{CRASH_EXIT}\\]"):
            launch_local(1, [sys.executable, str(script)], env=env,
                         faults="site=work.step,fault=crash",
                         flight_dir=out, timeout=120)
        (d,) = glob.glob(os.path.join(out, "flight-*"))
        manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
        assert manifest["reason"] == "injected_crash"
        faults = json.load(open(os.path.join(d, "faults.json")))
        assert faults["plan"] == "site=work.step,fault=crash"
        assert faults["injected"] == 1
        assert faults["events"][0]["site"] == "work.step"

    def test_watchdog_escalation_dumps_bundle(self, tmp_path):
        fl = obs_flight.FlightRecorder(
            out_dir=str(tmp_path / "flight")).install()
        release = threading.Event()
        ti = ThreadedIter(max_capacity=2, name="flight.stalled")
        ti.init(lambda: (release.wait(30.0), None)[1])
        consumer = threading.Thread(target=ti.next, daemon=True)
        try:
            with Watchdog(threshold_s=0.15, interval_s=0.05) as wd:
                consumer.start()
                deadline = time.time() + 5.0
                while not wd.reports and time.time() < deadline:
                    time.sleep(0.02)
            assert fl.dumped, "escalation never dumped"
            wdj = json.load(open(os.path.join(
                fl.bundle_dir, "watchdog.json")))
            blocked = wdj["escalating_report"]["blocked"]
            assert any("flight.stalled" in b["name"] for b in blocked)
            manifest = json.load(open(os.path.join(
                fl.bundle_dir, "MANIFEST.json")))
            assert manifest["reason"] == "watchdog_stall"
        finally:
            release.set()
            consumer.join(timeout=5.0)
            ti.destroy()
            fl.uninstall()


class TestWatchdogReportRetention:
    def test_timestamped_history_bounded(self, tmp_path):
        report_path = str(tmp_path / "stall.json")
        wd = Watchdog(threshold_s=0.02, interval_s=999,
                      report_path=report_path, keep_reports=2).start()
        try:
            for i in range(4):
                token = obs_watchdog.begin_wait(f"soak.{i}")
                time.sleep(0.03)
                report = wd.check()
                assert report is not None, f"stall {i} unreported"
                obs_watchdog.end_wait(token)
                time.sleep(0.002)  # distinct ms timestamps
        finally:
            wd.stop()
        assert os.path.exists(report_path)
        latest = json.load(open(report_path))
        assert latest["blocked"][0]["name"] == "soak.3"
        history = sorted(glob.glob(str(tmp_path / "stall.*.json")))
        assert len(history) == 2, history  # keep_reports=2 pruned 4->2
        names = [json.load(open(p))["blocked"][0]["name"]
                 for p in history]
        assert names == ["soak.2", "soak.3"]  # the LAST two survive


class TestWatchdogHistory:
    def test_stall_report_attaches_decay(self, monkeypatch):
        """With the shared time-series ring installed, a stall report
        carries its trailing samples and a fresh one: the decay INTO the
        stall, not just the frozen end state."""
        from dmlc_tpu_torch.obs import timeseries as obs_ts
        before = REGISTRY.counter("decay.rows").value
        ring = obs_ts.TimeSeriesRing(period_s=60)
        monkeypatch.setattr(obs_ts, "_ring", ring)  # installed, driven
        REGISTRY.counter("decay.rows").inc(100)
        ring.sample_now(t=time.time() - 10.0)
        REGISTRY.counter("decay.rows").inc(5)  # the rate died
        wd = Watchdog(threshold_s=0.02, interval_s=999,
                      history_s=60.0).start()
        try:
            token = obs_watchdog.begin_wait("pull/dying.demo")
            time.sleep(0.03)
            report = wd.check()
            obs_watchdog.end_wait(token)
        finally:
            wd.stop()
        assert report is not None
        assert report["history_s"] == 60.0
        hist = report["history"]
        assert len(hist) >= 2  # the old sample + the forced fresh one
        assert hist[0]["v"]["counters.decay.rows"] == before + 100
        assert hist[-1]["v"]["counters.decay.rows"] == before + 105

    def test_report_without_ring_has_empty_history(self):
        wd = Watchdog(threshold_s=0.02, interval_s=999).start()
        try:
            token = obs_watchdog.begin_wait("pull/lonely.demo")
            time.sleep(0.03)
            report = wd.check()
            obs_watchdog.end_wait(token)
        finally:
            wd.stop()
        assert report is not None and report["history"] == []
