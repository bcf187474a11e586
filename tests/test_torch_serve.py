"""The port's live status server (``dmlc_tpu_torch/obs/serve.py``) held
to the reference's ``tests/test_obs_live.py`` (``TestPrometheusExposition``,
``TestStatusServer``, ``TestGangServe``) and ``tests/test_rpc.py``
(``TestRpcEndpoint``; ``test_gang_view_carries_rpc``'s twin is in
``tests/test_torch_obs_planes.py`` with the gang aggregator).

Beside the twins: ``render_prometheus`` of one seeded snapshot gives the
same text in both packages; the analytic planes' endpoints answer the
reference's 404 body while their plane is absent; ``/gang`` serves the
rendezvous membership section. Every wait is bounded.
"""

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dmlc_tpu_torch.obs import flight as obs_flight
from dmlc_tpu_torch.obs import log as obs_log
from dmlc_tpu_torch.obs import rpc
from dmlc_tpu_torch.obs import trace as obs_trace
from dmlc_tpu_torch.obs import watchdog as obs_watchdog
from dmlc_tpu_torch.obs.export import chrome_events
from dmlc_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from dmlc_tpu_torch.obs.serve import (
    StatusServer, render_prometheus, scrape, scrape_gang,
)
from dmlc_tpu_torch.obs.watchdog import Watchdog

CHROME_REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_clean():
    """Tracing off, no flight recorder, an empty RPC edge table and
    fresh log state per test."""
    obs_flight.uninstall()
    obs_trace.stop()
    obs_trace.clear_fallback()
    obs_log.reset()
    rpc.EDGES.reset()
    yield
    obs_flight.uninstall()
    obs_trace.stop()
    obs_trace.clear_fallback()
    obs_log.reset()
    rpc.EDGES.reset()


def _write_libsvm(tmp_path, rows=600, name="live.libsvm"):
    lines = [f"{i % 2} 1:0.5 7:1.25 9:{i}.0" for i in range(rows)]
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _get(url: str, timeout_s: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.status, resp.read()


def _assert_chrome_golden(doc):
    assert "traceEvents" in doc and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        for key in CHROME_REQUIRED_KEYS:
            assert key in ev, (key, ev)
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            assert "dur" in ev, ev


def _settle(rec, pred, timeout_s=5.0):
    """Server spans land from the HANDLER thread after the response is
    on the wire — poll the live recorder until the pair shows up."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        evs = chrome_events(rec)
        if pred(evs):
            return evs
        time.sleep(0.01)
    return chrome_events(rec)


class TestPrometheusExposition:
    def _registry(self, cls=MetricsRegistry):
        reg = cls()
        reg.counter("rows.parsed").inc(5)
        reg.gauge("queue.depth").set(3)
        reg.gauge("replay.tier").set("pages")
        reg.gauge("never.set")  # value None: silently absent
        # a structured gauge value has no single exposition line ->
        # skipped + counted
        reg.gauge("weird.object").set({"structured": 1})
        reg.histogram("wait.s").observe(0.25)
        reg.histogram("wait.s").observe(0.5)
        return reg

    def test_golden_families(self):
        """Golden: family names, TYPE lines, HELP lines, and value
        lines of the exposition are pinned."""
        reg = self._registry()

        class Surface:
            def stats(self):
                return {"qsize": 2, "note": "text", "nested": {"n": 7}}

        s = Surface()
        reg.register("queue/demo", s, Surface.stats)
        text = render_prometheus(reg.snapshot(), reg)
        assert text.endswith("\n")
        assert "# TYPE dmlc_obs_info gauge" in text
        assert 'dmlc_obs_info{rank="None"' in text
        assert "# HELP dmlc_rows_parsed_total Counter rows.parsed" in text
        assert "# TYPE dmlc_rows_parsed_total counter" in text
        assert "\ndmlc_rows_parsed_total 5\n" in text
        assert "# TYPE dmlc_queue_depth gauge" in text
        assert "\ndmlc_queue_depth 3\n" in text
        assert 'dmlc_replay_tier_info{value="pages"} 1' in text
        assert "dmlc_replay_tier pages" not in text
        assert "dmlc_weird_object" not in text
        assert "# TYPE dmlc_obs_export_skipped_total counter" in text
        assert "\ndmlc_obs_export_skipped_total 1\n" in text
        assert "# TYPE dmlc_wait_s histogram" in text
        assert 'dmlc_wait_s_bucket{le="+Inf"} 2' in text
        assert "\ndmlc_wait_s_count 2\n" in text
        assert "\ndmlc_wait_s_sum 0.75\n" in text
        assert "# TYPE dmlc_wait_s_p50 gauge" in text
        assert "# TYPE dmlc_wait_s_p99 gauge" in text
        assert "\ndmlc_wait_s_p50 " in text
        assert "\ndmlc_wait_s_p99 0.5\n" in text  # clamped to max
        assert ('dmlc_collector_value{collector="queue/demo",'
                'key="qsize"} 2') in text
        assert ('dmlc_collector_value{collector="queue/demo",'
                'key="nested.n"} 7') in text
        assert "note" not in text

    def test_every_line_is_valid_exposition(self):
        reg = self._registry()
        text = render_prometheus(reg.snapshot(), reg)
        line_re = re.compile(
            r"^[a-z_][a-z0-9_]*(\{[^{}]*\})? -?[0-9.eE+-]+$")
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            assert line_re.match(line), line

    def test_skipped_counter_accumulates(self):
        reg = self._registry()
        render_prometheus(reg.snapshot(), reg)
        text = render_prometheus(reg.snapshot(), reg)
        assert "\ndmlc_obs_export_skipped_total 2\n" in text
        assert text.count("# TYPE dmlc_obs_export_skipped_total") == 1
        assert text.count("dmlc_obs_export_skipped_total 2") == 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_text_as_the_reference(self, seed):
        """One seeded snapshot dict (counters, numeric, string, None and
        structured gauges, histograms with buckets and quantiles, nested
        collectors with lists, bools and strings) renders to the same
        exposition text in both packages, skip counters included."""
        from dmlc_tpu.obs.metrics import MetricsRegistry as RefRegistry
        from dmlc_tpu.obs.serve import render_prometheus as ref_render
        rng = np.random.default_rng(seed)
        snap = {
            "schema": 1, "rank": int(rng.integers(0, 4)), "pid": 4242,
            "counters": {f"c.{i}/x-{j}": int(rng.integers(0, 1 << 40))
                         for i in range(4) for j in range(2)},
            "gauges": {"g.float": float(rng.random()),
                       "g.int": int(rng.integers(-5, 5)),
                       "g.bool": bool(rng.integers(0, 2)),
                       "g.tier": "pages\n\"quoted\"\\",
                       "g.none": None, "g.obj": {"a": 1},
                       "g.list": [1, 2]},
            "histograms": {"h.wait_s": {
                "count": 5, "sum": float(rng.random() * 3),
                "buckets": {repr(2.0 ** -k): int(rng.integers(0, 3))
                            for k in range(1, 5)},
                "p50": 0.125, "p99": float(rng.random())}},
            "collectors": {"pipe/x": {"n": 3, "s": "text", "ok": True,
                                      "nested": {"v": [1.5, "a", 2]}},
                           "rpc": {"edges": [{"count": 7}]}},
        }
        port_reg, ref_reg = MetricsRegistry(), RefRegistry()
        for _ in range(2):
            assert render_prometheus(snap, port_reg) == \
                ref_render(snap, ref_reg)
        assert port_reg.counter("obs.export_skipped").value == \
            ref_reg.counter("obs.export_skipped").value == 4


class TestStatusServer:
    def test_endpoints(self):
        reg = MetricsRegistry()
        reg.counter("srv.hits").inc(7)
        reg.gauge("srv.tier").set("memory")
        with StatusServer(registry=reg) as srv:
            status, body = _get(srv.url("/metrics"))
            assert status == 200
            assert b"dmlc_srv_hits_total 7" in body
            assert b'dmlc_srv_tier_info{value="memory"} 1' in body
            status, body = _get(srv.url("/metrics.json"))
            snap = json.loads(body)
            assert snap["schema"] == 1
            assert snap["counters"]["srv.hits"] == 7
            status, body = _get(srv.url("/healthz"))
            health = json.loads(body)
            assert health["ok"] is True
            assert health["pid"] == os.getpid()
            assert health["watchdog"]["installed"] is False
            assert health["waits"] == []
            status, body = _get(srv.url("/stacks"))
            assert status == 200 and b"Thread" in body
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url("/nope"))
            assert e.value.code == 404

    def test_healthz_reports_blocked_waits(self):
        """The liveness endpoint names the pull that is wedged RIGHT
        NOW."""
        with StatusServer() as srv:
            wd = Watchdog(threshold_s=60, interval_s=10).start()
            try:
                token = obs_watchdog.begin_wait("pull/wedged.demo")
                time.sleep(0.02)
                health = json.loads(_get(srv.url("/healthz"))[1])
                names = [w["name"] for w in health["waits"]]
                assert "pull/wedged.demo" in names
                assert health["watchdog"]["installed"] is True
                obs_watchdog.end_wait(token)
                health = json.loads(_get(srv.url("/healthz"))[1])
                assert health["waits"] == []
            finally:
                wd.stop()

    def test_scrape_under_load(self, tmp_path):
        """The server answers /metrics while a real pipeline loop runs
        in this process (the bench-loop shape)."""
        from dmlc_tpu_torch.pipeline import Pipeline
        uri = _write_libsvm(tmp_path, rows=3000)
        built = (Pipeline.from_uri(uri)
                 .parse(format="libsvm", engine="python",
                        chunk_size=2048)
                 .batch(128)
                 .build())
        stop = threading.Event()
        errors = []

        def pump():
            try:
                while not stop.is_set():
                    for _ in built:
                        pass
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        t = threading.Thread(target=pump, daemon=True)
        with StatusServer() as srv:
            t.start()
            try:
                ok = 0
                deadline = time.time() + 10.0
                while ok < 20 and time.time() < deadline:
                    status, body = _get(srv.url("/metrics"))
                    assert status == 200
                    assert body.startswith(b"# HELP dmlc_obs_info")
                    snap = json.loads(_get(srv.url("/metrics.json"))[1])
                    assert snap["schema"] == 1
                    ok += 1
                assert ok >= 20
            finally:
                stop.set()
                t.join(timeout=10.0)
        assert any(k.startswith("pipeline")
                   for k in REGISTRY.snapshot()["collectors"])
        built.close()
        assert errors == []

    def test_trace_capture_of_running_recorder(self):
        rec = obs_trace.start()
        with obs_trace.span("live-work"):
            pass
        try:
            with StatusServer() as srv:
                doc = json.loads(_get(srv.url("/trace?seconds=0"))[1])
                _assert_chrome_golden(doc)
                assert any(e.get("name") == "live-work"
                           for e in doc["traceEvents"])
            assert obs_trace.active() is rec
        finally:
            obs_trace.stop()

    def test_trace_capture_installs_when_off(self):
        assert obs_trace.active() is None
        with StatusServer() as srv:
            doc = json.loads(_get(srv.url("/trace?seconds=0.05"))[1])
            assert "traceEvents" in doc
            assert doc["otherData"]["capture_s"] == 0.05
        assert obs_trace.active() is None

    @pytest.mark.parametrize("path", ["/analyze", "/control", "/history",
                                      "/profile", "/slo", "/tenants"])
    def test_absent_planes_answer_the_reference_404(self, path):
        """An analytic plane's endpoint answers the reference's 404 body
        (its error and its enable hint) while the plane is not installed
        in this process: never a 500, never a fallback body."""
        from dmlc_tpu.obs.serve import StatusServer as RefStatusServer
        docs = []
        for cls in (StatusServer, RefStatusServer):
            with cls() as srv:
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.url(path))
                assert e.value.code == 404
                docs.append(json.loads(e.value.read()))
        assert docs[0] == docs[1]
        assert "error" in docs[0]

    @pytest.mark.parametrize("live", [False, True])
    def test_shuffle_answers_its_view_or_the_reference_404(
            self, tmp_path, monkeypatch, live):
        """``/shuffle`` answers the live global shuffle's view with 200,
        and with none the reference's 404 ``{error, hint}``, the hint
        naming ``global_seed``, never a not-ported error."""
        from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR
        from dmlc_tpu_torch.shuffle import GlobalShuffleSplit
        from dmlc_tpu_torch.shuffle import exchange as exchange_mod
        monkeypatch.setenv(ENV_STORE_DIR, str(tmp_path / "store"))
        monkeypatch.setattr(exchange_mod, "_VIEW_REF", None)
        path = tmp_path / "t.txt"
        path.write_bytes(b"".join(b"row-%d\n" % i for i in range(50)))
        sp = (GlobalShuffleSplit(str(path), 0, 1, "text", seed=9,
                                 window_bytes=64) if live else None)
        with StatusServer() as srv:
            if live:
                assert sp.next_record() is not None
                status, body = _get(srv.url("/shuffle"))
                doc = json.loads(body)
                assert status == 200 and doc == sp.reader.view_dict()
                assert (doc["seed"], doc["delivered"], doc["records"]) \
                    == (9, 1, 50)
                return
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url("/shuffle"))
            assert e.value.code == 404
            doc = json.loads(e.value.read())
        assert set(doc) == {"error", "hint"}
        assert doc["error"] == "no global shuffle active"
        assert "global_seed" in doc["hint"]

    def test_serve_if_env_and_shutdown(self, monkeypatch):
        import importlib

        from dmlc_tpu_torch.parallel.launch import find_free_port
        # (the package exports a function of the module's name)
        serve_mod = importlib.import_module("dmlc_tpu_torch.obs.serve")
        monkeypatch.delenv("DMLC_TPU_SERVE_PORT", raising=False)
        assert serve_mod.serve_if_env() is None
        port = find_free_port()
        monkeypatch.setenv("DMLC_TPU_SERVE_PORT", str(port))
        try:
            srv = serve_mod.serve_if_env()
            assert srv is not None and srv.port == port
            assert serve_mod.serve() is srv  # one per process
            assert json.loads(_get(srv.url("/healthz"))[1])["ok"]
            assert REGISTRY.gauge("obs.serve_port").value == port
        finally:
            serve_mod.shutdown()
        with pytest.raises(urllib.error.URLError):
            _get(f"http://127.0.0.1:{port}/healthz", timeout_s=1.0)


class TestGangMembership:
    def test_gang_404_without_membership(self):
        with StatusServer() as srv:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url("/gang"))
            assert e.value.code == 404
            doc = json.loads(e.value.read())
        assert "rendezvous" in doc["hint"]

    def test_gang_serves_membership_section(self):
        """With a rendezvous client installed, /gang carries its view as
        the ``membership`` section (the aggregator view is not
        ported)."""
        from dmlc_tpu_torch import rendezvous as rndv
        with rndv.RendezvousService() as svc:
            cli = rndv.RendezvousClient(svc.host, svc.port, gang="g",
                                        member="worker-0")
            cli.join()
            rndv.install(cli)
            try:
                with StatusServer() as srv:
                    doc = json.loads(_get(srv.url("/gang"))[1])
            finally:
                rndv.uninstall()
        assert doc["schema"] == 0
        assert doc["membership"] == cli.view()
        assert doc["membership"]["world"] == 1
        assert doc["membership"]["rank"] == 0


class TestRpcEndpoint:
    def test_get_rpc_serves_edge_table(self):
        rpc.EDGES.observe("peer:1", "get", 123.0, 45.0)
        with StatusServer(port=0) as srv:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/rpc") as resp:
                doc = json.load(resp)
        assert doc["schema"] == rpc.RPC_SCHEMA
        (edge,) = doc["edges"]
        assert (edge["peer"], edge["verb"]) == ("peer:1", "get")

    def test_scrape_is_a_traced_edge(self):
        """Every scrape poll is its own traced operation — a
        flow-linked client/server pair with queue/handle/write phases on
        the server side."""
        srv = StatusServer(port=0)
        rec = obs_trace.start()
        try:
            snap = scrape(srv.port)
            evs = _settle(rec, lambda es: [
                e for e in es if e.get("cat") == obs_trace.CAT_RPC_SERVER])
        finally:
            obs_trace.stop()
            srv.close()
        assert "counters" in snap
        (cl,) = [e for e in evs if e.get("cat") == obs_trace.CAT_RPC_CLIENT
                 and e["args"]["verb"] == "scrape"]
        sv = [e for e in evs if e.get("cat") == obs_trace.CAT_RPC_SERVER
              and e["args"][rpc.TRACE_FIELD] == cl["args"][rpc.TRACE_FIELD]]
        assert len(sv) == 1
        for phase in ("queue_us", "handle_us", "write_us"):
            assert phase in sv[0]["args"], phase
        assert cl["args"]["server_us"] == pytest.approx(
            sv[0]["args"]["handle_us"], abs=0.11)


class TestGangServe:
    """Acceptance: a REAL 2-process launch_local gang serves scrapeable
    per-rank /metrics and /healthz DURING the run."""

    def test_two_process_gang_scraped_live(self, tmp_path):
        from dmlc_tpu_torch.parallel.launch import (
            find_free_ports, launch_local,
        )
        script = tmp_path / "serve_worker.py"
        stop_file = tmp_path / "stop"
        script.write_text(
            "import os, sys, time\n"
            "from dmlc_tpu_torch.obs.serve import serve_if_env\n"
            "from dmlc_tpu_torch.obs.metrics import REGISTRY\n"
            "srv = serve_if_env()\n"
            "assert srv is not None, 'serve port env missing'\n"
            "rank = int(os.environ['DMLC_TPU_TASK_ID'])\n"
            "REGISTRY.counter('gang.rows').inc(100 * (rank + 1))\n"
            "REGISTRY.gauge('gang.tier').set('pages')\n"
            "deadline = time.time() + 60\n"
            "while not os.path.exists(sys.argv[1]) "
            "and time.time() < deadline:\n"
            "    time.sleep(0.05)\n"
        )
        ports = find_free_ports(2)
        env = {"PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])}
        result = {}

        def gang():
            try:
                result["codes"] = launch_local(
                    2, [sys.executable, str(script), str(stop_file)],
                    env=env, serve_ports=ports, timeout=90)
            except Exception as e:  # noqa: BLE001
                result["error"] = e

        t = threading.Thread(target=gang, daemon=True)
        t.start()
        try:
            deadline = time.time() + 60.0
            healthy = {}
            while len(healthy) < 2 and time.time() < deadline:
                for rank, port in enumerate(ports):
                    if rank in healthy:
                        continue
                    try:
                        h = scrape(port, path="/healthz", timeout_s=2.0)
                        assert h["ok"] is True
                        assert h["rank"] == rank
                        healthy[rank] = h
                    except (OSError, urllib.error.URLError):
                        time.sleep(0.05)
            assert len(healthy) == 2, f"gang never served: {result}"
            status, body = _get(f"http://127.0.0.1:{ports[0]}/metrics")
            assert status == 200 and b"dmlc_gang_rows_total 100" in body
            status, body = _get(f"http://127.0.0.1:{ports[1]}/metrics")
            assert status == 200 and b"dmlc_gang_rows_total 200" in body
            merged = scrape_gang(ports)
            assert set(merged["workers"]) == {"rank0", "rank1"}
            assert merged["workers"]["rank1"]["counters"]["gang.rows"] \
                == 200
            assert "unreachable" not in merged
        finally:
            stop_file.write_text("stop")
            t.join(timeout=60.0)
        assert result.get("codes") == [0, 0], result

    def test_scrape_gang_names_an_unreachable_rank(self):
        from dmlc_tpu_torch.parallel.launch import find_free_port
        dead = find_free_port()
        with StatusServer() as srv:
            merged = scrape_gang([srv.port, dead], timeout_s=1.0)
        assert list(merged["unreachable"]) == [str(dead)]
