"""The analytic obs planes wired together in the port: the status server,
the flight recorder, the watchdog and ``launch_local``'s env contracts.

Twins of ``tests/test_obs_history.py::TestGangServeLive`` (a real
two-process ``launch_local`` gang under ``history_s`` and
``gang_poll_s`` serves ``/history`` on both ranks and, on rank 0,
``/gang``'s aggregator view; when rank 1 vanishes the view keeps serving
with an explicit gap), of ``tests/test_rpc.py::TestRpcEndpoint::
test_gang_view_carries_rpc`` (the aggregator's rank rows carry each
rank's RPC edge totals), and of the reference's flight-bundle sections:
a bundle of a process with an RPC edge has the reference's ``rpc.json``
(the edge table as ``obs.rpc.view()`` gives it), one with a profiler
``profile.txt`` (its collapsed stacks), and a stall report carries the
profiler's collapsed stacks. Every plane a test installs is uninstalled
after it.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from dmlc_tpu.obs import flight as ref_flight
from dmlc_tpu.obs import rpc as ref_rpc
from dmlc_tpu_torch.obs import aggregate as obs_agg
from dmlc_tpu_torch.obs import flight as obs_flight
from dmlc_tpu_torch.obs import profile as obs_prof
from dmlc_tpu_torch.obs import rpc
from dmlc_tpu_torch.obs import timeseries as obs_ts
from dmlc_tpu_torch.obs import watchdog as obs_watchdog
from dmlc_tpu_torch.obs.serve import StatusServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _planes_clean():
    for m in (obs_flight, obs_prof, obs_ts, obs_agg, ref_flight):
        m.uninstall()
    rpc.EDGES.reset()
    ref_rpc.EDGES.reset()
    yield
    for m in (obs_flight, obs_prof, obs_ts, obs_agg, ref_flight):
        m.uninstall()
    rpc.EDGES.reset()
    ref_rpc.EDGES.reset()


def _get(url, timeout_s=5.0):
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def test_gang_view_carries_rpc():
    rpc.EDGES.observe("peer:1", "get", 123.0, 45.0)
    srv = StatusServer(port=0)
    try:
        agg = obs_agg.GangAggregator(ports=[srv.port])
        agg.poll_once()
        view = agg.view()
    finally:
        srv.close()
    (rank,) = view["ranks"].values()
    assert rank["rpc"]["count"] >= 1


def _bundle(mod, tmp_path, name):
    fl = mod.FlightRecorder(out_dir=str(tmp_path / name)).install()
    try:
        return fl.dump("unit_test")
    finally:
        fl.uninstall()


@pytest.mark.parametrize("edges", [
    [("peer:1", "get", 123.0, 45.0)],
    [("127.0.0.1:9100", "GET /pages", 900.0, 300.0),
     ("127.0.0.1:9100", "GET /pages", 700.0, None),
     ("obj://b", "get", 2100.0, 2000.0)]])
def test_flight_bundle_writes_the_references_rpc_json(tmp_path, edges):
    """The same edges in both packages' tables give the same
    ``rpc.json`` in each package's bundle (the section the port's
    bundle used to drop)."""
    for table in (rpc.EDGES, ref_rpc.EDGES):
        for peer, verb, client_us, server_us in edges:
            table.observe(peer, verb, client_us, server_us)
    got = json.load(open(os.path.join(_bundle(obs_flight, tmp_path, "p"),
                                      "rpc.json")))
    want = json.load(open(os.path.join(_bundle(ref_flight, tmp_path, "r"),
                                       "rpc.json")))
    assert got == want == rpc.view()
    assert sum(e["count"] for e in got["edges"]) == len(edges)
    manifest = json.load(open(os.path.join(
        _bundle(obs_flight, tmp_path, "m"), "MANIFEST.json")))
    assert manifest["files"]["rpc.json"] == "ok"


def test_flight_bundle_without_edges_has_no_rpc_json(tmp_path):
    d = _bundle(obs_flight, tmp_path, "p")
    assert not os.path.exists(os.path.join(d, "rpc.json"))
    assert not os.path.exists(os.path.join(d, "profile.txt"))
    assert not os.path.exists(os.path.join(d, "control.json"))


def _spin(seconds):
    x = 0
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        x += sum(i * i for i in range(500))
    return x


def test_flight_bundle_and_stall_report_carry_the_profile(tmp_path):
    obs_prof.install(hz=200)
    t = threading.Thread(target=_spin, args=(0.2,), name="bundle-spin")
    t.start()
    t.join()
    d = _bundle(obs_flight, tmp_path, "p")
    lines = open(os.path.join(d, "profile.txt")).read().splitlines()
    assert any(ln.startswith("bundle-spin;") for ln in lines)
    wd = obs_watchdog.Watchdog(threshold_s=0.02, interval_s=999).start()
    try:
        token = obs_watchdog.begin_wait("pull/profiled.demo")
        time.sleep(0.03)
        report = wd.check()
        obs_watchdog.end_wait(token)
    finally:
        wd.stop()
    assert report["profile"] and all(" " in ln for ln in report["profile"])


def test_launch_local_gang_serves_history_and_gang_with_a_gap(tmp_path):
    from dmlc_tpu_torch.parallel.launch import find_free_ports, launch_local
    script = tmp_path / "gang_worker.py"
    stop_file, die_file = tmp_path / "stop", tmp_path / "die"
    script.write_text(
        "import os, sys, time\n"
        "from dmlc_tpu_torch.obs.serve import serve_if_env\n"
        "from dmlc_tpu_torch.obs.timeseries import install_if_env as h\n"
        "from dmlc_tpu_torch.obs.aggregate import install_if_env as g\n"
        "from dmlc_tpu_torch.obs.metrics import REGISTRY\n"
        "srv = serve_if_env()\n"
        "assert srv is not None, 'serve port env missing'\n"
        "assert h() is not None, 'history env missing'\n"
        "rank = int(os.environ['DMLC_TPU_TASK_ID'])\n"
        "agg = g()\n"
        "assert (agg is not None) == (rank == 0), (rank, agg)\n"
        "REGISTRY.counter('gang.rows').inc(100 * (rank + 1))\n"
        "deadline = time.time() + 60\n"
        "while time.time() < deadline:\n"
        "    REGISTRY.counter('gang.ticks').inc()\n"
        "    if rank == 1 and os.path.exists(sys.argv[2]):\n"
        "        os._exit(0)\n"
        "    if rank == 0 and os.path.exists(sys.argv[1]):\n"
        "        break\n"
        "    time.sleep(0.05)\n")
    ports = find_free_ports(2)
    result = {}

    def gang():
        try:
            result["codes"] = launch_local(
                2, [sys.executable, str(script), str(stop_file),
                    str(die_file)],
                env={"PYTHONPATH": REPO}, serve_ports=ports,
                history_s=0.1, gang_poll_s=0.1, timeout=90)
        except Exception as e:  # noqa: BLE001 — asserted below
            result["error"] = e

    t = threading.Thread(target=gang, daemon=True)
    t.start()
    try:
        view = None
        deadline = time.time() + 45.0
        while time.time() < deadline:
            try:
                view = _get(f"http://127.0.0.1:{ports[0]}/gang", 2.0)
            except (OSError, urllib.error.URLError, ValueError):
                time.sleep(0.05)
                continue
            ranks = view.get("ranks") or {}
            if set(ranks) == {"rank0", "rank1"} and all(
                    r["series"]["samples"] for r in ranks.values()):
                break
            time.sleep(0.05)
        assert view is not None and set(view["ranks"]) == \
            {"rank0", "rank1"}, f"gang never aggregated: {result}"
        r1 = view["ranks"]["rank1"]
        assert r1["unreachable"] is False
        assert r1["series"]["samples"][-1]["v"]["counters.gang.rows"] == 200
        for port in ports:
            assert _get(f"http://127.0.0.1:{port}/history")["samples"]
        die_file.write_text("die")
        dead = None
        deadline = time.time() + 45.0
        while time.time() < deadline:
            try:
                view = _get(f"http://127.0.0.1:{ports[0]}/gang", 2.0)
            except (OSError, urllib.error.URLError, ValueError):
                time.sleep(0.05)
                continue
            dead = view["ranks"]["rank1"]
            if dead["unreachable"] and dead["gaps"]:
                break
            time.sleep(0.05)
        assert dead is not None and dead["unreachable"] is True
        assert dead["gaps"][0]["error"] and dead["polls_failed"] >= 1
        assert view["ranks"]["rank0"]["unreachable"] is False
        roll = view["rollup"]["samples"][-1]["v"]
        assert (roll["gang.reachable"], roll["gang.expected"]) == (1.0, 2.0)
    finally:
        stop_file.write_text("stop")
        t.join(timeout=45.0)
    assert "error" not in result, result
    assert result["codes"] == [0, 0]
