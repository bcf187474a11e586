"""The port's time-series ring (``dmlc_tpu_torch/obs/timeseries.py``) and
gang aggregator (``dmlc_tpu_torch/obs/aggregate.py``) against the
reference's.

Twins of ``tests/test_obs_history.py``'s ``TestTimeSeriesRing`` and
``TestGangAggregator``: the same registry gives the same numeric leaves;
the same appends give the same ring (its coarsening keeps the oldest and
newest samples under the byte budget, a forced sample bypasses the
stride); ``install_if_env`` honours ``DMLC_TPU_HISTORY_S``; ``/history``
serves the ring; the aggregator polls two status servers (a port's and
the reference's, each reading the other's ``/metrics.json``) into the
same per-rank series and rollups as the reference's aggregator, and an
unreachable rank gets an explicit gap, nothing invented. Every ring and
aggregator a test installs is uninstalled by the fixture.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from dmlc_tpu.obs import aggregate as ref_agg
from dmlc_tpu.obs import timeseries as ref_ts
from dmlc_tpu.obs.metrics import MetricsRegistry as RefRegistry
from dmlc_tpu.obs.serve import StatusServer as RefStatusServer
from dmlc_tpu_torch.obs import aggregate as obs_agg
from dmlc_tpu_torch.obs import timeseries as obs_ts
from dmlc_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from dmlc_tpu_torch.obs.serve import StatusServer


@pytest.fixture(autouse=True)
def _planes_clean():
    """No ring or aggregator of either package outlives a test."""
    for m in (obs_ts, obs_agg, ref_ts, ref_agg):
        m.uninstall()
    yield
    for m in (obs_ts, obs_agg, ref_ts, ref_agg):
        m.uninstall()


def _get(url):
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return json.loads(resp.read())


def _fill(reg):
    reg.counter("rows").inc(7)
    reg.gauge("depth").set(3)
    reg.gauge("tier").set("pages")  # a string: no timeline
    reg.histogram("wait_s").observe(0.25)
    reg.histogram("wait_s").observe(1.5)

    class Surface:
        def stats(self):
            return {"qsize": 2, "note": "text", "nested": {"n": 5},
                    "flag": True}

    s = Surface()
    reg.register("queue/demo", s, Surface.stats)
    return s


def test_constants_are_the_references():
    assert obs_ts.TIMESERIES_SCHEMA == ref_ts.TIMESERIES_SCHEMA
    assert obs_ts.ENV_HISTORY_S == ref_ts.ENV_HISTORY_S
    assert obs_ts.ENV_HISTORY_BYTES == ref_ts.ENV_HISTORY_BYTES
    assert obs_agg.GANG_SCHEMA == ref_agg.GANG_SCHEMA
    assert obs_agg.ENV_GANG_POLL_S == ref_agg.ENV_GANG_POLL_S


def test_numeric_leaves_match_reference():
    reg, ref = MetricsRegistry(), RefRegistry()
    keep = (_fill(reg), _fill(ref))
    snap = reg.snapshot()
    got = obs_ts.numeric_leaves(snap)
    assert got == ref_ts.numeric_leaves(ref.snapshot())
    # the same function of one snapshot
    assert got == ref_ts.numeric_leaves(json.loads(json.dumps(snap)))
    assert got["counters.rows"] == 7 and got["gauges.depth"] == 3
    assert "gauges.tier" not in got
    assert got["collectors.queue/demo.nested.n"] == 5
    assert "collectors.queue/demo.note" not in got
    del keep


def _appends(ring, n, force_every=0):
    for i in range(n):
        ring.append(float(i), {"counters.rows": i,
                               "gauges.queue.depth": i % 7,
                               "histograms.wait_s.sum": i * 0.1},
                    force=bool(force_every and i % force_every == 0))


@pytest.mark.parametrize("budget,n,force_every", [
    (4 << 10, 20000, 0), (16 << 10, 5000, 0), (2 << 10, 3000, 97),
    (1 << 20, 100, 0)])
def test_coarsening_matches_reference(budget, n, force_every):
    """The same appends give the same ring: the budget holds, the span
    anchor and the newest sample survive every coarsening pass."""
    ring = obs_ts.TimeSeriesRing(period_s=1.0, budget_bytes=budget)
    ref = ref_ts.TimeSeriesRing(period_s=1.0, budget_bytes=budget)
    _appends(ring, n, force_every)
    _appends(ref, n, force_every)
    got, want = ring.to_dict(), ref.to_dict()
    assert got == want
    assert ring.approx_bytes() <= ring.budget_bytes
    assert got["samples"][0]["t"] == 0.0
    assert got["samples"][-1]["t"] >= n - 1 - max(got["stride"], 1)
    ts = [s["t"] for s in got["samples"]]
    assert ts == sorted(ts)
    # the trailing window and last() read the same samples
    assert ring.to_dict(last_s=50.0) == ref.to_dict(last_s=50.0)
    assert ring.last(30.0) == ref.last(30.0)


def test_forced_sample_bypasses_the_stride():
    ring = obs_ts.TimeSeriesRing(period_s=1.0, budget_bytes=4 << 10)
    _appends(ring, 20000)
    assert ring.to_dict()["stride"] >= 2
    assert ring.append(99998.0, {"counters.rows": 1}, force=True)
    assert ring.append(99999.0, {"counters.rows": 2}, force=True)
    assert ring.to_dict()["samples"][-1]["t"] == 99999.0


def test_sampler_thread_collects():
    reg = MetricsRegistry()
    reg.counter("ticks").inc()
    ring = obs_ts.TimeSeriesRing(period_s=0.02, registry=reg)
    ring.start()
    try:
        deadline = time.time() + 5.0
        while len(ring.samples()) < 3 and time.time() < deadline:
            reg.counter("ticks").inc()
            time.sleep(0.01)
    finally:
        ring.stop()
    samples = ring.samples()
    assert len(samples) >= 3
    assert [s["t"] for s in samples] == sorted(s["t"] for s in samples)
    assert samples[-1]["v"]["counters.ticks"] >= \
        samples[0]["v"]["counters.ticks"]


def test_install_if_env(monkeypatch):
    monkeypatch.delenv(obs_ts.ENV_HISTORY_S, raising=False)
    assert obs_ts.install_if_env() is None
    monkeypatch.setenv(obs_ts.ENV_HISTORY_S, "0.05")
    monkeypatch.setenv(obs_ts.ENV_HISTORY_BYTES, str(32 << 10))
    ring = obs_ts.install_if_env()
    assert ring is not None and obs_ts.active() is ring
    assert (ring.period_s, ring.budget_bytes) == (0.05, 32 << 10)
    assert obs_ts.install_if_env() is ring  # idempotent
    assert ref_ts.active() is None  # the packages keep their own rings


def test_history_endpoint_serves_the_ring(monkeypatch):
    ring = obs_ts.TimeSeriesRing(period_s=60)
    monkeypatch.setattr(obs_ts, "_ring", ring)  # installed, driven
    base = REGISTRY.counter("hist.demo").value
    REGISTRY.counter("hist.demo").inc(5)
    ring.sample_now(t=time.time() - 100.0)
    ring.sample_now()
    with StatusServer() as srv:
        doc = _get(srv.url("/history"))
        assert doc["schema"] == obs_ts.TIMESERIES_SCHEMA
        assert doc["kept"] == 2
        assert doc["samples"][-1]["v"]["counters.hist.demo"] == base + 5
        assert len(_get(srv.url("/history?seconds=30"))["samples"]) == 1


def _servers(cls_a, reg_a, cls_b, reg_b):
    for reg, count in ((reg_a, 100), (reg_b, 200)):
        reg.counter("agg.rows").inc(count)
        reg.gauge("agg.depth").set(count // 100)
    return cls_a(registry=reg_a), cls_b(registry=reg_b)


def _strip(view):
    """An aggregator view without its wall clock and ports (which differ
    between two aggregators polling at two moments)."""
    out = json.loads(json.dumps(view))
    out.pop("ports", None)
    for r in out["ranks"].values():
        r.pop("last_poll_t")
        r.pop("port")
        for s in r["series"]["samples"]:
            s.pop("t")
        for g in r["gaps"]:
            g.pop("t", None)
        for k in ("period_s", "resolution_s"):
            r["series"].pop(k, None)
    for s in out["rollup"]["samples"]:
        s.pop("t")
    return out


@pytest.mark.parametrize("mixed", [False, True])
def test_rollups_match_reference(mixed):
    """Two ranks polled twice by each package's aggregator: the same
    per-rank series and sum/min/max rollups. With ``mixed`` the ranks
    are one port server and one reference server (each package reads
    the other's /metrics.json)."""
    clss = (StatusServer, RefStatusServer if mixed else StatusServer)
    a, b = _servers(clss[0], MetricsRegistry(), clss[1],
                    RefRegistry() if mixed else MetricsRegistry())
    try:
        views = []
        for mod in (obs_agg, ref_agg):
            agg = mod.GangAggregator(ports=[a.port, b.port], period_s=60)
            assert agg.poll_once() == {f"port{a.port}": True,
                                       f"port{b.port}": True}
            agg.poll_once()
            views.append(agg.view())
        got, want = views
        assert got["schema"] == obs_agg.GANG_SCHEMA
        roll = got["rollup"]["samples"][-1]["v"]
        assert roll["gang.expected"] == roll["gang.reachable"] == 2.0
        assert roll["sum.counters.agg.rows"] == 300
        assert (roll["min.counters.agg.rows"],
                roll["max.counters.agg.rows"]) == (100, 200)
        ra = got["ranks"][f"port{a.port}"]
        assert ra["polls_ok"] == 2 and ra["unreachable"] is False
        if not mixed:
            # the same rank's rows: only the wall clocks differ (the
            # serve-port gauge and scrape counters are rank state)
            assert sorted(_strip(got)["ranks"]) == \
                sorted(_strip(want)["ranks"])
            assert _strip(got)["rollup"]["samples"][-1]["v"][
                "sum.counters.agg.rows"] == _strip(want)["rollup"][
                "samples"][-1]["v"]["sum.counters.agg.rows"]
    finally:
        a.close()
        b.close()


def test_unreachable_rank_gets_an_explicit_gap():
    a, b = _servers(StatusServer, MetricsRegistry(), StatusServer,
                    MetricsRegistry())
    agg = obs_agg.GangAggregator(ports=[a.port, b.port], period_s=60,
                                 timeout_s=0.5)
    agg.poll_once()
    dead_label = f"port{b.port}"
    b.close()  # the rank dies between polls
    try:
        status = agg.poll_once()
        assert status == {f"port{a.port}": True, dead_label: False}
        view = agg.view()
        dead = view["ranks"][dead_label]
        assert dead["unreachable"] is True and dead["last_error"]
        assert len(dead["gaps"]) == 1 and dead["gaps"][0]["first"] is True
        assert len(dead["series"]["samples"]) == 1  # nothing invented
        roll = view["rollup"]["samples"][-1]["v"]
        assert roll["gang.reachable"] == 1.0
        assert roll["sum.counters.agg.rows"] == 100
    finally:
        a.close()
        agg.stop()


def test_aggregator_install_if_env_and_gang_endpoint(monkeypatch):
    monkeypatch.delenv(obs_agg.ENV_GANG_POLL_S, raising=False)
    assert obs_agg.install_if_env() is None
    reg = MetricsRegistry()
    reg.counter("agg.rows").inc(7)
    srv = StatusServer(registry=reg)
    try:
        monkeypatch.setenv(obs_agg.ENV_GANG_POLL_S, "0.05")
        monkeypatch.setenv("DMLC_TPU_SERVE_PORTS", str(srv.port))
        agg = obs_agg.install_if_env()
        assert agg is not None and agg.ports == [srv.port]
        deadline = time.time() + 5.0
        while agg.view()["polls"] < 2 and time.time() < deadline:
            time.sleep(0.02)
        doc = _get(srv.url("/gang"))
        assert doc["schema"] == obs_agg.GANG_SCHEMA
        assert doc["polls"] >= 2 and list(doc["ranks"]) == [
            f"port{srv.port}"]
        assert "membership" not in doc
    finally:
        obs_agg.uninstall()
        srv.close()


def test_gang_404_names_both_enable_routes():
    with StatusServer() as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url("/gang"))
        assert e.value.code == 404
        doc = json.loads(e.value.read())
    assert "DMLC_TPU_GANG_POLL_S" in doc["hint"]
    assert "rendezvous" in doc["hint"]
