"""The port's SLO plane (``dmlc_tpu_torch/obs/slo.py``) against the
reference's.

Twins of ``tests/test_slo.py``: ``latency_bounds`` puts the target on a
bucket edge in both; the same objectives over the same observation
stream, sampled on the same explicit clock, give the same attainment,
budget, per-window burn and fast and slow alerts at every step of a
fire-and-clear arc; ``merge_views`` re-judges a gang on summed counts and
marks an unreachable rank incomplete as the reference does (also over a
reference rank's view); ``/slo`` serves the view and ``/analyze``
carries a burning objective's ``slo`` verdict; the ``slo`` registry
collector and the ``slo.*`` gauges; ``parse_objectives`` and the env and
scheduler declarations; and a flight bundle gains ``slo.json``. Every
engine and scheduler a test installs is uninstalled by the fixture.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from dmlc_tpu.obs import slo as ref_slo
from dmlc_tpu.obs.metrics import MetricsRegistry as RefRegistry
from dmlc_tpu.pipeline import scheduler as ref_sched
from dmlc_tpu_torch.obs import flight as obs_flight
from dmlc_tpu_torch.obs import slo as obs_slo
from dmlc_tpu_torch.obs.metrics import MetricsRegistry
from dmlc_tpu_torch.obs.serve import StatusServer, scrape_gang
from dmlc_tpu_torch.pipeline import scheduler as sched_mod
from dmlc_tpu_torch.utils.logging import DMLCError


@pytest.fixture(autouse=True)
def _planes_clean():
    for m in (obs_slo, sched_mod, ref_slo, ref_sched):
        m.uninstall()
    yield
    obs_flight.uninstall()
    for m in (obs_slo, sched_mod, ref_slo, ref_sched):
        m.uninstall()


def _get_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5.0) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_constants_are_the_references():
    for name in ("SLO_SCHEMA", "FAST_BURN_RATE", "SLOW_BURN_RATE",
                 "ENV_SLO"):
        assert getattr(obs_slo, name) == getattr(ref_slo, name), name


@pytest.mark.parametrize("target", [0.001, 0.05, 0.15, 0.25, 2.0])
def test_latency_bounds_match_reference(target):
    got = obs_slo.latency_bounds(target)
    assert got == ref_slo.latency_bounds(target)
    assert target in got


def test_latency_bounds_reject_nonpositive_target():
    with pytest.raises(DMLCError):
        obs_slo.latency_bounds(0)


def _engine(mod, reg_cls, window_s=72.0, budget=0.01, target=0.1):
    reg = reg_cls()
    h = reg.histogram("lat", bounds=mod.latency_bounds(target))
    eng = mod.SloEngine(registry=reg)
    eng.register("api", metric="lat", target_s=target, window_s=window_s,
                 budget=budget, tenant="t0")
    return reg, h, eng


# (seconds after t0, observations: value -> count) of one stream
ARC = [(1, {0.01: 100}), (2, {0.5: 50}), (3, {0.01: 500}), (10, {}),
       (30, {0.2: 7, 0.05: 3}), (120, {})]


def _row(eng):
    return eng.view(sample=False)["objectives"]["api"]


def test_same_stream_gives_the_same_judgment_at_every_step():
    """The fire-and-clear arc of the reference's test on one explicit
    clock, fed to both engines: every step's row is the same."""
    _, h, eng = _engine(obs_slo, MetricsRegistry)
    _, rh, ref = _engine(ref_slo, RefRegistry)
    t0 = time.monotonic()
    rows = []
    for dt, obs in ARC:
        for v, n in obs.items():
            for _ in range(n):
                h.observe(v)
                rh.observe(v)
        eng.sample(now=t0 + dt)
        ref.sample(now=t0 + dt)
        got, want = _row(eng), _row(ref)
        assert got == want, dt
        rows.append(got)
    assert rows[0]["attainment"] == 1.0
    assert rows[1]["alerts"]["fast"] and rows[1]["alerts"]["slow"]
    assert rows[1]["windows"]["fast_short"]["burn"] == 100.0
    assert not rows[2]["alerts"]["fast"] and rows[2]["alerts"]["slow"]
    assert rows[3]["windows"]["short"]["burn"] is None
    assert rows[5]["attainment"] is None and not rows[5]["alerts"]["firing"]
    assert eng.verdicts(epoch=2) == ref.verdicts(epoch=2)


def test_registration_baseline_excludes_prior_traffic():
    reg = MetricsRegistry()
    h = reg.histogram("lat", bounds=obs_slo.latency_bounds(0.1))
    for _ in range(100):
        h.observe(5.0)
    eng = obs_slo.SloEngine(registry=reg)
    eng.register("api", metric="lat", target_s=0.1, window_s=60)
    for _ in range(10):
        h.observe(0.01)
    eng.sample()
    row = _row(eng)
    assert row["attainment"] == 1.0
    assert row["windows"]["long"]["total"] == 10


def test_gauges_and_collector_per_objective():
    reg, h, eng = _engine(obs_slo, MetricsRegistry)
    for _ in range(10):
        h.observe(0.01)
    eng.sample()
    snap = reg.snapshot()
    assert snap["gauges"]["slo.api.attainment"] == 1.0
    assert snap["gauges"]["slo.api.fast_burn"] is False
    coll = snap["collectors"]["slo"]
    assert coll["schema"] == obs_slo.SLO_SCHEMA
    assert coll["count"] == 1 and coll["firing"] == 0


def _view(mod, reg_cls, good, total):
    _, h, eng = _engine(mod, reg_cls, window_s=60.0)
    for _ in range(good):
        h.observe(0.01)
    for _ in range(total - good):
        h.observe(0.5)
    eng.sample()
    return eng.view(sample=False)


@pytest.mark.parametrize("counts,unreachable", [
    (((100, 100), (0, 100)), []), (((50, 50),), ["rank1"]),
    (((3, 10), (10, 10), (7, 9)), [])])
def test_merge_views_matches_reference(counts, unreachable):
    port = [_view(obs_slo, MetricsRegistry, g, t) for g, t in counts]
    ref = [_view(ref_slo, RefRegistry, g, t) for g, t in counts]
    got = obs_slo.merge_views(port, unreachable=unreachable)
    assert got == ref_slo.merge_views(ref, unreachable=unreachable)
    # one package's merge of the other's views
    assert got == obs_slo.merge_views(ref, unreachable=unreachable)
    row = got["objectives"]["api"]
    assert row["windows"]["long"]["total"] == sum(t for _, t in counts)
    assert got["incomplete"] is bool(unreachable)


def test_gang_view_over_a_dead_rank_is_incomplete():
    from dmlc_tpu_torch.parallel.launch import find_free_port
    reg, h, eng = _engine(obs_slo, MetricsRegistry, window_s=60.0)
    for _ in range(20):
        h.observe(0.01)
    eng.sample()
    dead = find_free_port()
    with StatusServer(registry=reg) as srv:
        merged = scrape_gang([srv.port, dead], timeout_s=1.0)
    gv = obs_slo.gang_view(merged)
    assert gv is not None and gv["incomplete"] is True
    assert gv["unreachable"] == [str(dead)]
    assert gv["objectives"]["api"]["attainment"] == 1.0


def test_slo_endpoint_and_analyze_ride_along():
    reg = MetricsRegistry()
    with StatusServer(registry=reg) as srv:
        code, doc = _get_json(srv.port, "/slo")
        assert code == 404 and doc["error"] == "no SLO objectives registered"
        assert "DMLC_TPU_SLO" in doc["hint"] and "add_tenant" in doc["hint"]
        h = reg.histogram("lat", bounds=obs_slo.latency_bounds(0.1))
        eng = obs_slo.install(obs_slo.SloEngine(registry=reg))
        eng.register("api", metric="lat", target_s=0.1, window_s=60,
                     tenant="t0")
        for _ in range(20):
            h.observe(0.5)
        eng.sample()
        code, doc = _get_json(srv.port, "/slo")
        assert code == 200 and doc["schema"] == obs_slo.SLO_SCHEMA
        assert doc["objectives"]["api"]["alerts"]["fast"]
        code, doc = _get_json(srv.port, "/analyze")
    assert code == 200
    (v,) = doc["slo_verdicts"]
    assert (v["bound"], v["band"], v["tenant"]) == ("slo", "fast-burn",
                                                    "t0")


@pytest.mark.parametrize("spec", [
    "name=a,metric=m,target=0.1",
    "name=a,metric=m,target=0.1;name=b,metric=n,target=0.2,window=30,"
    "budget=0.05,tenant=t"])
def test_parse_objectives_matches_reference(spec):
    assert obs_slo.parse_objectives(spec) == ref_slo.parse_objectives(spec)


@pytest.mark.parametrize("bad", ["name=a", "name=a,metric=m,target=x",
                                 "name=a,metric=m,target=0.1,bogus=1"])
def test_parse_objectives_rejects_as_reference(bad):
    with pytest.raises(ValueError):
        obs_slo.parse_objectives(bad)
    with pytest.raises(ValueError):
        ref_slo.parse_objectives(bad)


def test_env_grammar_declares_and_malformed_degrades(monkeypatch):
    monkeypatch.setenv(obs_slo.ENV_SLO, "name=api,metric=lat,target=0.1,"
                       "window=60,budget=0.02")
    eng = obs_slo.install_if_env()
    assert eng is not None and eng.objectives() == ["api"]
    obs_slo.uninstall()
    monkeypatch.setenv(obs_slo.ENV_SLO, "target=nope")
    eng = obs_slo.install_if_env()
    assert eng is not None and eng.objectives() == []
    obs_slo.uninstall()
    monkeypatch.setenv(obs_slo.ENV_SLO, "0")
    assert obs_slo.install_if_env() is None


def test_scheduler_declares_with_slo_aware_bounds(monkeypatch):
    """``add_tenant(slo=...)`` and the ``slo.<tenant>=`` option of
    ``DMLC_TPU_SCHED`` declare the tenant's objective, as the
    reference's do, with the target on a bucket edge."""
    monkeypatch.setenv(sched_mod.ENV_SCHED,
                       "quantum=2,slo.victim=0.15:60:0.02")
    sched = sched_mod.install_if_env()
    assert sched.to_dict()["tenants"]["victim"]["slo"] == {
        "target_s": 0.15, "window_s": 60.0, "budget": 0.02}
    sched.add_tenant("feed", weight=4,
                     slo={"target_s": 0.25, "window_s": 30,
                          "budget": 0.01})
    eng = obs_slo.active()
    assert eng is not None
    assert sorted(eng.objectives()) == ["tenant.feed", "tenant.victim"]
    view = eng.view()["objectives"]["tenant.feed"]
    assert (view["target_s"], view["window_s"], view["budget"]) == \
        (0.25, 30.0, 0.01)
    with pytest.raises(DMLCError):
        sched.add_tenant("bad", slo={"window_s": 3})


def test_flight_bundle_gains_slo_json(tmp_path):
    reg = MetricsRegistry()
    reg.histogram("lat", bounds=obs_slo.latency_bounds(0.1)).observe(0.5)
    eng = obs_slo.install(obs_slo.SloEngine(registry=reg))
    eng.register("api", metric="lat", target_s=0.1, window_s=60)
    fl = obs_flight.FlightRecorder(out_dir=str(tmp_path / "f")).install()
    try:
        d = fl.dump("test")
    finally:
        fl.uninstall()
    doc = json.load(open(os.path.join(d, "slo.json")))
    assert doc["schema"] == obs_slo.SLO_SCHEMA and "api" in doc[
        "objectives"]
    obs_slo.uninstall()
    fl = obs_flight.FlightRecorder(out_dir=str(tmp_path / "g")).install()
    try:
        d = fl.dump("test")
    finally:
        fl.uninstall()
    assert not os.path.exists(os.path.join(d, "slo.json"))
