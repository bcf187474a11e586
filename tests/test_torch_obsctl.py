"""The obsctl twin (``python -m dmlc_tpu_torch.obsctl``) against the
reference's ``scripts/obsctl.py``.

Every subcommand renders the same text and returns the same exit code as
the reference's on the same server document (each module's ``_fetch``
stubbed to return it): ``top``, ``diagnose`` (live and from a BENCH
file), ``compare`` (3 on a regression), ``history``, ``gang`` (the
aggregator view with its rollups and the membership section, including a
reshard's record on ``control``), ``tenants``, ``control``, ``rpc``,
``slo``, ``shuffle`` and ``profile`` (with ``--out`` in both formats);
every 404 body gives exit 2 with the server's hint. Twins of
``tests/test_shuffle.py::TestShuffleSurface``'s
``test_render_shuffle_fabricated_view`` and ``test_cmd_shuffle_exit_codes``.
Then against a live port status server with no plane installed and with
every plane installed: the exit codes the reference documents; and the
module run as ``python -m dmlc_tpu_torch.obsctl`` with
``DMLC_TPU_SERVE_PORT`` as its default port.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

from dmlc_tpu_torch import obsctl
from dmlc_tpu_torch.obs import profile as obs_prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_obsctl():
    spec = importlib.util.spec_from_file_location(
        "ref_obsctl", os.path.join(REPO, "scripts", "obsctl.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_obsctl = _ref_obsctl()


def _profile_doc():
    t = obs_prof.FrameTrie()
    for _ in range(3):
        t.add("main", ["a.py:f", "parser.py:tokenize"])
    t.add("io", ["c.py:h", "threading.py:wait", obs_prof.WAIT_FRAME],
          wait=True)
    t.add("native/worker-0", ["native:parse"])
    d = {"schema": obs_prof.PROFILE_SCHEMA, "hz": 67.0, "duration_s": 2.5,
         "burst": False, "effective_hz": 67.0, "tick_cost_s": 0.0001}
    d.update(t.to_dict())
    return d


def _pipeline_snap(tenant=None):
    return {"schema": 1, "epoch": 3, "wall_s": 2.0, "tenant": tenant,
            "knobs": {"prefetch.depth": 4},
            "stages": [{"name": "parse", "kind": "parse", "items": 10,
                        "rows": 1000, "nnz": 5000, "bytes": 1 << 20,
                        "wait_s": 1.2, "wait_frac": 0.6,
                        "queue_occupancy": 0.5, "extra": {}},
                       {"name": "to_device", "kind": "to_device",
                        "items": 10, "rows": 1000, "nnz": 5000,
                        "bytes": 1 << 20, "wait_s": 0.3,
                        "wait_frac": 0.15, "queue_occupancy": None,
                        "extra": {"xfer_wait_s": 0.3}}]}


MEMBERSHIP = {"gang": "grow", "epoch": 3, "world": 3, "member": "a",
              "rank": 0,
              "roster": [{"rank": r, "member": m, "host": "127.0.0.1",
                          "port": 7101 + r, "attempt": 0}
                         for r, m in enumerate("abc")],
              "progress": {"0": 10, "1": 5}}


def _gang_view():
    from dmlc_tpu_torch.obs.timeseries import TimeSeriesRing
    ring, roll = TimeSeriesRing(period_s=0.5), TimeSeriesRing(period_s=0.5)
    for i in range(4):
        ring.append(100.0 + i, {
            "counters.objstore.bytes": 10 * i,
            "counters.objstore.peer.bytes": 20 * i,
            "counters.objstore.peer.served_bytes": 5 * i,
            "collectors.control.decisions": i,
            "collectors.control.freezes": 0,
            "collectors.control.reverted": 0})
        roll.append(100.0 + i, {"gang.reachable": 2.0,
                                "gang.expected": 2.0,
                                "sum.counters.agg.rows": 300.0 * i})
    rank = {"port": 9100, "rank": 0, "unreachable": False,
            "last_error": None, "last_poll_t": 103.0, "polls_ok": 4,
            "polls_failed": 0, "gaps": [], "rpc": None, "slo": None,
            "series": ring.to_dict()}
    dead = dict(rank, port=9101, rank=1, unreachable=True,
                last_error="URLError", polls_failed=2,
                gaps=[{"t": 102.0, "error": "URLError", "first": True}])
    return {"schema": 1, "period_s": 0.5, "host": "127.0.0.1",
            "ports": [9100, 9101], "polls": 4,
            "ranks": {"rank0": rank, "rank1": dead},
            "rollup": roll.to_dict(), "membership": MEMBERSHIP}


def _control_doc():
    from dmlc_tpu_torch.obs import control as obs_control
    store = {"k": 4}
    ctl = obs_control.Controller([obs_control.ControlKnob(
        "k", "parse", lambda: store["k"],
        lambda n: store.__setitem__("k", n), lo=1, hi=64)])
    try:
        for e, b in ((1, 1 << 30), (2, 2 << 30), (3, 1 << 20)):
            ctl.observe({"schema": 1, "epoch": e, "wall_s": 2.0,
                         "knobs": {}, "stages": [
                             {"name": "parse", "kind": "parse",
                              "wait_s": 1.8, "bytes": b}]})
        ctl.ledger.append({
            "epoch": 4, "verdict_id": "m4-grow", "tenant": None,
            "bound": "membership", "band": None,
            "evidence": ["membership epoch 4: reshard, world 2 -> 3"],
            "family": "gang", "knob": "membership", "old": 2, "new": 3,
            "outcome": "reshard", "reverted": False})
        return ctl.to_dict()
    finally:
        ctl.close()


def _slo_doc():
    from dmlc_tpu_torch.obs import slo as obs_slo
    from dmlc_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    h = reg.histogram("lat", bounds=obs_slo.latency_bounds(0.1))
    eng = obs_slo.SloEngine(registry=reg)
    eng.register("api", metric="lat", target_s=0.1, window_s=60,
                 tenant="t0")
    for v in [0.01] * 10 + [0.5] * 30:
        h.observe(v)
    eng.sample()
    doc = eng.view(sample=False)
    doc["objectives"]["api"]["incomplete"] = True
    doc["incomplete"] = True
    doc["unreachable"] = ["4001"]
    return doc


TENANTS = {
    "schema": 1, "quantum": 4.0, "burst": 2.0, "queue_budget": 48,
    "rounds": 17,
    "tenants": {
        "svc": {"weight": 2.0, "deficit": 3.5, "paused": False,
                "pipelines": 1, "max_pipelines": 4, "queue_share": 32,
                "pulls": 120, "batch_p50_s": 0.002, "batch_p99_s": 0.011,
                "queue_occupancy": 0.4, "admitted": 1, "rejected": 0,
                "queued": 0,
                "last_verdict": {"verdict_id": "v3-abc", "bound": "parse",
                                 "band": "plateau", "confidence": "high"},
                "watermark": {"uri": "feed.log", "windows": 9,
                              "watermark_records": 900,
                              "watermark_bytes": 12345,
                              "last_advance_s_ago": 0.2, "retries": 1}},
        "batch": {"weight": 1.0, "deficit": 0.0, "paused": True,
                  "pipelines": 0, "max_pipelines": 2, "queue_share": None,
                  "pulls": 8, "batch_p50_s": None, "batch_p99_s": None,
                  "queue_occupancy": None, "admitted": 2, "rejected": 1,
                  "queued": 1}}}

SHUFFLE = {"seed": 11, "epoch": 2, "rank": 1, "world": 3,
           "uri": "/tmp/x.rec", "split_type": "recordio", "records": 9000,
           "windows": 14, "window_bytes": 32 << 20, "position": 4000,
           "delivered": 1333, "coverage": 0.4444,
           "records_by_tier": {"local": 100, "peer": 1000, "wire": 233},
           "bytes_by_tier": {"local": 4096, "peer": 9 << 20,
                             "wire": 1 << 20}}

RPC = {"schema": 1, "edges": [
    {"peer": "127.0.0.1:9100", "verb": "GET /pages", "count": 12,
     "errors": 1, "attributed": 11, "client_total_us": 48000.0,
     "server_total_us": 12000.0, "residual_total_us": 30000.0,
     "client_us": {"p50": 4000.0, "p99": 20000.0},
     "server_us": {"p50": 1000.0, "p99": 8000.0},
     "residual_us": {"p50": 3000.0, "p99": 12000.0}},
    {"peer": "127.0.0.1:9101", "verb": "GET /healthz", "count": 3,
     "errors": 0, "attributed": 0, "client_total_us": 900.0,
     "server_total_us": None, "residual_total_us": None,
     "client_us": {"p50": 300.0, "p99": 310.0}, "server_us": {},
     "residual_us": {}}]}


def _docs():
    from dmlc_tpu_torch.obs import analyze
    snap = _pipeline_snap("feed")
    return {
        "/metrics.json": {"schema": 1, "rank": 0, "pid": 42,
                          "collectors": {"pipeline": snap}},
        "/analyze": analyze.attribute(snap),
        "/history": _history_doc(),
        "/gang": _gang_view(),
        "/tenants": TENANTS,
        "/control": _control_doc(),
        "/rpc": RPC,
        "/slo": _slo_doc(),
        "/shuffle": SHUFFLE,
        "/profile": _profile_doc(),
    }


def _history_doc():
    from dmlc_tpu_torch.obs.timeseries import TimeSeriesRing
    ring = TimeSeriesRing(period_s=0.5)
    for i in range(6):
        ring.append(10.0 + i, {"counters.rows": 100 * i,
                               "gauges.depth": i % 3})
    return ring.to_dict()


CASES = [("top", "--once"), ("diagnose",), ("history",),
         ("history", "--keys", "1"), ("gang",), ("tenants",),
         ("control",), ("control", "--keys", "2"), ("rpc",), ("slo",),
         ("shuffle",), ("profile",), ("profile", "--keys", "1"),
         ("gang", "--json"), ("tenants", "--json")]


def _run(mod, argv, docs, monkeypatch, capsys):
    def fetch(port, path, host="127.0.0.1", timeout_s=5.0):
        return json.loads(json.dumps(docs[path.split("?")[0]]))
    monkeypatch.setattr(mod, "_fetch", fetch)
    rc = mod.main(list(argv) + ["--port", "9100"])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", CASES, ids=lambda a: "_".join(a))
def test_subcommand_renders_as_the_reference(argv, monkeypatch, capsys):
    docs = _docs()
    got = _run(obsctl, argv, docs, monkeypatch, capsys)
    want = _run(ref_obsctl, argv, docs, monkeypatch, capsys)
    assert got == want
    assert got[0] == 0 and got[1].strip()


@pytest.mark.parametrize("path,argv", [
    ("/history", ("history",)), ("/gang", ("gang",)),
    ("/tenants", ("tenants",)), ("/control", ("control",)),
    ("/slo", ("slo",)), ("/shuffle", ("shuffle",)),
    ("/profile", ("profile",)), ("/analyze", ("diagnose",)),
    ("/rpc", ("rpc",))])
def test_absent_plane_exits_2_with_the_hint(path, argv, monkeypatch,
                                            capsys):
    docs = _docs()
    docs[path] = {"error": "no such plane installed",
                  "hint": "set the plane's variable"}
    got = _run(obsctl, argv, docs, monkeypatch, capsys)
    want = _run(ref_obsctl, argv, docs, monkeypatch, capsys)
    assert got == want
    assert got[0] == 2 and "hint" in got[1]


def test_gang_renders_rollups_membership_and_the_reshard_record(
        monkeypatch, capsys):
    docs = _docs()
    rc, out = _run(obsctl, ("gang",), docs, monkeypatch, capsys)
    assert rc == 0
    assert "membership: gang 'grow' epoch 3" in out
    assert "rank 2  c" in out and "progress: 2 part(s)" in out
    assert "gang of 2" in out and "UNREACHABLE" in out
    assert "1 gap(s)" in out and "4 rollup samples" in out
    rc, out = _run(obsctl, ("control",), docs, monkeypatch, capsys)
    assert rc == 0 and "reshard" in out and "membership" in out


def test_render_shuffle_fabricated_view():
    out = obsctl.render_shuffle(SHUFFLE)
    assert out == ref_obsctl.render_shuffle(SHUFFLE)
    assert "seed 11" in out and "epoch 2" in out and "rank 1/3" in out
    assert "9000" in out and "14" in out
    assert "coverage 44.44%" in out
    assert "peer" in out and "9.0MiB" in out and "wire" in out


def test_cmd_shuffle_exit_codes(monkeypatch, capsys):
    docs = {"/shuffle": {"error": "no global shuffle active",
                         "hint": "Pipeline..."}}
    monkeypatch.setattr(obsctl, "_fetch",
                        lambda port, path, host="x", **k: docs[path])
    args = type("A", (), {"port": 1, "host": "h", "json": False})
    assert obsctl.cmd_shuffle(args) == 2
    assert "hint" in capsys.readouterr().out
    docs["/shuffle"] = {"seed": 1, "records_by_tier": {},
                        "bytes_by_tier": {}}
    assert obsctl.cmd_shuffle(args) == 0


@pytest.mark.parametrize("fmt", ["collapsed", "speedscope"])
def test_profile_out_writes_the_references_file(fmt, tmp_path, monkeypatch,
                                                capsys):
    docs = _docs()
    paths = {}
    for name, mod in (("port", obsctl), ("ref", ref_obsctl)):
        p = str(tmp_path / f"{name}.{fmt}")
        rc, out = _run(mod, ("profile", "--out", p, "--format", fmt),
                       docs, monkeypatch, capsys)
        assert rc == 0 and p in out
        paths[name] = p
    if fmt == "collapsed":
        assert open(paths["port"]).read() == open(paths["ref"]).read()
    else:
        # the same document but the exporter's and the default name
        got, want = (json.load(open(paths[k])) for k in ("port", "ref"))
        for doc in (got, want):
            doc.pop("exporter")
            doc.pop("name")
            doc["profiles"][0].pop("name")
        assert got == want


@pytest.mark.parametrize("a,b,rc", [
    ("BENCH_r05.json", "BENCH_r05.json", 0),
    ("BENCH_r04.json", "BENCH_r05.json", 0)])
def test_compare_matches_reference(a, b, rc, capsys):
    argv = ["compare", os.path.join(REPO, a), os.path.join(REPO, b)]
    got = (obsctl.main(argv), capsys.readouterr().out)
    want = (ref_obsctl.main(argv), capsys.readouterr().out)
    assert got == want and got[0] == rc


def test_compare_regression_exits_3(tmp_path, capsys):
    a = {"metric": "m", "value": 1.0, "epochs": 10, "run_band": "plateau",
         "gauge_bands": {"plateau": {"epochs": 10, "sustained": 1.0}}}
    b = json.loads(json.dumps(a))
    b["gauge_bands"]["plateau"]["sustained"] = 0.5
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    argv = ["compare", str(pa), str(pb)]
    got = (obsctl.main(argv), capsys.readouterr().out)
    want = (ref_obsctl.main(argv), capsys.readouterr().out)
    assert got == want and got[0] == 3


BARE = {("history",): 2, ("gang",): 2, ("tenants",): 2, ("control",): 2,
        ("slo",): 2, ("shuffle",): 2, ("profile",): 2, ("rpc",): 0,
        ("top", "--once"): 0, ("diagnose",): 2}


def test_module_runs_with_the_env_port():
    """``python -m dmlc_tpu_torch.obsctl`` with ``DMLC_TPU_SERVE_PORT``
    and no ``--port``: the server's 404 hint and exit 2 for an absent
    plane, 0 for ``rpc``."""
    from dmlc_tpu_torch.obs.metrics import MetricsRegistry
    from dmlc_tpu_torch.obs.serve import StatusServer
    env = dict(os.environ, PYTHONPATH=REPO)
    with StatusServer(registry=MetricsRegistry()) as srv:
        env["DMLC_TPU_SERVE_PORT"] = str(srv.port)
        outs = [subprocess.run(
            [sys.executable, "-m", "dmlc_tpu_torch.obsctl", *a], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=120)
            for a in (("history",), ("rpc",))]
    assert outs[0].returncode == 2 and "DMLC_TPU_HISTORY_S" in outs[0].stdout
    assert outs[1].returncode == 0, outs[1].stdout + outs[1].stderr


def _main_codes(port, commands, capsys):
    out = {}
    for a in commands:
        rc = obsctl.main(list(a) + ["--port", str(port)])
        out[a] = (rc, capsys.readouterr().out)
    return out


def test_exit_codes_against_a_bare_server(capsys):
    """Against a live port server with no plane installed: 2 with the
    hint where the reference's exits 2, 0 for ``rpc`` and ``top``, in
    both CLIs."""
    from dmlc_tpu_torch.obs.metrics import MetricsRegistry
    from dmlc_tpu_torch.obs.serve import StatusServer
    with StatusServer(registry=MetricsRegistry()) as srv:
        got = _main_codes(srv.port, BARE, capsys)
        want = {a: (ref_obsctl.main(list(a) + ["--port", str(srv.port)]),
                    capsys.readouterr().out) for a in BARE}
    for a, code in BARE.items():
        assert got[a][0] == want[a][0] == code, (a, got[a])
        if code == 2:
            assert "hint" in got[a][1] or "error" in got[a][1], a


def test_exit_codes_with_every_plane_installed(tmp_path, capsys):
    """Every plane installed in one process, a tenant pipeline run to
    its end: each subcommand exits 0 and renders it."""
    from dmlc_tpu_torch.obs import (
        aggregate, control, profile, slo, timeseries,
    )
    from dmlc_tpu_torch.obs.serve import StatusServer
    from dmlc_tpu_torch.pipeline import Pipeline, scheduler
    p = tmp_path / "a.libsvm"
    p.write_text("".join(f"{i % 2} {i % 40 + 1}:1.5\n"
                         for i in range(3000)))
    srv = StatusServer()
    sched = scheduler.install(quantum=4, queue_budget=32)
    try:
        timeseries.install(period_s=0.05)
        profile.install(hz=50)
        control.install()
        aggregate.install(ports=[srv.port], period_s=0.05)
        sched.add_tenant("train", slo={"target_s": 0.25, "window_s": 30,
                                       "budget": 0.01})
        with (Pipeline.from_uri(str(p)).parse(format="libsvm")
              .batch(256).build(tenant="train")) as built:
            built.run_epoch()
            deadline = time.monotonic() + 10
            while (aggregate.active().view()["polls"] < 2
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            outs = _main_codes(srv.port,
                               [a for a in BARE if a != ("shuffle",)],
                               capsys)
    finally:
        for m in (aggregate, profile, timeseries, control, slo, scheduler):
            m.uninstall()
        srv.close()
    for a, (rc, out) in outs.items():
        assert rc == 0, (a, out)
    assert "train" in outs[("tenants",)][1]
    assert "gang of 1" in outs[("gang",)][1]
    assert "tenant.train" in outs[("slo",)][1]
