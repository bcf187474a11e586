"""The port's verdict-driven control plane (``dmlc_tpu_torch/obs/
control.py``) against the reference's.

Twins of ``tests/test_control.py``'s policy, ledger and adoption cases:
the same verdict sequence (epoch snapshots, wire counters and credit
gauges) observed by each package's ``Controller`` over the same knobs
gives the same ledger, record for record, and leaves the knobs at the
same values (a parse-bound epoch grows the parse family, xfer moves the
transfer family, wire escalates coalesce then the codec, a credit-drained
epoch freezes everything or discards a pending trial, consumer is an
explicit no-op, a spent revert budget exhausts the family); the ledger
coarsens like the reference's; ``RECORD_KEYS`` and the family maps are
the reference's; ``membership_record`` writes the reference's record; an
installed controller adopts a port pipeline's knobs in place of its
autotuner, with the scheduler's knobs withheld; ``/control`` and the
flight bundle's ``control.json``. The fixture uninstalls every
controller a test installs.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from dmlc_tpu.obs import control as ref_control
from dmlc_tpu.obs.metrics import MetricsRegistry as RefRegistry
from dmlc_tpu_torch.obs import control as obs_control
from dmlc_tpu_torch.obs import flight as obs_flight
from dmlc_tpu_torch.obs.metrics import MetricsRegistry
from dmlc_tpu_torch.obs.serve import StatusServer
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.pipeline import scheduler as sched_mod


@pytest.fixture(autouse=True)
def _controllers_clean():
    for m in (obs_control, ref_control, sched_mod):
        m.uninstall()
    yield
    obs_flight.uninstall()
    for m in (obs_control, ref_control, sched_mod):
        m.uninstall()


def _snap(stages, wall_s=2.0, epoch=1, bytes_=1 << 30):
    stages = [dict(s) for s in stages]
    stages[-1].setdefault("bytes", bytes_)
    return {"schema": 1, "epoch": epoch, "wall_s": wall_s,
            "stages": stages, "knobs": {}}


def _parse_bound(epoch=1, wall_s=2.0, bytes_=1 << 30):
    return _snap([{"name": "parse", "kind": "parse", "wait_s": 0.9 * wall_s,
                   "bytes": bytes_}], wall_s=wall_s, epoch=epoch,
                 bytes_=bytes_)


def _xfer(epoch=1):
    return _snap([{"name": "parse", "kind": "parse", "wait_s": 0.1},
                   {"name": "to_device", "kind": "to_device", "wait_s": 1.5,
                    "extra": {"xfer_wait_s": 1.5}}], epoch=epoch)


def _consumer(epoch=1):
    return _snap([{"name": "parse", "kind": "parse", "wait_s": 0.01,
                   "bytes": 1 << 30}], epoch=epoch)


WIRE = {"counters": {"pagestore.hit": 0, "pagestore.miss": 40,
                     "objstore.get": 40, "objstore.bytes": 1 << 30}}


def _wire(bytes_):
    return _snap([{"name": "parse", "kind": "parse", "wait_s": 1.0,
                   "bytes": bytes_}])


# each scenario: the knobs (name, family, initial, lo, hi, codec-like)
# and the observe() calls (snapshot, keyword arguments)
SCENARIOS = {
    "parse_grows": ([("k", "parse", 4, 1, 64, False)],
                    [(_parse_bound(epoch=e, bytes_=(1 + e) << 29), {})
                     for e in range(1, 6)], {}),
    "xfer_only": ([("k", "parse", 4, 1, 64, False),
                   ("w", "transfer", 2, 1, 32, False)],
                  [(_xfer(e), {}) for e in range(1, 4)], {}),
    "wire_escalates": ([("wire.coalesce", "wire", 4, 1, 16, False),
                        ("wire.codec_level", "wire", 0, 0, 9, True)],
                       [(_wire(1 << 30), {"metrics": WIRE}),
                        (_wire(1 << 24), {"metrics": WIRE}),
                        (_wire(1 << 30), {"metrics": WIRE})], {}),
    "credit_freezes": ([("k", "parse", 4, 1, 64, False),
                        ("w", "transfer", 2, 1, 32, False)],
                       [(_parse_bound(epoch=e),
                         {"epoch_gauges": [0.3, 0.4, 0.5]})
                        for e in range(1, 6)], {}),
    "consumer_noop": ([("k", "parse", 4, 1, 64, False)],
                      [(_consumer(e), {}) for e in range(1, 3)], {}),
    "revert_budget": ([("k", "parse", 4, 1, 64, False)],
                      [(_parse_bound(epoch=1), {}),
                       (_parse_bound(epoch=2, bytes_=1 << 20), {}),
                       (_parse_bound(epoch=3), {})],
                      {"revert_budget": 1, "cooldown": 0}),
    "drain_discards": ([("k", "parse", 4, 1, 64, False)],
                       [(_parse_bound(epoch=1), {}),
                        (_parse_bound(epoch=2, bytes_=1 << 20),
                         {"epoch_gauges": [0.3, 0.4]}),
                        (_parse_bound(epoch=3), {})],
                       {"revert_budget": 1}),
    "reverted_arms_nothing": ([("k", "parse", 4, 1, 64, False),
                               ("k2", "parse", 2, 1, 64, False)],
                              [(_parse_bound(epoch=1), {}),
                               (_parse_bound(epoch=2, bytes_=1 << 20), {}),
                               (_parse_bound(epoch=3), {})], {}),
}


def _run(mod, name):
    """The scenario on ``mod``'s Controller over a registry of its own:
    the process registry's wire counters (other tests' object-store
    traffic) must not reach the verdicts."""
    specs, calls, kw = SCENARIOS[name]
    store = {n: init for n, _, init, _, _, _ in specs}
    knobs = []
    for n, fam, _, lo, hi, codec in specs:
        extra = ({"grow": lambda cur: 6 if cur == 0 else cur}
                 if codec else {})
        knobs.append(mod.ControlKnob(
            n, fam, (lambda n=n: store[n]),
            (lambda v, n=n: store.__setitem__(n, v)), lo=lo, hi=hi,
            **extra))
    reg = MetricsRegistry() if mod is obs_control else RefRegistry()
    kw = {"revert_budget": 2, "registry": reg, **kw}
    ctl = mod.Controller(knobs, **kw)
    try:
        outs = [ctl.observe(json.loads(json.dumps(s)),
                            **json.loads(json.dumps(k)))
                for s, k in calls]
        doc = ctl.to_dict()
    finally:
        ctl.close()
    return outs, doc, store


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_verdicts_give_the_same_ledger(name):
    got, got_doc, got_store = _run(obs_control, name)
    want, want_doc, want_store = _run(ref_control, name)
    assert got == want
    assert got_doc == want_doc
    assert got_store == want_store
    for rec in got_doc["ledger"]["records"]:
        assert sorted(rec) == sorted(obs_control.RECORD_KEYS)


def test_scenarios_act_as_the_reference_documents():
    outs, _, store = _run(obs_control, "credit_freezes")
    assert [r["outcome"] for r in outs] == ["freeze"] * 5
    assert store == {"k": 4, "w": 2}
    outs, _, store = _run(obs_control, "wire_escalates")
    assert [(r["outcome"], r["knob"]) for r in outs] == [
        ("trial", "wire.coalesce"), ("reverted", "wire.coalesce"),
        ("trial", "wire.codec_level")]
    assert store == {"wire.coalesce": 4, "wire.codec_level": 6}
    outs, doc, _ = _run(obs_control, "revert_budget")
    assert outs[-1]["outcome"] == "family-exhausted"
    outs, doc, store = _run(obs_control, "drain_discards")
    assert [r["outcome"] for r in doc["ledger"]["records"]][:3] == [
        "trial", "discarded", "freeze"]


def test_constants_are_the_references():
    for name in ("RECORD_KEYS", "CONTROL_SCHEMA", "ENV_CONTROL",
                 "FAMILY_FOR_BOUND", "FAMILY_FOR_STAGE_KIND"):
        assert getattr(obs_control, name) == getattr(ref_control, name)


def _rec(i):
    return {"epoch": i, "verdict_id": f"v{i}-x", "tenant": None,
            "bound": "parse", "band": "unknown",
            "evidence": [f"parse wait {i}s"], "family": "parse",
            "knob": "k", "old": 1, "new": 2, "outcome": "trial",
            "reverted": False}


@pytest.mark.parametrize("budget,n", [(2 << 10, 300), (8 << 10, 1000),
                                      (1 << 20, 50)])
def test_ledger_coarsens_as_the_reference(budget, n):
    led = obs_control.DecisionLedger(budget_bytes=budget)
    ref = ref_control.DecisionLedger(budget_bytes=budget)
    for i in range(n):
        led.append(_rec(i))
        ref.append(_rec(i))
    d = led.to_dict()
    assert d == ref.to_dict()
    assert led.to_dict(last=3) == ref.to_dict(last=3)
    assert d["approx_bytes"] <= d["budget_bytes"]
    assert d["records"][0]["epoch"] == 0
    assert d["records"][-1]["epoch"] == n - 1


def test_membership_record_is_the_references():
    assert obs_control.membership_record("reshard", "g", 2, 1, 2) is None
    kw = dict(gang="local", epoch=3, old_world=1, new_world=2,
              member="worker-1", rank=0)
    ctl = obs_control.install(obs_control.Controller([]))
    ref = ref_control.install(ref_control.Controller([]))
    got = obs_control.membership_record("reshard", **kw)
    want = ref_control.membership_record("reshard", **kw)
    assert got == want and sorted(got) == sorted(obs_control.RECORD_KEYS)
    assert ctl.ledger.records() == ref.ledger.records() == [got]


def test_install_if_env_owns_the_wire_family(monkeypatch):
    monkeypatch.delenv(obs_control.ENV_CONTROL, raising=False)
    assert obs_control.install_if_env() is None
    monkeypatch.setenv(obs_control.ENV_CONTROL, "1")
    ctl = obs_control.install_if_env()
    assert ctl is not None and obs_control.install_if_env() is ctl
    assert {k["family"] for k in ctl.to_dict()["knobs"].values()} == \
        {"wire"}
    assert sorted(ctl.to_dict()["knobs"]) == sorted(
        k.name for k in obs_control.objstore_knobs())


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(800):
        nnz = rng.randint(3, 9)
        idx = np.sort(rng.choice(500, nnz, replace=False))
        lines.append(f"{i % 2} " + " ".join(
            f"{j}:{v:.4f}" for j, v in zip(idx, rng.rand(nnz))))
    p = tmp_path / "data.libsvm"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_installed_controller_adopts_a_port_pipeline(corpus):
    built = (Pipeline.from_uri(corpus).parse(format="libsvm")
             .batch(64).prefetch(depth="auto").build(autotune=True))
    ctl = obs_control.install(obs_control.Controller())
    try:
        for _ in range(3):
            built.run_epoch()
        knobs = ctl.to_dict()["knobs"]
        assert knobs["prefetch.depth"]["family"] == "assemble"
        assert len(ctl.ledger.records()) >= 3
        assert ctl.to_dict()["epoch"] == 3
        assert built.autotune_report()["decisions"] == []
    finally:
        built.close()


def test_tenant_pipeline_withholds_scheduler_knobs(corpus):
    """A tenant pipeline's queue knobs belong to the scheduler: the
    controller adopts none of them, and its ledger records carry the
    tenant."""
    sched = sched_mod.install(quantum=4, queue_budget=16)
    sched.add_tenant("feed")
    built = (Pipeline.from_uri(corpus).parse(format="libsvm")
             .batch(64).prefetch(depth="auto").build(tenant="feed"))
    ctl = obs_control.install(obs_control.Controller())
    try:
        built.run_epoch()
        built.run_epoch()
        assert "prefetch.depth" not in ctl.to_dict()["knobs"]
        recs = ctl.ledger.records()
        assert recs and all(r["tenant"] == "feed" for r in recs)
    finally:
        built.close()


def test_a_raising_controller_hands_the_pipeline_back(corpus,
                                                        monkeypatch):
    """The one-way hand-off: a controller that raises on a pipeline is
    never called for it again, and the pipeline's autotuner resumes."""
    built = (Pipeline.from_uri(corpus).parse(format="libsvm")
             .batch(64).prefetch(depth="auto").build(autotune=True))
    ctl = obs_control.install(obs_control.Controller())
    calls = []

    def boom(pipe, snap):
        calls.append(snap["epoch"])
        raise RuntimeError("controller bug")

    monkeypatch.setattr(ctl, "observe_pipeline", boom)
    try:
        built.run_epoch()
        built.run_epoch()
        assert calls == [1] and built._control_failed
        # the autotuner took epoch 1's step once the controller raised,
        # and epoch 2's
        assert built.autotune_report()["epochs"] == 2
    finally:
        built.close()


def test_control_endpoint_and_flight_bundle(tmp_path):
    store = {"k": 4}
    knob = obs_control.ControlKnob(
        "k", "parse", lambda: store["k"],
        lambda n: store.__setitem__("k", n), lo=1, hi=64)
    with StatusServer() as srv:
        try:
            urllib.request.urlopen(srv.url("/control"), timeout=5)
            raise AssertionError("/control answered without a controller")
        except urllib.error.HTTPError as e:
            assert e.code == 404 and b"DMLC_TPU_CONTROL" in e.read()
        reg = MetricsRegistry()  # no other test's wire counters
        ctl = obs_control.install(obs_control.Controller([knob],
                                                         registry=reg))
        ctl.observe(_parse_bound(epoch=1))
        ctl.observe(_parse_bound(epoch=2, bytes_=2 << 30))
        with urllib.request.urlopen(srv.url("/control"), timeout=5) as r:
            doc = json.load(r)
        with urllib.request.urlopen(srv.url("/control?last=1"),
                                    timeout=5) as r:
            last = json.load(r)
    assert doc["schema"] == obs_control.CONTROL_SCHEMA
    assert [r["outcome"] for r in doc["ledger"]["records"]] == [
        "trial", "accepted", "trial"]
    assert doc["knobs"]["k"]["value"] == 16
    assert len(last["ledger"]["records"]) == 1
    assert reg.snapshot()["collectors"]["control"]["decisions"] == 2
    fl = obs_flight.FlightRecorder(out_dir=str(tmp_path / "f")).install()
    try:
        d = fl.dump("unit_test")
    finally:
        fl.uninstall()
    got = json.load(open(os.path.join(d, "control.json")))
    assert got["ledger"]["records"] == doc["ledger"]["records"]
    manifest = json.load(open(os.path.join(d, "MANIFEST.json")))
    assert manifest["files"]["control.json"] == "ok"
