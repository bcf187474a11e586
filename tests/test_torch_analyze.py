"""The port's bottleneck attribution (``dmlc_tpu_torch/obs/analyze.py``)
against the reference's (``dmlc_tpu/obs/analyze.py``).

Twins of ``tests/test_obs_history.py::TestAnalyze``: every synthetic
epoch snapshot there, with its gauges and wire counters, gives the same
verdict dict in both packages (exact equality: the same bound, band,
confidence, evidence lines, stage waits and ``verdict_id``); the
band-aware comparison of the repo's own BENCH archive, ``gauge_band``,
``slo_verdict`` and ``diagnose_bench`` agree; the pinned key sets are the
reference's; the port's ``/analyze`` serves a port pipeline's verdict and
scopes wire counters to the epoch as the reference's does; and config
13's block (``bench_analyze``) is schema-valid with epoch-scoped wire
counters, restoring the registry's counters afterwards rather than
resetting it.
"""

import json
import os
import urllib.request

import pytest

from dmlc_tpu.obs import analyze as ref_analyze
from dmlc_tpu_torch.obs import analyze
from dmlc_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from dmlc_tpu_torch.obs.serve import StatusServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snap(stages, wall_s=2.0, **extra):
    return {"schema": 1, "epoch": 1, "wall_s": wall_s,
            "stages": stages, "knobs": {}, **extra}


def _get(url):
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return json.loads(resp.read())


# (snapshot, attribute() keyword arguments): the reference's cases
CASES = {
    "parse_bound": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.4,
         "bytes": 1 << 30},
        {"name": "to_device", "kind": "to_device", "wait_s": 0.2,
         "extra": {"xfer_wait_s": 0.2}}]), {"epoch_gauges": [2.0, 2.2]}),
    "xfer_bound": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 0.3,
         "bytes": 1 << 30},
        {"name": "to_device", "kind": "to_device", "wait_s": 1.5,
         "extra": {"xfer_wait_s": 1.5}}]), {}),
    "assemble_fused": (_snap([
        {"name": "assemble", "kind": "assemble", "wait_s": 1.0,
         "bytes": 1 << 30,
         "extra": {"assembly_path": "native-padded", "assemble_s": 0.8,
                   "engine": {}}}]), {}),
    "fused_carveout": (_snap([
        {"name": "assemble", "kind": "assemble", "wait_s": 2.0,
         "bytes": 1 << 30,
         "extra": {"assembly_path": "native-padded", "assemble_s": 0.3}},
        {"name": "to_device", "kind": "to_device", "wait_s": 0.1,
         "extra": {"staging_assemble_s": 1.0, "xfer_wait_s": 0.1}}]), {}),
    "cache_first": (_snap([
        {"name": "cache", "kind": "cache", "wait_s": 1.4,
         "bytes": 1 << 30},
        {"name": "to_device", "kind": "to_device", "wait_s": 0.1,
         "extra": {"xfer_wait_s": 0.1}}]), {}),
    "credit_limited": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.4,
         "bytes": 1 << 30}]), {"epoch_gauges": [0.2, 0.4, 0.3]}),
    "consumer": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 0.02,
         "bytes": 1 << 30}], wall_s=5.0), {}),
    "wire": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.4,
         "bytes": 1 << 30}]),
        {"metrics": {"counters": {"objstore.get": 50,
                                  "objstore.bytes": 1 << 30,
                                  "pagestore.hit": 1,
                                  "pagestore.miss": 40}}}),
    "sharded_leg": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 0.7,
         "bytes": 1 << 30},
        {"name": "assemble", "kind": "assemble", "wait_s": 0.9,
         "bytes": 1 << 30,
         "extra": {"assembly_path": "python-fused", "assemble_s": 0.2}}]),
        {}),
    "tenant": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.1,
         "bytes": 1 << 28}], tenant="feed"), {}),
    "decode_path": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.2,
         "bytes": 1 << 28, "extra": {"decode_path": "native"}}]), {}),
    "hot_frames": (_snap([
        {"name": "parse", "kind": "parse", "wait_s": 1.2,
         "bytes": 1 << 28}]),
        {"profile_doc": {"samples": 10, "threads": {"main": {
            "name": "main", "self": 0, "children": [
                {"name": "parser.py:parse_block", "self": 7,
                 "children": []},
                {"name": "native:parse", "self": 3, "children": []}]}}}}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_snapshot_gives_the_same_verdict(name):
    snap, kw = CASES[name]
    got = analyze.attribute(json.loads(json.dumps(snap)),
                            **json.loads(json.dumps(kw)))
    want = ref_analyze.attribute(json.loads(json.dumps(snap)),
                                 **json.loads(json.dumps(kw)))
    assert got == want
    assert sorted(got) == sorted(analyze.VERDICT_KEYS)
    json.dumps(got)


def test_pinned_keys_and_bounds_are_the_references():
    assert analyze.VERDICT_KEYS == ref_analyze.VERDICT_KEYS
    assert analyze.BOUNDS == ref_analyze.BOUNDS
    assert analyze.DEFAULT_TOLERANCE == ref_analyze.DEFAULT_TOLERANCE


@pytest.mark.parametrize("gauge", [None, 0.1, 0.3, 0.9, 1.6, 2.5, 7.0])
def test_gauge_band_matches_reference(gauge):
    assert analyze.gauge_band(gauge) == ref_analyze.gauge_band(gauge)


@pytest.mark.parametrize("a,b", [("BENCH_r04.json", "BENCH_r05.json"),
                                 ("BENCH_r05.json", "BENCH_r05.json"),
                                 ("BENCH_r01.json", "BENCH_r03.json")])
def test_compare_files_matches_reference(a, b):
    a, b = os.path.join(REPO, a), os.path.join(REPO, b)
    assert analyze.compare_files(a, b) == ref_analyze.compare_files(a, b)


@pytest.mark.parametrize("sustained", [0.9, 0.5, 1.4])
def test_compare_bands_match_reference(sustained):
    a = {"metric": "m", "value": 1.0, "epochs": 10, "run_band": "plateau",
         "parse_cpu_gbps_core": 1.0,
         "gauge_bands": {"plateau": {"epochs": 10, "sustained": 1.0},
                         "drained": {"epochs": 3, "sustained": 0.2}}}
    b = json.loads(json.dumps(a))
    b["gauge_bands"]["plateau"]["sustained"] = sustained
    got, want = analyze.compare(a, b), ref_analyze.compare(a, b)
    assert got == want
    assert (got["regressions"] != []) == (sustained == 0.5)


def test_diagnose_bench_matches_reference(tmp_path):
    snap, _ = CASES["parse_bound"]
    for doc in ({"metric": "m", "value": 1.0,
                 "analysis": ref_analyze.attribute(snap)},
                json.load(open(os.path.join(REPO, "BENCH_r05.json")))):
        p = tmp_path / "bench.json"
        p.write_text(json.dumps(doc))
        assert analyze.diagnose_bench(str(p)) == \
            ref_analyze.diagnose_bench(str(p))


@pytest.mark.parametrize("band", ["fast-burn", "slow-burn"])
def test_slo_verdict_matches_reference(band):
    row = {"metric": "tenant.feed.batch_s", "target": 0.25,
           "window_s": 30.0, "budget": 0.01, "attainment": 0.8,
           "budget_remaining": -19.0,
           "windows": {"fast_long": {"burn": 20.0, "good": 8,
                                     "total": 10},
                       "fast_short": {"burn": 20.0, "good": 4,
                                      "total": 5},
                       "long": {"burn": 20.0, "good": 8, "total": 10},
                       "short": {"burn": 20.0, "good": 4, "total": 5}},
           "alerts": {"fast": band == "fast-burn", "slow": True,
                      "firing": True}, "tenant": "feed"}
    got = analyze.slo_verdict("tenant.feed", row, epoch=3)
    want = ref_analyze.slo_verdict("tenant.feed", row, epoch=3)
    assert got == want
    assert (got["bound"], got["band"], got["tenant"]) == ("slo", band,
                                                          "feed")


def test_analyze_endpoint_serves_a_port_pipeline_verdict(tmp_path):
    from dmlc_tpu_torch.pipeline import Pipeline
    p = tmp_path / "a.libsvm"
    p.write_text("\n".join(f"{i % 2} 1:0.5 7:1.25 9:{i}.0"
                           for i in range(2000)) + "\n")
    built = (Pipeline.from_uri(str(p))
             .parse(format="libsvm", engine="python", chunk_size=2048)
             .batch(128).build())
    built.run_epoch()
    try:
        with StatusServer() as srv:
            v = _get(srv.url("/analyze"))
    finally:
        built.close()
    assert v["bound"] in analyze.BOUNDS and v["tenant"] is None
    assert sorted(v) == sorted(analyze.VERDICT_KEYS)
    assert v["stage_waits"]["stages"]


def test_analyze_endpoint_scopes_wire_counters_to_the_epoch():
    reg = MetricsRegistry()
    state = {"epoch": 1}

    class Holder:
        def stats(self):
            return _snap([{"name": "parse", "kind": "parse",
                           "wait_s": 1.4, "bytes": 1 << 30}]) \
                | {"epoch": state["epoch"]}

    h = Holder()
    reg.register("pipeline", h, Holder.stats)
    reg.counter("objstore.get").inc(50)
    reg.counter("objstore.bytes").inc(1 << 30)
    reg.counter("pagestore.miss").inc(40)
    reg.counter("pagestore.hit").inc(1)
    with StatusServer(registry=reg) as srv:
        assert _get(srv.url("/analyze"))["bound"] == "wire"
        state["epoch"] = 2   # a local epoch, no new wire traffic
        v2 = _get(srv.url("/analyze"))
    assert v2["bound"] != "wire"
    assert not any("objstore" in e for e in v2["evidence"])


@pytest.fixture
def criteo(tmp_path):
    """A small criteo-shaped corpus at the name config 13 reads first."""
    import numpy as np
    rng = np.random.RandomState(7)
    lines = []
    for i in range(2000):
        idx = np.unique(rng.randint(0, 10 ** 6, rng.randint(25, 45)))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.rand():.6f}"
                                            for j in idx))
    block = ("\n".join(lines) + "\n").encode()
    p = tmp_path / "dmlc_tpu_torch_bench_suite.criteo.libsvm"
    with open(p, "wb") as f:
        for _ in range((24 << 20) // len(block) + 1):
            f.write(block)
    return str(tmp_path)


def test_bench_analyze_block_counts_only_its_epoch(criteo):
    """Config 13: a schema-valid verdict with hot_frames, and wire
    counters left in the process registry by earlier work do not flip
    its local epoch to wire-bound. The registry's counters are put back
    afterwards (never reset wholesale, which would drop other modules'
    collectors)."""
    from dmlc_tpu_torch.bench_suite import bench_analyze
    names = ("objstore.get", "objstore.bytes", "pagestore.miss")
    before = {n: REGISTRY.counter(n).value for n in names}
    added = {"objstore.get": 5000, "objstore.bytes": 50 << 30,
             "pagestore.miss": 10000}
    try:
        for n, v in added.items():
            REGISTRY.counter(n).inc(v)
        out = bench_analyze(2, work=criteo)
    finally:
        for n, v in added.items():
            REGISTRY.counter(n).inc(-v)
    assert {n: REGISTRY.counter(n).value for n in names} == before
    v = out["analysis"]
    assert out["config"] == "analyze" and out["bytes"] >= 18 << 20
    assert sorted(v) == sorted(analyze.VERDICT_KEYS)
    assert v["bound"] != "wire" and v["hot_frames"]
    assert not any("objstore" in e for e in v["evidence"])
