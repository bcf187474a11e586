"""The port's trace plane (dmlc_tpu_torch.obs) against the JAX package's.

Twins of ``tests/test_obs.py``'s TestTraceRecorder, TestChromeExport,
TestPipelineTracing, TestMetricsRegistry, TestObsLog, TestGangTracing and
TestProfilerShim: each case makes the same calls on the reference's
modules and on the port's and compares what they leave.

- Recorder and export: equal ``chrome_events`` once ``ts``, ``pid`` and
  ``tid`` are dropped (ph, name, cat, args, order and thread names
  kept; the process name differs only by the package's name), and
  ``merge_chrome_files`` writes byte-identical JSON from the same files.
- Metrics and log: equal ``snapshot()`` values after equal counter,
  gauge and histogram calls; ``warn_limited`` returns the same sequence.
- Pipeline traces: one small libsvm file through the native engine at
  the same chunk size and thread count: equal multisets of the Python
  spans' (name, cat) and equal counts of native spans by name; the
  device stage's chain is traced under ``device=`` and under a
  replicated ``sharding=`` alike.
- Gang traces: ``launch_local(2, ..., trace_dir=d)`` leaves a
  ``trace-gang.json`` with one process per rank, as the reference's
  does (its supervisor's process is the one the port has not).
- ``cuda_trace`` on the CPU leaves the profiler stats ``jax_trace``
  leaves, writes a Chrome trace with its ``record_function`` span into
  ``log_dir``, and refuses ``cuda`` on a host without a card.
"""

import collections
import glob
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from dmlc_tpu.obs import export as ref_export
from dmlc_tpu.obs import log as ref_log
from dmlc_tpu.obs import metrics as ref_metrics
from dmlc_tpu.obs import trace as ref_trace
from dmlc_tpu.parallel import launch as ref_launch
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu.utils.logging import set_log_sink as ref_set_log_sink
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.obs import export, log, metrics, trace
from dmlc_tpu_torch.parallel import launch
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError, set_log_sink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"ref": (ref_trace, ref_export, ref_metrics, ref_log,
                 ref_set_log_sink),
         "port": (trace, export, metrics, log, set_log_sink)}
# the Python spans only one side emits, with the reason: none so far —
# the port's pinned staging emits the reference's device.assemble and
# device.xfer names. Queue waits are left out of the comparison: whether
# a consumer or producer blocks depends on thread timing, not the data.
ONE_SIDED_SPANS = {}
TIMING_CATS = ("queue",)


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts with tracing off and fresh log dedup state."""
    for tr, _, _, lg, _ in SIDES.values():
        tr.stop()
        lg.reset()
    yield
    for tr, _, _, lg, _ in SIDES.values():
        tr.stop()
        lg.reset()


def _write_libsvm(tmp_path, rows=600, name="obs.libsvm", seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        nnz = rng.randint(3, 9)
        idx = np.sort(rng.choice(500, nnz, replace=False))
        lines.append(f"{i % 2} " + " ".join(
            f"{j}:{v:.4f}" for j, v in zip(idx, rng.rand(nnz))))
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _record(tr):
    """One fixed sequence of recorder calls, the second thread's named."""
    rec = tr.start(capacity=64)
    with tr.span("work", "test", {"k": 1}):
        pass
    tr.instant("marker", "test", {"why": "x"})
    tr.counter("queue", {"depth": 3, "skip": "notnum", "flag": True})
    rec.complete("explicit", time.perf_counter(), 0.002, "pipeline",
                 {"bytes": 7})
    rec.complete_at("native/tokenize", time.perf_counter(), 0.001,
                    0x6E000002, "native", {"seq": 4})
    rec.instant_at("native/cache.hit", time.perf_counter(), 0x6E000001,
                   "native")
    rec.name_thread(0x6E000002, "native/worker-0")
    rec.name_thread(0x6E000001, "native/reader")

    def work():
        tr.instant("from-thread", "test")

    t = threading.Thread(target=work, name="obs-test-thread")
    t.start()
    t.join()
    tr.counter("ghost", {"s": "text only"})  # no numeric series: dropped
    assert tr.stop() is rec
    return rec


def _comparable(events):
    """Trace events without ts/pid/tid, durations to the millisecond (a
    measured span's few microseconds vary), thread names kept by value
    and the process name's package prefix dropped."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "pid", "tid")}
        if "dur" in e:
            e["dur"] = round(e["dur"] / 1e3)
        if e["ph"] == "M" and e["name"] == "process_name":
            name = e["args"]["name"]
            e["args"] = {"name": name.split(" ", 1)[1]}
        out.append(e)
    return out


# --------------------------------------------------------- recorder


@pytest.mark.parametrize("capacity,n", [(100, 3), (10, 25), (1, 4)])
def test_ring_buffer_equals_reference(capacity, n):
    got = {}
    for side, (tr, *_) in SIDES.items():
        rec = tr.start(capacity=capacity)
        for i in range(n):
            tr.instant(f"e{i}")
        tr.stop()
        got[side] = (rec.recorded, rec.dropped,
                     [e[:3] for e in rec.events()])
    assert got["port"] == got["ref"]
    assert got["port"][1] == max(0, n - capacity)


def test_recorder_events_equal_reference():
    ref, port = _record(ref_trace), _record(trace)
    strip = [(ph, name, cat, round(dur, 3), args)
             for ph, name, cat, _t, dur, _tid, args in ref.events()]
    assert [(ph, name, cat, round(dur, 3), args)
            for ph, name, cat, _t, dur, _tid, args in port.events()] == strip
    assert [e[0] for e in port.events()] == ["X", "i", "C", "X", "X", "i",
                                             "i"]
    assert port.events()[2][6] == {"depth": 3}  # numeric series only
    assert (sorted(port.thread_names().values())
            == sorted(ref.thread_names().values()))
    assert "obs-test-thread" in port.thread_names().values()


def test_off_is_noop_on_both():
    for tr, *_ in SIDES.values():
        assert tr.active() is None
        with tr.span("ghost"):
            pass
        tr.instant("ghost")
        tr.counter("ghost", {"x": 1})
        assert tr.stop() is None


def test_start_over_live_recorder_warns_as_reference():
    said = {}
    for side, (tr, _, _, _, sink) in SIDES.items():
        hits = []
        sink(lambda lvl, msg: hits.append(msg))
        try:
            tr.start()
            tr.instant("doomed")
            tr.start()  # replaces: the buffered event is gone
            tr.stop()
        finally:
            sink(None)
        said[side] = [m.split(": ", 1)[1] for m in hits]
    assert said["port"] == said["ref"]
    assert "replacing an active recorder" in said["port"][0]


def test_fallback_ring_interplay_equals_reference():
    got = {}
    for side, (tr, *_) in SIDES.items():
        fb = tr.TraceRecorder(16)
        tr.set_fallback(fb)
        tr.instant("into-fallback")
        explicit = tr.start(8)
        tr.instant("into-explicit")
        stopped = tr.stop()
        restored = tr.active() is fb
        tr.instant("fallback-again")
        cleared = tr.clear_fallback() is fb
        got[side] = ([e[1] for e in fb.events()],
                     [e[1] for e in explicit.events()],
                     stopped is explicit, restored, cleared,
                     tr.active() is None)
    assert got["port"] == got["ref"]


# --------------------------------------------------------- export


def test_chrome_events_equal_reference():
    ref = _comparable(ref_export.chrome_events(_record(ref_trace)))
    port = _comparable(export.chrome_events(_record(trace)))
    assert port == ref
    for e in export.chrome_events(_record(trace)):
        for key in ("ph", "ts", "pid", "tid", "name"):
            assert key in e, (key, e)


def test_write_chrome_envelope_equals_reference(tmp_path):
    docs = {}
    for side, (tr, ex, *_) in SIDES.items():
        path = str(tmp_path / f"{side}.json")
        ex.write_chrome(_record(tr), path, pid=4242, process_name="rank 0")
        docs[side] = json.load(open(path))
    assert docs["port"]["otherData"] == docs["ref"]["otherData"]
    assert docs["port"]["displayTimeUnit"] == docs["ref"]["displayTimeUnit"]
    assert (_comparable(docs["port"]["traceEvents"])
            == _comparable(docs["ref"]["traceEvents"]))
    xs = [e for e in docs["port"]["traceEvents"] if e["ph"] == "X"]
    assert xs and all("dur" in e for e in xs)


def test_rpc_flow_events_equal_reference():
    """A client/server span pair carrying a trace context renders the
    reference's Perfetto flow events (and a garbled context none)."""
    evs = {}
    for side, (tr, ex, *_) in SIDES.items():
        rec = tr.TraceRecorder()
        t = time.perf_counter()
        rec.complete("get", t, 0.001, tr.CAT_RPC_CLIENT,
                     {"trace": "abcd-01", "peer": "p"})
        rec.complete("serve", t, 0.001, tr.CAT_RPC_SERVER,
                     {"trace": "abcd-02"})
        rec.complete("bad", t, 0.001, tr.CAT_RPC_CLIENT, {"trace": "nodash"})
        evs[side] = _comparable(ex.chrome_events(rec))
    assert evs["port"] == evs["ref"]
    assert [e["ph"] for e in evs["port"] if e["name"] == "rpc.flow"] == [
        "s", "f"]


def test_rank_tag_from_env(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_TASK_ID", "3")
    names = {}
    for side, (tr, ex, *_) in SIDES.items():
        rec = tr.TraceRecorder()
        rec.instant("x")
        proc = [e for e in ex.chrome_events(rec) if e["ph"] == "M"
                and e["name"] == "process_name"][0]
        names[side] = proc["args"]["name"]
    assert names == {"ref": "dmlc_tpu rank 3", "port": "dmlc_tpu_torch rank 3"}


def test_merge_is_byte_identical(tmp_path):
    a = trace.TraceRecorder()
    a.complete("wa", time.perf_counter(), 0.001)
    b = ref_trace.TraceRecorder()
    b.complete("wb", time.perf_counter(), 0.001)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    export.write_chrome(a, pa, pid=1001, process_name="rank 0")
    ref_export.write_chrome(b, pb, pid=1002, process_name="rank 1")
    outs = {}
    for side, (_, ex, *_) in SIDES.items():
        out = str(tmp_path / f"gang-{side}.json")
        merged = ex.merge_chrome_files([pa, pb], out)
        outs[side] = open(out, "rb").read()
        assert {e["pid"] for e in merged["traceEvents"]} == {1001, 1002}
    assert outs["port"] == outs["ref"]


# --------------------------------------------------------- metrics, log


def _fill(reg):
    reg.counter("events").inc(3)
    reg.counter("events").inc()
    reg.gauge("tier").set("pages")
    reg.gauge("depth").set(np.int64(5))
    for v in (0.25, 1e-7, 0.0, 3.5, 0.25):
        reg.histogram("wait_s").observe(v)
    h = reg.histogram("lat", bounds=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)


def test_snapshot_equals_reference():
    snaps = {}
    for side, (_, _, me, *_) in SIDES.items():
        reg = me.MetricsRegistry()
        _fill(reg)

        class Surface:
            def stats(self):
                return {"produced": 7, "nested": {"a": (1, 2)}}

        class Broken:
            def stats(self):
                raise RuntimeError("torn down")

        s, b = Surface(), Broken()
        reg.register("queue/x", s, Surface.stats)
        reg.register("queue/x", s, Surface.stats)  # suffixed
        reg.register("broken", b, Broken.stats)
        snap = reg.snapshot()
        json.dumps(snap)
        snaps[side] = snap
    assert snaps["port"]["schema"] == snaps["ref"]["schema"] == 1
    for key in ("rank", "counters", "gauges", "histograms"):
        assert snaps["port"][key] == snaps["ref"][key], key
    assert sorted(snaps["port"]["collectors"]) == ["broken", "queue/x",
                                                  "queue/x#2"]
    assert (list(snaps["port"]["collectors"].values())
            == list(snaps["ref"]["collectors"].values()))


def test_histogram_bounds_refused_as_reference():
    for bad in ([], [0.0, 1.0], [2.0, 1.0]):
        with pytest.raises(ValueError):
            ref_metrics.Histogram(bounds=bad)
        with pytest.raises(ValueError):
            metrics.Histogram(bounds=bad)


def test_collector_weak_drop_and_merge():
    import gc
    for _, _, me, *_ in SIDES.values():
        reg = me.MetricsRegistry()

        class Surface:
            def stats(self):
                return {}

        s = Surface()
        name = reg.register("queue/x", s, Surface.stats)
        del s
        gc.collect()
        assert name not in reg.snapshot()["collectors"]
    snaps = [{"schema": 1, "pid": 10, "rank": 0},
             {"schema": 1, "pid": 11, "rank": 1},
             {"schema": 1, "pid": 12, "rank": None},
             {"schema": 1, "pid": 13, "rank": 0}]
    assert (metrics.merge_snapshots(snaps)
            == ref_metrics.merge_snapshots(snaps))


def test_named_queue_and_profiler_register():
    """A named ThreadedIter and the global profiler land in the port's
    one snapshot, and the queue leaves it at destroy()."""
    from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
    ti = ThreadedIter(max_capacity=2, name="reg.demo")
    src = iter([1, 2])
    ti.init(lambda: next(src, None))
    while ti.next() is not None:
        pass
    snap = metrics.REGISTRY.snapshot()
    keys = [k for k in snap["collectors"] if k.startswith("queue/reg.demo")]
    assert keys, snap["collectors"].keys()
    got = snap["collectors"][keys[0]]
    assert got["produced"] == 2 and got["capacity"] == 2
    assert "profiler" in snap["collectors"]
    ti.destroy()
    assert not [k for k in metrics.REGISTRY.snapshot()["collectors"]
                if k.startswith("queue/reg.demo")]


@pytest.mark.parametrize("rank,all_ranks", [(None, False), ("2", False),
                                            ("2", True)])
def test_warn_channel_equals_reference(monkeypatch, rank, all_ranks):
    if rank is None:
        monkeypatch.delenv("DMLC_TPU_TASK_ID", raising=False)
        monkeypatch.delenv("DMLC_TASK_ID", raising=False)
    else:
        monkeypatch.setenv("DMLC_TPU_TASK_ID", rank)
    got = {}
    for side, (tr, _, me, lg, sink) in SIDES.items():
        hits = []
        sink(lambda lvl, msg: hits.append(msg))
        rec = tr.start()
        before = dict(me.REGISTRY.snapshot()["counters"])
        try:
            calls = [lg.warn_once("k1", "first", all_ranks=all_ranks),
                     lg.warn_once("k1", "second", all_ranks=all_ranks),
                     lg.warn_once("k2", "other", all_ranks=all_ranks),
                     lg.warn_limited("r", "a", 60, all_ranks=all_ranks),
                     lg.warn_limited("r", "b", 60, all_ranks=all_ranks),
                     lg.warn_limited("r", "c", 0.0, all_ranks=all_ranks)]
        finally:
            sink(None)
            tr.stop()
        after = me.REGISTRY.snapshot()["counters"]
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith("log.suppressed") and v != before.get(k, 0)}
        got[side] = (calls, hits, delta,
                     [(e[1], e[6]) for e in rec.events()])
    assert got["port"] == got["ref"]


# --------------------------------------------------------- pipelines


def _trace_counts(path):
    evs = json.load(open(path))["traceEvents"]
    py = collections.Counter(
        (e["name"], e.get("cat")) for e in evs
        if e["ph"] == "C" or (e["ph"] in ("X", "i")
                              and e.get("cat") != "native"
                              and e.get("cat") not in TIMING_CATS))
    native = collections.Counter(e["name"] for e in evs
                                 if e.get("cat") == "native"
                                 and e["ph"] == "X")
    # the arena pool's hit or miss depends on when the consumer returned
    # an arena; their sum (one a chunk) does not
    native["native/cache"] = sum(1 for e in evs if e.get("cat") == "native"
                                 and e["ph"] == "i")
    # which parse worker took a chunk depends on thread timing: the
    # tracks are compared by role
    threads = {e["args"]["name"].rstrip("0123456789-") for e in evs
               if e["ph"] == "M" and e["name"] == "thread_name"
               and e["args"]["name"].startswith("native/")}
    return py, native, threads


def _chains(uri, cls):
    """The chains both packages lower alike: the native parse with its
    padded assembly, a prefetch queue and the host→device stage (the
    reference's on JAX's CPU, the port's to_device(device="cpu"))."""
    dev = {"device": "cpu"} if cls is Pipeline else {}
    if cls is Pipeline:
        from dmlc_tpu_torch.parallel.placement import NamedSharding, P
        from dmlc_tpu_torch.parallel.sharded import Mesh
        placed = NamedSharding(Mesh((2,), ("data",), device="cpu"), P())
    else:
        import jax
        from jax.sharding import Mesh as RefMesh
        from jax.sharding import NamedSharding as RefNS
        from jax.sharding import PartitionSpec as RefP
        placed = RefNS(RefMesh(np.array(jax.devices()[:2]), ("data",)),
                       RefP())
    parse = dict(format="libsvm", engine="native", chunk_size=64 << 10,
                 nthreads=2)
    return {
        "assemble+device": (cls.from_uri(uri).parse(**parse)
                            .batch(128, pad=True, nnz_bucket=128 * 10)
                            .to_device(window=2, **dev)),
        # a sharding target rides the same staged window and spans
        "assemble+sharding": (cls.from_uri(uri).parse(**parse)
                              .batch(128, pad=True, nnz_bucket=128 * 10)
                              .to_device(window=2, sharding=placed)),
        "parse+batch+prefetch": (cls.from_uri(uri).parse(**parse)
                                 .batch(100).prefetch(depth=2)),
    }


@pytest.mark.parametrize("chain", ["assemble+device", "assemble+sharding",
                                   "parse+batch+prefetch"])
def test_pipeline_trace_equals_reference(tmp_path, chain):
    if not native_available():
        pytest.skip("the port's native engine did not build")
    uri = _write_libsvm(tmp_path, rows=6000)
    got = {}
    for side, cls in (("ref", RefPipeline), ("port", Pipeline)):
        built = _chains(uri, cls)[chain].build()
        path = str(tmp_path / f"{side}.json")
        with built.trace(path):
            for _ in built:
                pass
        snap = built.stats()
        built.close()
        got[side] = _trace_counts(path)
        # span count == delivered items at every stage, with one .end
        py = got[side][0]
        for st in snap["stages"]:
            assert py[(f"pull/{st['name']}", "pipeline")] == st["items"]
            assert py[(f"pull/{st['name']}.end", "pipeline")] == 1
    (rpy, rnat, rthr), (ppy, pnat, pthr) = got["ref"], got["port"]
    for key in ONE_SIDED_SPANS:
        rpy.pop(key, None)
        ppy.pop(key, None)
    assert ppy == rpy
    assert pnat == rnat and sum(pnat.values()) > 0
    assert pthr == rthr
    assert ppy[("engine", "native")] == 1  # the engine's counter track
    if chain == "assemble+device":
        n = ppy[("pull/to_device", "pipeline")]
        assert ppy[("to_device.drain", "transfer")] == n
        assert ppy[("device.xfer", "transfer")] == n


def test_span_totals_match_probe_waits(tmp_path):
    """Per-stage span totals (delivered pulls + the end wait) agree with
    the probe's wait_s: the same perf_counter pair."""
    uri = _write_libsvm(tmp_path)
    built = (Pipeline.from_uri(uri)
             .parse(format="libsvm", engine="python", chunk_size=2048)
             .batch(64).prefetch(depth=2).build())
    path = str(tmp_path / "pipe.json")
    with built.trace(path):
        for _ in built:
            pass
    snap = built.stats()
    built.close()
    evs = json.load(open(path))["traceEvents"]
    for st in snap["stages"]:
        spans = [e for e in evs if e["ph"] == "X" and e["name"] in
                 (f"pull/{st['name']}", f"pull/{st['name']}.end")]
        assert len(spans) == st["items"] + 1, st["name"]
        total_s = sum(e["dur"] for e in spans) / 1e6
        assert total_s == pytest.approx(st["wait_s"], rel=0.10, abs=0.002)


def test_queue_wait_spans_present():
    from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
    rec = trace.start()
    ti = ThreadedIter(max_capacity=1, name="obs.demo")
    src = iter(range(8))
    ti.init(lambda: next(src, None))
    time.sleep(0.05)  # producer fills the 1-slot queue and blocks
    while ti.next() is not None:
        time.sleep(0.005)  # slow consumer: producer re-blocks
    ti.destroy()
    trace.stop()
    names = {(e[1], e[2]) for e in rec.events()}
    assert ("obs.demo.producer_wait", "queue") in names


def test_device_prefetch_spans():
    """Staged device_prefetch emits one device.assemble and one
    device.xfer span a batch, as the reference's does."""
    from dmlc_tpu_torch.parallel.device_iter import device_prefetch
    batches = [{"x": np.full(8, i, np.float32)} for i in range(5)]
    rec = trace.start()
    out = [b["x"][0].item() for b in device_prefetch(
        iter(batches), size=2, device="cpu", staging=True)]
    trace.stop()
    assert out == [0.0, 1.0, 2.0, 3.0, 4.0]
    names = collections.Counter(e[1] for e in rec.events())
    assert names["device.assemble"] == 5 and names["device.xfer"] == 5
    assert metrics.REGISTRY.gauge("device.staging").value == 0


# --------------------------------------------------------- gang


_GANG_WORKER = (
    "import sys\n"
    "from {pkg}.obs.trace import span, trace_if_env\n"
    "with trace_if_env():\n"
    "    with span('worker-work', 'test'):\n"
    "        pass\n")


def test_gang_trace_one_process_per_rank(tmp_path):
    procs = {}
    for side, (mod, pkg) in (("ref", (ref_launch, "dmlc_tpu")),
                             ("port", (launch, "dmlc_tpu_torch"))):
        d = str(tmp_path / side)
        os.makedirs(d)
        open(os.path.join(d, "trace-rank7.json"), "w").write("{}")  # stale
        codes = mod.launch_local(
            2, [sys.executable, "-c", _GANG_WORKER.format(pkg=pkg)],
            env={"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}, timeout=120,
            trace_dir=d)
        assert codes == [0, 0]
        assert not os.path.exists(os.path.join(d, "trace-rank7.json"))
        merged = json.load(open(os.path.join(d, "trace-gang.json")))
        evs = merged["traceEvents"]
        procs[side] = sorted(e["args"]["name"].split(" ", 1)[1] for e in evs
                             if e["name"] == "process_name")
        work = [e for e in evs if e["name"] == "worker-work"]
        assert len(work) == 2 and len({e["pid"] for e in work}) == 2
    # each package's gang supervisor exports its own process row
    assert procs["ref"] == sorted(["rank 0", "rank 1", "gang supervisor"])
    assert procs["port"] == procs["ref"]


def test_trace_if_env_and_merge(tmp_path, monkeypatch):
    d = str(tmp_path / "gang")
    monkeypatch.setenv("DMLC_TPU_TRACE_DIR", d)
    monkeypatch.setenv("DMLC_TPU_TASK_ID", "0")
    with trace.trace_if_env():
        with trace.span("worker-work"):
            pass
    assert os.path.exists(os.path.join(d, "trace-rank0.json"))
    out = launch.merge_gang_traces(d)
    assert out == ref_launch.merge_gang_traces(d)
    assert any(e.get("name") == "worker-work"
               for e in json.load(open(out))["traceEvents"])
    monkeypatch.delenv("DMLC_TPU_TRACE_DIR")
    with trace.trace_if_env():
        assert trace.active() is None
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert launch.merge_gang_traces(empty) is None
    assert ref_launch.merge_gang_traces(empty) is None


# --------------------------------------------------------- profiler, hook


def _stage_calls(tr):
    p = tr.Profiler()
    with p.stage("fold", nbytes=100, items=2):
        pass
    with p.stage("fold", nbytes=50):
        pass
    p.add("extra", seconds=0.5, nbytes=10, items=1)
    return {k: (v.calls, v.bytes, v.items) for k, v in p.stats().items()}


def test_profiler_stats_equal_reference():
    assert _stage_calls(trace) == _stage_calls(ref_trace)
    rec = trace.start()
    p = trace.Profiler()
    with p.stage("fold", nbytes=100, items=2):
        pass
    trace.stop()
    assert [(e[1], e[2], e[6]) for e in rec.events()] == [
        ("fold", "profiler", {"bytes": 100, "items": 2})]
    assert "fold" in p.report() and "GB/s" in p.report()


def test_cuda_trace_feeds_the_profiler_as_jax_trace(tmp_path):
    got = {}
    for side, run in (("ref", lambda n: ref_trace.jax_trace(n)),
                      ("port", lambda n: trace.cuda_trace(n,
                                                          device="cpu"))):
        prof = (ref_trace if side == "ref" else trace).profiler
        prof.reset()
        tr = ref_trace if side == "ref" else trace
        rec = tr.start()
        for name in ("step", "step", "eval"):
            with run(name):
                pass
        tr.stop()
        got[side] = ({k: (v.calls, v.bytes, v.items)
                      for k, v in prof.stats().items()},
                     [(e[1], e[2]) for e in rec.events()])
        prof.reset()
    assert got["port"] == got["ref"]


def test_cuda_trace_writes_a_chrome_trace(tmp_path):
    import torch
    log_dir = str(tmp_path / "prof")
    with trace.cuda_trace("hooked", log_dir=log_dir, device="cpu"):
        torch.ones(64).sum()
    files = glob.glob(os.path.join(log_dir, "hooked.*.pt.trace.json"))
    assert len(files) == 1
    evs = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "hooked" and e.get("ph") == "X"
               for e in evs), "no record_function span"
    # without log_dir: a record_function span under the caller's profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.cuda_trace("annotated", device="cpu"):
            torch.ones(8).sum()
    assert any(e.key == "annotated" for e in prof.key_averages())


def test_cuda_trace_refuses_a_missing_card():
    import torch
    assert not torch.cuda.is_available()  # the CPU test host
    with pytest.raises(DMLCError, match="CUDA card"):
        with trace.cuda_trace("x"):
            pass
    with pytest.raises(DMLCError, match="cuda or cpu"):
        with trace.cuda_trace("x", device="meta"):
            pass
    assert "x" not in trace.profiler.stats()


def test_profiler_shim_warns_and_aliases():
    import dmlc_tpu_torch.utils.profiler as shim
    with pytest.warns(DeprecationWarning):
        assert shim.Profiler is trace.Profiler
    with pytest.warns(DeprecationWarning):
        assert shim.trace is trace.cuda_trace
    with pytest.raises(AttributeError):
        shim.nothing  # noqa: B018


def test_timer_is_the_reference_clock():
    from dmlc_tpu.utils.timer import get_time as ref_get_time
    from dmlc_tpu_torch.utils.timer import get_time
    a, b, c = ref_get_time(), get_time(), ref_get_time()
    assert a <= b <= c
