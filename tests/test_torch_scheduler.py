"""The port's multi-tenant scheduler (``dmlc_tpu_torch/pipeline/
scheduler.py``) and streaming split (``dmlc_tpu_torch/io/
streaming_split.py``) against the reference's.

Twins of ``tests/test_scheduler.py`` and ``tests/test_streaming.py``:
the same deterministic sequence of acquires, admissions and releases
leaves the same ``/tenants`` document (DRR credits, burst allowance,
queue shares split by weight) in both packages; a lone tenant runs
unthrottled; pause parks a puller (watchdog-visible as
``tenant/<name>.paused``) until resume; admission rejects or queues; a
tenant pipeline bills its pulls, rows and batch latencies, stamps its
snapshot and hands its queue knobs to the scheduler, which shrinks a
tenant's share when another is admitted; ``DMLC_TPU_SCHED``'s options.
For streaming: the same appends give the same records, the same windows
and the same watermark in both packages, the watermark advances
monotonically, ``stop()`` drains an unterminated tail, a shrunk source
raises, and a streamed pipeline epoch hashes as the reference's and as a
finite epoch over the finished file. The fixture uninstalls every
scheduler; a paused tenant is resumed before its pipeline closes.
"""

import json
import threading
import time
import urllib.request

import pytest

from dmlc_tpu.io.streaming_split import StreamingSplit as RefStreamingSplit
from dmlc_tpu.obs.metrics import MetricsRegistry as RefRegistry
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu.pipeline import scheduler as ref_sched
from dmlc_tpu_torch.io import StreamingSplit
from dmlc_tpu_torch.obs import watchdog as obs_watchdog
from dmlc_tpu_torch.obs.metrics import MetricsRegistry
from dmlc_tpu_torch.obs.serve import StatusServer
from dmlc_tpu_torch.pipeline import (
    AdmissionError, Pipeline, PipelineScheduler,
)
from dmlc_tpu_torch.pipeline import scheduler as sched_mod
from dmlc_tpu_torch.utils.logging import DMLCError


@pytest.fixture(autouse=True)
def _schedulers_clean():
    for m in (sched_mod, ref_sched):
        m.uninstall()
    yield
    for m in (sched_mod, ref_sched):
        m.uninstall()


def _libsvm_file(tmp_path, name="t.libsvm", rows=600):
    p = tmp_path / name
    p.write_text("".join(f"{i % 2} {i % 40 + 1}:1.5 {i % 70 + 3}:2.25\n"
                         for i in range(rows)))
    return str(p)


def test_constants_are_the_references():
    assert sched_mod.MANAGED_KNOBS == ref_sched.MANAGED_KNOBS
    assert sched_mod.ENV_SCHED == ref_sched.ENV_SCHED
    assert sched_mod.TENANTS_SCHEMA == ref_sched.TENANTS_SCHEMA


class _P:
    """A stand-in admitted pipeline with one queue knob."""

    def __init__(self):
        self.depth = 4
        from dmlc_tpu_torch.pipeline.autotune import Knob
        self._knob = Knob("prefetch.depth", "prefetch",
                          lambda: self.depth,
                          lambda n: setattr(self, "depth", n), lo=1, hi=64)

    def knobs(self):
        return [self._knob]


def _plan(mod, reg_cls):
    """One deterministic plan: three tenants, admissions and a release,
    single-threaded acquires (a lone demander advances rounds itself)."""
    s = mod.PipelineScheduler(quantum=2.0, burst=2.0, queue_budget=24,
                              registry=reg_cls())
    s.register_tenant("a", weight=1.0)
    s.register_tenant("b", weight=3.0, max_pipelines=2)
    s.register_tenant("c", weight=2.0, admission="queue")
    pipes = {n: _P() for n in ("a", "b1", "b2", "c")}
    s.admit("a", pipes["a"])
    s.admit("b", pipes["b1"])
    s.admit("b", pipes["b2"])
    s.admit("c", pipes["c"])
    for name in ("a",) * 7 + ("b",) * 11 + ("c",) * 5:
        s.acquire(name)
    with pytest.raises(mod.AdmissionError):
        s.admit("b", _P())
    s.release(pipes["b2"])
    shares = {n: p.depth for n, p in pipes.items()}
    doc = s.to_dict()
    s.close()
    return doc, shares


def _strip(doc):
    out = json.loads(json.dumps(doc))
    for row in out["tenants"].values():
        for k in ("credit_wait_s", "batch_p50_s", "batch_p99_s"):
            row.pop(k, None)
    return out


def test_same_plan_gives_the_same_tenants_document():
    got, got_shares = _plan(sched_mod, MetricsRegistry)
    want, want_shares = _plan(ref_sched, RefRegistry)
    assert _strip(got) == _strip(want)
    assert got_shares == want_shares
    rows = got["tenants"]
    assert (rows["b"]["rejected"], rows["b"]["admitted"]) == (1, 2)
    assert rows["b"]["pipelines"] == 1


def test_lone_tenant_is_unthrottled_and_keeps_its_burst():
    s = PipelineScheduler(quantum=2.0, burst=2.0,
                          registry=MetricsRegistry())
    s.register_tenant("a", weight=3.0)
    for _ in range(50):
        s.acquire("a")
    assert s.to_dict()["tenants"]["a"]["credit_waits"] == 0
    assert s.rounds >= 8
    with s._cond:
        assert s._tenants["a"].deficit <= 2.0 * 2.0 * 3.0 + 1e-9
    s.acquire("a", cost=1e9)  # clamped to the burst: no deadlock
    with pytest.raises(DMLCError, match="unknown tenant"):
        s.acquire("ghost")
    s.close()


def test_weighted_interleave():
    s = PipelineScheduler(quantum=2.0, active_horizon_s=5.0,
                          round_period_s=5.0, registry=MetricsRegistry())
    s.register_tenant("small", weight=1.0)
    s.register_tenant("big", weight=3.0)
    counts = {"small": 0, "big": 0}
    stop = time.monotonic() + 1.0

    def burn(name):
        while time.monotonic() < stop:
            s.acquire(name)
            counts[name] += 1

    ts = [threading.Thread(target=burn, args=(n,)) for n in counts]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    s.close()
    ratio = counts["big"] / max(counts["small"], 1)
    assert 2.0 <= ratio <= 4.5, (counts, ratio)


def test_pause_parks_a_named_wait_until_resume():
    s = PipelineScheduler(registry=MetricsRegistry())
    s.register_tenant("victim")
    s.pause("victim")
    got = threading.Event()
    wd = obs_watchdog.Watchdog(threshold_s=0.1, interval_s=0.05).start()

    def puller():
        s.acquire("victim")
        got.set()

    t = threading.Thread(target=puller, daemon=True)
    t.start()
    try:
        assert not got.wait(0.3)
        deadline = time.monotonic() + 5.0
        while not wd.reports and time.monotonic() < deadline:
            time.sleep(0.05)
        names = [b["name"] for r in wd.reports for b in r["blocked"]]
        assert "tenant/victim.paused" in names
    finally:
        wd.stop()
        s.resume("victim")
    assert got.wait(2.0)
    t.join()
    s.close()


def test_queue_admission_waits_for_a_slot_or_times_out():
    s = PipelineScheduler(registry=MetricsRegistry())
    s.register_tenant("a", max_pipelines=1, admission="queue")
    p1, p2 = _P(), _P()
    s.admit("a", p1)
    with pytest.raises(AdmissionError, match="timed out"):
        s.admit("a", _P(), timeout_s=0.2)
    admitted = threading.Event()
    t = threading.Thread(target=lambda: (s.admit("a", p2, timeout_s=5.0),
                                         admitted.set()), daemon=True)
    t.start()
    assert not admitted.wait(0.3)
    s.release(p1)
    assert admitted.wait(3.0)
    t.join()
    s.close()


def test_tenant_epoch_bills_and_matches_reference(tmp_path):
    """A tenant pipeline bills one pull a batch, its rows and bytes and
    a verdict citing the tenant, in both packages alike; the row leaves
    with the pipeline."""
    path = _libsvm_file(tmp_path)
    rows = {}
    for mod, P in ((sched_mod, Pipeline), (ref_sched, RefPipeline)):
        s = mod.install(quantum=8.0)
        s.register_tenant("job")
        built = (P.from_uri(path).parse(format="libsvm", engine="python")
                 .batch(128).build(tenant="job"))
        n = sum(1 for _ in built)
        row = s.to_dict()["tenants"]["job"]
        v = s._tenants["job"].last_verdict
        assert row["last_verdict"]["verdict_id"] == v["verdict_id"]
        assert built.stats()["tenant"] == "job"
        built.close()
        assert s.to_dict()["tenants"]["job"]["pipelines"] == 0
        rows[P] = (n, row["pulls"], row["rows"], row["batches"],
                   v["tenant"], v["bound"] is not None)
        mod.uninstall()
    assert rows[Pipeline] == rows[RefPipeline] == (5, 5, 600, 5, "job",
                                                   True)


def test_queue_budget_rebalances_on_admission(tmp_path):
    path = _libsvm_file(tmp_path)
    s = sched_mod.install(queue_budget=32)
    s.register_tenant("a")
    s.register_tenant("b")
    pa = (Pipeline.from_uri(path).parse(format="libsvm", engine="python")
          .batch(64).prefetch(depth="auto").build(tenant="a"))
    knob = next(k for k in pa.knobs() if k.name == "prefetch.depth")
    assert knob.get() == 32
    pb = (Pipeline.from_uri(path).parse(format="libsvm", engine="python")
          .batch(64).prefetch(depth="auto").build(tenant="b"))
    assert knob.get() == 16
    pb.close()
    assert knob.get() == 32
    pa.close()


def test_tenants_endpoint_serves_rows(tmp_path):
    path = _libsvm_file(tmp_path)
    s = sched_mod.install()
    s.register_tenant("svc", weight=2.0)
    built = (Pipeline.from_uri(path).parse(format="libsvm")
             .batch(128).build(tenant="svc"))
    try:
        for _ in built:
            pass
        with StatusServer() as srv:
            with urllib.request.urlopen(srv.url("/tenants"),
                                        timeout=5) as r:
                doc = json.load(r)
    finally:
        built.close()
    assert doc["schema"] == sched_mod.TENANTS_SCHEMA
    row = doc["tenants"]["svc"]
    assert row["pulls"] > 0 and row["weight"] == 2.0
    assert row["last_verdict"]["bound"]


# ---------------------------------------------------------- yield points

def _heavy_light(preempt_s):
    reg = MetricsRegistry()
    s = PipelineScheduler(registry=reg)
    s.preempt_s = preempt_s
    s.register_tenant("light", weight=1.0)
    s.register_tenant("peer", weight=1.0)
    s.register_tenant("heavy", weight=4.0)
    return s, reg


def _timed(fn):
    """Run fn on a thread; returns (done event, [seconds it took])."""
    done, took = threading.Event(), []

    def run():
        t0 = time.monotonic()
        fn()
        took.append(time.monotonic() - t0)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    return done, took


@pytest.mark.parametrize("hold", ["yield_point", "acquire"])
def test_a_heavier_pull_in_flight_holds_a_lighter_tenant(hold):
    s, reg = _heavy_light(preempt_s=30.0)
    with s.pulling("heavy"):
        done, _ = _timed(lambda: getattr(s, hold)("light"))
        assert not done.wait(0.3)
    assert done.wait(2.0)
    assert reg.counter("tenant.light.preempt_waits").value == 1
    # the hold is not a credit wait: nothing billed to the DRR columns
    row = s.to_dict()["tenants"]["light"]
    assert (row["credit_waits"], row["credit_wait_s"]) == (0, 0.0)
    s.close()


def test_the_hold_ends_after_preempt_s_of_the_heavier_pull():
    s, reg = _heavy_light(preempt_s=0.15)
    with s.pulling("heavy"):
        done, took = _timed(lambda: s.yield_point("light"))
        assert done.wait(2.0)
        assert 0.1 <= took[0] < 1.0, took
        # past preempt_s the pull holds nobody: the next point is free
        t0 = time.monotonic()
        s.yield_point("light")
        assert time.monotonic() - t0 < 0.05
    assert reg.counter("tenant.light.preempt_waits").value == 1
    s.close()


@pytest.mark.parametrize("pulling,waiter", [
    ("peer", "light"),    # equal weights: DRR alone decides
    ("light", "heavy"),   # a lighter pull never holds a heavier one
    ("light", "light"),   # nor a tenant its own second thread
])
def test_no_hold_without_a_heavier_pull(pulling, waiter):
    s, reg = _heavy_light(preempt_s=30.0)
    with s.pulling(pulling):
        t0 = time.monotonic()
        s.yield_point(waiter)
        s.acquire(waiter)
        assert time.monotonic() - t0 < 0.5
    assert reg.counter(f"tenant.{waiter}.preempt_waits").value == 0
    s.close()


def test_concurrent_pulls_leave_no_pull_in_flight():
    """Many threads (more than cores) enter and leave pulls of three
    weights under a short switch interval: every entry is removed, so
    no phantom pull holds anybody afterwards."""
    import sys
    s, _ = _heavy_light(preempt_s=0.001)
    names = ("light", "peer", "heavy")
    errors = []

    def worker(i):
        try:
            for _ in range(200):
                with s.pulling(names[i % 3]):
                    s.yield_point(names[(i + 1) % 3])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(24)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    assert s._inflight == {} and s._inflight_view == ()
    s.close()


def test_pause_lands_at_the_next_yield_point():
    s, _ = _heavy_light(preempt_s=0.0)
    s.pause("light")
    done, _ = _timed(lambda: s.yield_point("light"))
    assert not done.wait(0.3)
    s.resume("light")
    assert done.wait(2.0)
    s.pause("light")
    done, _ = _timed(lambda: s.yield_point("light"))
    assert not done.wait(0.2)
    s.close()  # closing releases a paused yield point too
    assert done.wait(2.0)


def test_tenant_parse_reaches_yield_points_and_parses_the_same(
        tmp_path, monkeypatch):
    path = _libsvm_file(tmp_path, rows=2000)
    s = sched_mod.install()
    s.register_tenant("py")
    calls = []
    real = s.yield_point
    monkeypatch.setattr(s, "yield_point",
                        lambda name: (calls.append(name), real(name)))

    def hashes(built):
        try:
            return [b.content_hash() for b in built]
        finally:
            built.close()

    def chain(mod):
        return (mod.from_uri(path)
                .parse(format="libsvm", engine="python",
                       chunk_size=16 << 10).batch(256))

    got = hashes(chain(Pipeline).build(tenant="py"))
    assert calls and set(calls) == {"py"}
    # one point per EVERY records of each chunk, over the whole file
    assert 2000 // 16 <= len(calls) <= 2000 // 16 + 64
    assert got == hashes(chain(Pipeline).build())
    assert got == hashes(chain(RefPipeline).build())


@pytest.mark.parametrize("spec,want", [
    ("quantum=3,queue=9,burst=4", (3.0, 9, 4.0)),
    ("1", None), ("quantum=4,queue=32", (4.0, 32, None))])
def test_install_if_env_matches_reference(monkeypatch, spec, want):
    monkeypatch.setenv(sched_mod.ENV_SCHED, spec)
    s, r = sched_mod.install_if_env(), ref_sched.install_if_env()
    assert (s.quantum, s.queue_budget, s.burst) == \
        (r.quantum, r.queue_budget, r.burst)
    if want is not None:
        assert (s.quantum, s.queue_budget) == want[:2]
        if want[2] is not None:
            assert s.burst == want[2]
    sched_mod.uninstall()
    monkeypatch.setenv(sched_mod.ENV_SCHED, "0")
    assert sched_mod.install_if_env() is None


# ------------------------------------------------------------ streaming

def _lines(n, start=0):
    return [f"{(i + start) % 2} {(i % 50) + 1}:{i * 0.5}\n"
            for i in range(n)]


def _chunks(cls, path, **kw):
    split = cls(path, **kw)
    out = []
    while (chunk := split.next_chunk()) is not None:
        out.append(bytes(chunk))
    wm = dict(split.watermark())
    wm.pop("last_advance_s_ago")
    return out, wm


@pytest.mark.parametrize("kw", [
    {"window_records": 100}, {"window_records": 7},
    {"window_records": 10 ** 6, "chunk_size": 4096}])
def test_finished_file_streams_as_the_reference(tmp_path, kw):
    """All bytes present before the first poll: the same windows and the
    same final watermark in both packages."""
    path = tmp_path / "feed.libsvm"
    path.write_text("".join(_lines(600)))
    kw = {"poll_interval_s": 0.01, "idle_timeout_s": 0.2, **kw}
    got = _chunks(StreamingSplit, str(path), **kw)
    want = _chunks(RefStreamingSplit, str(path), **kw)
    assert got[0] == want[0]
    assert {k: v for k, v in got[1].items() if k != "uri"} == \
        {k: v for k, v in want[1].items() if k != "uri"}
    assert got[1]["watermark_records"] == 600 and got[1]["ended"]


class _Writer:
    def __init__(self, path, total=1200, slice_rows=150, interval_s=0.02):
        self.path = str(path)
        self.rows = _lines(total)
        self.slice_rows = slice_rows
        self.interval_s = interval_s
        self.thread = threading.Thread(target=self._run, daemon=True)
        open(self.path, "w").close()

    def _run(self):
        with open(self.path, "a") as f:
            for i in range(0, len(self.rows), self.slice_rows):
                f.write("".join(self.rows[i:i + self.slice_rows]))
                f.flush()
                time.sleep(self.interval_s)

    def start(self):
        self.thread.start()
        return self


def test_growing_file_streams_every_record_with_a_monotone_watermark(
        tmp_path):
    w = _Writer(tmp_path / "feed.libsvm").start()
    split = StreamingSplit(w.path, window_records=128, poll_interval_s=0.01,
                           idle_timeout_s=0.5)
    marks, records = [], []
    while (chunk := split.next_chunk()) is not None:
        wm = split.watermark()
        marks.append((wm["windows"], wm["watermark_bytes"],
                      wm["watermark_records"]))
        records += [ln for ln in bytes(chunk).splitlines() if ln]
    w.thread.join()
    assert records == [ln.strip().encode() for ln in w.rows]
    assert len(marks) >= 4
    for a, b in zip(marks, marks[1:]):
        assert b[0] > a[0] and b[1] > a[1] and b[2] > a[2]
    assert split.watermark()["ended"] is True


@pytest.mark.parametrize("cls", [StreamingSplit, RefStreamingSplit])
def test_stop_drains_an_unterminated_tail(tmp_path, cls):
    path = tmp_path / "feed.libsvm"
    path.write_text("1 2:1.5\n0 3:2.5")
    split = cls(str(path), poll_interval_s=0.01)
    split.stop()
    assert list(split) == [b"1 2:1.5", b"0 3:2.5"]


def test_shrunk_source_raises_and_no_rewind(tmp_path):
    path = tmp_path / "feed.libsvm"
    path.write_text("".join(_lines(50)))
    split = StreamingSplit(str(path), window_records=10,
                           poll_interval_s=0.01, idle_timeout_s=0.2)
    assert split.next_chunk() is not None
    assert split.rewindable is False
    path.write_text("1 1:1\n")
    with pytest.raises(DMLCError):
        while split.next_chunk() is not None:
            pass


def test_streamed_epoch_hashes_as_reference_and_finite(tmp_path):
    """A streamed pipeline epoch over a growing file: the same batches as
    the reference's streamed epoch over the same appends, and as a
    finite epoch over the finished file."""
    hashes = {}
    for P in (Pipeline, RefPipeline):
        w = _Writer(tmp_path / f"feed-{P.__module__}.libsvm").start()
        with (P.from_stream(w.path, window_records=256,
                            poll_interval_s=0.01, idle_timeout_s=0.5)
              .parse(format="libsvm").batch(512).build()) as built:
            hashes[P] = [b.content_hash() for b in built]
            w.thread.join()
            wm = built.stream_stats()
            assert wm["watermark_records"] == 1200
        finite = (Pipeline.from_uri(w.path)
                  .parse(format="libsvm", engine="python")
                  .batch(512).build())
        assert [b.content_hash() for b in finite] == hashes[P]
        finite.close()
    assert hashes[Pipeline] == hashes[RefPipeline]


def test_streaming_tenant_row_carries_the_watermark(tmp_path):
    w = _Writer(tmp_path / "feed.libsvm", total=400, slice_rows=100).start()
    s = sched_mod.install()
    s.register_tenant("feed")
    with (Pipeline.from_stream(w.path, window_records=128,
                               poll_interval_s=0.01, idle_timeout_s=0.5)
          .parse(format="libsvm").batch(128).build(tenant="feed")) as b:
        n = sum(1 for _ in b)
        w.thread.join()
        row = s.to_dict()["tenants"]["feed"]
    assert row["pulls"] == n > 0
    assert row["watermark"]["watermark_records"] == 400


def test_stream_refuses_what_the_reference_refuses(tmp_path):
    p = Pipeline.from_stream(str(tmp_path / "x.libsvm"))
    with pytest.raises(DMLCError, match="cache"):
        p.parse(format="libsvm").cache().batch(8).build()
    with pytest.raises(DMLCError, match="shuffle"):
        p.shuffle(num_shuffle_parts=2).parse(format="libsvm").build()
