"""The port's RPC trace-context plane (``dmlc_tpu_torch/obs/rpc.py``) held
to the reference's ``tests/test_rpc.py`` in the parts that need no
status server (its ``TestRpcEndpoint`` is twinned in
``tests/test_torch_serve.py``): the context and its wire form, the Perfetto flow events
of a client/server pair, the edge table and its registry collector, the
emulator's server half, one span a retried attempt (``guarded`` reports
an injected failure), and the tracing-off cost. The reference's ±20%
decomposition bar (``TestEmulatorDecomposition``) is a lower bound
here: the server half's handle time is at least the modeled wire delay,
and the client's at least the server's."""

import time

import pytest

import dmlc_tpu.obs.rpc as ref_rpc
import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
from dmlc_tpu_torch.obs import rpc
from dmlc_tpu_torch.obs import trace as obs_trace
from dmlc_tpu_torch.obs.export import chrome_events
from dmlc_tpu_torch.resilience import inject


@pytest.fixture(autouse=True)
def _clean_plane(tmp_path, monkeypatch):
    """Every test starts with a quiet tracing plane, an empty edge table
    and its own page-store root, and leaves no recorder, client or
    option behind."""
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "pagestore"))
    if "rpc" not in REGISTRY.snapshot()["collectors"]:
        REGISTRY.register("rpc", rpc.EDGES, rpc.RpcEdgeTable.stats)
    saved = ofs.options()
    rpc.EDGES.reset()
    yield
    if obs_trace.active() is not None:
        obs_trace.stop()
    rpc.EDGES.reset()
    inject.uninstall()
    objstore.configure(None, block_bytes=saved["block_bytes"],
                       hydrate=saved["hydrate"])


def _client_spans(evs, verb=None):
    out = [e for e in evs if e.get("cat") == obs_trace.CAT_RPC_CLIENT]
    if verb is not None:
        out = [e for e in out if e["args"]["verb"] == verb]
    return out


def _server_spans(evs):
    return [e for e in evs if e.get("cat") == obs_trace.CAT_RPC_SERVER]


class TestTraceContext:
    def test_wire_names_are_the_references(self):
        for name in ("TRACE_HEADER", "HANDLE_HEADER", "TRACE_FIELD",
                     "HANDLE_FIELD", "RPC_SCHEMA"):
            assert getattr(rpc, name) == getattr(ref_rpc, name)
        ctx = rpc.new_context()
        assert ref_rpc.parse(rpc.serialize(ctx)) == tuple(ctx)
        assert rpc.parse(ref_rpc.serialize(ref_rpc.new_context()))

    def test_roundtrip_and_wire_form(self):
        ctx = rpc.new_context()
        assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 8
        wire = rpc.serialize(ctx)
        assert wire == f"{ctx.trace_id}-{ctx.span_id}"
        assert rpc.parse(wire) == ctx

    def test_operation_pins_trace_id(self):
        obs_trace.start()
        try:
            with rpc.operation("io.objstore.get") as tid:
                a = rpc.new_context(tid)
                b = rpc.new_context(tid)
            assert a.trace_id == b.trace_id == tid
            assert a.span_id != b.span_id
        finally:
            obs_trace.stop()

    def test_parse_tolerates_garbage(self):
        for junk in (None, 42, "", "nodash", "-", "a-", "-b",
                     b"aaaa-bbbb", ["x-y"]):
            assert rpc.parse(junk) is None

    def test_inject_extract_header_and_field(self):
        ctx = rpc.new_context()
        hdrs = {}
        rpc.inject(ctx, hdrs)
        assert hdrs == {rpc.TRACE_HEADER: rpc.serialize(ctx)}
        assert rpc.extract(hdrs) == ctx
        payload = {"op": "join"}
        rpc.inject(ctx, payload, key=rpc.TRACE_FIELD)
        assert rpc.extract(payload, key=rpc.TRACE_FIELD) == ctx
        assert rpc.extract(object()) is None
        assert rpc.extract({}) is None

    def test_off_cost_mints_nothing(self):
        assert obs_trace.active() is None
        with rpc.operation("io.objstore.get") as op:
            assert op is None
            with rpc.client_span("get", "emulator") as call:
                assert call is None
                assert rpc.active_call() is None
        rpc.note_injected_failure("io.objstore.get")
        assert rpc.EDGES.view()["edges"] == []


class TestFlowEventGolden:
    """The Perfetto flow events of one pair: ph "s" inside the client
    slice, ph "f" + bp "e" inside the server slice, both bound by
    id == trace_id, with the keys the reference's export gives."""

    def _trace_one_pair(self, rpc_mod, trace_mod, export):
        rec = trace_mod.start()
        with rpc_mod.operation("io.objstore.get"):
            with rpc_mod.client_span("get", "127.0.0.1:9") as call:
                ctx = call.ctx
                with rpc_mod.emulated_server("get"):
                    time.sleep(0.002)
        trace_mod.stop()
        return export(rec), ctx

    def test_flow_golden_keys_match_the_reference(self):
        from dmlc_tpu.obs import trace as ref_trace
        from dmlc_tpu.obs.export import chrome_events as ref_chrome
        evs, ctx = self._trace_one_pair(rpc, obs_trace, chrome_events)
        ref_evs, _ = self._trace_one_pair(ref_rpc, ref_trace, ref_chrome)
        flows = [e for e in evs if e.get("name") == "rpc.flow"]
        ref_flows = [e for e in ref_evs if e.get("name") == "rpc.flow"]
        assert len(flows) == 2
        assert sorted((f["ph"], sorted(f)) for f in flows) == \
            sorted((f["ph"], sorted(f)) for f in ref_flows)
        start = [f for f in flows if f["ph"] == "s"]
        finish = [f for f in flows if f["ph"] == "f"]
        assert len(start) == 1 and len(finish) == 1
        for f in flows:
            assert f["cat"] == "rpc"
            assert f["id"] == ctx.trace_id
        assert finish[0]["bp"] == "e"
        assert "bp" not in start[0]

    def test_flow_ts_matches_owning_slice(self):
        evs, ctx = self._trace_one_pair(rpc, obs_trace, chrome_events)
        cl = _client_spans(evs, "get")[0]
        sv = _server_spans(evs)[0]
        flows = {f["ph"]: f for f in evs if f.get("name") == "rpc.flow"}
        assert flows["s"]["ts"] == cl["ts"]
        assert flows["f"]["ts"] == sv["ts"]
        assert cl["args"][rpc.TRACE_FIELD] == sv["args"][rpc.TRACE_FIELD]
        assert sv["args"]["handle_us"] >= 2000

    def test_no_flow_without_context(self):
        rec = obs_trace.start()
        with obs_trace.span("stage", "pipeline"):
            pass
        obs_trace.stop()
        assert [e for e in chrome_events(rec)
                if e.get("name") == "rpc.flow"] == []


class TestEdgeTable:
    def test_view_matches_the_reference_table(self):
        """The same observations give the reference's document."""
        port, ref = rpc.RpcEdgeTable(max_edges=4), \
            ref_rpc.RpcEdgeTable(max_edges=4)
        for t in (port, ref):
            for i in range(100):
                t.observe(f"peer:{i % 6}", "get", 1000.0 + 7 * i,
                          400.0 if i % 3 else None, ok=bool(i % 11))
        assert port.view() == ref.view()
        assert port.stats() == ref.stats()
        assert port.retire(["peer:1"]) == ref.retire(["peer:1"])
        assert port.view() == ref.view()

    def test_percentiles_and_residual(self):
        t = rpc.RpcEdgeTable()
        for i in range(100):
            t.observe("peer:1", "get", 1000.0 + i, 400.0)
        (edge,) = t.view()["edges"]
        assert edge["count"] == 100 and edge["errors"] == 0
        assert edge["attributed"] == 100
        assert edge["client_us"]["p50"] == pytest.approx(1050, abs=2)
        assert edge["client_us"]["p99"] == pytest.approx(1099, abs=1)
        assert edge["server_us"]["p50"] == 400.0
        assert edge["residual_us"]["p50"] == pytest.approx(650, abs=2)

    def test_residual_clamped_at_zero(self):
        t = rpc.RpcEdgeTable()
        t.observe("p", "get", 100.0, 250.0)
        (edge,) = t.view()["edges"]
        assert edge["residual_us"]["p50"] == 0.0

    def test_unattributed_edge_has_no_server_stats(self):
        t = rpc.RpcEdgeTable()
        t.observe("p", "stat", 50.0)
        (edge,) = t.view()["edges"]
        assert edge["attributed"] == 0
        assert edge["server_us"] is None and edge["residual_us"] is None

    def test_bounded_cardinality_folds_to_other(self):
        t = rpc.RpcEdgeTable(max_edges=4)
        for i in range(10):
            t.observe(f"peer:{i}", "get", 10.0)
        doc = t.view()
        peers = {e["peer"] for e in doc["edges"]}
        assert len(doc["edges"]) == 5  # 4 tracked + the overflow bucket
        assert "other" in peers
        other = next(e for e in doc["edges"] if e["peer"] == "other")
        assert other["count"] == 6

    def test_stats_totals_ride_the_collector(self):
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        rpc.EDGES.observe("p", "get", 100.0, 60.0)
        rpc.EDGES.observe("p", "get", 200.0, 80.0, ok=False)
        got = REGISTRY.snapshot()["collectors"]["rpc"]
        assert got["count"] == 2 and got["errors"] == 1
        assert got["attributed"] == 2
        assert got["client_us"] == pytest.approx(300.0)
        assert got["server_us"] == pytest.approx(140.0)
        assert got["residual_us"] == pytest.approx(160.0)

    def test_membership_change_retires_departed_peers(self):
        rpc.EDGES.observe("h:1", "get", 10.0)
        rpc.EDGES.observe("h:2", "get", 10.0)
        rpc.membership_changed({"roster": [{"host": "h", "port": 1},
                                           {"host": "h", "port": 2}]})
        assert rpc.membership_changed(
            {"roster": [{"host": "h", "port": 1}]}) == 1
        assert [e["peer"] for e in rpc.view()["edges"]] == ["h:1"]
        rpc.membership_changed({"roster": []})


class TestEmulatorDecomposition:
    def test_server_handle_at_least_the_modeled_delay(self, tmp_path):
        """The edge table splits client latency into the emulator's
        handle time and a residual. Held as lower bounds (a loaded host
        only adds time): every GET is attributed, the server's p50 is at
        least the modeled 20 ms, and the client's at least the
        server's."""
        modeled_s = 0.02
        em = objstore.configure(root=str(tmp_path / "root"),
                                latency_s=modeled_s,
                                block_bytes=1 << 16)
        em.put("b", "k.bin", b"x" * (1 << 17))  # 2 blocks
        obs_trace.start()
        try:
            s = create_seek_stream_for_read("obj://b/k.bin")
            got = 0
            while True:
                chunk = s.read(1 << 20)
                if not chunk:
                    break
                got += len(chunk)
            s.close()
        finally:
            obs_trace.stop()
        assert got == 1 << 17
        edges = {(e["peer"], e["verb"]): e
                 for e in rpc.view()["edges"]}
        get = edges[("emulator", "get")]
        assert get["attributed"] == get["count"] >= 2
        assert get["server_us"]["p50"] >= modeled_s * 1e6
        assert get["client_us"]["p50"] >= get["server_us"]["p50"]
        assert get["residual_us"]["p50"] >= 0.0


class TestChaosPerAttemptSpans:
    def test_injected_retries_are_countable_spans(self, tmp_path):
        """A FaultPlan-injected retry at io.objstore.get gives one client
        span an ATTEMPT (``guarded`` reports each injected failure), all
        sharing the pinned trace_id."""
        em = objstore.configure(root=str(tmp_path / "root"))
        em.put("b", "k.bin", b"z" * (1 << 14))
        inject.install("site=io.objstore.get,fault=ioerror,times=2")
        rec = obs_trace.start()
        try:
            s = create_seek_stream_for_read("obj://b/k.bin")
            data = s.read(1 << 20)
            s.close()
        finally:
            obs_trace.stop()
            inject.uninstall()
        assert len(data) == 1 << 14
        spans = _client_spans(chrome_events(rec), "get")
        assert len(spans) == 3  # 2 injected failures + the success
        oks = sorted(e["args"]["ok"] for e in spans)
        assert oks == [False, False, True]
        assert sum(bool(e["args"].get("injected")) for e in spans) == 2
        tids = {e["args"][rpc.TRACE_FIELD].split("-")[0] for e in spans}
        assert len(tids) == 1, "attempts must share the trace_id"
        span_ids = {e["args"][rpc.TRACE_FIELD] for e in spans}
        assert len(span_ids) == 3, "each attempt is its own span"
        edge = next(e for e in rpc.view()["edges"]
                    if e["verb"] == "get")
        assert edge["errors"] == 2


class TestTracingOffOverhead:
    def test_off_overhead_smoke_under_2pct(self, tmp_path):
        """With tracing OFF the rpc seams cost one global read + branch
        an edge: judged against tracing ON on the quietest interleaved
        pair, the off epochs stay within 2% (+ 10 ms of slack)."""
        em = objstore.configure(root=str(tmp_path / "root"),
                                block_bytes=1 << 20, hydrate=False)
        em.put("b", "big.bin", b"q" * (1 << 22))  # 4 x 1MiB GETs

        def epoch_wall():
            t0 = time.perf_counter()
            s = create_seek_stream_for_read("obj://b/big.bin")
            while s.read(1 << 20):
                pass
            s.close()
            return time.perf_counter() - t0

        epoch_wall()  # warm imports/caches outside the measurement
        off, on = [], []
        for _ in range(5):
            off.append(epoch_wall())
            obs_trace.start()
            try:
                on.append(epoch_wall())
            finally:
                obs_trace.stop()
        grace = 0.010 / min(off)  # flat 10 ms, scaled to the wall
        ratios = [a / b for a, b in zip(on, off)]
        assert min(ratios) <= 1.02 + grace, (on, off, ratios)
