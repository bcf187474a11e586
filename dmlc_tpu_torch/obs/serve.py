"""Live telemetry plane: an in-process, stdlib-only HTTP status server.

Copy of ``dmlc_tpu/obs/serve.py`` with its imports rewritten to
``dmlc_tpu_torch``: the exposition, the endpoints, their JSON shapes and
the ``/pages`` headers are the reference's, so a scrape or a peer of
either package reads the other's server. A production data plane is
monitored while it runs; one daemon thread per rank serves:

- ``GET /metrics`` — Prometheus text exposition (0.0.4) rendered from
  :meth:`~dmlc_tpu_torch.obs.metrics.MetricsRegistry.snapshot`: counters
  as ``dmlc_*_total``, numeric gauges as gauges, STRING gauges as
  labeled info-style series (``dmlc_<name>_info{value="pages"} 1`` — a
  ``Gauge.set("pages")`` must not emit an invalid exposition line), any
  other non-numeric gauge skipped and counted in
  ``dmlc_obs_export_skipped_total``, histograms with cumulative
  ``_bucket{le=...}`` series, and collector dicts flattened to numeric
  leaves labeled by collector/key;
- ``GET /metrics.json`` — the raw versioned snapshot (what
  :func:`scrape_gang` fetches to merge a gang);
- ``GET /healthz`` — liveness + the instrumented pulls blocked right
  now (:func:`dmlc_tpu_torch.obs.watchdog.current_waits`);
- ``GET /stacks`` — an all-thread stack dump;
- ``GET /trace?seconds=N`` — an on-demand bounded Perfetto capture of
  the RUNNING process: installs a recorder for N seconds when none is
  active (restoring the flight ring after), or lets an active ring
  accumulate N more seconds, then returns the Chrome trace-event JSON;
- ``GET /rpc`` — the RPC edge table (:func:`dmlc_tpu_torch.obs.rpc.view`);
- ``GET /history[?seconds=N]`` — the shared time-series ring
  (:mod:`dmlc_tpu_torch.obs.timeseries`): this rank's metric history,
  optionally trimmed to the trailing N seconds;
- ``GET /gang[?seconds=N]`` — the gang aggregator's merged view
  (:mod:`dmlc_tpu_torch.obs.aggregate`, rank 0 / launcher): per-rank
  series, rollups, explicit unreachable-rank gaps; plus a ``membership``
  section (roster, ranks, membership epoch) whenever this process has
  joined a :mod:`dmlc_tpu_torch.rendezvous` gang;
- ``GET /tenants`` — the multi-tenant scheduler's per-tenant rows
  (:mod:`dmlc_tpu_torch.pipeline.scheduler`): budget, live pipelines,
  credits/deficit, queue share and occupancy, batch p50/p99, streaming
  watermark, last bound verdict (404 with an enable hint until a
  scheduler is installed, like ``/history``);
- ``GET /slo`` — declared objectives judged live
  (:mod:`dmlc_tpu_torch.obs.slo`): per-objective windowed attainment,
  error-budget remaining, and multi-rate burn alerts (404 with an
  enable hint until an objective is registered);
- ``GET /analyze`` — a bottleneck-attribution verdict
  (:mod:`dmlc_tpu_torch.obs.analyze`) over the last completed pipeline
  epoch's stage stats + the current registry snapshot; any FIRING
  SLO alerts ride along as ``slo_verdicts``;
- ``GET /control[?last=N]`` — the verdict-driven controller's state
  and decision ledger (:mod:`dmlc_tpu_torch.obs.control`): every knob
  move, freeze, and no-op with the verdict evidence that caused it (404
  with an enable hint until a controller is installed);
- ``GET /profile[?seconds=N&hz=M]`` — the sampling profiler's merged
  Python+native flamegraph (:mod:`dmlc_tpu_torch.obs.profile`): the
  continuous trie, or an on-demand burst capture of the next N seconds
  at M Hz (404 with an enable hint when no profiler is installed);
- ``GET /pages/<entry>`` — the gang peer DATA plane: serves one
  committed, fingerprint-fresh page-store entry's bytes (``Range:
  bytes=a-b`` honored with a 206) under a refcounted pin, stamping the
  entry's fingerprint and codec tag as response headers so the peer
  client (:mod:`dmlc_tpu_torch.io.objstore.peer`) can validate before
  trusting a byte. Stale-stamped, uncommitted, or unsafely-named
  entries answer 404 — a peer can degrade to the wire, it must never be
  fed a wrong page. This endpoint is why ``ThreadingHTTPServer``
  matters: a slow ``/pages`` body transfer runs on its own handler
  thread and cannot starve ``/healthz`` or ``/metrics`` scrapes.

``GET /shuffle`` is the global shuffle's row surface: the installed
reader's view (``dmlc_tpu_torch.shuffle.view()``: seed, epoch, windows,
position, coverage, records and bytes by tier), or the reference's 404
with a hint naming ``global_seed`` when no global shuffle is active in
this process.

The ``/pages`` freshness cache belongs to each server, not to the
module.

``launch_local(serve_ports=[...])`` hands every worker a port via
``DMLC_TPU_SERVE_PORT`` (workers opt in with one :func:`serve_if_env`
call) plus the full gang list via ``DMLC_TPU_SERVE_PORTS`` so rank 0 —
or the launcher — can :func:`scrape_gang` the live processes into one
merged snapshot.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from dmlc_tpu_torch.obs import rpc as _rpc
from dmlc_tpu_torch.obs.metrics import (
    REGISTRY, MetricsRegistry, merge_snapshots,
)

__all__ = ["StatusServer", "serve", "serve_if_env", "shutdown",
           "render_prometheus", "scrape", "scrape_gang",
           "ENV_SERVE_PORT", "ENV_SERVE_PORTS"]

# env contract (parallel.launch.launch_local(serve_ports=...) sets both)
ENV_SERVE_PORT = "DMLC_TPU_SERVE_PORT"    # this worker's port
ENV_SERVE_PORTS = "DMLC_TPU_SERVE_PORTS"  # comma-joined gang ports

# /trace?seconds=N is clamped here: the handler thread sleeps for the
# capture window and an unbounded N would pin it (and the client)
MAX_TRACE_CAPTURE_S = 60.0

# /pages freshness verdicts are cached briefly: re-statting the origin
# per served block (a HEAD for obj:// sources) would erode the 1/N
# wire saving the peer tier delivers. A stale page can thus be served
# for up to the TTL — bounded and safe: entry names are etag-keyed (a
# changed object changes the requested name) and the peer CLIENT
# independently validates the stamped fingerprint before trusting a
# byte. Keyed by (root, name, stamp), so a re-stamped entry is
# re-judged immediately.
PAGE_FRESH_TTL_S = 2.0

_name_ok = re.compile(r"[^a-z0-9_]")


def _prom_name(name: str, prefix: str = "dmlc_") -> str:
    """Registry name -> Prometheus metric name ([a-z0-9_], prefixed)."""
    return prefix + _name_ok.sub("_", name.lower())


def _prom_label(value: str) -> str:
    """Escape a label value per the exposition format (bounded: a
    runaway state string must not bloat every scrape)."""
    return (str(value)[:200].replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _num(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _flatten_numeric(prefix: str, value: Any,
                     out: List[tuple]) -> None:
    """Collector payloads are arbitrary JSON; keep numeric leaves as
    (dotted.key.path, number) and drop the rest silently — collectors
    carry strings by design (replay tiers, error notes)."""
    if isinstance(value, dict):
        for k, v in value.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            _flatten_numeric(key, v, out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _flatten_numeric(f"{prefix}.{i}", v, out)
    elif _is_num(value) or isinstance(value, bool):
        out.append((prefix, value))


def render_prometheus(snap: Dict[str, Any],
                      registry: Optional[MetricsRegistry] = None) -> str:
    """One snapshot -> Prometheus text exposition (format 0.0.4).

    The rendered families (the reference's names, types and HELP lines;
    the HELP text names ``dmlc_tpu.obs.metrics`` as the reference's
    does, so both packages render one snapshot to the same text):

    - ``dmlc_obs_info{rank=...,pid=...,schema=...} 1`` — who answered;
    - counters  -> ``dmlc_<name>_total`` (TYPE counter);
    - gauges    -> numeric: ``dmlc_<name>`` (TYPE gauge); string:
      ``dmlc_<name>_info{value="..."} 1``; anything else (snapshot()
      reprs unknown objects but passes dicts/lists through) is
      SKIPPED and counted in ``dmlc_obs_export_skipped_total`` — a
      structured value has no valid single exposition line;
    - histograms -> ``_bucket{le=...}`` cumulative + ``_sum``/``_count``;
    - collectors -> ``dmlc_collector_value{collector=...,key=...}``
      for every numeric leaf.
    """
    reg = registry if registry is not None else REGISTRY
    skipped = 0
    lines: List[str] = [
        "# HELP dmlc_obs_info Identity of the serving process.",
        "# TYPE dmlc_obs_info gauge",
        f'dmlc_obs_info{{rank="{_prom_label(snap.get("rank"))}",'
        f'pid="{_prom_label(snap.get("pid"))}",'
        f'schema="{_prom_label(snap.get("schema"))}"}} 1',
    ]
    for name, value in sorted((snap.get("counters") or {}).items()):
        if name == "obs.export_skipped":
            continue  # rendered once at the end with THIS render's
            # skips included — emitting it here too would duplicate
            # the family, which Prometheus rejects outright
        pn = _prom_name(name) + "_total"
        lines.append(f"# HELP {pn} Counter {name} "
                     "(dmlc_tpu.obs.metrics).")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_num(value)}")
    for name, value in sorted((snap.get("gauges") or {}).items()):
        pn = _prom_name(name)
        if _is_num(value) or isinstance(value, bool):
            lines.append(f"# HELP {pn} Gauge {name} "
                         "(dmlc_tpu.obs.metrics).")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_num(value)}")
        elif isinstance(value, str):
            # info-style labeled series: the VALUE rides as a label
            lines.append(f"# HELP {pn}_info Gauge {name} "
                         "(non-numeric state, value in label).")
            lines.append(f"# TYPE {pn}_info gauge")
            lines.append(f'{pn}_info{{value="{_prom_label(value)}"}} 1')
        elif value is None:
            continue  # never-set gauge: nothing to export
        else:
            skipped += 1
    for name, h in sorted((snap.get("histograms") or {}).items()):
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} Histogram {name} "
                     "(dmlc_tpu.obs.metrics, log2 buckets).")
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        # snapshot buckets are keyed by repr(upper_bound), per-bucket
        # counts; the exposition wants cumulative le= series
        try:
            buckets = sorted((float(k), v)
                             for k, v in (h.get("buckets") or {}).items())
        except (TypeError, ValueError):
            buckets = []
        for ub, count in buckets:
            cum += count
            lines.append(f'{pn}_bucket{{le="{repr(ub)}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.get("count", 0)}')
        lines.append(f"{pn}_sum {_num(h.get('sum') or 0)}")
        lines.append(f"{pn}_count {h.get('count', 0)}")
        # bucket-estimated quantiles as sibling gauge families (a
        # histogram family admits no extra series of its own)
        for qk in ("p50", "p99"):
            qv = h.get(qk)
            if _is_num(qv):
                qn = f"{pn}_{qk}"
                lines.append(f"# HELP {qn} Histogram {name} {qk} "
                             "estimate (log2 buckets, clamped to "
                             "min/max).")
                lines.append(f"# TYPE {qn} gauge")
                lines.append(f"{qn} {_num(qv)}")
    leaves: List[tuple] = []
    for cname, payload in sorted((snap.get("collectors") or {}).items()):
        flat: List[tuple] = []
        _flatten_numeric("", payload, flat)
        leaves.extend((cname, key, v) for key, v in flat)
    if leaves:
        lines.append("# HELP dmlc_collector_value Numeric leaves of "
                     "registered stats() collectors.")
        lines.append("# TYPE dmlc_collector_value gauge")
        for cname, key, v in leaves:
            lines.append(
                f'dmlc_collector_value{{collector="{_prom_label(cname)}"'
                f',key="{_prom_label(key)}"}} {_num(v)}')
    if skipped:
        reg.counter("obs.export_skipped").inc(skipped)
    total = reg.counter("obs.export_skipped").value
    if total:
        pn = "dmlc_obs_export_skipped_total"
        lines.append(f"# HELP {pn} Gauge values not renderable in the "
                     "exposition (neither numeric nor string).")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {total}")
    return "\n".join(lines) + "\n"


def _thread_stacks() -> str:
    """All-thread stack dump (the watchdog's report helper)."""
    from dmlc_tpu_torch.obs.watchdog import _thread_stacks as dump
    return dump()


def _capture_trace(seconds: float) -> Dict[str, Any]:
    """On-demand bounded capture of the running process: when no
    recorder is active, install one for the window (start() displaces
    the flight ring if installed; stop() reinstates it); when a ring is
    already live (flight fallback or an explicit trace) let it
    accumulate the window and export its CURRENT contents without
    disturbing it."""
    from dmlc_tpu_torch.obs import trace as _trace
    from dmlc_tpu_torch.obs.export import chrome_events
    seconds = max(0.0, min(float(seconds), MAX_TRACE_CAPTURE_S))
    rec = _trace.active()
    owned = rec is None or rec is _trace.fallback()
    if rec is None:
        rec = _trace.start()
    if seconds:
        time.sleep(seconds)
    if owned and _trace.active() is rec and rec is not _trace.fallback():
        _trace.stop()
    return {
        "traceEvents": chrome_events(rec),
        "displayTimeUnit": "ms",
        "otherData": {"recorded": rec.recorded, "dropped": rec.dropped,
                      "capture_s": seconds},
    }


class _Handler(BaseHTTPRequestHandler):
    """Routes; the owning StatusServer rides on the server object."""

    server_version = "dmlc-tpu-obs/1"

    def log_message(self, format, *args):  # noqa: A002 — base signature
        pass  # scrapes must not spam stderr

    def setup(self):
        # arrival stamp for the server span's queue phase: everything
        # between the connection being handed to this thread and
        # do_GET starting (request-line/header parse included)
        self._rpc_arrival = time.perf_counter()
        super().setup()

    def _echo_trace(self) -> None:
        """Echo an inbound trace context plus the server handle time
        so far (obs.rpc headers) — the client folds the echo into its
        edge table to split wire wait from server work. Untraced
        requests get no extra headers. Call between send_response()
        and end_headers()."""
        ctx = getattr(self, "_rpc_ctx", None)
        if ctx is None:
            return
        self._rpc_sent = time.perf_counter()
        self.send_header(_rpc.TRACE_HEADER, _rpc.serialize(ctx))
        self.send_header(
            _rpc.HANDLE_HEADER,
            str(round((self._rpc_sent - self._rpc_t0) * 1e6, 1)))

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self._echo_trace()
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload: Any, code: int = 200) -> None:
        self._send(code, json.dumps(payload).encode(),
                   "application/json")

    def _serve_page(self, owner: "StatusServer", name: str) -> None:
        """The /pages/<entry> peer data plane: one committed,
        fingerprint-fresh page-store entry's stored bytes, under a
        refcounted pin so eviction cannot pull the page mid-transfer.
        The stored bytes may be a codec frame — the client decodes;
        headers carry the stamped fingerprint + codec tag for the
        client's own validation. Ranges (``Range: bytes=a-b``) apply
        to the STORED entry bytes and answer 206."""
        from urllib.parse import unquote

        from dmlc_tpu_torch.io.pagestore import fingerprint_fresh
        name = unquote(name)
        # entry names are flat files in the store root: anything
        # path-shaped is rejected before it touches the filesystem
        if (not name or "/" in name or "\\" in name or ".." in name
                or name.startswith(".")):
            self._send_json({"error": "invalid page name"}, code=404)
            return
        store = owner.pages_store()
        meta = store.stamp(name)
        if meta is None:
            # no sidecar = not a committed store entry (or a bare
            # legacy file whose staleness nobody can judge): never
            # serve it to a peer
            self._send_json({"error": "no such committed page",
                             "entry": name}, code=404)
            return
        fp = meta.get("fingerprint")
        fresh = owner.page_fresh(store.root, name, fp, fingerprint_fresh)
        if fresh is False:
            self._send_json({"error": "stale page fingerprint",
                             "entry": name}, code=404)
            return
        store.pin(name)
        try:
            s = store.open_read(name)
            if s is None:
                self._send_json({"error": "no such committed page",
                                 "entry": name}, code=404)
                return
            with s:
                data = s.read_all()
            total = len(data)
            code = 200
            content_range = None
            rng = self.headers.get("Range")
            m = re.match(r"bytes=(\d+)-(\d*)$", (rng or "").strip())
            if m:
                lo = int(m.group(1))
                hi = int(m.group(2)) + 1 if m.group(2) else total
                hi = min(hi, total)
                if lo >= hi:
                    self._send_json(
                        {"error": f"unsatisfiable range {rng!r}",
                         "size": total}, code=416)
                    return
                data = data[lo:hi]
                code = 206
                content_range = f"bytes {lo}-{hi - 1}/{total}"
            self.send_response(code)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            if content_range:
                self.send_header("Content-Range", content_range)
            self.send_header("X-Dmlc-Fingerprint", json.dumps(fp))
            self.send_header("X-Dmlc-Codec",
                             str(meta.get("codec", "raw")))
            self._echo_trace()
            self.end_headers()
            self.wfile.write(data)
            owner.registry.counter("objstore.peer.served").inc()
            owner.registry.counter(
                "objstore.peer.served_bytes").inc(len(data))
        finally:
            store.unpin(name)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        # bind the inbound trace context (if any): the echo headers and
        # the server span below both key off it
        self._rpc_ctx = _rpc.extract(self.headers)
        self._rpc_t0 = time.perf_counter()
        self._rpc_sent: Optional[float] = None
        try:
            owner: "StatusServer" = self.server.status_server
            if url.path == "/metrics":
                body = render_prometheus(owner.registry.snapshot(),
                                         owner.registry)
                self._send(200, body.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/metrics.json":
                self._send_json(owner.registry.snapshot())
            elif url.path == "/healthz":
                self._send_json(owner.health())
            elif url.path == "/stacks":
                self._send(200, _thread_stacks().encode(),
                           "text/plain; charset=utf-8")
            elif url.path == "/trace":
                q = parse_qs(url.query)
                seconds = float(q.get("seconds", ["1"])[0])
                self._send_json(_capture_trace(seconds))
            elif url.path == "/history":
                from dmlc_tpu_torch.obs import timeseries as _ts
                ring = _ts.active()
                if ring is None:
                    self._send_json(
                        {"error": "no timeseries ring installed",
                         "hint": "set DMLC_TPU_HISTORY_S (launch_local"
                                 "(history_s=...)) or call "
                                 "obs.timeseries.install()"},
                        code=404)
                else:
                    q = parse_qs(url.query)
                    raw = q.get("seconds", [None])[0]
                    last_s = float(raw) if raw else None
                    self._send_json(ring.to_dict(last_s=last_s))
            elif url.path == "/gang":
                from dmlc_tpu_torch.obs import aggregate as _agg
                agg = _agg.active()
                membership = None
                try:
                    from dmlc_tpu_torch import rendezvous as _rndv
                    cli = _rndv.active()
                    if cli is not None:
                        membership = cli.view()
                except Exception:  # noqa: BLE001 — membership rows
                    pass           # are additive, never a 500
                if agg is None and membership is None:
                    self._send_json(
                        {"error": "no gang aggregator or rendezvous "
                                  "membership installed",
                         "hint": "set DMLC_TPU_GANG_POLL_S (launch_"
                                 "local(gang_poll_s=...)) or join a "
                                 "rendezvous (launch_local("
                                 "rendezvous=True) + dmlc_tpu_torch."
                                 "rendezvous.install_if_env())"},
                        code=404)
                else:
                    if agg is not None:
                        q = parse_qs(url.query)
                        raw = q.get("seconds", [None])[0]
                        last_s = float(raw) if raw else None
                        body = agg.view(last_s=last_s)
                    else:
                        body = {"schema": 0}
                    if membership is not None:
                        # the elastic half of the gang story: who is
                        # in, at which rank, under which membership
                        # epoch (docs/rendezvous.md)
                        body["membership"] = membership
                    self._send_json(body)
            elif url.path == "/control":
                from dmlc_tpu_torch.obs import control as _control
                ctl = _control.active()
                if ctl is None:
                    self._send_json(
                        {"error": "no controller installed",
                         "hint": "set DMLC_TPU_CONTROL=1 (launch_"
                                 "local(control=True)) or call "
                                 "obs.control.install()"},
                        code=404)
                else:
                    q = parse_qs(url.query)
                    raw = q.get("last", [None])[0]
                    last = int(raw) if raw else None
                    self._send_json(ctl.to_dict(last=last))
            elif url.path == "/tenants":
                from dmlc_tpu_torch.pipeline import scheduler as _sched
                sched = _sched.active()
                if sched is None:
                    self._send_json(
                        {"error": "no pipeline scheduler installed",
                         "hint": "set DMLC_TPU_SCHED=1 (launch_local"
                                 "(scheduler=True)) or call "
                                 "pipeline.scheduler.install()"},
                        code=404)
                else:
                    self._send_json(sched.to_dict())
            elif url.path == "/slo":
                from dmlc_tpu_torch.obs import slo as _slo
                eng = _slo.active()
                if eng is None or not eng.objectives():
                    self._send_json(
                        {"error": "no SLO objectives registered",
                         "hint": "set DMLC_TPU_SLO (launch_local"
                                 "(slo=...)), declare via "
                                 "scheduler.add_tenant(slo=...), or "
                                 "call obs.slo.install().register()"},
                        code=404)
                else:
                    self._send_json(eng.view())
            elif url.path == "/shuffle":
                from dmlc_tpu_torch import shuffle as _shuffle
                doc = _shuffle.view()
                if doc is None:
                    self._send_json(
                        {"error": "no global shuffle active",
                         "hint": "Pipeline.from_uri(...).shuffle("
                                 "global_seed=...) or construct "
                                 "dmlc_tpu_torch.shuffle."
                                 "GlobalShuffleSplit in this process"},
                        code=404)
                else:
                    self._send_json(doc)
            elif url.path == "/analyze":
                verdict = owner.analyze_verdict()
                # a burning declared objective rides along: the stage
                # verdict says WHERE time goes, the slo verdicts say
                # which promises that breaks (obs.slo)
                svs = []
                try:
                    from dmlc_tpu_torch.obs import slo as _slo
                    eng = _slo.active()
                    if eng is not None:
                        svs = eng.verdicts()
                except Exception:  # noqa: BLE001
                    svs = []
                if verdict is None and not svs:
                    self._send_json(
                        {"error": "no pipeline stats to attribute "
                                  "(no registered pipeline collector "
                                  "has completed an epoch yet)"},
                        code=404)
                elif verdict is None:
                    self._send_json({"slo_verdicts": svs})
                else:
                    if svs:
                        verdict = dict(verdict)
                        verdict["slo_verdicts"] = svs
                    self._send_json(verdict)
            elif url.path == "/profile":
                from dmlc_tpu_torch.obs import profile as _prof
                prof = _prof.active()
                if prof is None:
                    self._send_json(
                        {"error": "no sampling profiler installed",
                         "hint": "set DMLC_TPU_PROFILE_HZ (launch_"
                                 "local(profile_hz=...)) or call "
                                 "obs.profile.install()"},
                        code=404)
                else:
                    q = parse_qs(url.query)
                    raw_s = q.get("seconds", [None])[0]
                    raw_hz = q.get("hz", [None])[0]
                    if raw_s is None:
                        self._send_json(prof.to_dict())
                    else:
                        # the handler thread sleeps for the burst
                        # window — same clamp as /trace?seconds=N
                        seconds = max(0.0, min(float(raw_s),
                                               MAX_TRACE_CAPTURE_S))
                        hz = float(raw_hz) if raw_hz else None
                        self._send_json(prof.burst(seconds, hz=hz))
            elif url.path == "/rpc":
                self._send_json(_rpc.view())
            elif url.path.startswith("/pages/"):
                self._serve_page(owner, url.path[len("/pages/"):])
            else:
                self._send_json({"error": "unknown endpoint",
                                 "endpoints": ["/metrics",
                                               "/metrics.json",
                                               "/healthz", "/stacks",
                                               "/trace?seconds=N",
                                               "/history", "/gang",
                                               "/tenants", "/slo",
                                               "/shuffle",
                                               "/analyze",
                                               "/control[?last=N]",
                                               "/profile?seconds=N"
                                               "&hz=M",
                                               "/rpc",
                                               "/pages/<entry>"]},
                                code=404)
        except Exception as e:  # noqa: BLE001 — a scrape must never
            try:                # take down the serving thread
                self._send_json({"error": repr(e)}, code=500)
            except Exception:  # noqa: BLE001 — client went away
                pass
        finally:
            ctx = self._rpc_ctx
            if ctx is not None:
                t1 = time.perf_counter()
                arrival = getattr(self, "_rpc_arrival", self._rpc_t0)
                sent = self._rpc_sent if self._rpc_sent is not None \
                    else t1
                verb = url.path.lstrip("/").split("/", 1)[0] or "/"
                _rpc.record_server_span(
                    verb, _rpc.serialize(ctx), arrival, t1 - arrival,
                    args={
                        "peer": str(self.client_address[0]),
                        "queue_us": round(
                            (self._rpc_t0 - arrival) * 1e6, 1),
                        "handle_us": round(
                            (sent - self._rpc_t0) * 1e6, 1),
                        "write_us": round((t1 - sent) * 1e6, 1),
                    })


class StatusServer:
    """One daemon-thread HTTP status server for this process."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 pages_root: Optional[str] = None):
        self.registry = registry if registry is not None else REGISTRY
        # /pages serves THIS store's committed entries (None = the
        # process default store, resolved per request so env-driven
        # per-rank roots apply)
        self._pages_root = pages_root
        # /pages freshness verdicts of THIS server (see PAGE_FRESH_TTL_S)
        self._page_fresh: Dict[tuple, tuple] = {}
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.status_server = self
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self.started_s = time.time()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dmlc_tpu_torch.obs.StatusServer")
        # /analyze wire-counter scoping: (epoch, closing counters of
        # the PREVIOUS epoch, baseline used for this epoch) — see
        # analyze_verdict()
        self._analyze_lock = threading.Lock()
        self._analyze_prev = None
        self._thread.start()
        # the port is itself telemetry: a merged gang snapshot tells
        # the reader where each rank can be curled
        self.registry.gauge("obs.serve_port").set(self.port)

    def pages_store(self):
        """The page store /pages serves from: the explicit
        ``pages_root``, else the process default store (hydrated
        remote blocks live there)."""
        from dmlc_tpu_torch.io.pagestore import PageStore
        if self._pages_root is not None:
            return PageStore.at(self._pages_root)
        return PageStore.default()

    def analyze_verdict(self) -> Optional[Dict[str, Any]]:
        """The /analyze payload: attribute the last completed epoch of
        the first live pipeline collector. Wire-side counters
        (objstore/pagestore) are process-cumulative in the registry, so
        they are DELTA-scoped here against the counters seen when the
        previous epoch closed — earlier remote work (a cold hydration
        configs ago) must not flip a purely local epoch's verdict to
        wire-bound. The very first call has no baseline and reads
        cumulative counters; within one epoch, repeated polls reuse the
        same baseline so the verdict is stable."""
        from dmlc_tpu_torch.obs import analyze as _an
        snap = self.registry.snapshot()
        pipeline = next(
            (v for k, v in sorted(
                (snap.get("collectors") or {}).items())
             if k.startswith("pipeline") and v), None)
        if pipeline is None:
            return None
        counters = dict(snap.get("counters") or {})
        epoch = pipeline.get("epoch")
        with self._analyze_lock:
            prev = self._analyze_prev
            if prev is None:
                baseline = None
                self._analyze_prev = (epoch, counters, None)
            elif epoch != prev[0]:
                baseline = prev[1]
                self._analyze_prev = (epoch, counters, baseline)
            else:
                baseline = prev[2]
        if baseline:
            snap = dict(snap)
            snap["counters"] = {
                k: (v - baseline[k] if isinstance(v, (int, float))
                    and isinstance(baseline.get(k), (int, float))
                    else v)
                for k, v in counters.items()}
        return _an.attribute(pipeline, metrics=snap)

    def page_fresh(self, root: str, name: str, fp, judge) -> Optional[bool]:
        """``judge(fp)`` (``pagestore.fingerprint_fresh``), cached for
        PAGE_FRESH_TTL_S per (root, name, stamp)."""
        key = (root, name, json.dumps(fp))
        hit = self._page_fresh.get(key)
        if hit is not None and time.monotonic() - hit[0] \
                < PAGE_FRESH_TTL_S:
            return hit[1]
        fresh = judge(fp)
        if len(self._page_fresh) > 1024:
            self._page_fresh.clear()  # bounded, coarse
        self._page_fresh[key] = (time.monotonic(), fresh)
        return fresh

    def health(self) -> Dict[str, Any]:
        from dmlc_tpu_torch.obs import trace as _trace
        from dmlc_tpu_torch.obs import watchdog as _watchdog
        from dmlc_tpu_torch.obs.metrics import worker_rank
        wd = _watchdog.active()
        return {
            "ok": True,
            "pid": os.getpid(),
            "rank": worker_rank(),
            "uptime_s": round(time.time() - self.started_s, 3),
            "tracing": _trace.active() is not None,
            "watchdog": {
                "installed": wd is not None,
                "threshold_s": wd.threshold_s if wd else None,
                "reports": len(wd.reports) if wd else 0,
            },
            "waits": _watchdog.current_waits(),
        }

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "StatusServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_server: Optional[StatusServer] = None


def serve(port: int = 0, host: str = "127.0.0.1",
          registry: Optional[MetricsRegistry] = None) -> StatusServer:
    """Start the process status server (port 0 = OS-assigned; read
    ``.port``). One per process: a second call returns the running
    instance (env/CLI wiring may race module import order)."""
    global _server
    if _server is not None:
        return _server
    _server = StatusServer(port=port, host=host, registry=registry)
    return _server


def serve_if_env() -> Optional[StatusServer]:
    """Gang-worker hook (one line, like trace_if_env): start the status
    server when ``DMLC_TPU_SERVE_PORT`` is set — launch_local's
    ``serve_ports=...`` sets it per worker — else no-op."""
    port = os.environ.get(ENV_SERVE_PORT)
    if not port:
        return None
    try:
        return serve(port=int(port))
    except (ValueError, OSError) as e:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("serve-port-failed",
                  f"obs.serve: could not serve on {ENV_SERVE_PORT}="
                  f"{port!r}: {e}", all_ranks=True)
        return None


def shutdown() -> None:
    """Stop the process server started by serve()/serve_if_env()."""
    global _server
    srv, _server = _server, None
    if srv is not None:
        srv.close()


def scrape(port: int, host: str = "127.0.0.1",
           path: str = "/metrics.json",
           timeout_s: float = 5.0) -> Dict[str, Any]:
    """GET one rank's JSON endpoint (stdlib urllib; no deps).

    A resilience seam (site ``obs.scrape``, fail-fast 2-attempt site
    default): one dropped connection does not mark a live rank
    unreachable in the merged gang view. Each poll is a traced RPC
    edge of its own — one operation trace_id per scrape, one client
    span per attempt — so a slow or retried scrape shows up on the
    gang timeline instead of silently inflating ``obs.scrape``."""
    from urllib.request import Request, urlopen

    from dmlc_tpu_torch.resilience.policy import guarded

    def get() -> Dict[str, Any]:
        with _rpc.client_span("scrape", f"{host}:{port}") as call:
            hdrs: Dict[str, str] = {}
            if call is not None:
                _rpc.inject(call.ctx, hdrs)
            with urlopen(Request(f"http://{host}:{port}{path}",
                                 headers=hdrs),
                         timeout=timeout_s) as resp:
                if call is not None:
                    call.note_server(
                        resp.headers.get(_rpc.HANDLE_HEADER))
                return json.load(resp)

    with _rpc.operation("obs.scrape", peer=f"{host}:{port}"):
        return guarded("obs.scrape", get)


def scrape_gang(ports: Optional[List[int]] = None,
                host: str = "127.0.0.1",
                timeout_s: float = 5.0) -> Dict[str, Any]:
    """Scrape every rank's /metrics.json and merge into one gang view
    (merge_snapshots, keyed by rank). ``ports=None`` reads the gang
    list from ``DMLC_TPU_SERVE_PORTS`` — so rank 0 INSIDE a
    launch_local gang can scrape its peers. Unreachable ranks land
    under ``"unreachable"`` instead of failing the merged read (the
    rank you cannot scrape is exactly the one you are diagnosing)."""
    if ports is None:
        raw = os.environ.get(ENV_SERVE_PORTS, "")
        ports = [int(p) for p in raw.split(",") if p.strip()]
    snaps, unreachable = [], {}
    for port in ports:
        try:
            snaps.append(scrape(port, host=host, timeout_s=timeout_s))
        except Exception as e:  # noqa: BLE001 — dead rank stays visible
            unreachable[str(port)] = repr(e)
    merged = merge_snapshots(snaps)
    if unreachable:
        merged["unreachable"] = unreachable
    return merged
