"""obsctl — operator CLI over the live obs plane and BENCH archives.

Copy of ``scripts/obsctl.py`` with its imports rewritten to
``dmlc_tpu_torch``, run as ``python -m dmlc_tpu_torch.obsctl``: the same
subcommands, tables and exit codes, against a status server of either
package.

Subcommands (all read-only; the plane stays in charge):

- ``top``      — live top-style per-stage table of a running rank's
                 pipeline (polls ``/metrics.json``; ``--once`` for a
                 single frame);
- ``diagnose`` — one-shot bottleneck verdict: from a live rank's
                 ``/analyze`` endpoint, or offline from a BENCH JSON
                 (prefers the run's own embedded ``"analysis"``);
- ``compare``  — band-aware diff of two BENCH JSONs (gauge bands from
                 BASELINE.md): in-band credit variance reports as
                 variance, only out-of-tolerance same-band deltas flag
                 as regressions (exit 3 when any do);
- ``history``  — a rank's ``/history`` time-series ring, summarized;
- ``gang``     — rank 0's ``/gang`` merged gang view (per-rank
                 reachability, gaps, rollups), summarized — including
                 each rank's data-plane byte split (wire vs
                 peer-served vs served-to-peers), so the objstore
                 peer tier's 1/N wire claim is visible on one
                 timeline;
- ``control``  — a rank's ``/control`` decision ledger (the
                 verdict-driven controller): knob state per family
                 and every decision — trial / accepted / reverted /
                 freeze / no-op — with the verdict evidence that
                 caused it, so "why is this knob at this value" is
                 answerable from the CLI; exit 2 with the server's
                 enable hint when no controller is installed;
- ``rpc``      — a rank's ``/rpc`` RPC edge table (distributed
                 tracing plane): per-(peer, verb) call counts and
                 client p50/p99 latency, decomposed into
                 server-reported handle time vs network+queue
                 residual — "is the wire slow or is the server slow"
                 answerable per edge from the CLI;
- ``slo``      — a rank's ``/slo`` declared objectives (obs.slo):
                 per-objective windowed attainment, error-budget
                 remaining, and fast/slow burn-alert state — "are we
                 keeping the promises we declared" answerable from
                 the CLI; exit 2 with the server's enable hint when
                 nothing is declared;
- ``shuffle``  — a rank's ``/shuffle`` global-shuffle row
                 (dmlc_tpu_torch.shuffle): permutation identity (seed,
                 epoch, window budget), coverage watermark, and the
                 local/peer/wire split of exchanged records and
                 bytes — "is the gang actually exchanging through
                 the peer tier" answerable from the CLI; exit 2 with
                 the server's enable hint when no shuffle is active;
- ``profile``  — a rank's ``/profile`` merged Python+native
                 flamegraph: live burst (``--seconds N --hz M``) or
                 the continuous trie, summarized as a top-frame
                 table, or written with ``--out`` as collapsed
                 stacks / a speedscope JSON (``--format``); exit 2
                 with the server's enable hint when no profiler is
                 installed.

Port defaults to ``DMLC_TPU_SERVE_PORT`` so ``obsctl top`` inside a
gang worker's environment needs no flags.

Examples::

    python -m dmlc_tpu_torch.obsctl top --port 9100
    python -m dmlc_tpu_torch.obsctl diagnose --port 9100
    python -m dmlc_tpu_torch.obsctl diagnose BENCH_r07.json
    python -m dmlc_tpu_torch.obsctl compare BENCH_r06.json BENCH_r07.json
    python -m dmlc_tpu_torch.obsctl gang --port 9100
    python -m dmlc_tpu_torch.obsctl profile --port 9100 --seconds 5
    python -m dmlc_tpu_torch.obsctl profile --out prof.speedscope.json \\
        --format speedscope
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional


def _fetch(port: int, path: str, host: str = "127.0.0.1",
           timeout_s: float = 5.0) -> Dict[str, Any]:
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=timeout_s) as resp:
            return json.load(resp)
    except urllib.error.HTTPError as e:
        # the server's 404s carry a JSON {error, hint} payload (e.g.
        # "no timeseries ring installed" + how to enable it) — return
        # it so the subcommands can show the hint instead of a bare
        # HTTP status line
        try:
            payload = json.load(e)
        except Exception:  # noqa: BLE001 — non-JSON body: original err
            raise e from None
        return payload


def _default_port(args) -> int:
    if args.port:
        return args.port
    env = os.environ.get("DMLC_TPU_SERVE_PORT")
    if env:
        return int(env)
    raise SystemExit("no --port given and DMLC_TPU_SERVE_PORT unset")


def _pipeline_of(snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    for k, v in sorted((snap.get("collectors") or {}).items()):
        if k.startswith("pipeline") and v:
            return v
    return None


def _fmt(v: Any, nd: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_stage_table(pl: Dict[str, Any]) -> str:
    """One pipeline stats snapshot -> an aligned per-stage table."""
    cols = ["stage", "kind", "items", "rows", "MB", "wait_s", "wait%",
            "GB/s", "q"]
    rows: List[List[str]] = []
    for st in pl.get("stages") or []:
        occ = st.get("queue_occupancy")
        q = (f"{st.get('queue_depth_mean')}/{st.get('queue_cap')}"
             if st.get("queue_cap") else "-")
        rows.append([
            str(st.get("name", "?")), str(st.get("kind", "?")),
            _fmt(st.get("items")), _fmt(st.get("rows")),
            _fmt((st.get("bytes") or 0) / 1e6, 1),
            _fmt(st.get("wait_s"), 3),
            (f"{st['wait_frac']:.0%}"
             if st.get("wait_frac") is not None else "-"),
            _fmt(st.get("throughput_gbps"), 3),
            q + (f" ({occ:.0%})" if occ is not None else ""),
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows
              else len(c) for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    lines.append(f"epoch {pl.get('epoch')}  wall {pl.get('wall_s')}s  "
                 f"knobs {pl.get('knobs')}")
    return "\n".join(lines)


def render_verdict(v: Dict[str, Any]) -> str:
    lines = [f"bound: {v.get('bound')}   band: {v.get('band')}   "
             f"confidence: {v.get('confidence')}"
             # schema-4 verdicts carry the tenant whose epoch was
             # judged (multi-tenant scheduler); untenanted runs omit it
             + (f"   tenant: {v['tenant']}" if v.get("tenant")
                else "")
             # schema-3 verdicts are citable (the control ledger
             # references them by id); older BENCH docs lack the field
             + (f"   [{v['verdict_id']}]" if v.get("verdict_id")
                else "")]
    sw = v.get("stage_waits") or {}
    lines.append(
        f"waits: parse {_fmt(sw.get('parse_s'), 3)}s  assemble "
        f"{_fmt(sw.get('assemble_s'), 3)}s  xfer "
        f"{_fmt(sw.get('xfer_s'), 3)}s  (total "
        f"{_fmt(sw.get('total_wait_s'), 3)}s of wall "
        f"{_fmt(sw.get('wall_s'), 3)}s)")
    lines.append("evidence:")
    for e in v.get("evidence") or []:
        lines.append(f"  - {e}")
    hot = v.get("hot_frames") or []
    if hot:
        lines.append("hot frames (sampling profiler, on-CPU):")
        for h in hot:
            lines.append(f"  {h['frac']:>6.1%}  {h['frame']} "
                         f"({h['samples']} samples)")
    return "\n".join(lines)


def render_compare(r: Dict[str, Any]) -> str:
    lines = [f"tolerance ±{r['tolerance']:.0%} within a credit band "
             "(BASELINE.md bands; cross-band reads are incomparable)"]
    header = ["band", "epochs a/b", "a GB/s", "b GB/s", "delta",
              "status"]
    rows: List[List[str]] = []
    for band, row in (r.get("bands") or {}).items():
        ea, eb = (row.get("epochs") or [None, None])[:2]
        rows.append([
            band, f"{_fmt(ea)}/{_fmt(eb)}", _fmt(row.get("a"), 4),
            _fmt(row.get("b"), 4),
            (f"{row['delta_frac']:+.1%}"
             if row.get("delta_frac") is not None else "-"),
            row.get("status", "-")])
    cpu = r.get("parse_cpu")
    if cpu:
        rows.append(["cpu-core*", "-", _fmt(cpu["a"], 4),
                     _fmt(cpu["b"], 4), f"{cpu['delta_frac']:+.1%}",
                     cpu["status"]])
    widths = [max(len(c), *(len(x[i]) for x in rows)) if rows
              else len(c) for i, c in enumerate(header)]
    lines.append("  ".join(c.ljust(w) for c, w in zip(header, widths)))
    for x in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(x, widths)))
    if cpu:
        lines.append("(* parse_cpu_gbps_core: credit-immune, compared "
                     "across bands)")
    for reg in r.get("regressions") or []:
        lines.append(f"REGRESSION: {reg}")
    for imp in r.get("improvements") or []:
        lines.append(f"improvement: {imp}")
    if not r.get("regressions"):
        lines.append("no regressions outside in-band variance")
    return "\n".join(lines)


def cmd_top(args) -> int:
    port = _default_port(args)
    while True:
        snap = _fetch(port, "/metrics.json", host=args.host)
        pl = _pipeline_of(snap)
        stamp = time.strftime("%H:%M:%S")
        who = (f"rank {snap.get('rank')}" if snap.get("rank") is not None
               else f"pid {snap.get('pid')}")
        print(f"— obsctl top · {who} · :{port} · {stamp} —")
        if pl is None:
            print("no pipeline collector yet (no CompiledPipeline has "
                  "completed an epoch in this process)")
        else:
            print(render_stage_table(pl))
        if args.once:
            return 0
        sys.stdout.flush()
        time.sleep(args.interval)


def cmd_diagnose(args) -> int:
    from dmlc_tpu_torch.obs.analyze import diagnose_bench
    if args.bench:
        v = diagnose_bench(args.bench)
    else:
        port = _default_port(args)
        v = _fetch(port, "/analyze", host=args.host)
        if "bound" not in v:
            print(json.dumps(v))
            return 2
    if args.json:
        print(json.dumps(v))
    else:
        print(render_verdict(v))
    return 0


def cmd_compare(args) -> int:
    from dmlc_tpu_torch.obs.analyze import compare_files
    r = compare_files(args.a, args.b, tolerance=args.tolerance)
    if args.json:
        print(json.dumps(r))
    else:
        print(render_compare(r))
    return 3 if r["regressions"] else 0


def cmd_history(args) -> int:
    port = _default_port(args)
    path = "/history" + (f"?seconds={args.seconds}" if args.seconds
                         else "")
    h = _fetch(port, path, host=args.host)
    if args.json or "samples" not in h:
        print(json.dumps(h))
        return 0 if "samples" in h else 2
    samples = h["samples"]
    span = (samples[-1]["t"] - samples[0]["t"]) if len(samples) > 1 \
        else 0.0
    print(f"{len(samples)} samples spanning {span:.1f}s at "
          f"~{h['resolution_s']}s resolution "
          f"({h['approx_bytes']}/{h['budget_bytes']} bytes, "
          f"{h['coarsenings']} coarsenings)")
    if samples:
        for key in sorted(samples[-1]["v"])[:args.keys]:
            first = next((s["v"][key] for s in samples
                          if key in s["v"]), None)
            print(f"  {key}: {first} -> {samples[-1]['v'][key]}")
    return 0


def render_membership(mem: Dict[str, Any]) -> str:
    """One /gang ``membership`` section -> roster rows (the elastic
    half: who is in, at which rank, under which membership epoch)."""
    lines = [f"membership: gang {mem.get('gang')!r} epoch "
             f"{mem.get('epoch')} · world {mem.get('world')} · "
             f"this member {mem.get('member')} (rank "
             f"{mem.get('rank')})"]
    for e in sorted(mem.get("roster") or [],
                    key=lambda e: e.get("rank", 0)):
        port = e.get("port")
        lines.append(f"  rank {e.get('rank')}  {e.get('member')}  "
                     f"{e.get('host')}" + (f":{port}" if port else "")
                     + f"  attempt {e.get('attempt')}")
    prog = mem.get("progress") or {}
    if prog:
        done = sum(int(v) for v in prog.values())
        lines.append(f"  progress: {len(prog)} part(s) started, "
                     f"{done} records committed gang-wide")
    return "\n".join(lines)


def cmd_gang(args) -> int:
    port = _default_port(args)
    g = _fetch(port, "/gang", host=args.host)
    has_ranks = "ranks" in g
    membership = g.get("membership")
    if args.json or (not has_ranks and not membership):
        print(json.dumps(g))
        return 0 if (has_ranks or membership) else 2
    if membership:
        print(render_membership(membership))
    if not has_ranks:
        return 0
    print(f"gang of {len(g['ports'])} (poll {g['period_s']}s, "
          f"{g['polls']} polls)")
    data_plane = False
    for label, m in sorted(g["ranks"].items()):
        state = "UNREACHABLE" if m["unreachable"] else "up"
        gaps = len(m["gaps"])
        kept = m["series"]["kept"]
        print(f"  {label} :{m['port']}  {state}  "
              f"{m['polls_ok']} ok / {m['polls_failed']} failed"
              + (f"  {gaps} gap(s)" if gaps else "")
              + f"  {kept} samples"
              + (f"  last error {m['last_error']}"
                 if m["last_error"] else ""))
        # the rank's data-plane byte split: wire GETs vs bytes served
        # BY peers to this rank vs bytes this rank served TO peers —
        # the peer tier's 1/N claim, readable on one timeline
        samples = m["series"].get("samples") or []
        v = samples[-1]["v"] if samples else {}
        wire = v.get("counters.objstore.bytes")
        peer = v.get("counters.objstore.peer.bytes")
        served = v.get("counters.objstore.peer.served_bytes")
        if any(x for x in (wire, peer, served)):
            data_plane = True
            print(f"    bytes: wire {_fmt(wire, 0)} · "
                  f"peer-served {_fmt(peer, 0)} · "
                  f"served-to-peers {_fmt(served, 0)}")
        # the rank's checkpoint-restore byte split: what restore()
        # materialized and which tier carried it — the fanout's ~1/N
        # wire claim, per rank
        ck = v.get("counters.checkpoint.restore_bytes")
        if ck:
            print(f"    restore: {_fmt(ck, 0)} bytes · local "
                  f"{_fmt(v.get('counters.checkpoint.restore.local_bytes'), 0)}"
                  " · peer "
                  f"{_fmt(v.get('counters.checkpoint.restore.peer_bytes'), 0)}"
                  " · wire "
                  f"{_fmt(v.get('counters.checkpoint.restore.wire_bytes'), 0)}")
        # the rank's control-plane cadence (collectors.control.* ride
        # the same gang timeline): decisions made, climate freezes,
        # reverted trials — the observe→act loop, visible per rank
        dec = v.get("collectors.control.decisions")
        if dec is not None:
            print(f"    control: {_fmt(dec, 0)} decisions · "
                  f"{_fmt(v.get('collectors.control.freezes'), 0)} "
                  "freezes · "
                  f"{_fmt(v.get('collectors.control.reverted'), 0)} "
                  "reverted")
    roll = g["rollup"]["samples"]
    if roll:
        last = roll[-1]["v"]
        print(f"  rollup: reachable {last.get('gang.reachable')}/"
              f"{last.get('gang.expected')} at last poll, "
              f"{len(roll)} rollup samples")
        if data_plane:
            gw = last.get("sum.counters.objstore.bytes")
            gp = last.get("sum.counters.objstore.peer.bytes")
            print(f"  rollup bytes: wire {_fmt(gw, 0)} · "
                  f"peer-served {_fmt(gp, 0)} across reachable ranks")
    return 0


def render_control(doc: Dict[str, Any], last: int = 12) -> str:
    """One /control payload -> knob state + the decision tail."""
    lines = [f"controller: epoch {doc.get('epoch')}  "
             + "  ".join(f"{k}={v}" for k, v in
                         (doc.get("counts") or {}).items() if v)]
    for name, k in sorted((doc.get("knobs") or {}).items()):
        lines.append(
            f"  knob {name} = {k['value']} (family {k['family']}, "
            f"[{k['lo']},{k['hi']}], initial {k['initial']}"
            + (", FROZEN" if k.get("frozen") else "") + ")")
    led = doc.get("ledger") or {}
    lines.append(f"ledger: {led.get('kept')} of {led.get('offered')} "
                 f"decisions kept "
                 f"({led.get('approx_bytes')}/{led.get('budget_bytes')} "
                 f"bytes, {led.get('coarsenings')} coarsenings)")
    for rec in (led.get("records") or [])[-last:]:
        move = (f" {rec['knob']} {rec['old']}→{rec['new']}"
                if rec.get("knob") else "")
        lines.append(
            f"  [e{rec.get('epoch')}] {rec.get('outcome', '?'):<10} "
            f"{rec.get('family') or '-':<9} bound={rec.get('bound')}"
            f"/{rec.get('band')}{move}  ({rec.get('verdict_id')})")
        for e in (rec.get("evidence") or [])[:2]:
            lines.append(f"      - {e}")
    return "\n".join(lines)


def cmd_control(args) -> int:
    port = _default_port(args)
    path = "/control" + (f"?last={args.last}" if args.last else "")
    doc = _fetch(port, path, host=args.host)
    if "ledger" not in doc:
        # the server's 404 payload ({error, hint}: no controller
        # installed) — surface the hint, exit 2 like history/gang
        print(json.dumps(doc))
        return 2
    if args.json:
        print(json.dumps(doc))
        return 0
    print(render_control(doc, last=args.keys))
    return 0


def render_tenants(doc: Dict[str, Any]) -> str:
    """One /tenants payload -> per-tenant table + plane header."""
    lines = [f"scheduler: quantum {doc.get('quantum')} · burst "
             f"{doc.get('burst')} · queue budget "
             f"{doc.get('queue_budget')} · {doc.get('rounds')} rounds"]
    hdr = (f"{'tenant':<12} {'pipes':>5} {'share':>5} {'credits':>7} "
           f"{'pulls':>8} {'p50 ms':>8} {'p99 ms':>8} {'occ':>5} "
           f"{'verdict':<18}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for name, t in sorted((doc.get("tenants") or {}).items()):
        v = t.get("last_verdict") or {}
        verdict = (f"{v.get('bound')}/{v.get('confidence')}"
                   if v else "-")
        if t.get("paused"):
            verdict = "PAUSED " + verdict
        ms = [t.get("batch_p50_s"), t.get("batch_p99_s")]
        ms = [f"{x * 1e3:.1f}" if x is not None else "-" for x in ms]
        pipes = f"{t.get('pipelines')}/{t.get('max_pipelines')}"
        lines.append(
            f"{name:<12} {pipes:>5} {_fmt(t.get('queue_share'), 0):>5} "
            f"{_fmt(t.get('deficit'), 1):>7} {t.get('pulls', 0):>8} "
            f"{ms[0]:>8} {ms[1]:>8} "
            f"{_fmt(t.get('queue_occupancy')):>5} {verdict:<18}")
        wm = t.get("watermark")
        if wm:
            lines.append(
                f"    stream {wm.get('uri')}: {wm.get('windows')} "
                f"windows, watermark {wm.get('watermark_records')} "
                f"records / {wm.get('watermark_bytes')} bytes "
                f"(advanced {wm.get('last_advance_s_ago')}s ago, "
                f"{wm.get('retries')} degraded polls)")
        if t.get("rejected"):
            lines.append(f"    admission: {t['admitted']} admitted, "
                         f"{t['rejected']} rejected, "
                         f"{t['queued']} queued")
    return "\n".join(lines)


def cmd_tenants(args) -> int:
    port = _default_port(args)
    doc = _fetch(port, "/tenants", host=args.host)
    if "tenants" not in doc:
        # the server's 404 payload ({error, hint}: no scheduler
        # installed) — surface the hint, exit 2 like history/gang
        print(json.dumps(doc))
        return 2
    if args.json:
        print(json.dumps(doc))
        return 0
    print(render_tenants(doc))
    return 0


def render_rpc(doc: Dict[str, Any]) -> str:
    """One /rpc payload -> per-(peer, verb) attribution table: where
    each edge's client-observed latency went (server handle vs
    network+queue residual)."""
    edges = doc.get("edges") or []
    hdr = ["peer", "verb", "count", "err", "cli p50us", "cli p99us",
           "srv p50us", "srv p99us", "net p50us", "srv%"]
    rows: List[List[str]] = []
    for e in sorted(edges, key=lambda e: (e["peer"], e["verb"])):
        cli = e.get("client_us") or {}
        srv = e.get("server_us") or {}
        net = e.get("residual_us") or {}
        attributed = e.get("server_total_us") is not None \
            and e.get("attributed")
        share = "-"
        if attributed:
            total = (e["server_total_us"] or 0.0) \
                + (e["residual_total_us"] or 0.0)
            if total > 0:
                share = f"{e['server_total_us'] / total:.0%}"
        rows.append([
            str(e["peer"]), str(e["verb"]), str(e["count"]),
            str(e["errors"]), _fmt(cli.get("p50"), 0),
            _fmt(cli.get("p99"), 0), _fmt(srv.get("p50"), 0),
            _fmt(srv.get("p99"), 0), _fmt(net.get("p50"), 0), share,
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows
              else len(c) for i, c in enumerate(hdr)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(hdr, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    lines.append("(srv% = server handle share of attributed wire "
                 "wait; the rest is network+queue residual)")
    return "\n".join(lines)


def cmd_rpc(args) -> int:
    port = _default_port(args)
    doc = _fetch(port, "/rpc", host=args.host)
    if "edges" not in doc:
        print(json.dumps(doc))
        return 2
    if args.json:
        print(json.dumps(doc))
        return 0
    if not doc["edges"]:
        print("no RPC edges recorded yet (tracing off, or no "
              "cross-process calls since start)")
        return 0
    print(render_rpc(doc))
    return 0


def render_slo(doc: Dict[str, Any]) -> str:
    """One /slo payload -> per-objective judgment table: windowed
    attainment, error budget remaining, and which burn alert (if any)
    is firing right now."""
    lines = [f"slo: fast-burn >= {doc.get('fast_burn_rate')}x · "
             f"slow-burn >= {doc.get('slow_burn_rate')}x "
             "(both windows of a pair must exceed the rate)"]
    hdr = ["objective", "tenant", "metric", "target", "window",
           "attain", "budget left", "burn", "fast burn", "alert"]
    rows: List[List[str]] = []
    for name, o in sorted((doc.get("objectives") or {}).items()):
        w = o.get("windows") or {}
        alerts = o.get("alerts") or {}
        alert = ("FAST-BURN" if alerts.get("fast")
                 else "slow-burn" if alerts.get("slow") else "-")
        if o.get("incomplete"):
            alert += " (incomplete)"
        att = o.get("attainment")
        rem = o.get("budget_remaining")
        rows.append([
            str(name), str(o.get("tenant") or "-"),
            str(o.get("metric")),
            f"{o.get('target_s')}s", f"{o.get('window_s')}s",
            f"{att:.2%}" if att is not None else "-",
            f"{rem:.0%}" if rem is not None else "-",
            _fmt((w.get("long") or {}).get("burn"), 1),
            _fmt((w.get("fast_short") or {}).get("burn"), 1),
            alert,
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows
              else len(c) for i, c in enumerate(hdr)]
    lines.append("  ".join(c.ljust(w) for c, w in zip(hdr, widths)))
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    lines.append("(burn = long-window burn rate; fast burn = the "
                 "short fast window — the alert's reset edge)")
    if doc.get("incomplete"):
        lines.append(f"INCOMPLETE gang rollup: unreachable "
                     f"{', '.join(doc.get('unreachable') or [])} — "
                     "attainment judged on a subset of the gang")
    return "\n".join(lines)


def cmd_slo(args) -> int:
    port = _default_port(args)
    doc = _fetch(port, "/slo", host=args.host)
    if "objectives" not in doc:
        # the server's 404 payload ({error, hint}: nothing declared)
        # — surface the hint, exit 2 like tenants/control
        print(json.dumps(doc))
        return 2
    if args.json:
        print(json.dumps(doc))
        return 0
    print(render_slo(doc))
    return 0


def _fmt_bytes(n: int) -> str:
    """1536 -> '1.5KiB' — compact byte counts for the row tables."""
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return f"{int(n)}B"


def render_shuffle(doc: Dict[str, Any]) -> str:
    """One /shuffle payload -> the rank's global-shuffle row: the
    permutation identity (seed/epoch/window budget), the coverage
    watermark, and where the exchanged bytes actually came from
    (local page store vs peer /pages tier vs source wire)."""
    rec = doc.get("records_by_tier") or {}
    byt = doc.get("bytes_by_tier") or {}
    cov = doc.get("coverage")
    lines = [
        f"shuffle: seed {doc.get('seed')} · epoch {doc.get('epoch')} "
        f"· rank {doc.get('rank')}/{doc.get('world')} · "
        f"{doc.get('uri')} ({doc.get('split_type')})",
        f"  records {doc.get('records')} in {doc.get('windows')} "
        f"windows (budget {_fmt_bytes(doc.get('window_bytes') or 0)})",
        f"  position {doc.get('position')} · delivered "
        f"{doc.get('delivered')} · coverage "
        + (f"{cov:.2%}" if cov is not None else "-"),
    ]
    hdr = ["tier", "records", "bytes"]
    rows = [[t, str(rec.get(t, 0)), _fmt_bytes(byt.get(t, 0))]
            for t in ("local", "peer", "wire")]
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(hdr)]
    lines.append("  ".join(c.ljust(w) for c, w in zip(hdr, widths)))
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    lines.append("(peer = window pages served by another rank's "
                 "/pages tier; wire = hydrated from the source)")
    return "\n".join(lines)


def cmd_shuffle(args) -> int:
    port = _default_port(args)
    doc = _fetch(port, "/shuffle", host=args.host)
    if "records_by_tier" not in doc:
        # the server's 404 payload ({error, hint}: no shuffle active)
        print(json.dumps(doc))
        return 2
    if args.json:
        print(json.dumps(doc))
        return 0
    print(render_shuffle(doc))
    return 0


def cmd_profile(args) -> int:
    port = _default_port(args)
    qs = []
    if args.seconds is not None:
        qs.append(f"seconds={args.seconds}")
    if args.hz is not None:
        qs.append(f"hz={args.hz}")
    path = "/profile" + ("?" + "&".join(qs) if qs else "")
    doc = _fetch(port, path, host=args.host,
                 timeout_s=max(10.0, (args.seconds or 0) + 10.0))
    if "threads" not in doc:
        # the server's 404 payload ({error, hint}: no profiler
        # installed) — surface the hint, exit 2 like history/gang
        print(json.dumps(doc))
        return 2
    if args.out:
        from dmlc_tpu_torch.obs.export import (
            write_collapsed, write_speedscope,
        )
        if args.format == "speedscope":
            write_speedscope(doc, args.out)
        else:
            write_collapsed(doc, args.out)
        print(f"{args.format} profile -> {args.out} "
              f"({doc['samples']} samples)")
        return 0
    if args.json:
        print(json.dumps(doc))
        return 0
    from dmlc_tpu_torch.obs.profile import hot_frames
    total = doc["samples"]
    wait = doc.get("wait_samples", 0)
    kind = (f"burst {doc.get('duration_s')}s" if doc.get("burst")
            else f"continuous {doc.get('duration_s')}s")
    print(f"{total} samples ({kind} at {doc.get('hz')} Hz), "
          f"{wait} off-cpu"
          + (f" ({wait / total:.0%})" if total else "")
          + f", {doc.get('coarsenings', 0)} coarsenings")
    for h in hot_frames(doc, limit=args.keys):
        print(f"  {h['frac']:>6.1%}  {h['frame']} "
              f"({h['samples']} samples)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="obsctl", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--port", type=int, default=0,
                       help="status-server port (default: "
                            "DMLC_TPU_SERVE_PORT)")
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--json", action="store_true",
                       help="raw JSON output")

    p = sub.add_parser("top", help="live per-stage pipeline table")
    common(p)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("diagnose",
                       help="bottleneck verdict (live rank or BENCH "
                            "JSON)")
    common(p)
    p.add_argument("bench", nargs="?", default=None,
                   help="BENCH JSON to diagnose offline")
    p.set_defaults(fn=cmd_diagnose)

    p = sub.add_parser("compare",
                       help="band-aware diff of two BENCH JSONs")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("history", help="a rank's time-series ring")
    common(p)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--keys", type=int, default=12,
                   help="series keys to summarize")
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser("gang", help="rank 0's merged gang view")
    common(p)
    p.set_defaults(fn=cmd_gang)

    p = sub.add_parser("tenants",
                       help="a rank's /tenants rows (multi-tenant "
                            "pipeline scheduler)")
    common(p)
    p.set_defaults(fn=cmd_tenants)

    p = sub.add_parser("control",
                       help="a rank's /control decision ledger "
                            "(verdict-driven controller)")
    common(p)
    p.add_argument("--last", type=int, default=None,
                   help="fetch only the trailing N ledger records")
    p.add_argument("--keys", type=int, default=12,
                   help="ledger records to render in the summary")
    p.set_defaults(fn=cmd_control)

    p = sub.add_parser("rpc",
                       help="a rank's /rpc edge table (per-peer wire "
                            "latency attribution)")
    common(p)
    p.set_defaults(fn=cmd_rpc)

    p = sub.add_parser("slo",
                       help="a rank's /slo declared objectives "
                            "(attainment, error budget, burn alerts)")
    common(p)
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser("shuffle",
                       help="a rank's /shuffle global-shuffle row "
                            "(seed, epoch, window budget, coverage, "
                            "local/peer/wire exchange)")
    common(p)
    p.set_defaults(fn=cmd_shuffle)

    p = sub.add_parser("profile",
                       help="a rank's merged Python+native flamegraph")
    common(p)
    p.add_argument("--seconds", type=float, default=None,
                   help="burst-capture the next N seconds (default: "
                        "dump the continuous profile)")
    p.add_argument("--hz", type=float, default=None,
                   help="burst sample rate (default: the installed "
                        "profiler's rate)")
    p.add_argument("--out", default=None,
                   help="write the profile to a file instead of "
                        "summarizing")
    p.add_argument("--format", choices=("collapsed", "speedscope"),
                   default="collapsed",
                   help="--out format: collapsed stacks "
                        "(flamegraph.pl) or speedscope JSON")
    p.add_argument("--keys", type=int, default=12,
                   help="hot frames to list in the summary")
    p.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    if args.cmd == "compare" and args.tolerance is None:
        from dmlc_tpu_torch.obs.analyze import DEFAULT_TOLERANCE
        args.tolerance = DEFAULT_TOLERANCE
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except (OSError, urllib.error.URLError) as e:
        print(f"obsctl: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
