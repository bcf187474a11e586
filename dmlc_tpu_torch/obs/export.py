"""Chrome/Perfetto trace-event JSON export + gang-trace merging.

Copy of ``dmlc_tpu/obs/export.py`` up to its sampling-profiler renderers
(which wait for the port of ``obs/profile.py``). One exporter for every
:class:`~dmlc_tpu_torch.obs.trace.TraceRecorder`: ``chrome_events()``
renders the ring buffer into trace-event dicts (the Trace Event Format's
required keys — ``ph``/``ts``/``pid``/``tid``/``name``), ``write_chrome()``
wraps them in the ``{"traceEvents": [...]}`` envelope Perfetto and
chrome://tracing both load, and ``merge_chrome_files()`` concatenates
per-worker trace files from a :mod:`dmlc_tpu_torch.parallel.launch` gang
onto one timeline — events stay distinguishable because every process
tags its own ``pid`` (and a rank-named process_name metadata track).

The reference's RPC spans carry a trace context (``trace_id-span_id``
under the ``trace`` arg) that becomes Perfetto flow events; the port
keeps that rendering (:func:`_trace_id`) though no port module emits
such spans yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from dmlc_tpu_torch.obs.metrics import worker_rank
from dmlc_tpu_torch.obs.trace import (CAT_RPC_CLIENT, CAT_RPC_SERVER,
                                      TraceRecorder)

__all__ = ["chrome_events", "write_chrome", "merge_chrome_files",
           "worker_rank"]

# the span arg that carries an RPC span's serialized trace context
TRACE_FIELD = "trace"


def _trace_id(value: Any) -> Optional[str]:
    """The trace_id of a serialized ``trace_id-span_id`` context; None
    for anything malformed (wrong type, no dash, an empty half)."""
    if not isinstance(value, str):
        return None
    trace_id, dash, span_id = value.partition("-")
    if not dash or not trace_id or not span_id:
        return None
    return trace_id


def chrome_events(rec: TraceRecorder,
                  pid: Optional[int] = None,
                  process_name: Optional[str] = None) -> List[Dict[str, Any]]:
    """Render a recorder's ring buffer as trace-event dicts.

    Spans become complete ("X") events, instants "i", counter samples
    "C" (one track per counter name, one series per dict key — the
    shape Perfetto draws as stacked counter tracks). Metadata ("M")
    events name the process (rank-tagged when launched in a gang) and
    every recording thread.

    RPC spans (cat ``rpc.client``/``rpc.server``) additionally
    emit Perfetto flow events bound by their trace_id — a flow start
    ("s") inside the client slice and a binding flow finish ("f",
    ``bp: "e"``) inside the server slice — so a merged gang trace draws
    an arrow from each caller to the serving rank's handler, retries
    included (every attempt shares the operation's trace_id).
    """
    if pid is None:
        pid = os.getpid()
    rank = worker_rank()
    if process_name is None:
        process_name = (f"dmlc_tpu_torch rank {rank}" if rank is not None
                        else f"dmlc_tpu_torch pid {pid}")
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0,
        "args": {"name": process_name},
    }]
    for ident, tname in sorted(rec.thread_names().items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": ident, "ts": 0, "args": {"name": tname}})
    for ph, name, cat, t_s, dur_s, tid, args in rec.events():
        ev: Dict[str, Any] = {
            "ph": ph, "name": name, "pid": pid, "tid": tid,
            "ts": round(rec.ts_us(t_s), 3),
        }
        if cat:
            ev["cat"] = cat
        if ph == "X":
            ev["dur"] = round(dur_s * 1e6, 3)
            if args:
                ev["args"] = args
            if cat in (CAT_RPC_CLIENT, CAT_RPC_SERVER) and args:
                trace_id = _trace_id(args.get(TRACE_FIELD))
                if trace_id is not None:
                    flow: Dict[str, Any] = {
                        "name": "rpc.flow", "cat": "rpc",
                        "id": trace_id, "pid": pid, "tid": tid,
                        "ts": ev["ts"],
                    }
                    if cat == CAT_RPC_CLIENT:
                        flow["ph"] = "s"
                    else:
                        flow["ph"] = "f"
                        flow["bp"] = "e"  # bind to enclosing slice
                    out.append(ev)
                    out.append(flow)
                    continue
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
        else:  # "C": args IS the series dict
            ev["args"] = args or {}
        out.append(ev)
    return out


def write_chrome(rec: TraceRecorder, path: str,
                 pid: Optional[int] = None,
                 process_name: Optional[str] = None) -> Dict[str, Any]:
    """Export one recorder to a Chrome trace-event JSON file. Returns
    the envelope that was written (handy for tests)."""
    doc = {
        "traceEvents": chrome_events(rec, pid=pid,
                                     process_name=process_name),
        "displayTimeUnit": "ms",
        "otherData": {
            "recorded": rec.recorded,
            "dropped": rec.dropped,
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


def merge_chrome_files(paths: List[str], out_path: str) -> Dict[str, Any]:
    """Concatenate per-worker trace files onto one timeline.

    Every worker exports with its own ``pid`` and a rank-tagged
    process_name track, and timestamps are wall-anchored at recording
    time (obs.trace), so merging is pure concatenation — Perfetto lays
    the gang out as one process row per rank."""
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        events.extend(doc.get("traceEvents", []))
        meta.append({"file": os.path.basename(p),
                     **doc.get("otherData", {})})
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "otherData": {"merged_from": meta}}
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, out_path)
    return merged
