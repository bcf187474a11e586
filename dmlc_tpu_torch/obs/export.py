"""Chrome/Perfetto trace-event JSON export + gang-trace merging.

Copy of ``dmlc_tpu/obs/export.py``. One exporter for every
:class:`~dmlc_tpu_torch.obs.trace.TraceRecorder`: ``chrome_events()``
renders the ring buffer into trace-event dicts (the Trace Event Format's
required keys — ``ph``/``ts``/``pid``/``tid``/``name``), ``write_chrome()``
wraps them in the ``{"traceEvents": [...]}`` envelope Perfetto and
chrome://tracing both load, and ``merge_chrome_files()`` concatenates
per-worker trace files from a :mod:`dmlc_tpu_torch.parallel.launch` gang
onto one timeline — events stay distinguishable because every process
tags its own ``pid`` (and a rank-named process_name metadata track).

The sampling profiler (:mod:`dmlc_tpu_torch.obs.profile`) exports
through here too, from the same ``to_dict()`` payload the ``/profile``
endpoint serves: ``collapsed_lines()``/``write_collapsed()`` render the
collapsed-stack format (one ``frame;frame;... N`` line per path),
``speedscope_doc()``/``write_speedscope()`` the sampled-profile JSON
speedscope loads directly.

RPC spans (``obs.rpc``) carry a trace context (``trace_id-span_id``
under the ``trace`` arg) that becomes Perfetto flow events
(:func:`_trace_id`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from dmlc_tpu_torch.obs.metrics import worker_rank
from dmlc_tpu_torch.obs.trace import (CAT_RPC_CLIENT, CAT_RPC_SERVER,
                                      TraceRecorder)

__all__ = ["chrome_events", "write_chrome", "merge_chrome_files",
           "collapsed_lines", "write_collapsed", "speedscope_doc",
           "write_speedscope", "worker_rank"]

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


# ------------------------------------------------ profile exports

def _walk_profile(doc: Dict[str, Any]):
    """Yield (path, weight) for every weighted node of a profile
    ``to_dict()`` payload — ``path`` is root-first starting at the
    thread label; folded (coarsened-away) weight rides a synthetic
    ``[coarsened]`` leaf so no sample weight is ever dropped from an
    export."""
    from dmlc_tpu_torch.obs.profile import FOLDED_FRAME

    def _visit(node: Dict[str, Any], path: List[str]):
        path = path + [node.get("name") or "?"]
        n = int(node.get("self") or 0)
        if n:
            yield path, n
        folded = int(node.get("folded") or 0)
        if folded:
            yield path + [FOLDED_FRAME], folded
        for child in node.get("children") or []:
            yield from _visit(child, path)

    for root in (doc.get("threads") or {}).values():
        yield from _visit(root, [])


def collapsed_lines(doc: Dict[str, Any]) -> List[str]:
    """Profile payload -> collapsed-stack lines
    (``thread;frame;frame N``), sorted for stable diffs."""
    return sorted(f"{';'.join(path)} {n}"
                  for path, n in _walk_profile(doc))


def write_collapsed(doc: Dict[str, Any], path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(collapsed_lines(doc)) + "\n")
    os.replace(tmp, path)
    return path


def speedscope_doc(doc: Dict[str, Any],
                   name: str = "dmlc_tpu_torch profile") -> Dict[str, Any]:
    """Profile payload -> a speedscope "sampled" profile document
    (shared frame table + per-path sample/weight arrays; the thread
    label is the root frame, so one flamegraph carries the whole
    process — Python threads and native phase tracks side by side)."""
    frames: List[str] = []
    index: Dict[str, int] = {}

    def fi(frame: str) -> int:
        i = index.get(frame)
        if i is None:
            i = index[frame] = len(frames)
            frames.append(frame)
        return i

    samples: List[List[int]] = []
    weights: List[int] = []
    for path, n in _walk_profile(doc):
        samples.append([fi(p) for p in path])
        weights.append(n)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "dmlc_tpu_torch.obs",
        "shared": {"frames": [{"name": f} for f in frames]},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
    }


def write_speedscope(doc: Dict[str, Any], path: str,
                     name: str = "dmlc_tpu_torch profile") -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(speedscope_doc(doc, name=name), f)
    os.replace(tmp, path)
    return path
