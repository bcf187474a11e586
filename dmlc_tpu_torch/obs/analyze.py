"""Bottleneck attribution: turn recorded telemetry into a verdict.

Copy of ``dmlc_tpu/obs/analyze.py`` with its imports rewritten to
``dmlc_tpu_torch``; the verdict keys are the reference's.

A pipeline's epochs have been
interpreted by a human reading JSON files: stage waits here, credit
gauges there, assembly path in a third key. This module is that
judgment as code, decomposing an epoch from data the plane ALREADY
records — ``StageProbe`` wait totals, the device stage's
``xfer_wait_s``/``staging_assemble_s`` extras, the fused engine's
``assemble_s``, pagestore/objstore hit counters, and the credit-gauge
bands bench.py computes — into one structured verdict:

``{"schema": 4, "epoch": <monotonic>, "verdict_id": "v<epoch>-<digest>",
"tenant": <label or None>, "bound": "parse" | "assemble" | "xfer" |
"wire" | "credit-limited" | "consumer", "band": <credit band>,
"confidence": "high" | "medium" | "low", "evidence": [...],
"hot_frames": [...], "stage_waits": {...}}``

``tenant`` (schema 4) is the multi-tenant label: a pipeline admitted
under a :mod:`dmlc_tpu_torch.pipeline.scheduler` tenant stamps its epoch
snapshots with the tenant name, so the verdict says WHOSE epoch it
judged — the ``/tenants`` rows cite a per-tenant bound, and the
controller's ledger records inherit it through the verdict. None for
untenanted pipelines.

``epoch``/``verdict_id`` (schema 3) make verdicts citable: the epoch
is the snapshot's monotonic counter and the id digests what was
judged, so a control-plane ledger record (:mod:`dmlc_tpu_torch.obs.control`)
can reference the EXACT verdict that moved a knob.

``hot_frames`` (schema 2) is function-level evidence from the
sampling profiler (:mod:`dmlc_tpu_torch.obs.profile`) when one is
installed: the top on-CPU frames whose call path matches the bound
component — the first rung below stage granularity, "parse-bound"
becomes "parse-bound, and it is THIS function". Empty when no
profiler runs (the verdict says which stage, not which frame).

The key set is pinned by ``scripts/lint.py``'s verdict-schema gate (a
literal-dict key check like the metric-name gate), so the ``/analyze``
endpoint, bench.py's embedded ``"analysis"`` block, and
the obsctl CLI can never drift apart. Every evidence entry
names the MEASURED quantity it rests on — two legs with different
stage waits can share a ``bound`` but never share evidence.

The second half is regression judgment: :func:`compare` diffs two
BENCH JSONs band-for-band (BASELINE.md's credit-recovery bands), so
in-band credit variance — the ~10x wall-rate swing this burstable
host's credit scheduler causes — is reported as variance, and only an
out-of-tolerance delta WITHIN one comparability band flags as a
regression.
"""

from __future__ import annotations

import hashlib as _hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["attribute", "slo_verdict", "compare", "compare_files",
           "load_bench", "diagnose_bench", "gauge_band",
           "VERDICT_KEYS", "BOUNDS", "ANALYSIS_SCHEMA",
           "DEFAULT_TOLERANCE"]

# bump when the verdict's top-level shape changes incompatibly
# (2: hot_frames — sampling-profiler function-level evidence;
#  3: epoch + verdict_id — the control ledger back-references the
#  exact verdict that moved a knob;
#  4: tenant — multi-tenant snapshots carry a tenant label, so a
#  verdict says WHOSE epoch it judged and the /tenants rows can cite
#  a per-tenant bound; None for untenanted pipelines)
ANALYSIS_SCHEMA = 4

# the verdict's pinned key set — scripts/lint.py's verdict-schema gate
# checks every literal verdict dict in the package against this tuple
VERDICT_KEYS = ("schema", "epoch", "verdict_id", "tenant", "bound",
                "band", "confidence", "evidence", "hot_frames",
                "stage_waits")

BOUNDS = ("parse", "assemble", "xfer", "wire", "credit-limited",
          "consumer",
          # a declared objective burning its error budget (obs.slo) —
          # not a stage, but it rides the same verdict contract so the
          # Controller can consume it without a second shape
          "slo")

# in-band delta tolerated before compare() flags a regression: the
# BENCH_r0* archive shows ~±12% sustained-rate spread across same-band
# reruns with no code change (credit/thermal climate), so the default
# sits just above it
DEFAULT_TOLERANCE = 0.15

# below this fraction of wall spent waiting on ANY stage, the pipeline
# is not the bottleneck — whoever consumes it is
_CONSUMER_WAIT_FRAC = 0.15


def gauge_band(g: Optional[float]) -> str:
    """Credit-comparability band of one host-memcpy gauge reading
    (BASELINE.md "Credit-recovery profile"). The ONE implementation —
    bench.py and compare() both read bands through here."""
    if g is None:
        return "unknown"
    if g < 1.0:
        return "drained"
    if g < 1.6:
        return "plateau"
    if g < 3.0:
        return "elevated"
    return "full"


def _modal_band(gauges: Optional[List[float]]) -> str:
    if not gauges:
        return "unknown"
    counts: Dict[str, int] = {}
    for g in gauges:
        b = gauge_band(g)
        counts[b] = counts.get(b, 0) + 1
    return max(counts, key=lambda b: counts[b])


def _counter(metrics: Optional[Dict[str, Any]], name: str) -> float:
    if not metrics:
        return 0.0
    v = (metrics.get("counters") or {}).get(name)
    return float(v) if isinstance(v, (int, float)) else 0.0


# call-path substrings that tie a sampled frame to a bound component:
# hot_frames for bound=X keeps frames whose path matches X's hints
# (falling back to the overall top when nothing matches — an honest
# "hottest frames overall" beats fabricated stage attribution)
_BOUND_FRAME_HINTS = {
    "parse": ("native:parse", "native:read", "parser", "parse",
              "tokenize", "strtonum", "recordio", "input_split",
              "parquet", "pyarrow"),
    "assemble": ("native:assemble", "native:gang_assemble", "padding",
                 "assemble", "stack_padded", "pad_to_bucket",
                 "pad_single"),
    "xfer": ("device", "xfer", "transfer", "staging", "backends"),
    "wire": ("objstore", "urlopen", "http", "emulator", "pagestore"),
}


def _hot_frames_for(bound: str,
                    profile_doc: Optional[Dict[str, Any]] = None,
                    limit: int = 8
                    ) -> Tuple[List[Dict[str, Any]], str]:
    """Top on-CPU frames of the bound component, from an explicit
    profile ``to_dict()`` payload or the process's installed sampling
    profiler. Returns ``(frames, scope)`` — scope "bound" when the
    frames actually matched the bound's hints, "overall" when the
    bound HAS no frame vocabulary (consumer/credit-limited), and
    "fallback" when hints existed but nothing matched (the evidence
    line must SAY which, or the fallback fabricates the very stage
    attribution it exists to avoid). ``([], "bound")`` when nothing
    was sampled at all."""
    if profile_doc is None:
        try:
            from dmlc_tpu_torch.obs import profile as _prof
            p = _prof.active()
            profile_doc = p.to_dict() if p is not None else None
        except Exception:  # noqa: BLE001 — evidence is optional
            profile_doc = None
    if not profile_doc or not profile_doc.get("samples"):
        return [], "bound"
    from dmlc_tpu_torch.obs.profile import hot_frames
    hints = _BOUND_FRAME_HINTS.get(bound)
    if hints is None:
        return hot_frames(profile_doc, hints=None, limit=limit), \
            "overall"
    out = hot_frames(profile_doc, hints=hints, limit=limit)
    if out:
        return out, "bound"
    return hot_frames(profile_doc, hints=None, limit=limit), \
        "fallback"


def attribute(pipeline_snap: Dict[str, Any],
              metrics: Optional[Dict[str, Any]] = None,
              epoch_gauges: Optional[List[float]] = None,
              run_band: Optional[str] = None,
              profile_doc: Optional[Dict[str, Any]] = None,
              epoch: Optional[int] = None
              ) -> Dict[str, Any]:
    """Decompose one epoch into a bound verdict.

    ``pipeline_snap`` is a pipeline stats snapshot
    (``PIPELINE_STATS_SCHEMA``: ``CompiledPipeline.stats()``, the
    ``pipeline`` collector in a registry snapshot, or the ``pipeline``
    block of a BENCH JSON). ``metrics`` is an optional registry
    snapshot for the wire-side counters (pagestore/objstore hit
    rates). ``epoch_gauges``/``run_band`` carry bench.py's credit
    gauges when available — without them the credit-limited bound
    cannot be claimed and the verdict says so. ``profile_doc`` is an
    optional :mod:`dmlc_tpu_torch.obs.profile` ``to_dict()`` payload for
    the ``hot_frames`` evidence; when omitted, the process's
    installed sampling profiler (if any) is read.

    ``epoch`` (schema 3) defaults to the snapshot's own monotonic
    epoch counter; with it the verdict carries a stable
    ``verdict_id`` (epoch + a content digest), so a control-ledger
    record can reference the EXACT verdict that moved a knob.
    """
    stages = list(pipeline_snap.get("stages") or [])
    wall = float(pipeline_snap.get("wall_s") or 0.0)
    per_stage: Dict[str, float] = {}
    parse_s = assemble_s = xfer_s = 0.0
    assembly_path = None
    decode_path = None
    decode_wait = decode_bytes = 0
    occupancies: List[Tuple[str, float]] = []
    fused_first = False
    fused_assemble = 0.0
    for i, st in enumerate(stages):
        name = str(st.get("name", "?"))
        kind = st.get("kind")
        wait = float(st.get("wait_s") or 0.0)
        per_stage[name] = round(wait, 6)
        x = st.get("extra") or {}
        if kind == "parse":
            parse_s += wait
        elif i == 0 and kind == "assemble":
            # the fused native rung (ABI-5) folds parse INTO the first
            # assemble-kind stage: its delivery wait is the parse side,
            # with THIS stage's own measured assemble seconds carved
            # out below (not the whole pipeline's — downstream staging
            # assembly belongs to other stages). Only the fused shape
            # earns the credit — a cache- or shard-first pipeline's
            # stage-0 wait is replay/shard I/O, not parsing.
            parse_s += wait
            fused_first = True
            fused_assemble = (float(x.get("assemble_s") or 0.0)
                              + float(x.get("staging_assemble_s")
                                      or 0.0))
        assemble_s += float(x.get("assemble_s") or 0.0)
        assemble_s += float(x.get("staging_assemble_s") or 0.0)
        xfer_s += float(x.get("xfer_wait_s") or 0.0)
        if x.get("assembly_path"):
            assembly_path = x["assembly_path"]
        if x.get("decode_path"):
            # which decoder served the epoch (parquet: pyarrow golden
            # vs the native page decoder) + what it measurably moved
            decode_path = x["decode_path"]
            decode_wait = wait
            decode_bytes = int(x.get("bytes_read") or st.get("bytes")
                               or 0)
        occ = st.get("queue_occupancy")
        if occ is not None:
            occupancies.append((name, float(occ)))
    if fused_first:
        parse_s = max(0.0, parse_s - fused_assemble)
    total_wait = sum(per_stage.values())

    # wire side: pagestore hit rate + objstore GET traffic (cumulative
    # process counters — a cold remote epoch shows misses and GETs).
    # objstore.bytes counts ON-WIRE bytes (compressed when the page
    # codec is on); objstore.bytes_served the decompressed payload —
    # the wire-heaviness judgment uses the SERVED side (that is what
    # the pipeline consumed), the evidence names both rates.
    ps_hit = _counter(metrics, "pagestore.hit")
    ps_miss = _counter(metrics, "pagestore.miss")
    obj_gets = _counter(metrics, "objstore.get")
    obj_bytes = _counter(metrics, "objstore.bytes")
    obj_served = _counter(metrics, "objstore.bytes_served")
    obj_payload = obj_served or obj_bytes
    peer_gets = _counter(metrics, "objstore.peer.get")
    peer_bytes = _counter(metrics, "objstore.peer.bytes")
    peer_miss = _counter(metrics, "objstore.peer.miss")
    hit_rate = (ps_hit / (ps_hit + ps_miss)
                if (ps_hit + ps_miss) else None)
    pipeline_bytes = max((int(st.get("bytes") or 0) for st in stages),
                         default=0)
    wire_heavy = (obj_gets > 0 and obj_payload >= 0.5 * pipeline_bytes
                  and (hit_rate is None or hit_rate < 0.5))

    band = run_band or _modal_band(epoch_gauges)
    evidence: List[str] = []
    waits = {"parse": parse_s, "assemble": assemble_s, "xfer": xfer_s}

    if band != "unknown":
        mean_g = (round(sum(epoch_gauges) / len(epoch_gauges), 2)
                  if epoch_gauges else None)
        evidence.append(
            f"credit band {band}"
            + (f" (mean memcpy gauge {mean_g} GB/s over "
               f"{len(epoch_gauges)} epochs)" if mean_g is not None
               else ""))
    for comp, s in sorted(waits.items(), key=lambda kv: -kv[1]):
        if s > 0:
            frac = f" = {s / wall:.0%} of wall" if wall > 0 else ""
            evidence.append(f"{comp} wait {round(s, 4)}s{frac}")
    if assembly_path:
        evidence.append(f"assembly_path={assembly_path}")
    if decode_path:
        # the DECODE-bound leg: a config-5-shaped epoch's verdict says
        # WHICH decode path was the wall and how fast it actually ran
        # (the controller maps parse-bound onto the parse knob
        # family — shard count first — either way)
        line = f"decode path {decode_path}"
        if decode_wait > 0 and decode_bytes:
            line += (f": {decode_bytes / decode_wait / 1e9:.2f} GB/s "
                     f"({decode_bytes} bytes over "
                     f"{round(decode_wait, 4)}s decode-stage wait)")
        evidence.append(line)
    if hit_rate is not None:
        evidence.append(f"pagestore hit rate {hit_rate:.2f} "
                        f"({int(ps_hit)} hit / {int(ps_miss)} miss)")
    if obj_gets:
        line = (f"objstore: {int(obj_gets)} GETs, "
                f"{int(obj_bytes)} wire bytes vs "
                f"{pipeline_bytes} pipeline bytes")
        if obj_served > obj_bytes:
            # page codec on: the wire moved fewer bytes than it served
            line += (f" (codec: {int(obj_served)} bytes served from "
                     f"{int(obj_bytes)} on-wire, "
                     f"{obj_served / obj_bytes:.1f}x")
            if wall > 0:
                line += (f"; {obj_bytes / wall / 1e9:.3f} GB/s "
                         "compressed wire -> "
                         f"{obj_served / wall / 1e9:.3f} GB/s served")
            line += ")"
        evidence.append(line)
    if peer_gets or peer_bytes or peer_miss:
        # the gang peer tier split: bytes that arrived from peers'
        # /pages endpoints never touched the wire — the 1/N claim,
        # named as rates so a wire verdict says which tier carried it
        line = (f"peer tier: {int(peer_gets)} peer GETs, "
                f"{int(peer_bytes)} peer-served bytes, "
                f"{int(peer_miss)} degraded to the wire")
        if wall > 0 and (peer_bytes or obj_payload):
            line += (f" ({peer_bytes / wall / 1e9:.3f} GB/s "
                     "peer-served vs "
                     f"{obj_payload / wall / 1e9:.3f} GB/s "
                     "wire-served)")
        evidence.append(line)
    rpc = ((metrics or {}).get("collectors") or {}).get("rpc")
    if isinstance(rpc, dict) and rpc.get("attributed"):
        # the RPC edge table's wire-wait decomposition (obs.rpc):
        # server-reported handle time vs the network+queue residual —
        # a wire verdict names WHERE the waiting actually happened
        server = float(rpc.get("server_us") or 0.0)
        residual = float(rpc.get("residual_us") or 0.0)
        attributed = server + residual
        if attributed > 0:
            evidence.append(
                f"wire wait: {server / attributed:.0%} server handle, "
                f"{residual / attributed:.0%} network+queue residual "
                f"over {int(rpc.get('attributed', 0))} attributed "
                f"RPCs ({int(rpc.get('count', 0))} total, "
                f"{int(rpc.get('errors', 0))} errors)")
    ck_restore = _counter(metrics, "checkpoint.restore_bytes")
    if ck_restore:
        # the checkpoint fanout split: of the bytes restore()
        # materialized, how many each tier carried — peer-served pages
        # are the ~1/N-wire claim for gang restores, named as rates
        ck_local = _counter(metrics, "checkpoint.restore.local_bytes")
        ck_peer = _counter(metrics, "checkpoint.restore.peer_bytes")
        ck_wire = _counter(metrics, "checkpoint.restore.wire_bytes")
        line = (f"checkpoint restore: {int(ck_restore)} bytes "
                f"({int(ck_local)} local, {int(ck_peer)} peer-served, "
                f"{int(ck_wire)} wire)")
        if wall > 0 and (ck_peer or ck_wire):
            line += (f" — {ck_peer / wall / 1e9:.3f} GB/s peer-served "
                     f"vs {ck_wire / wall / 1e9:.3f} GB/s wire-served")
        evidence.append(line)
    resharded = _counter(metrics, "rendezvous.reshard")
    mem_joins = _counter(metrics, "rendezvous.join")
    mem_deaths = _counter(metrics, "rendezvous.death")
    if resharded or mem_joins or mem_deaths:
        # the gang changed shape DURING this epoch: wire/peer deltas
        # above include reshard traffic (new owners fast-forwarding
        # over the page store), so the verdict names the membership
        # change instead of letting it read as a wire regression
        evidence.append(
            f"membership: {int(resharded)} reshard(s) this epoch "
            f"({int(mem_joins)} join / {int(mem_deaths)} death; "
            "gang/member/* instants on the trace, roster on /gang)")
    for name, occ in occupancies:
        if occ >= 0.8:
            evidence.append(f"queue {name} {occ:.0%} full "
                            "(producer outpacing consumer)")

    # the decision ladder: climate first (a drained credit bucket
    # swamps every in-pipeline signal), then the wire, then whichever
    # measured wait dominates, with tiny-wait epochs handed to the
    # consumer
    ranked = sorted(waits.items(), key=lambda kv: -kv[1])
    top_name, top_s = ranked[0]
    second_s = ranked[1][1]
    if band == "drained":
        bound = "credit-limited"
        confidence = "high"
        evidence.insert(0, "modal gauge band is drained: wall rates "
                        "reflect the credit scheduler, not the "
                        "pipeline")
    elif wire_heavy:
        bound = "wire"
        confidence = "high" if (hit_rate or 0) < 0.2 else "medium"
    elif wall > 0 and total_wait < _CONSUMER_WAIT_FRAC * wall:
        bound = "consumer"
        confidence = "high" if total_wait < 0.05 * wall else "medium"
        evidence.insert(0, f"stage waits total {round(total_wait, 4)}s "
                        f"= {total_wait / wall:.0%} of wall "
                        f"{round(wall, 4)}s — the pipeline is not the "
                        "bottleneck")
    elif top_s <= 0:
        bound = "consumer"
        confidence = "low"
        evidence.insert(0, "no stage reported a wait; defaulting to "
                        "consumer-bound")
    else:
        bound = top_name
        if second_s <= 0 or top_s >= 2.0 * second_s:
            confidence = "high"
        elif top_s >= 1.2 * second_s:
            confidence = "medium"
        else:
            confidence = "low"
            evidence.append(
                f"close call: {ranked[0][0]} {round(top_s, 4)}s vs "
                f"{ranked[1][0]} {round(second_s, 4)}s")
    hot, hot_scope = _hot_frames_for(bound, profile_doc)
    if hot:
        label = {"bound": f"hot frames ({bound})",
                 "overall": "hot frames (overall)",
                 "fallback": f"hot frames (overall — no sampled "
                             f"frame matched the {bound} stage)"
                 }[hot_scope]
        evidence.append(
            f"{label}: "
            + ", ".join(f"{h['frame']} {h['frac']:.0%}"
                        for h in hot[:3]))
    if epoch is None:
        try:
            epoch = int(pipeline_snap.get("epoch") or 0)
        except (TypeError, ValueError):
            epoch = 0
    stage_waits = {
        "parse_s": round(parse_s, 6),
        "assemble_s": round(assemble_s, 6),
        "xfer_s": round(xfer_s, 6),
        "total_wait_s": round(total_wait, 6),
        "wall_s": round(wall, 6),
        "stages": per_stage,
    }
    # stable id: the monotonic epoch + a digest of what was judged —
    # two verdicts over the same measurements share an id, a ledger
    # record can reference exactly the verdict that moved its knob
    tenant = pipeline_snap.get("tenant")
    digest = _hashlib.sha256(json.dumps(
        [epoch, tenant, bound, band, stage_waits],
        sort_keys=True).encode()).hexdigest()[:10]
    return {
        "schema": ANALYSIS_SCHEMA,
        "epoch": epoch,
        "verdict_id": f"v{epoch}-{digest}",
        "tenant": tenant,
        "bound": bound,
        "band": band,
        "confidence": confidence,
        "evidence": evidence,
        "hot_frames": hot,
        "stage_waits": stage_waits,
    }


def slo_verdict(name: str, row: Dict[str, Any],
                epoch: Optional[int] = None) -> Dict[str, Any]:
    """A burning SLO as a verdict: called by ``SloEngine.verdicts()``
    for each objective whose fast/slow burn alert fires, so budget
    burn rides the same ``/analyze`` → Controller → ledger path as
    stage attribution (the verdict only: no knob moves on it).
    ``row`` is one objective row from
    ``SloEngine.view()``; bound is always ``slo``, band names WHICH
    alert (``fast-burn`` / ``slow-burn``)."""
    alerts = row.get("alerts") or {}
    band = "fast-burn" if alerts.get("fast") else "slow-burn"
    windows = row.get("windows") or {}
    long_total = int((windows.get("long") or {}).get("total") or 0)
    # confidence scales with how many observations back the judgment
    confidence = ("high" if long_total >= 100
                  else "medium" if long_total >= 10 else "low")
    evidence = [
        f"objective {name}: {row.get('metric')} <= "
        f"{row.get('target_s')}s over {row.get('window_s')}s, "
        f"budget {row.get('budget')}",
        f"budget_remaining {row.get('budget_remaining')} "
        f"(attainment {row.get('attainment')})",
    ]
    for label in ("long", "short", "fast_long", "fast_short"):
        w = windows.get(label) or {}
        evidence.append(
            f"{label} {w.get('window_s')}s: burn {w.get('burn')} "
            f"({w.get('good')}/{w.get('total')} good)")
    epoch = int(epoch or 0)
    tenant = row.get("tenant") or name
    digest = _hashlib.sha256(json.dumps(
        [epoch, tenant, "slo", band, evidence],
        sort_keys=True).encode()).hexdigest()[:10]
    return {
        "schema": ANALYSIS_SCHEMA,
        "epoch": epoch,
        "verdict_id": f"v{epoch}-{digest}",
        "tenant": tenant,
        "bound": "slo",
        "band": band,
        "confidence": confidence,
        "evidence": evidence,
        "hot_frames": [],
        "stage_waits": {},
    }


# ------------------------------------------------------- BENCH compare

def load_bench(path_or_doc) -> Dict[str, Any]:
    """Load a BENCH JSON: either the raw one-line dict bench.py
    prints, or the campaign wrapper the BENCH_r0*.json archive uses
    (``{"n", "cmd", "rc", "tail", "parsed"}`` — ``parsed`` is the
    bench line; older wrappers may only carry it inside ``tail``)."""
    if isinstance(path_or_doc, dict):
        doc = path_or_doc
    else:
        with open(path_or_doc) as f:
            doc = json.load(f)
    # bench_suite config lines (config 14 recio_native etc.) carry
    # "config" + "gbps": comparable band-for-band via their
    # epoch_gauges/gbps fallback in _bands_of
    if "metric" in doc or "pipeline" in doc or "config" in doc:
        return doc
    if isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    for line in reversed((doc.get("tail") or "").splitlines()):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                inner = json.loads(line)
            except ValueError:
                continue
            if "metric" in inner:
                return inner
    raise ValueError("not a BENCH JSON (no metric/parsed/tail line)")


def _bands_of(doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-band sustained rates of one BENCH doc. Prefers the
    ``gauge_bands`` block (present in newer docs); older docs fall back to
    their modal band (from ``epoch_gauges``) carrying
    ``sustained_gauge_ok``/``value`` — and a doc with no gauges at all
    lands in band "unknown", comparable only with another unknown."""
    out: Dict[str, Dict[str, Any]] = {}
    gb = doc.get("gauge_bands")
    if isinstance(gb, dict):
        for band, v in gb.items():
            if isinstance(v, dict) and v.get("sustained") is not None:
                out[band] = {"sustained": v["sustained"],
                             "epochs": v.get("epochs")}
    if out:
        return out
    band = doc.get("run_band") or _modal_band(doc.get("epoch_gauges"))
    value = doc.get("sustained_gauge_ok")
    if value is None:
        value = doc.get("value")
    if value is None:
        value = doc.get("gbps")  # bench_suite config lines
    if value is not None:
        out[band] = {"sustained": value, "epochs": doc.get("epochs")}
    return out


def compare(doc_a: Dict[str, Any], doc_b: Dict[str, Any],
            tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Band-aware diff of two BENCH docs (a = baseline, b = candidate).

    Rates are compared WITHIN one credit band only; a band present in
    just one run is reported ``incomparable`` (the climate differed,
    not necessarily the code). ``parse_cpu_gbps_core`` — the
    credit-immune kernel rate — is compared across the whole run
    regardless of band. Deltas within ±``tolerance`` are ``in-band``
    variance, never regressions."""
    a, b = load_bench(doc_a), load_bench(doc_b)
    bands_a, bands_b = _bands_of(a), _bands_of(b)
    rows: Dict[str, Dict[str, Any]] = {}
    regressions: List[str] = []
    improvements: List[str] = []
    for band in sorted(set(bands_a) | set(bands_b)):
        ra, rb = bands_a.get(band), bands_b.get(band)
        if ra is None or rb is None:
            rows[band] = {"a": ra and ra["sustained"],
                          "b": rb and rb["sustained"],
                          "epochs": [ra and ra.get("epochs"),
                                     rb and rb.get("epochs")],
                          "delta_frac": None,
                          "status": "incomparable"}
            continue
        va, vb = float(ra["sustained"]), float(rb["sustained"])
        delta = (vb - va) / va if va else None
        if delta is None:
            status = "incomparable"
        elif delta < -tolerance:
            status = "regression"
            regressions.append(
                f"band {band}: {va} -> {vb} GB/s ({delta:+.1%})")
        elif delta > tolerance:
            status = "improvement"
            improvements.append(
                f"band {band}: {va} -> {vb} GB/s ({delta:+.1%})")
        else:
            status = "in-band"
        rows[band] = {"a": va, "b": vb,
                      "epochs": [ra.get("epochs"), rb.get("epochs")],
                      "delta_frac": (round(delta, 4)
                                     if delta is not None else None),
                      "status": status}
    cpu = None
    ca, cb = a.get("parse_cpu_gbps_core"), b.get("parse_cpu_gbps_core")
    if ca and cb:
        delta = (cb - ca) / ca
        status = ("regression" if delta < -tolerance else
                  "improvement" if delta > tolerance else "in-band")
        if status == "regression":
            regressions.append(
                f"parse_cpu_gbps_core (credit-immune): {ca} -> {cb} "
                f"({delta:+.1%})")
        elif status == "improvement":
            improvements.append(
                f"parse_cpu_gbps_core (credit-immune): {ca} -> {cb} "
                f"({delta:+.1%})")
        cpu = {"a": ca, "b": cb, "delta_frac": round(delta, 4),
               "status": status}
    return {
        "schema": ANALYSIS_SCHEMA,
        "tolerance": tolerance,
        "a": {"value": a.get("value"), "run_band": a.get("run_band"),
              "bound": a.get("bound"), "epochs": a.get("epochs")},
        "b": {"value": b.get("value"), "run_band": b.get("run_band"),
              "bound": b.get("bound"), "epochs": b.get("epochs")},
        "bands": rows,
        "parse_cpu": cpu,
        "regressions": regressions,
        "improvements": improvements,
    }


def compare_files(path_a: str, path_b: str,
                  tolerance: float = DEFAULT_TOLERANCE
                  ) -> Dict[str, Any]:
    return compare(load_bench(path_a), load_bench(path_b),
                   tolerance=tolerance)


def diagnose_bench(path_or_doc) -> Dict[str, Any]:
    """Attribute a finished BENCH run offline from its embedded
    telemetry (pipeline stage snapshot + registry snapshot + epoch
    gauges) — obsctl's ``diagnose BENCH.json`` path. Prefers the
    run's own embedded ``analysis`` when present (re-deriving would
    hide what the run itself claimed)."""
    doc = load_bench(path_or_doc)
    if isinstance(doc.get("analysis"), dict):
        return doc["analysis"]
    pipeline = doc.get("pipeline") or {}
    snap = {"stages": pipeline.get("stages") or [], "wall_s": None}
    # the BENCH doc carries no wall_s at top level; derive it from the
    # best epoch's rate when possible
    if doc.get("best_epoch") and doc.get("metric"):
        stages = snap["stages"]
        nbytes = max((int(s.get("bytes") or 0) for s in stages),
                     default=0)
        if nbytes:
            snap["wall_s"] = nbytes / (float(doc["best_epoch"]) * 1e9)
    return attribute(snap, metrics=doc.get("metrics"),
                     epoch_gauges=doc.get("epoch_gauges"),
                     run_band=doc.get("run_band"))
