"""Benchmark: libsvm parse-to-device GB/s on one card, the twin of the
repo root's ``bench.py``, driven by the port.

Measures the whole single-device path: a Criteo-shaped libsvm file (one
shard; ``bench_suite`` config 4 runs several parts) → the native C++
parse → zero-copy CSR views → copies to the device from pinned memory,
riding under the parse through detached leases.

The measured chain is built from the port's declarative pipeline
(:func:`build_pipeline`): ``from_uri(...).parse(...).batch(pad=True)
.to_device(...)`` lowers to the parser with the engine's ABI-5 padded
batch assembly (``assembly_path`` says which rung served), windowed
copies through the reusable pinned staging slots, a probe at each stage
boundary, and the in-flight window owned by the between-epoch autotuner
(or by the verdict-driven controller, on by default).
``DMLC_TPU_BENCH_ASSEMBLY=none`` measures raw blocks instead. A short
hand-wired run (``DMLC_TPU_BENCH_HANDWIRED_EPOCHS``, default 3) reports
``handwired_gbps`` beside it.

CLI: ``python -m dmlc_tpu_torch.bench [--trace OUT_JSON] [--device
cpu]``. The device is the CUDA card unless ``--device cpu`` asks for the
host; with no card and no ``--device cpu`` the run fails at once, naming
the missing card. ``--trace`` records the measurement epochs under the
port's ``obs.trace`` recorder and writes Chrome/Perfetto trace-event
JSON (pull spans, queue waits, transfer drains, the engine's counter
tracks) at the path; ``--trace`` without a path exits with 2 before any
data is written. The environment knobs keep the reference's names
(``DMLC_TPU_BENCH_MB``, ``DMLC_TPU_BENCH_BUDGET_S``, ``DMLC_TPU_PROFILE_HZ``,
``DMLC_TPU_CONTROL``, ...), so one command line drives either package.

Prints exactly ONE JSON line on stdout, with the reference's keys:
"value" is the sustained rate (20%-trimmed mean of per-epoch GB/s over
>= 5 epochs and >= the time budget), "best_epoch" the fastest epoch,
"parse_cpu_gbps_core" the thread-CPU parse rate, "sustained_gauge_ok"
the same trimmed mean over epochs whose pre-epoch host-memcpy gauge
cleared "gauge_ok_threshold", "gauge_bands" that statistic by gauge band
with the run's modal band in "run_band", "replay" the parse-once /
replay-pages probe (``bench_suite.bench_page_replay``), "replay_tier"
the page-spill probe (``bench_suite.bench_spill_replay``), "bound"
whether the best epoch waited on transfers or on the parse, "pipeline"
the best epoch's per-stage stats with the autotune report, "metrics"
the ``obs.metrics`` registry at the best epoch, "analysis" the
``obs.analyze`` verdict, "control" the controller's ledger excerpt and
"trace" the ``--trace`` path. "vs_baseline" is null: the reference
divides by ``BASELINE.json``'s 2 GB/s target, which is a TPU chip's, and
no TPU figure carries over to the card. Everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["data_path", "ensure_data", "ensure_native", "resolve_device",
           "build_pipeline", "main"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def data_path() -> str:
    """The twin's corpus, beside (never over) the reference's
    ``/tmp/dmlc_tpu_bench.libsvm``: one package never rewrites the other's
    file mid-run."""
    return os.path.join(tempfile.gettempdir(), "dmlc_tpu_torch_bench.libsvm")


def ensure_data(path: str, size_mb: int) -> int:
    """The reference's Criteo-ish corpus at ``path``: 4000 rows from
    ``RandomState(0)`` (25-44 sorted distinct indices below 10^6, uniform
    values, labels ``i % 2``) repeated to ``size_mb`` MB, byte for byte
    the reference's. A file within a quarter of the size is kept."""
    want = size_mb << 20
    if os.path.exists(path) and abs(os.path.getsize(path) - want) < want // 4:
        return os.path.getsize(path)
    import numpy as np
    rng = np.random.RandomState(0)
    rows = []
    for i in range(4000):
        nnz = rng.randint(25, 45)
        idx = np.sort(rng.choice(10 ** 6, nnz, replace=False))
        vals = rng.rand(nnz)
        rows.append(f"{i % 2} " + " ".join(
            f"{j}:{v:.6f}" for j, v in zip(idx, vals)))
    block = ("\n".join(rows) + "\n").encode()
    reps = max(1, want // len(block))
    with open(path, "wb") as f:
        for _ in range(reps):
            f.write(block)
    return os.path.getsize(path)


def ensure_native() -> bool:
    """The port's native engine, built when missing; False (the Python
    parse serves) when it cannot be built."""
    from dmlc_tpu_torch import native
    if native.native_available():
        return True
    try:
        subprocess.run([sys.executable, "-m", "dmlc_tpu_torch.native.build"],
                       check=True, capture_output=True, timeout=300)
        native._tried = False
        return native.native_available()
    except Exception as e:  # noqa: BLE001
        log(f"native build failed ({e}); falling back to python engine")
        return False


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the card) or ``cpu``; ``cuda`` with no card raises."""
    from dmlc_tpu_torch.utils.logging import DMLCError
    if name == "cuda" and not torch.cuda.is_available():
        raise DMLCError("python -m dmlc_tpu_torch.bench measures on a CUDA "
                        "card and this host has none "
                        "(torch.cuda.is_available() is False); pass "
                        "--device cpu to run it on the host")
    return torch.device(name)


def build_pipeline(path: str, device: torch.device):
    """The measured chain, as the reference builds it (``bench.py``):
    ``Pipeline.from_uri(path).parse(format="libsvm", engine="auto",
    chunk_size=DMLC_TPU_BENCH_CHUNK_MB MB, [shards=DMLC_TPU_BENCH_SHARDS])
    .batch(DMLC_TPU_BENCH_BATCH_ROWS, pad=True,
    nnz_bucket=DMLC_TPU_BENCH_NNZ_BUCKET).to_device(device, window="auto")
    .build(autotune=True)``; ``DMLC_TPU_BENCH_ASSEMBLY=none`` leaves out
    the batch stage (raw blocks)."""
    from dmlc_tpu_torch.pipeline import Pipeline
    chunk_mb = int(os.environ.get("DMLC_TPU_BENCH_CHUNK_MB", "4"))
    assembly_mode = os.environ.get("DMLC_TPU_BENCH_ASSEMBLY", "auto")
    # N > 1 splits the one file across N native parsers on aligned byte
    # ranges, in the file's order
    shards = int(os.environ.get("DMLC_TPU_BENCH_SHARDS", "0") or 0)
    parse_kw = {"shards": shards} if shards > 1 else {}
    pl = (Pipeline.from_uri(path)
          .parse(format="libsvm", engine="auto",
                 chunk_size=chunk_mb << 20, **parse_kw))
    if assembly_mode != "none":
        rows_pb = int(os.environ.get("DMLC_TPU_BENCH_BATCH_ROWS",
                                     str(8 << 10)))
        # worst-case nnz bound: ensure_data rows carry < 45 features
        nnz_pb = int(os.environ.get("DMLC_TPU_BENCH_NNZ_BUCKET",
                                    str(rows_pb * 45)))
        pl = pl.batch(rows_pb, pad=True, nnz_bucket=nnz_pb)
    return pl.to_device(device, window="auto").build(autotune=True)


def _handwired_epoch(parser, device: torch.device) -> float:
    """The hand-wired loop: each block's arrays copied to ``device``
    from pinned memory (``bench_suite._put``), 4 copies in flight, each
    block's lease released after its copy's event."""
    from dmlc_tpu_torch.bench_suite import _done, _put
    parser.before_first()
    t0 = time.perf_counter()
    in_flight: List = []  # (put, lease)
    while parser.next():
        block = parser.value()
        lease = parser.detach() if hasattr(parser, "detach") else None
        arrays = {"offset": block.offset, "label": block.label,
                  "index": block.index}
        if block.value is not None:
            arrays["value"] = block.value
        in_flight.append((_put(arrays, device), lease))
        if len(in_flight) > 4:
            put, ls = in_flight.pop(0)
            _done(put)
            if ls is not None:
                ls.release()
    for put, ls in in_flight:
        _done(put)
        if ls is not None:
            ls.release()
    return time.perf_counter() - t0


def _trimmed_mean(vals: Sequence[float]) -> float:
    """20%-per-side trimmed mean."""
    vals = sorted(vals)
    k = len(vals) // 5
    cut = vals[k:len(vals) - k]
    return sum(cut) / len(cut)


def _install_planes() -> None:
    """The live telemetry planes, in the reference's order; each is a
    no-op without its env var but the sampling profiler and the
    controller, which are on unless their env var says otherwise."""
    from dmlc_tpu_torch.obs import control, profile
    from dmlc_tpu_torch.obs.aggregate import install_if_env as gang_if_env
    from dmlc_tpu_torch.obs.flight import install_if_env
    from dmlc_tpu_torch.obs.serve import serve_if_env
    from dmlc_tpu_torch.obs.timeseries import install_if_env as history_if_env
    srv = serve_if_env()
    if srv is not None:
        log(f"obs status server: http://127.0.0.1:{srv.port}/metrics")
    # history before flight: flight joins a running ring, or installs
    # its own 15 s one, so DMLC_TPU_HISTORY_S/_BYTES must come first
    history_if_env()
    install_if_env()
    gang_if_env()
    if profile.install_if_env() is None \
            and os.environ.get(profile.ENV_PROFILE_HZ) is None:
        profile.install()
    if control.install_if_env() is None \
            and os.environ.get(control.ENV_CONTROL) is None:
        control.install()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.bench",
        description="libsvm parse-to-device GB/s on one card: one JSON "
                    "line on stdout")
    ap.add_argument("--trace", metavar="OUT_JSON", default=None,
                    help="record the measurement epochs and write Chrome "
                         "trace-event JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    # parsed, and the card checked, before any data is written
    args = ap.parse_args(argv)
    trace_path = args.trace
    device = resolve_device(args.device)
    size_mb = int(os.environ.get("DMLC_TPU_BENCH_MB", "256"))
    path = data_path()
    size = ensure_data(path, size_mb)
    have_native = ensure_native()
    _install_planes()
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.obs import control as _ctl
    from dmlc_tpu_torch.obs import metrics as obs_metrics
    from dmlc_tpu_torch.obs import trace as obs_trace
    from dmlc_tpu_torch.obs.analyze import attribute, gauge_band

    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "host CPU"
    log(f"device: {device} ({name})")
    log(f"data: {size / 1e6:.1f} MB, "
        f"engine={'native' if have_native else 'python'}")

    # warm-up: the engine's first parse and the first copy to the device
    warm = Parser.create(path, 0, 64, format="libsvm", engine="auto")
    warm.next()
    torch.from_numpy(warm.value().offset).to(device)
    if on_card:
        torch.cuda.synchronize(device)
    if hasattr(warm, "destroy"):
        warm.destroy()

    chunk_mb = int(os.environ.get("DMLC_TPU_BENCH_CHUNK_MB", "4"))
    handwired_gbps = None
    hw_epochs = int(os.environ.get("DMLC_TPU_BENCH_HANDWIRED_EPOCHS", "3"))
    if hw_epochs > 0:
        hw_parser = Parser.create(path, 0, 1, format="libsvm",
                                  engine="auto", chunk_size=chunk_mb << 20)
        hw_walls = [_handwired_epoch(hw_parser, device)
                    for _ in range(hw_epochs)]
        if hasattr(hw_parser, "destroy"):
            hw_parser.destroy()
        handwired_gbps = round(size / min(hw_walls) / 1e9, 4)
        log(f"hand-wired reference: best of {hw_epochs} epochs = "
            f"{handwired_gbps} GB/s")

    built = build_pipeline(path, device)

    def epoch():
        for _ in built:
            pass
        snap = built.stats()
        parse_st = snap["stages"][0]
        dx = snap["stages"][-1].get("extra") or {}
        # assemble-wait: the engine's assemble_ns on the fused native
        # rung, pad_single on the python rung (its own stage), plus the
        # copies into the pinned staging slots
        t_asm = dx.get("staging_assemble_s", 0.0)
        stats = None
        for st in snap["stages"]:
            x = st.get("extra") or {}
            t_asm += x.get("assemble_s", 0.0)
            if stats is None:
                stats = x.get("engine")
        return (snap["wall_s"], parse_st["wait_s"],
                dx.get("xfer_wait_s", 0.0), t_asm, parse_st["rows"],
                parse_st["nnz"], stats, snap)

    budget_s = float(os.environ.get("DMLC_TPU_BENCH_BUDGET_S", "60"))
    min_epochs = max(3, int(os.environ.get("DMLC_TPU_BENCH_MIN_EPOCHS", "5")))
    # DMLC_TPU_TRACE=<dir>: a torch.profiler timeline of one epoch
    trace_dir = os.environ.get("DMLC_TPU_TRACE")
    if trace_dir:
        with obs_trace.cuda_trace("bench_epoch", log_dir=trace_dir,
                                  device=device):
            epoch()
        log(f"torch.profiler trace written to {trace_dir}")
    if trace_path:
        obs_trace.start()

    # every epoch is tagged with a host-memcpy gauge read just before it;
    # epochs whose gauge clears GAUGE_OK_GBPS feed sustained_gauge_ok
    gauge_ok_gbps = float(os.environ.get("DMLC_TPU_BENCH_GAUGE_OK", "1.0"))
    times = []   # (wall_s, gauge_gbps) per epoch
    best = None
    best_stats = None
    best_waits = (0.0, 0.0, 0.0)
    best_snap = None
    best_metrics = None
    t_start = time.perf_counter()
    i = 0
    while True:
        gauge = memcpy_gauge()
        if _ctl.active() is not None:
            _ctl.active().note_gauge(gauge)
        dt, t_pull, t_xfer, t_asm, rows, nnz, stats, snap = epoch()
        times.append((dt, gauge))
        log(f"epoch {i}: rows={rows} nnz={nnz} wall={dt:.2f}s "
            f"pull-wait={t_pull:.2f}s xfer-wait={t_xfer:.2f}s "
            f"assemble-wait={t_asm:.2f}s "
            f"gauge={gauge:.2f} -> {size / dt / 1e9:.3f} GB/s")
        if best is None or dt < best:
            best, best_stats = dt, stats
            best_waits = (t_pull, t_xfer, t_asm)
            best_snap = snap
            best_metrics = obs_metrics.REGISTRY.snapshot()
        i += 1
        if i >= min_epochs and time.perf_counter() - t_start > budget_s:
            break
    if trace_path:
        rec = obs_trace.stop()
        if rec is not None:
            from dmlc_tpu_torch.obs.export import write_chrome
            write_chrome(rec, trace_path)
            log(f"obs trace: {len(rec.events())} events "
                f"({rec.dropped} dropped) -> {trace_path}")

    sustained = _trimmed_mean([size / t / 1e9 for t, _ in times])
    ok_rates = [size / t / 1e9 for t, g in times if g >= gauge_ok_gbps]
    sustained_gauge_ok = (round(_trimmed_mean(ok_rates), 4)
                          if len(ok_rates) >= 3 else None)
    log(f"gauge-ok epochs: {len(ok_rates)}/{len(times)} "
        f"(threshold {gauge_ok_gbps} GB/s memcpy)")
    band_rates: Dict[str, List[float]] = {}
    for t, g in times:
        band_rates.setdefault(gauge_band(g), []).append(size / t / 1e9)
    gauge_bands = {
        band: {"epochs": len(rates),
               "sustained": (round(_trimmed_mean(rates), 4)
                             if len(rates) >= 3 else None)}
        for band, rates in sorted(band_rates.items())}
    run_band = max(band_rates, key=lambda b: len(band_rates[b]))
    log("gauge bands: " + ", ".join(
        f"{b}={v['epochs']}ep"
        + (f"@{v['sustained']}" if v["sustained"] else "")
        for b, v in gauge_bands.items()) + f"; run_band={run_band}")
    if best_stats:
        from dmlc_tpu_torch.bench_suite import format_stages
        line = format_stages(best_stats, size)
        if line:
            log(line)
    autotune_report = built.autotune_report()
    if _ctl.active() is not None:
        # the controller owned the knobs: its moves are in "control"
        autotune_report = None
    built.close()
    if autotune_report:
        log(f"autotune: values={autotune_report['values']} "
            f"tuned={autotune_report['tuned']} "
            f"decisions={len(autotune_report['decisions'])}")

    # the parse-once / replay-pages probe, beside the headline ("value"
    # stays the parse rate)
    replay_gbps = None
    replay = None
    if os.environ.get("DMLC_TPU_BENCH_REPLAY", "1") != "0":
        try:
            from dmlc_tpu_torch.bench_suite import bench_page_replay
            rp_epochs = int(os.environ.get("DMLC_TPU_BENCH_REPLAY_EPOCHS",
                                           "5"))
            rp = bench_page_replay(min(size_mb, 64), epochs=rp_epochs,
                                   gauge_fn=memcpy_gauge, device=device)
            rp_rates = rp["epoch_rates_text_gbps"]
            replay_gbps = rp["text_equiv_gbps"]  # best epoch
            replay = {
                "replay_best": replay_gbps,
                "replay_sustained": round(_trimmed_mean(rp_rates), 4),
                "epoch_walls": rp["epoch_walls"],
                "epoch_gauges": rp["epoch_gauges"],
                "build_s": rp["build_s"],
                "page_gbps": round(rp["gbps"], 4),
            }
            log(f"page replay: best {replay_gbps} / sustained "
                f"{replay['replay_sustained']} GB/s text-equivalent "
                f"over {len(rp_rates)} epochs (gauges "
                f"{rp['epoch_gauges']}, build {rp['build_s']}s)")
        except Exception as e:  # noqa: BLE001 — a probe must not end the run
            log(f"page replay measurement failed: {e!r}")

    # the page-spill probe: a sharded iterator over its cache budget
    # serving its steady epochs from spilled round pages
    replay_tier = None
    if os.environ.get("DMLC_TPU_BENCH_SPILL", "1") != "0":
        try:
            from dmlc_tpu_torch.bench_suite import bench_spill_replay
            sr = bench_spill_replay(min(size_mb, 64), gauge_fn=memcpy_gauge,
                                    device=device)
            replay_tier = {
                "mode": sr["mode"],
                "parse_epoch_gbps": sr["parse_epoch_gbps"],
                "parse_epoch_gauge": sr["parse_epoch_gauge"],
                "spill_epoch_gbps": sr["spill_epoch_gbps"],
                "replay_gbps": round(sr["gbps"], 4),
                "replay_sustained_gbps": sr["replay_sustained_gbps"],
                "speedup_vs_parse": sr["speedup_vs_parse"],
                "epoch_gauges": sr["epoch_gauges"],
                "rounds": sr["rounds"],
            }
            log(f"page-spill steady replay: {sr['gbps']:.3f} GB/s "
                f"text-equivalent vs {sr['parse_epoch_gbps']} parse "
                f"({sr['speedup_vs_parse']}x, tier={sr['mode']})")
        except Exception as e:  # noqa: BLE001 — a probe must not end the run
            log(f"page-spill replay measurement failed: {e!r}")

    best_gbps = size / best / 1e9
    parse_cpu_gbps = None
    if best_stats and best_stats.get("parse_cpu_ns"):
        parse_cpu_gbps = size / best_stats["parse_cpu_ns"]
    pull_s, xfer_s, asm_s = best_waits
    bound = "transfer" if xfer_s > pull_s else "parse"
    assembly_path = "none"
    if best_snap:
        assembly_path = next(
            (x["assembly_path"] for s in best_snap["stages"]
             if (x := s.get("extra") or {}).get("assembly_path")),
            "none")
    log(f"sustained (trimmed mean of {len(times)} epochs) = "
        f"{sustained:.3f} GB/s; best epoch = {best_gbps:.3f} GB/s; "
        f"bound={bound} (pull-wait {pull_s:.2f}s vs xfer-wait "
        f"{xfer_s:.2f}s vs assemble-wait {asm_s:.2f}s in best epoch); "
        f"assembly_path={assembly_path}")
    analysis = None
    if best_snap:
        analysis = attribute(best_snap, metrics=best_metrics,
                             epoch_gauges=[g for _, g in times],
                             run_band=run_band)
        log(f"analysis: bound={analysis['bound']} "
            f"({analysis['confidence']}) — "
            + "; ".join(analysis["evidence"][:3]))
    control_doc = None
    if _ctl.active() is not None:
        try:
            control_doc = _ctl.active().to_dict(last=32)
        except Exception as e:  # noqa: BLE001 — the line must survive
            log(f"control ledger excerpt failed: {e!r}")
    print(json.dumps({
        "metric": "libsvm_parse_to_hbm_throughput",
        "value": round(sustained, 4),
        "unit": "GB/s/chip",
        # no TPU target carries over to the card (module docstring)
        "vs_baseline": None,
        "best_epoch": round(best_gbps, 4),
        "epochs": len(times),
        "bound": bound,
        "assembly_path": assembly_path,
        "assemble_wait_s": round(asm_s, 4),
        "parse_cpu_gbps_core": (round(parse_cpu_gbps, 4)
                                if parse_cpu_gbps is not None else None),
        "sustained_gauge_ok": sustained_gauge_ok,
        "gauge_ok_epochs": len(ok_rates),
        "gauge_ok_threshold": gauge_ok_gbps,
        "epoch_gauges": [round(g, 2) for _, g in times],
        "gauge_bands": gauge_bands,
        "run_band": run_band,
        "replay_gbps": replay_gbps,
        "replay": replay,
        "replay_tier": replay_tier,
        "handwired_gbps": handwired_gbps,
        "pipeline": {
            "stages": best_snap["stages"] if best_snap else None,
            "knobs": best_snap["knobs"] if best_snap else None,
            "autotune": autotune_report,
        },
        "metrics": best_metrics,
        "analysis": analysis,
        "control": control_doc,
        "trace": trace_path,
    }), flush=True)


if __name__ == "__main__":
    main()
