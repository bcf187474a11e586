#!/usr/bin/env python3
"""Smoke test of dmlc_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path at full width, from the sources in this
checkout, and fails (non-zero exit, no result line) on any fault:

1. environment: needs ``torch.cuda.is_available()``; prints the card's
   name and power limit as nvidia-smi reports them;
2. build: the CUDA kernels (nvcc, sm_90a) and the native parse engine
   (g++), at once, each timed;
3. kernels: K1 ``csr_spmv`` and K2 ``csr_spmv_t`` against their plain
   PyTorch versions at the main path's shapes, edge cases included
   (empty rows, a padded tail, an index at F-1, an out-of-range index, a
   u64 index), with times beside their bound and a library call's;
4. main path: a seeded Criteo-shaped libsvm file of about 256 MB →
   native parser → ABI-5 padded batches (8192 rows, 368640 nonzeros) →
   pinned async H2D (``device_prefetch(staging=True)``) →
   ``SparseLinearModel(1_000_000).train_step`` for one epoch; the loss
   must fall and each kernel must have launched once per step;
5. parity: native padded batches byte-identical to the Python parser's
   ``pad_single``; 3 steps on the card allclose to 3 steps of the plain
   CPU path.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it the kernels' JSON record. Imports nothing of JAX or
of the ``dmlc_tpu`` package.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

NUM_FEATURES = 1_000_000       # LIBSVM's criteo, as BASELINE.json names it
ROW_BUCKET = 8192              # bench.py's batch rows
NNZ_BUCKET = ROW_BUCKET * 45   # bench.py's worst-case nnz bound (< 45/row)
FILE_MB = 256                  # bench.py's default corpus size
SEED = 0
# One rate for w and b. The bias sets the ceiling: its curvature is at
# most 1/4, so SGD on it diverges above a rate of 8. The 10^6 weights each
# see a few rows a batch, so at the reference's default of 0.1 the loss
# would not move visibly in one epoch.
LEARNING_RATE = 6.0
# Card peaks (H100 SXM data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Tolerances, each with its reason:
# K1 sums each row in another fp32 order (warp lanes + shuffle tree with
# fma) than the plain version (index_add_, atomics on the card). The
# rounding error of a sum scales with the sum of its terms' magnitudes,
# not with the result, so K1's rtol applies to sum_k |value[k]*w[index[k]]|:
# a row whose terms cancel (|y| << the terms) differs by as much as a
# row whose terms do not.
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# K2 adds with fp32 atomics whose order varies from run to run.
K2_RTOL, K2_ATOL = 1e-4, 1e-6
# 3 SGD steps on the card against the plain CPU path: the kernels' sums
# and the card's reductions of the loss run in other orders.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- phase 1

def environment():
    import torch
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false: this script needs a CUDA "
            "card")
    require(os.path.isdir(os.path.join(REPO, "dmlc_tpu_torch")),
            f"the dmlc_tpu_torch package is not beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


# --------------------------------------------------------------- phase 2

def build_all():
    """Build the kernels and the engine at once; returns their times."""
    from dmlc_tpu_torch.native import build
    times, errors = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e
        times[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=("kernels",
                                                  build.build_kernels)),
               threading.Thread(target=run, args=("engine", build.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errors.items():
        fail(f"{name} build failed: {e}")
    for line in open(build.kernels_path() + ".log").read().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: kernels {times['kernels']:.1f} s, engine "
        f"{times['engine']:.1f} s")
    return times


# --------------------------------------------------------------- data

def _distinct_sorted(rng, n: int, k: int):
    """k distinct values drawn uniformly from [0, n), sorted (Floyd's
    algorithm): the distribution of bench.py's
    ``np.sort(rng.choice(n, k, replace=False))``, without the full
    permutation of n that choice draws for every row."""
    import numpy as np
    chosen = set()
    for j in range(n - k, n):
        t = int(rng.randint(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.array(sorted(chosen), np.int64)


def write_corpus(path: str) -> int:
    """bench.py's Criteo-shaped recipe (4000 seeded rows of 25-44
    distinct sorted indices below 10^6 with uniform values, repeated to
    the size), with labels from a seeded hidden weight vector as in
    __graft_entry__.py."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    w_true = np.random.RandomState(7).randn(NUM_FEATURES)
    rows, margins = [], []
    for _ in range(4000):
        nnz = rng.randint(25, 45)
        idx = _distinct_sorted(rng, NUM_FEATURES, nnz)
        vals = rng.rand(nnz)
        rows.append((idx, vals))
        margins.append(float((vals * w_true[idx]).sum()))
    median = float(np.median(margins))
    block = ("\n".join(
        f"{1 if m > median else -1} " + " ".join(
            f"{j}:{v:.6f}" for j, v in zip(idx, vals))
        for (idx, vals), m in zip(rows, margins)) + "\n").encode()
    reps = max(1, (FILE_MB << 20) // len(block))
    with open(path, "wb") as f:
        for _ in range(reps):
            f.write(block)
    return os.path.getsize(path)


def padded_batches(parser):
    while True:
        batch = parser.next_padded(ROW_BUCKET, nnz_bucket=NNZ_BUCKET)
        if batch is None:
            return
        yield batch


def first_batch(path):
    """The native parser's first padded batch, copied out of its lease."""
    from dmlc_tpu_torch.data.parser import Parser
    parser = Parser.create(path, 0, 1, format="libsvm", engine="native")
    batch = next(padded_batches(parser)).copy()
    parser.destroy()
    return batch


def batch_hash(batch) -> str:
    import numpy as np
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(np.asarray(batch[k]))
        h.update(k.encode() + a.dtype.str.encode())
        h.update(a.tobytes())
    return h.hexdigest()


# --------------------------------------------------------------- phase 3

def call_ms(fn, iters: int = 100) -> float:
    """Milliseconds a call takes back to back, host launch included:
    CUDA events around ``iters`` calls."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us_by_kernel(fn):
    """{kernel name: (device µs, calls)} of what ``fn`` runs on the card,
    from a torch.profiler trace of device activity only (so no host op
    is counted beside the kernels it launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def device_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call of ``fn``: the summed device time of
    every kernel, copy and fill it runs, over ``iters`` calls."""
    for _ in range(10):
        fn()

    def loop():
        for _ in range(iters):
            fn()

    by_kernel = _device_us_by_kernel(loop)
    require(by_kernel, "the profiler saw no device time")
    return sum(t for t, _ in by_kernel.values()) / iters / 1e3


def edge_case_batch(first):
    """The main path's first padded batch with edge cases written in:
    rows 3 and 7 emptied, the last 100 rows made padding, an index at F-1
    in row 10 and one out of range in row 20 (returned)."""
    import numpy as np
    off = first["offset"]
    require(int(first["num_rows"]) == ROW_BUCKET,
            f"first batch has {int(first['num_rows'])} rows, want "
            f"{ROW_BUCKET}")
    old_lens = np.diff(off)
    lens = old_lens.copy()
    lens[[3, 7]] = 0
    lens[ROW_BUCKET - 100:] = 0
    keep = np.repeat(lens > 0, old_lens)
    nnz = int(lens.sum())
    new_off = np.zeros_like(off)
    new_off[1:] = np.cumsum(lens)
    idx = np.zeros_like(first["index"])
    val = np.zeros_like(first["value"])
    idx[:nnz] = first["index"][:int(off[-1])][keep]
    val[:nnz] = first["value"][:int(off[-1])][keep]
    idx[new_off[10]] = NUM_FEATURES - 1
    idx[new_off[20] + 1] = NUM_FEATURES + 12345
    return new_off, idx, val, 20


def check_kernels(first):
    """Phase 3: K1/K2 against their plain versions on the card."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops import csr

    cuda = torch.device("cuda")
    rng = np.random.RandomState(SEED + 1)
    off, idx, val, bad_row = edge_case_batch(first)
    w = torch.from_numpy(rng.randn(NUM_FEATURES).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(ROW_BUCKET).astype(np.float32)).to(cuda)
    t_off = torch.from_numpy(off).to(cuda)
    t_val = torch.from_numpy(val).to(cuda)
    before = (csr.csr_spmv.launches, csr.csr_spmv_t.launches)
    for dtype in (np.uint32, np.uint64):
        t_idx = torch.from_numpy(idx.astype(dtype)).to(cuda)
        y = csr.csr_spmv(t_off, t_idx, t_val, w)
        y_plain = csr.csr_spmv_plain(t_off, t_idx, t_val, w)
        gw = csr.csr_spmv_t(t_off, t_idx, t_val, g, NUM_FEATURES)
        gw_plain = csr.csr_spmv_t_plain(t_off, t_idx, t_val, g, NUM_FEATURES)
        torch.cuda.synchronize()
        name = np.dtype(dtype).name
        nan_rows = torch.isnan(y).nonzero().flatten().tolist()
        require(nan_rows == [bad_row],
                f"K1 {name}: NaN rows {nan_rows}, want [{bad_row}]")
        require(torch.isnan(y_plain).nonzero().flatten().tolist() == nan_rows,
                f"K1 {name}: plain version's NaN rows differ")
        require(bool((y[[3, 7]] == 0).all()) and
                bool((y[ROW_BUCKET - 100:] == 0).all()),
                f"K1 {name}: empty or padded rows are not 0")
        scale = csr.csr_spmv_plain(t_off, t_idx, t_val.abs(), w.abs())
        err = (y - y_plain).nan_to_num()
        require(bool((err.abs() <= K1_ATOL + K1_RTOL
                      * scale.nan_to_num()).all()),
                f"K1 {name} disagrees with its plain version: max |err| "
                f"{err.abs().max().item()}, max |err| / sum|terms| "
                f"{(err.abs() / scale).nan_to_num().max().item()}")
        require(torch.isfinite(gw).all().item(),
                f"K2 {name}: non-finite gradient")
        require(torch.allclose(gw, gw_plain, rtol=K2_RTOL, atol=K2_ATOL),
                f"K2 {name} disagrees with its plain version: max "
                f"|err| {(gw - gw_plain).abs().max().item()}")
        require(gw[NUM_FEATURES - 1].item() != 0.0,
                f"K2 {name}: the index at F-1 got no gradient")
        if dtype is np.uint32:
            k1_err = err.abs().max().item()
            k1_rel = (err.abs() / scale).nan_to_num().max().item()
            k2_err = (gw - gw_plain).abs().max().item()
    log(f"kernels agree with their plain versions (u32 and u64 index): "
        f"K1 max |err| {k1_err:.3g}, max |err| / sum|terms| {k1_rel:.3g} "
        f"(rtol {K1_RTOL} of sum|terms|, atol {K1_ATOL}), "
        f"K2 max |err| {k2_err:.3g} (rtol {K2_RTOL}, atol {K2_ATOL})")

    # Timing, at the main path's batch as it came from the parser.
    b_off = torch.from_numpy(first["offset"]).to(cuda)
    b_idx = torch.from_numpy(first["index"]).to(cuda)
    b_val = torch.from_numpy(first["value"]).to(cuda)
    n, nnz = ROW_BUCKET, int(first["num_nnz"])
    distinct = int(np.unique(first["index"][:nnz]).size)
    k1_bytes = (n + 1) * 8 + nnz * (4 + 4) + distinct * 4 + n * 4
    k2_bytes = (n + 1) * 8 + nnz * (4 + 4) + n * 4 + NUM_FEATURES * 4
    flops = 2 * nnz

    def k1():
        return csr.csr_spmv(b_off, b_idx, b_val, w)

    def k2():
        return csr.csr_spmv_t(b_off, b_idx, b_val, g, NUM_FEATURES)

    k1_ms, k1_call = device_ms(k1), call_ms(k1)
    k1_plain = device_ms(lambda: csr.csr_spmv_plain(b_off, b_idx, b_val, w))
    k2_ms, k2_call = device_ms(k2), call_ms(k2)
    k2_plain = device_ms(lambda: csr.csr_spmv_t_plain(b_off, b_idx, b_val, g,
                                                      NUM_FEATURES))
    # the library yardstick: one torch.sparse CSR product on the same
    # rows (the padded tail trimmed: a CSR tensor holds exactly nnz)
    a = torch.sparse_csr_tensor(b_off, b_idx[:nnz].to(torch.int64),
                                b_val[:nnz], size=(n, NUM_FEATURES))
    y_lib = a @ w
    torch.cuda.synchronize()
    lib_err = (y_lib - csr.csr_spmv(b_off, b_idx, b_val, w)).abs()
    lib_scale = csr.csr_spmv_plain(b_off, b_idx, b_val.abs(), w.abs())
    require(bool((lib_err <= K1_ATOL + K1_RTOL * lib_scale).all()),
            "K1 disagrees with torch.sparse on the main path's batch")
    k1_lib = device_ms(lambda: a @ w)
    try:
        at = a.t()
        at @ g
        k2_lib = device_ms(lambda: at @ g)
    except RuntimeError as e:
        log(f"library K2 (sparse CSR transpose @ dense) not timed: {e}")
        k2_lib = None
    after = (csr.csr_spmv.launches, csr.csr_spmv_t.launches)
    require(after[0] > before[0] and after[1] > before[1],
            "the kernel wrappers did not count their launches")

    def bound(nbytes):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations")

    log(f"timed at the main path's first batch: {n} rows, {nnz} nonzeros "
        f"of {NNZ_BUCKET}, {distinct} distinct features")
    k1_bound, k1_by = bound(k1_bytes)
    k2_bound, k2_by = bound(k2_bytes)
    rows = [
        {"name": "csr_spmv", "route": "cuda",
         "source": "dmlc_tpu_torch/csrc/csr_spmv.cu",
         "replaces": "dmlc_tpu/ops/csr.py:46",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
         "call_ms": k1_call},
        {"name": "csr_spmv_t", "route": "cuda",
         "source": "dmlc_tpu_torch/csrc/csr_spmv.cu",
         "replaces": "dmlc_tpu/models/common.py:89",
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
         "call_ms": k2_call},
    ]
    return rows


def report_kernels(rows, launches, steps):
    for r in rows:
        r["launches"] = launches[r["name"]]
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us")
        log(f"{r['name']}: kernel {r['ms'] * 1e3:.2f} us on the device "
            f"({r['call_ms'] * 1e3:.1f} us a call back to back, launch "
            f"included), plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"{r['launches'] / steps:g} launches per step")


# --------------------------------------------------------------- phase 4

def train_epoch(path, model, device, train: bool):
    """One epoch: native parse → padded batches → pinned async H2D →
    (train steps). Returns (seconds, losses, batches, bytes moved)."""
    import torch
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.native.bindings import NativeLibSVMParser
    from dmlc_tpu_torch.parallel.device_iter import device_prefetch
    parser = Parser.create(path, 0, 1, format="libsvm", engine="native")
    require(isinstance(parser, NativeLibSVMParser),
            f"engine='native' gave {type(parser).__name__}")
    losses, batches, moved = [], 0, 0
    t0 = time.perf_counter()
    for batch in device_prefetch(padded_batches(parser), size=2,
                                 device=device, staging=True):
        batches += 1
        moved += sum(t.numel() * t.element_size() for t in batch.values())
        if train:
            losses.append(model.train_step(batch))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    parser.destroy()
    return secs, [float(x) for x in losses], batches, moved


def h2d_gbps(first) -> float:
    """One padded batch copied from its pinned staging slot to the card:
    its bytes over the copies' device time, over 50 copies."""
    from dmlc_tpu_torch.parallel.device_iter import HostStaging
    slot = HostStaging(pin=True).stage(first)
    nbytes = sum(t.numel() * t.element_size() for t in slot.values())
    ms = device_ms(lambda: [t.to("cuda", non_blocking=True)
                            for t in slot.values()])
    return nbytes / (ms * 1e-3) / 1e9


def main_path(path, size, lr):
    import torch
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    from dmlc_tpu_torch.ops import csr
    from dmlc_tpu_torch.parallel.device_iter import device_prefetch
    cuda = torch.device("cuda")
    # warm-up: one batch through the whole path (first launches, the
    # allocator, pinned slots)
    warm = Parser.create(path, 0, 1, format="libsvm", engine="native")
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    for batch in device_prefetch(padded_batches(warm), device=cuda,
                                 staging=True):
        model.train_step(batch)
        break
    torch.cuda.synchronize()
    warm.destroy()

    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=cuda)
    csr.csr_spmv.launches = 0
    csr.csr_spmv_t.launches = 0
    secs, losses, steps, moved = train_epoch(path, model, cuda, train=True)
    launches = {"csr_spmv": csr.csr_spmv.launches,
                "csr_spmv_t": csr.csr_spmv_t.launches}
    require(steps > 0, "the epoch yielded no batch")
    require(all(v == steps for v in launches.values()),
            f"launch counts {launches} != {steps} steps: the main path did "
            "not go through the kernels once per step")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss in {losses}")
    require(losses[-1] < losses[0],
            f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    w = model.w.detach()
    require(bool(torch.isfinite(w).all()), "non-finite weights")
    log(f"main path: {steps} steps at learning rate {lr}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}); "
        f"launches {launches}")
    log(f"  losses: {[round(x, 4) for x in losses]}")
    parse_secs, _, batches2, _ = train_epoch(path, None, cuda, train=False)
    require(batches2 == steps, f"second epoch gave {batches2} batches, "
            f"first {steps}")
    stats = {
        "text_bytes": size, "steps": steps,
        "epoch_s": secs, "parse_to_device_gbps_training": size / secs / 1e9,
        "parse_to_device_gbps": size / parse_secs / 1e9,
        "steps_per_s": steps / secs,
        "h2d_bytes_per_batch": moved // steps,
    }
    log(f"parse-to-device with training: "
        f"{stats['parse_to_device_gbps_training']:.3f} GB/s ({size} text "
        f"bytes in {secs:.3f} s), {stats['steps_per_s']:.2f} steps/s; "
        f"without training: {stats['parse_to_device_gbps']:.3f} GB/s "
        f"({parse_secs:.3f} s)")
    return launches, stats


def device_time(path, lr, epoch_s):
    """Where the card's time goes: the device time of one more training
    epoch, traced by torch.profiler and summed by kernel, and its share
    of the unprofiled epoch's wall time (copies overlapping compute
    count twice)."""
    import torch
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    model = SparseLinearModel(NUM_FEATURES, learning_rate=lr,
                              device=torch.device("cuda"))
    by_kernel = _device_us_by_kernel(
        lambda: train_epoch(path, model, torch.device("cuda"), train=True))
    require(by_kernel, "the profiler saw no device time")
    total_us = sum(t for t, _ in by_kernel.values())
    log(f"device time over a training epoch: {total_us / 1e3:.3f} ms, "
        f"busy share {total_us / 1e6 / epoch_s:.4f} of the "
        f"{epoch_s:.3f} s epoch; by kernel:")
    for key, (t, n) in sorted(by_kernel.items(),
                              key=lambda kv: -kv[1][0])[:12]:
        log(f"  {t / 1e3:9.3f} ms  {n:5d} calls  {key[:90]}")
    return {"device_ms": total_us / 1e3,
            "busy_share": total_us / 1e6 / epoch_s}


# --------------------------------------------------------------- phase 5

def parity(path, lr):
    import numpy as np
    import torch
    from dmlc_tpu_torch.data.padding import pad_single
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.models.linear import SparseLinearModel
    native = Parser.create(path, 0, 1, format="libsvm", engine="native")
    firsts = []
    for batch in padded_batches(native):
        firsts.append(batch.copy())
        if len(firsts) == 4:
            break
    native.destroy()
    golden = Parser.create(path, 0, 1, format="libsvm", engine="python",
                           prefetch=False)
    cont = RowBlockContainer(np.uint32)
    for block in golden:
        cont.push_block(block)
        if cont.size >= 4 * ROW_BUCKET:
            break
    rows = cont.get_block()
    for i, nat in enumerate(firsts):
        gold = pad_single(rows.slice(i * ROW_BUCKET, (i + 1) * ROW_BUCKET),
                          ROW_BUCKET, NNZ_BUCKET)
        require(batch_hash(nat) == batch_hash(gold),
                f"native padded batch {i} differs from pad_single over the "
                "Python parser")
    log("parity: the first 4 native padded batches are byte-identical to "
        "pad_single over the Python parser")

    results = {}
    for dev in ("cuda", "cpu"):
        model = SparseLinearModel(NUM_FEATURES, learning_rate=lr, device=dev)
        losses = []
        for batch in firsts[:3]:
            t = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in batch.items()}
            losses.append(model.train_step(t))
        results[dev] = (torch.stack(losses).cpu(), model.w.detach().cpu(),
                        model.b.detach().cpu())
    (lc, wc, bc), (lp, wp, bp) = results["cuda"], results["cpu"]
    for name, a, b in (("losses", lc, lp), ("w", wc, wp), ("b", bc, bp)):
        require(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL),
                f"3 steps on the card vs the CPU plain path: {name} max "
                f"|err| {(a - b).abs().max().item()}")
    log(f"parity: 3 steps on the card match the CPU plain path (losses "
        f"{[round(float(x), 6) for x in lc]}, w max |err| "
        f"{(wc - wp).abs().max().item():.3g}, rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL})")


# --------------------------------------------------------------- main

def main() -> None:
    card = environment()
    sys.path.insert(0, REPO)
    import torch
    build_all()
    work = tempfile.mkdtemp(prefix="dmlc_chip_smoke_")
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        t0 = time.perf_counter()
        size = write_corpus(path)
        log(f"corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        first = first_batch(path)
        rows = check_kernels(first)
        launches, stats = main_path(path, size, LEARNING_RATE)
        report_kernels(rows, launches, stats["steps"])
        stats["device"] = device_time(path, LEARNING_RATE, stats["epoch_s"])
        stats["h2d_gbps"] = h2d_gbps(first)
        log(f"H2D from pinned slots: {stats['h2d_gbps']:.2f} GB/s "
            f"({stats['h2d_bytes_per_batch']} bytes per batch)")
        parity(path, LEARNING_RATE)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("main path: " + json.dumps(stats))
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
