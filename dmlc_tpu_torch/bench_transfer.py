"""Host→device transfer probe: the port's copy rates to the card on this host.

Counterpart of ``dmlc_tpu/bench_transfer.py``, with the same cells, the
same interleaving and the same JSON keys. A "put" is the port's own
host→device copy, the one ``parallel.device_iter`` makes for every batch:
a numpy chunk copied into a pinned :class:`HostStaging` slot, then copied
to the card on a copy stream with one event behind it
(``copy_to_device``); a put has landed when its event has completed
(``event.synchronize()``, the reference's ``jax.block_until_ready``).

Cells (each timed over ``--mb`` MB a repetition):

- ``single-<C>MB``: one thread, ``lookahead`` puts of C MB chunks in
  flight (2), a ring of reused source buffers;
- ``threads<N>-<C>MB``: N threads, each driving its own stream of puts
  (its own staging pool and copy stream);
- ``mono-64MB``: one put of 64 MB.

Cells interleave (one repetition of every cell a round) and each round
logs the host memcpy gauge (``memcpy_gauge``), so a reading can be
matched to the host's state when it was taken; runs on different hosts
compare only at similar gauges. Besides the cells: the share of the
copies' wall time the process spends on the CPU (``enqueue_cpu_share``),
and a single stream's rate while a host thread copies memory
(``cell_under_cpu_load``: do copies to the card and host work overlap?).
The stderr table also gives each ``single-*`` cell's pageable rate
(``torch.from_numpy(a).to(device)``, no staging), which the JSON leaves
out to keep the reference's keys.

Usage: python -m dmlc_tpu_torch.bench_transfer [--reps N] [--mb MB]
[--device cuda|cpu]. Prints the per-cell median table to stderr and ONE
JSON line to stdout: ``{"metric", "cells": {name: GB/s}, "memcpy_gbps",
"enqueue_cpu_share", "overlap_transfer_gbps", "overlap_memcpy_gbps",
"reps"}``. ``--device`` defaults to ``cuda``; on the CPU a "put" aliases
its slot and the numbers are host copies, not transfers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from dmlc_tpu_torch.parallel.device_iter import (
    DeviceBatch, HostStaging, copy_to_device,
)

__all__ = ["memcpy_gauge", "cell_single", "cell_threads", "cell_mono",
           "cell_under_cpu_load", "cell_pageable", "enqueue_cpu_share",
           "probe", "main"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def memcpy_gauge(mb: int = 48) -> float:
    """Host memcpy GB/s: the host's state when a reading was taken.
    Copy rates are comparable across runs only at similar gauges."""
    a = np.full(mb << 20, 7, np.uint8)
    b = np.empty_like(a)
    t0 = time.perf_counter()
    np.copyto(b, a)
    return a.nbytes / (time.perf_counter() - t0) / 1e9


class _Putter:
    """One stream of puts: a staging pool of ``lookahead + 1`` pinned
    slots (pinned on the card only) and a copy stream of its own."""

    def __init__(self, dev: torch.device, lookahead: int):
        on_cuda = dev.type == "cuda"
        self.dev = dev
        self.pool = HostStaging(lookahead + 1, pin=on_cuda,
                                alias_unsafe=not on_cuda)
        self.stream = torch.cuda.Stream(dev) if on_cuda else None

    def warm(self, buf: np.ndarray) -> "_Putter":
        """Allocate the pool's slots for ``buf``'s shape before a timed
        region (a pinned allocation is not a transfer)."""
        spec = {"x": (buf.shape, buf.dtype)}
        slots = [self.pool.acquire(spec) for _ in range(self.pool.slots)]
        for slot in slots:
            self.pool.release(slot, None)
        return self

    def put(self, buf: np.ndarray) -> DeviceBatch:
        slot = self.pool.stage({"x": buf})
        out = copy_to_device(slot, self.dev, self.stream)
        self.pool.release(slot, out.event)
        return out


def _landed(put: DeviceBatch) -> None:
    if put.event is not None:
        put.event.synchronize()


def _one_stream(putter: _Putter, lookahead: int, nchunks: int,
                bufs: List[np.ndarray]) -> None:
    pending: List[DeviceBatch] = []
    for i in range(nchunks):
        pending.append(putter.put(bufs[i % len(bufs)]))
        if len(pending) > lookahead:
            _landed(pending.pop(0))
    for p in pending:
        _landed(p)


def cell_single(dev: torch.device, chunk_mb: int, lookahead: int,
                total_mb: int) -> float:
    """One thread, ring of reused buffers, ``lookahead`` puts in flight:
    the shape of the port's ``to_device`` stage and serve thread."""
    chunk = chunk_mb << 20
    n = max(1, (total_mb << 20) // chunk)
    bufs = [np.full(chunk, 7, np.uint8) for _ in range(lookahead + 1)]
    putter = _Putter(dev, lookahead).warm(bufs[0])
    t0 = time.perf_counter()
    _one_stream(putter, lookahead, n, bufs)
    return n * chunk / (time.perf_counter() - t0) / 1e9


def cell_threads(dev: torch.device, nthreads: int, chunk_mb: int,
                 lookahead: int, total_mb: int) -> float:
    """N threads each driving an independent stream of puts: do
    concurrent streams add up?"""
    chunk = chunk_mb << 20
    n_per = max(1, (total_mb << 20) // chunk // nthreads)
    all_bufs = [[np.full(chunk, 7, np.uint8) for _ in range(lookahead + 1)]
                for _ in range(nthreads)]
    putters = [_Putter(dev, lookahead).warm(bufs[0]) for bufs in all_bufs]
    barrier = threading.Barrier(nthreads + 1)
    errors: List[BaseException] = []

    def work(i):
        barrier.wait()
        try:
            _one_stream(putters[i], lookahead, n_per, all_bufs[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,), daemon=True)
          for i in range(nthreads)]
    for t in ts:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return nthreads * n_per * chunk / dt / 1e9


def cell_mono(dev: torch.device, size_mb: int) -> float:
    """One put of ``size_mb``: per-call overhead amortized away."""
    a = np.full(size_mb << 20, 7, np.uint8)
    putter = _Putter(dev, 1).warm(a)
    t0 = time.perf_counter()
    _landed(putter.put(a))
    return (size_mb << 20) / (time.perf_counter() - t0) / 1e9


def cell_pageable(dev: torch.device, chunk_mb: int, lookahead: int,
                  total_mb: int) -> float:
    """``cell_single``'s stream without staging: each chunk copied from
    pageable memory (``torch.from_numpy(a).to(device)``)."""
    chunk = chunk_mb << 20
    n = max(1, (total_mb << 20) // chunk)
    bufs = [np.full(chunk, 7, np.uint8) for _ in range(lookahead + 1)]
    t0 = time.perf_counter()
    for i in range(n):
        torch.from_numpy(bufs[i % len(bufs)]).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return n * chunk / (time.perf_counter() - t0) / 1e9


def cell_under_cpu_load(dev: torch.device, chunk_mb: int = 4,
                        lookahead: int = 2, total_mb: int = 48):
    """A stream of puts while a host thread copies memory (a stand-in
    for the parse): returns (put GB/s, concurrent memcpy GB/s). Both
    staying high shows the copies to the card and host work overlap."""
    stop = threading.Event()
    a = np.full(8 << 20, 3, np.uint8)
    b = np.empty_like(a)
    copied = [0]

    def burn():
        while not stop.is_set():
            np.copyto(b, a)
            copied[0] += a.nbytes

    t = threading.Thread(target=burn, daemon=True)
    t.start()
    t0 = time.perf_counter()
    try:
        rate = cell_single(dev, chunk_mb, lookahead, total_mb)
    finally:
        dt = time.perf_counter() - t0
        stop.set()
        t.join()
    return rate, copied[0] / dt / 1e9


def enqueue_cpu_share(dev: torch.device, chunk_mb: int = 4,
                      total_mb: int = 1024) -> float:
    """Share of a stream's wall time that the process spends on the CPU
    (``time.process_time``, every thread of the process): the staging
    copies, the enqueues and the event waits (``event.synchronize`` may
    spin), so read it beside ``cell_under_cpu_load``. The stream is 1 GB
    (the reference's is 64 MB): the process clock of the card's host
    ticks in 10 ms, and 64 MB at the card's rates takes about 5 ms."""
    chunk = chunk_mb << 20
    n = max(1, (total_mb << 20) // chunk)
    bufs = [np.full(chunk, 7, np.uint8) for _ in range(3)]
    putter = _Putter(dev, 2).warm(bufs[0])
    w0, c0 = time.perf_counter(), time.process_time()
    _one_stream(putter, 2, n, bufs)
    wall = time.perf_counter() - w0
    cpu = time.process_time() - c0
    return cpu / wall if wall > 0 else 0.0


SINGLE_CHUNKS_MB = (1, 2, 4, 8)


def probe(dev: torch.device, reps: int = 5, mb: int = 64) -> Dict:
    """Run every cell ``reps`` times, interleaved, and return the JSON
    record (medians); the per-cell table and each round's gauge go to
    stderr."""
    warm = _Putter(dev, 1)
    _landed(warm.put(np.zeros(1 << 20, np.uint8)))
    cells: Dict[str, Callable[[], float]] = {
        **{f"single-{c}MB": (lambda c=c: cell_single(dev, c, 2, mb))
           for c in SINGLE_CHUNKS_MB},
        "threads2-4MB": lambda: cell_threads(dev, 2, 4, 2, mb),
        "threads4-4MB": lambda: cell_threads(dev, 4, 4, 2, mb),
        "threads4-1MB": lambda: cell_threads(dev, 4, 1, 2, mb),
        "mono-64MB": lambda: cell_mono(dev, 64),
    }
    pageable: Dict[str, Callable[[], float]] = {
        f"single-{c}MB": (lambda c=c: cell_pageable(dev, c, 2, mb))
        for c in SINGLE_CHUNKS_MB}
    # one rep of every cell a round, so a swing of the host's state
    # mid-run biases all cells alike; each round tagged with the gauge
    results: Dict[str, List[float]] = {k: [] for k in cells}
    pageable_results: Dict[str, List[float]] = {k: [] for k in pageable}
    gauges: List[float] = []
    for rep in range(reps):
        g = memcpy_gauge()
        gauges.append(g)
        for name, fn in cells.items():
            results[name].append(fn())
        for name, fn in pageable.items():
            pageable_results[name].append(fn())
        log(f"round {rep}: memcpy gauge {g:.2f} GB/s")
    share = enqueue_cpu_share(dev)
    overlap_t, overlap_c = cell_under_cpu_load(dev)

    med = {k: statistics.median(v) for k, v in results.items()}
    log(f"{'cell':14s} {'median':>7s}  runs (GB/s)")
    for k, v in results.items():
        log(f"{k:14s} {med[k]:7.3f}  " + " ".join(f"{x:.2f}" for x in v))
    for k, v in pageable_results.items():
        log(f"{k:14s} {statistics.median(v):7.3f}  "
            + " ".join(f"{x:.2f}" for x in v) + "  (pageable, no staging)")
    log(f"memcpy gauge median {statistics.median(gauges):.2f} GB/s; "
        f"enqueue CPU share {share:.0%}; under-cpu-load: transfer "
        f"{overlap_t:.2f} GB/s with {overlap_c:.2f} GB/s concurrent memcpy")
    return {
        "metric": "host_to_hbm_transfer_gbps",
        "cells": {k: round(v, 3) for k, v in med.items()},
        "memcpy_gbps": round(statistics.median(gauges), 3),
        "enqueue_cpu_share": round(share, 3),
        "overlap_transfer_gbps": round(overlap_t, 3),
        "overlap_memcpy_gbps": round(overlap_c, 3),
        "reps": reps,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved repetitions per cell (median reported)")
    ap.add_argument("--mb", type=int, default=64,
                    help="bytes per cell per rep (MB)")
    ap.add_argument("--device", default="cuda",
                    help="the device the puts copy to (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    log(f"device: {dev} ({name})")
    print(json.dumps(probe(dev, args.reps, args.mb)), flush=True)


if __name__ == "__main__":
    main()
