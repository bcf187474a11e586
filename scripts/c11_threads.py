#!/usr/bin/env python3
"""Where a threaded page epoch's time goes, thread by thread, on one card.

Usage: ``python3 scripts/c11_threads.py [TREE]`` on a machine with a
card, TREE the root of the checkout to measure (a ``git archive``
unpacked into a gitignored directory; this script's own checkout when
left out). It builds that checkout's kernels and engine,
writes chip_smoke's linear corpus (256 MB) and, at config 10's shape
(one part of 16384 rows, ``nnz_bucket`` 2^19) and the spill path's (4
parts of 8192 rows, 368640), runs a ``ShardedRowBlockIter`` at a 1 MB
replay budget through two parse epochs and three warm page epochs, then
times four page epochs with a synchronise after each batch (as config
10), each split by thread, in milliseconds an epoch:

- the serve thread: ``RawRoundStager`` calls, of which the wait for a
  group's read (``_take_group``), the slots' acquire and release, and
  the ``RoundStage`` calls (the copy's and the launch's enqueue);
- the readers: ``read_rounds_into``, summed over the readers;
- the making of each group's batches: by its reader on a tree where
  ``RoundStage.outputs`` does it (``reader.outputs``), on the serve
  thread where ``RoundStage.batches`` does (``serve.batches``), split
  three ways: its views (``views``: ``ops.pages._views``), the rest
  (``torch.empty`` and the layout: the whole less ``views``), and its
  wait to run (``.wait``: its wall less its thread's CPU time, which
  the host's thread clock may count in ticks of 10 ms);
- the consumer: ``ThreadedIter.next``, ``wait_copy`` and the
  synchronise;
- the caching allocator: ``torch.cuda.memory_stats()``'s
  ``num_device_alloc`` (its ``cudaMalloc`` calls) and
  ``segment.all.allocated`` before and after every page epoch, the
  three warm ones too (``allocs``: the tier, then each counter before
  and after).

Then, at config 10's first round, the host µs of a ``RoundStage`` call
with the allocation (100 calls, the thread's current stream the
stage's), alone and beside one more thread: one copying 64 MB at a time
through ``ctypes.memmove`` (no GIL held), one reading 4 KB at a time by
``os.pread`` (the GIL taken back after every read), one reading 8 MB at
a time by ``os.preadv``. It prints one JSON line a part and, last, one
with all of them and the card.
"""

import ctypes
import json
import os
import shutil
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("num_device_alloc", "segment.all.allocated")
SHAPES = ((1 << 14, 1 << 19, 1), (8192, 368640, 4))  # rows, nnz, parts
# (class, method, the name its milliseconds go under)
TIMED = (("RawRoundStager", "__call__", "serve.stager_call"),
         ("RawRoundStager", "_take_group", "serve.take_group"),
         ("HostStaging", "acquire", "serve.acquire"),
         ("HostStaging", "release", "serve.release"),
         ("RoundStage", "__call__", "serve.round_stage"),
         ("RoundStage", "batches", "serve.batches"),
         ("RoundStage", "outputs", "reader.outputs"),
         ("RoundSpillFile", "read_rounds_into", "reader.read_rounds_into"),
         ("ThreadedIter", "next", "consumer.ti_next"))


def _timer(fn, name, tm, lock):
    """``fn``, its wall seconds summed under ``name`` in ``tm``; for the
    making of a group's batches, its wall less its thread's CPU seconds
    under ``name + ".wait"`` too."""
    wait = name in ("reader.outputs", "serve.batches", "views")

    def timed(*a, **k):
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            return fn(*a, **k)
        finally:
            wall = time.perf_counter() - t0
            cpu = time.thread_time() - c0
            with lock:
                tm[name] = tm.get(name, 0.0) + wall
                if wait:
                    tm[name + ".wait"] = (tm.get(name + ".wait", 0.0)
                                          + wall - cpu)
    return timed


def _counters(dev):
    import torch
    stats = torch.cuda.memory_stats(dev)
    return [int(stats.get(k, 0)) for k in COUNTERS]


def split(path, work, dev, tm):
    """Four timed page epochs a shape, split by thread (module
    docstring)."""
    import torch
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    out = {}
    for rb, nb, parts in SHAPES:
        key = f"{parts}x{rb}"
        it = ShardedRowBlockIter(path, Mesh((parts,), ("data",), device=dev),
                                 format="libsvm", row_bucket=rb,
                                 nnz_bucket=nb, agreement_cache_bytes=1 << 20,
                                 first_epoch_cache="never",
                                 spill_dir=os.path.join(work, "spill" + key))
        allocs = []
        for epoch in range(5):  # parse, parse, three warm page epochs
            before = _counters(dev)
            for _b in it:
                torch.cuda.synchronize(dev)
            if it.replay_tier == "pages":
                allocs.append([it.replay_tier] + before + _counters(dev))
        runs = []
        for _ in range(4):
            tm.clear()
            sync = 0.0
            before = _counters(dev)
            t0 = time.perf_counter()
            for _b in it:
                s0 = time.perf_counter()
                torch.cuda.synchronize(dev)
                sync += time.perf_counter() - s0
            torch.cuda.synchronize(dev)
            allocs.append([it.replay_tier] + before + _counters(dev))
            run = {k: round(v * 1e3, 2) for k, v in sorted(tm.items())}
            run["consumer.sync"] = round(sync * 1e3, 2)
            run["epoch"] = round((time.perf_counter() - t0) * 1e3, 2)
            run["serve.work"] = round(it._serve_stats["work_s"] * 1e3, 2)
            runs.append(run)
        it.close()
        out[key] = {"runs": runs, "allocs": allocs}
        print(json.dumps({key: out[key]}), flush=True)
    return out


def beside(path, work, dev):
    """A ``RoundStage`` call's host µs at config 10's first round, alone
    and beside one more thread (module docstring)."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.ops.pages import INDEX_DTYPES, RoundStage
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    rb, nb, _ = SHAPES[0]
    it = ShardedRowBlockIter(path, Mesh((1,), ("data",), device=dev),
                             format="libsvm", row_bucket=rb, nnz_bucket=nb,
                             agreement_cache_bytes=1 << 20,
                             first_epoch_cache="never",
                             spill_dir=os.path.join(work, "spill_beside"))
    for _ in range(2):
        for _b in it:
            pass
    f = it._round_store.file
    host = torch.empty(f.table.max_size, dtype=torch.uint8, pin_memory=True)
    size = f.read_round_into(0, host.numpy())
    f.close()
    rows = f.table.blocks[0]
    stream = torch.cuda.Stream(dev)
    stage = RoundStage(torch.empty(size, dtype=torch.uint8, device=dev),
                       torch.from_numpy(rows.copy()).to(dev), rb, nb, stream)
    dtype = INDEX_DTYPES[int(rows[0, 4])]
    scratch = os.path.join(work, "beside.bin")
    with open(scratch, "wb") as out:
        out.write(b"\0" * (8 << 20))

    def memmove(stop):
        a, b = np.ones(64 << 20, np.uint8), np.empty(64 << 20, np.uint8)
        while not stop.is_set():
            ctypes.memmove(b.ctypes.data, a.ctypes.data, a.nbytes)

    def reads(n):
        def loop(stop):
            fd = os.open(scratch, os.O_RDONLY)
            buf = bytearray(n)
            try:
                while not stop.is_set():
                    os.preadv(fd, [buf], 0)
            finally:
                os.close(fd)
        return loop

    res = {}
    for name, target in (("alone", None), ("memmove_64mb", memmove),
                         ("pread_4kb", reads(4096)),
                         ("preadv_8mb", reads(8 << 20))):
        stop = threading.Event()
        th = threading.Thread(target=target, args=(stop,)) if target else None
        if th is not None:
            th.start()
            time.sleep(0.05)
        us = []
        with torch.cuda.stream(stream):
            for _ in range(3):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(100):
                    stage(host, 0, dtype, nbytes=size)
                us.append(round((time.perf_counter() - t0) / 100 * 1e6, 1))
                torch.cuda.synchronize(dev)
        stop.set()
        if th is not None:
            th.join()
        res[name] = us
    it.close()
    print(json.dumps({"round_stage_us": res}), flush=True)
    return res


def main(argv) -> int:
    tree = os.path.abspath(argv[0]) if argv else REPO
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as c
    card = c.environment()
    c.build_all()
    from dmlc_tpu_torch.data import row_iter, threaded_iter
    from dmlc_tpu_torch.ops import pages
    from dmlc_tpu_torch.parallel import device_iter, sharded
    owners = {"RawRoundStager": sharded.RawRoundStager,
              "HostStaging": device_iter.HostStaging,
              "RoundStage": pages.RoundStage,
              "RoundSpillFile": row_iter.RoundSpillFile,
              "ThreadedIter": threaded_iter.ThreadedIter}
    tm, lock = {}, threading.Lock()
    work = tempfile.mkdtemp(prefix="dmlc_c11_threads_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        res = {"tree": tree, "card": card, "size": c.write_corpus(path)}
        dev = torch.device("cuda", 0)
        res["round_stage_us"] = beside(path, work, dev)
        for o, m, name in TIMED:
            if o == "RoundStage" and m == "outputs" and \
                    hasattr(pages.RoundStage, "batches"):
                continue  # outputs calls batches: time that alone
            fn = getattr(owners[o], m, None)
            if fn is None:
                continue  # a method this tree lacks
            setattr(owners[o], m, _timer(fn, name, tm, lock))
        pages._views = _timer(pages._views, "views", tm, lock)
        sharded.wait_copy = _timer(sharded.wait_copy, "consumer.wait_copy",
                                   tm, lock)
        res["split"] = split(path, work, dev, tm)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
