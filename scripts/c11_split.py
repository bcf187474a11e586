#!/usr/bin/env python3
"""Split a page epoch of the raw route into its parts, on one card.

Usage: ``python3 scripts/c11_split.py`` from the root of a checkout on a
machine with a card. It builds the checkout's kernels and engine, writes
chip_smoke's linear corpus (256 MB), and for two shapes, config 10's (one
part of 16384 rows, ``nnz_bucket`` 2^19) and the spill path's (4 parts of
8192 rows, 368640), runs a ``ShardedRowBlockIter`` at a 1 MB replay
budget through two parse epochs and then times:

- three page epochs with a synchronise after each batch (as config 10)
  and three without, each with the serve thread's stats;
- the same ``RawRoundStager`` driven on this thread over every round,
  three times, its seconds split into the slot's acquire, the read
  (``read_round_into``) and the ``round_unpack`` wrapper (allocation,
  checks, launch), and the total;
- the reads alone: into one pinned buffer, into three in turn, into a
  pageable one, by ``os.preadv`` into three pinned buffers, and by
  ``os.preadv`` split over 2 and 4 threads;
- three host memcpy gauges (``bench_transfer.memcpy_gauge``);
- ``round_unpack``'s device µs at the shape's first round (profiler).

It prints one JSON line a shape and, last, one with both and the card.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1 << 14, 1 << 19, 1), (8192, 368640, 4))  # rows, nnz, parts


def _timed(name, fn, tm):
    def g(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        tm[name] += time.perf_counter() - t0
        return out
    g.launches = 0  # stands in for round_unpack, whose count it takes
    return g


def shape(c, path, work, dev, rb, nb, parts):
    """One shape's figures (module docstring)."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    from dmlc_tpu_torch.ops import pages
    from dmlc_tpu_torch.parallel.device_iter import HostStaging, wait_copy
    from dmlc_tpu_torch.parallel.sharded import (Mesh, RawRoundStager,
                                                 ShardedRowBlockIter)
    key = f"{parts}x{rb}"
    mesh = Mesh((parts,), ("data",), device=dev)
    it = ShardedRowBlockIter(path, mesh, format="libsvm", row_bucket=rb,
                             nnz_bucket=nb, agreement_cache_bytes=1 << 20,
                             first_epoch_cache="never",
                             spill_dir=os.path.join(work, "spill" + key))

    def epoch(sync=True):
        t0 = time.perf_counter()
        for _b in it:
            if sync:
                torch.cuda.synchronize(dev)
        torch.cuda.synchronize(dev)
        return round(time.perf_counter() - t0, 4)

    r = {"parse": [epoch(), epoch()]}
    r["pages_sync"] = [epoch() for _ in range(3)]
    r["serve_sync"] = it._serve_stats
    r["pages_nosync"] = [epoch(False) for _ in range(3)]
    r["serve_nosync"] = it._serve_stats
    print(json.dumps({key: r}), flush=True)
    f = it._round_store.file
    rounds = f.rounds
    r["rounds"], r["max_size"] = rounds, f.table.max_size

    # the stager on this thread, its parts timed
    pool = HostStaging(3, pin=True)
    st = RawRoundStager(f, dev, rb, nb, pool, torch.cuda.Stream(dev))
    tm = {"acquire": 0.0, "read": 0.0, "unpack": 0.0}
    orig = (pool.acquire, f.read_round_into, pages.round_unpack)
    pool.acquire = _timed("acquire", orig[0], tm)
    f.read_round_into = _timed("read", orig[1], tm)
    pages.round_unpack = _timed("unpack", orig[2], tm)
    manual = []
    try:
        for _ in range(3):
            for k in tm:
                tm[k] = 0.0
            t0 = time.perf_counter()
            for i in range(rounds):
                wait_copy(st(i, False, False), dev)
            torch.cuda.synchronize(dev)
            manual.append(dict({k: round(v, 4) for k, v in tm.items()},
                               total=round(time.perf_counter() - t0, 4)))
    finally:
        pool.acquire, f.read_round_into, pages.round_unpack = orig
        f.close()
    r["manual"] = manual

    # the reads alone
    bufs = [torch.empty(f.table.max_size, dtype=torch.uint8,
                        pin_memory=True) for _ in range(3)]
    pageable = np.empty(f.table.max_size, np.uint8)
    for name, target in (("pinned1", lambda i: bufs[0].numpy()),
                         ("pinned3", lambda i: bufs[i % 3].numpy()),
                         ("pageable", lambda i: pageable)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(rounds):
                f.read_round_into(i, target(i))
            ts.append(round(time.perf_counter() - t0, 4))
        f.close()
        r["read_" + name] = ts
    fd = os.open(f.path, os.O_RDONLY)
    try:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(rounds):
                os.preadv(fd, [memoryview(bufs[i % 3].numpy())[
                    :int(f.table.size[i])]], int(f.table.start[i]))
            ts.append(round(time.perf_counter() - t0, 4))
        r["preadv_pinned3"] = ts
        for nt in (2, 4):
            with ThreadPoolExecutor(nt) as ex:
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for i in range(rounds):
                        n = int(f.table.size[i])
                        mv = memoryview(bufs[i % 3].numpy())
                        step = (n + nt - 1) // nt
                        for x in [ex.submit(os.preadv, fd,
                                            [mv[a:min(n, a + step)]],
                                            int(f.table.start[i]) + a)
                                  for a in range(0, n, step)]:
                            x.result()
                    ts.append(round(time.perf_counter() - t0, 4))
            r[f"preadv_{nt}threads"] = ts
    finally:
        os.close(fd)
    r["gauge"] = [round(memcpy_gauge(), 3) for _ in range(3)]

    # round_unpack's device time at this shape's first round
    size = f.read_round_into(0, bufs[0].numpy())
    f.close()
    rows = f.table.blocks[0]
    raw = bufs[0][:size].to(dev)
    table = torch.from_numpy(rows.copy()).to(dev)
    args = (rb, nb, pages.INDEX_DTYPES[int(rows[0, 4])], False, False)
    out = pages.round_unpack(raw, table, *args)
    by = c._device_us_by_kernel(
        lambda: [pages.round_unpack(raw, table, *args, out=out)
                 for _ in range(50)], 50, {"round_unpack_kernel": 1})
    r["kernel_us"] = {k[:60]: v for k, v in by.items()}
    it.close()
    print(json.dumps({key: r}), flush=True)
    return key, r


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as c
    card = c.environment()
    c.build_all()
    work = tempfile.mkdtemp(prefix="dmlc_c11_split_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        res = {"card": card, "size": c.write_corpus(path)}
        dev = torch.device("cuda", 0)
        for rb, nb, parts in SHAPES:
            key, r = shape(c, path, work, dev, rb, nb, parts)
            res[key] = r
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
