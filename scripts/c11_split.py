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
- page epochs with a synchronise after each batch at each reader count
  in turns (``sharded.PAGE_READERS`` set to each of READER_ORDER in
  that order, READER_EPOCHS epochs each time, groups of
  ``PAGE_GROUP_BYTES``), with each count's median; then three at each
  read's byte cap of GROUP_BYTES (``sharded.PAGE_GROUP_BYTES``; 1 reads
  a round at a time) with ``PAGE_READERS`` readers; each with the last
  epoch's serve thread stats;
- the same ``RawRoundStager`` driven on this thread over every round,
  three times with read-ahead on (``PAGE_READERS`` readers) and three
  with its reads made on this thread (a stand-in for its readers that
  reads each group when it is asked for), its seconds split into the
  slots' acquire, the read (on this thread, or the wait for a
  reader's), the allocation of a group's batches (one allocation, the
  views; the reader's with read-ahead on, so inside the wait), the
  epoch's ``RoundStage`` call (the copy's and the launch's enqueue in
  one C call) and the total; the total less the read, a round, is the
  stager's host time excluding the reads;
- the reads alone: into one pinned buffer, into three in turn, into a
  pageable one, by ``os.preadv`` into three pinned buffers, and by
  ``os.preadv`` split over 2 and 4 threads;
- three host memcpy gauges (``bench_transfer.memcpy_gauge``);
- ``round_unpack``'s device µs at the shape's first round (profiler);
- one cold page epoch (``chip_smoke.cold_page_epoch``: the page file
  dropped from the host's page cache first), with a synchronise after
  each batch.

It prints one JSON line a shape and, last, one with both and the card.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from statistics import median

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1 << 14, 1 << 19, 1), (8192, 368640, 4))  # rows, nnz, parts
# each reader count three times, in balanced turns
READER_ORDER = (1, 3, 2, 4, 4, 2, 3, 1, 1, 3, 2, 4)
READER_EPOCHS = 8
GROUP_BYTES = (1, 8 << 20)


def _timed(name, fn, tm):
    def g(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        tm[name] += time.perf_counter() - t0
        return out
    return g


class _Inline:
    """The stager's readers replaced by reads on the calling thread, each
    group read when ``submit`` is called, its read timed in
    ``tm["read"]``."""

    def __init__(self, f, tm):
        self.f, self.tm = f, tm

    def submit(self, r0, r1, buf, after):
        t0 = time.perf_counter()
        spans, error = self.f.read_rounds_into(r0, r1, buf)
        self.tm["read"] += time.perf_counter() - t0
        done = Future()
        done.set_result((spans, error, after(spans)))
        return done

    def close(self):
        pass


class _Waited:
    """A read's Future whose ``result()`` adds its wait to ``tm["read"]``."""

    def __init__(self, fut, tm):
        self.fut, self.tm = fut, tm

    def result(self):
        t0 = time.perf_counter()
        try:
            return self.fut.result()
        finally:
            self.tm["read"] += time.perf_counter() - t0


def shape(c, path, work, dev, rb, nb, parts):
    """One shape's figures (module docstring)."""
    import numpy as np
    import torch
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    from dmlc_tpu_torch.ops import pages
    from dmlc_tpu_torch.parallel.device_iter import HostStaging, wait_copy
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.sharded import (PAGE_GROUP_BYTES,
                                                 PAGE_READERS, Mesh,
                                                 RawRoundStager,
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

    # page epochs at each reader count in turns, then at each group cap
    try:
        for k in READER_ORDER:
            sharded.PAGE_READERS = k
            r.setdefault(f"pages_readers{k}", []).extend(
                epoch() for _ in range(READER_EPOCHS))
            r[f"serve_readers{k}"] = it._serve_stats
        r["readers_median_s"] = {
            k: median(r[f"pages_readers{k}"]) for k in sorted(
                set(READER_ORDER))}
        sharded.PAGE_READERS = PAGE_READERS
        for g in GROUP_BYTES:
            sharded.PAGE_GROUP_BYTES = g
            r[f"pages_group{g}"] = [epoch() for _ in range(3)]
            r[f"serve_group{g}"] = it._serve_stats
    finally:
        sharded.PAGE_READERS = PAGE_READERS
        sharded.PAGE_GROUP_BYTES = PAGE_GROUP_BYTES

    # the stager on this thread, with read-ahead and with its reads on
    # this thread, its parts timed
    pool = HostStaging(3 + PAGE_READERS, pin=True)
    stream = torch.cuda.Stream(dev)
    tm = {"acquire": 0.0, "read": 0.0, "alloc": 0.0, "stage": 0.0}
    pool.acquire = _timed("acquire", pool.acquire, tm)
    try:
        for name in ("manual", "manual_inline"):
            runs = []
            for _ in range(3):
                st = RawRoundStager(f, dev, rb, nb, pool, stream)
                st._stage = _timed("stage", st._stage, tm)
                st._outputs = _timed("alloc", st._outputs, tm)
                if name == "manual_inline":
                    st._reads.close()
                    st._reads = _Inline(f, tm)
                else:
                    submit = st._reads.submit
                    st._reads.submit = (lambda r0, r1, buf, after,
                                        submit=submit:
                                        _Waited(submit(r0, r1, buf, after),
                                                tm))
                for k in tm:
                    tm[k] = 0.0
                t0 = time.perf_counter()
                try:
                    with torch.cuda.stream(stream):
                        for i in range(rounds):
                            wait_copy(st(i, False, False), dev)
                    torch.cuda.synchronize(dev)
                finally:
                    st.close()
                total = time.perf_counter() - t0
                runs.append(dict(
                    {k: round(v, 4) for k, v in tm.items()},
                    total=round(total, 4),
                    host_us_a_round=round(
                        (total - tm["read"]) / rounds * 1e6, 1)))
            r[name] = runs
    finally:
        f.close()
    r["page_readers"], r["page_group_bytes"] = PAGE_READERS, PAGE_GROUP_BYTES

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
    r["cold"] = c.cold_page_epoch(f.path, epoch)
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
