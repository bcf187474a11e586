"""The ported configs of the benchmark suite.

Counterpart of ``dmlc_tpu/bench_suite.py``, holding only the configs
whose planes are ported; each emits one JSON line with the reference's
keys, ``"platform"`` naming the device the numbers came from (``gpu``
on the card) where the reference reports one:

  1. libsvm  — LibSVMParser → RowBlockIter on an a1a-shaped single file
  2. csv     — CSVParser dense RowBlocks on a HIGGS-shaped file (label +
               28 columns), and its sparse mode on a variant with 30%
               exact zeros
  3. recordio — the RecordIO split over 4 parts of an ImageNet-.rec-
               shaped corpus (60-140 KB binary records), through the
               native record reader when the engine is built
  4. prefetch — four parts parsed on concurrent threads, each copying
               its blocks to the device through its own pinned staging
               pool, 4 copies in flight a part (the multi-host shape)
  5. parquet — Parquet columnar ingest through the pyarrow golden
  6. indexed_shuffled — the native shuffled indexed-RecordIO reader vs
               the Python split (seed 11, batches of 64 records),
               digest-checked
  7. multiprocess — a real 2-process gang (``launch_local``) streaming
               its parts through ShardedRowBlockIter for 3 epochs
               (``bench_mp_worker.py``): epoch 1 parses, epochs 2-3
               replay the retained rounds
  8. page_replay — binary page cache replay → device memory, parse
               skipped (DiskRowIter pages; the repeated-epoch shape)
 10. spill_replay — page-SPILL steady replay: ShardedRowBlockIter
               forced over its agreement_cache_bytes budget, steady
               epochs served from the spilled round pages (the
               larger-than-RAM training shape)
 11. remote_hydrate — the criteo-shaped corpus over ``obj://`` on the
               on-disk object-store emulator behind a modeled wire
               (2 ms, 4 GB/s): a cold epoch of ranged GETs hydrating
               the page store, three warm epochs with zero GETs, and
               the codec variant (level 6), every epoch sha256-held to
               the local file
 14. recio_native — the native dense-RecordIO decode (ABI 6) vs the
               Python golden vs the sharded gang, sha256-parity pinned
 17. parquet_native — the native Parquet page decode vs the pyarrow
               golden on a decode-bound corpus (20 null-bearing f32
               columns, UNCOMPRESSED V1 pages), sha256 stream parity at
               1/2/4 shards, interleaved and gauge-tagged; native >= 3x
               the golden and outstanding() == 0 checked
 18. image_record — the native image-payload decode (ABI 8): the
               config-3 scenario's decoded batches (raw uniform HWC u8
               -> padded f32), python / native / sharded x2
               sha256-identical

Run: python -m dmlc_tpu_torch.bench_suite [--config N] [--mb MB]
[--chaos PLAN]. ``--chaos`` arms a fault plan (the ``DMLC_TPU_FAULTS``
grammar) for the whole run: each config's JSON gets a ``chaos`` section
(the plan, its seed, and the faults injected and retries by site during
that config), and a config that fails emits an ``error`` line while the
next config still runs.
Configs 4, 7, 8 and 10 copy to the card (config 4 as the reference's
``--device`` run does; its parse-only form is not ported); configs 1,
2, 3, 5, 6, 11, 14, 17 and 18 are the reference's host-side
measurements (read, parse and decode, no copy), as there. Configs 5 and 17 write
their corpora with pyarrow (``make_parquet``,
``make_parquet_decode_bound``), so they run only where pyarrow is
installed: not on the card's machine, which has none.

Trimmed from the reference: every other config (their planes are not
ported), the warm-up pass, ``--trace`` and the live telemetry opt-ins. Data files go
under ``<tempdir>/dmlc_tpu_torch_bench_suite.*`` unless a config is
given a ``work`` directory. Configs 1, 2, 3, 5, 6, 14, 17 and 18 write
the reference's corpora (``make_libsvm`` at its a1a defaults,
``make_csv``, ``make_recordio``, ``make_parquet``,
``make_indexed_recordio``, ``make_dense_recordio``,
``make_parquet_decode_bound``, ``make_image_recordio``: the same bytes
from the same seed; pyarrow's files the same tables). Configs 4, 7, 8,
10 and 11 read one corpus file, the reference's criteo shape from seed
7 (the file its configs 4, 9 and 12 share; it writes the same bytes
under more names for 7, 8, 10 and 11):
``make_libsvm`` draws each row's indices by a permutation of 10^6, so
writing it takes minutes whatever ``mb`` is, and a second copy would
double that. Configs 8, 10, 14, 17 and 18 take the reference's
``gauge_fn`` (e.g. ``bench_transfer.memcpy_gauge``, the default of 14,
17 and 18), which
tags each epoch with the host's memcpy rate just before it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dmlc_tpu_torch.utils.logging import check

__all__ = ["make_libsvm", "make_csv", "make_recordio", "make_dense_recordio",
           "make_indexed_recordio", "make_parquet",
           "make_parquet_decode_bound", "make_image_recordio",
           "bench_libsvm", "bench_csv", "bench_recordio", "bench_prefetch",
           "bench_parquet", "bench_indexed_shuffled",
           "bench_multiprocess_ingest", "bench_page_replay",
           "bench_spill_replay", "bench_remote_hydrate",
           "bench_recio_native",
           "bench_parquet_native", "bench_image_record", "CONFIGS", "main"]


def _prefix(work: Optional[str]) -> str:
    return os.path.join(work or tempfile.gettempdir(),
                        "dmlc_tpu_torch_bench_suite")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _emit(payload: Dict) -> None:
    print(json.dumps(payload), flush=True)


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


def _content_hash(uri: str, fmt: str, **kw) -> str:
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    c = RowBlockContainer(np.uint32)
    p = Parser.create(uri, 0, 1, format=fmt, **kw)
    for b in p:
        c.push_block(b)
    if hasattr(p, "destroy"):
        p.destroy()
    return c.get_block().content_hash()


def make_libsvm(path: str, mb: int, seed: int = 0,
                nnz_range=(8, 18), index_space: int = 123,
                real_values: bool = False) -> int:
    """Defaults are a1a-shaped: ±1 labels, sparse binary features, small
    index space (a1a has 123 features; values 1). Pass a wide index
    space + real_values for criteo-shaped data. Copied from the
    reference, so one seed writes the same bytes in both packages."""
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) * 3 // 4:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(4000):
        nnz = rng.randint(*nnz_range)
        idx = np.sort(rng.choice(index_space, nnz, replace=False))
        if real_values:
            vals = rng.rand(nnz)
            feats = " ".join(f"{j}:{v:.6f}" for j, v in zip(idx, vals))
            lab = i % 2
        else:
            feats = " ".join(f"{j}:1" for j in idx)
            lab = (-1) ** i
        rows.append(f"{lab} {feats}")
    block = ("\n".join(rows) + "\n").encode()
    with open(path, "wb") as f:
        for _ in range(max(1, (mb << 20) // len(block))):
            f.write(block)
    return os.path.getsize(path)


def make_csv(path: str, mb: int, seed: int = 0,
             zero_frac: float = 0.0) -> int:
    """HIGGS-shaped: label + 28 float columns. zero_frac > 0 plants
    exact-zero cells (the sparse-mode corpus; BASELINE config 2 is
    "dense + sparse")."""
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) * 3 // 4:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(2000):
        vals = rng.rand(28)
        if zero_frac:
            vals[rng.rand(28) < zero_frac] = 0.0
        rows.append(f"{i % 2}," + ",".join(f"{v:.6f}" for v in vals))
    block = ("\n".join(rows) + "\n").encode()
    with open(path, "wb") as f:
        for _ in range(max(1, (mb << 20) // len(block))):
            f.write(block)
    return os.path.getsize(path)


def make_recordio(prefix: str, mb: int, nparts: int = 4,
                  seed: int = 0) -> List[str]:
    """ImageNet-.rec-shaped: multi-part files of ~100KB binary records."""
    from dmlc_tpu_torch.io.recordio import RecordIOWriter
    from dmlc_tpu_torch.io.stream import create_stream
    paths = [f"{prefix}.part{k}.rec" for k in range(nparts)]
    per_part = (mb << 20) // nparts
    rng = np.random.RandomState(seed)
    for p in paths:
        if os.path.exists(p) and os.path.getsize(p) >= per_part * 3 // 4:
            continue
        with create_stream(p, "w") as s:
            w = RecordIOWriter(s)
            written = 0
            while written < per_part:
                rec = rng.bytes(rng.randint(60_000, 140_000))
                w.write_record(rec)
                written += len(rec) + 8
    return paths


def make_dense_recordio(path: str, mb: int, seed: int = 0,
                        n_range=(24, 48)) -> int:
    """Dense .rec corpus for config 14: RecordIO-framed dense records
    (the frozen ABI-6 payload ``u32 n | f32 label | f32[n] values``)
    with a sprinkle of values whose f32 bits equal the frame magic, so
    the escaped multi-frame decode path runs inside the measured
    epoch (not just in unit tests)."""
    import struct

    from dmlc_tpu_torch.io.recordio import (DenseRecordWriter, RECORDIO_MAGIC)
    from dmlc_tpu_torch.io.stream import create_stream
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) * 3 // 4:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    magic_f32 = np.frombuffer(struct.pack("<I", RECORDIO_MAGIC),
                              "<f4")[0]
    with create_stream(path, "w") as s:
        w = DenseRecordWriter(s)
        written = 0
        i = 0
        while written < (mb << 20):
            n = int(rng.randint(*n_range))
            vals = rng.rand(n).astype(np.float32)
            if i % 251 == 0:
                vals[n // 2] = magic_f32
            w.write(float(i % 7) - 3.0, vals)
            written += 16 + 4 * n
            i += 1
    return os.path.getsize(path)


def make_indexed_recordio(path: str, mb: int, seed: int = 0) -> int:
    """ImageNet-.rec-shaped single file + .idx (key\\toffset) index."""
    from dmlc_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_tpu_torch.io.stream import create_stream
    if (os.path.exists(path) and os.path.exists(path + ".idx")
            and os.path.getsize(path) >= (mb << 20) * 3 // 4):
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    with create_stream(path, "w") as s, \
            create_stream(path + ".idx", "w") as ix:
        w = IndexedRecordIOWriter(s, ix)
        written = 0
        while written < (mb << 20):
            rec = rng.bytes(rng.randint(60_000, 140_000))
            w.write_record(rec)
            written += len(rec) + 8
    return os.path.getsize(path)


def make_parquet(path: str, mb: int, seed: int = 0) -> int:
    """Config-5 corpus: label + 28 float32 columns in 16 row groups,
    written by pyarrow (snappy pages, pyarrow's default)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) // 4:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    nrows = (mb << 20) // 120  # ~30 float32 cols
    cols = {"label": pa.array(rng.randint(0, 2, nrows).astype(np.float32))}
    for c in range(28):
        cols[f"f{c}"] = pa.array(rng.rand(nrows).astype(np.float32))
    pq.write_table(pa.table(cols), path, row_group_size=max(1, nrows // 16))
    return os.path.getsize(path)


def make_parquet_decode_bound(path: str, mb: int, seed: int = 0) -> int:
    """Config-17 corpus — the BASELINE config-5 DECODE-bound shape:
    null-bearing float32 feature columns (real tabular data carries
    nulls, and nulls knock the pyarrow golden off its zero-copy fast
    path onto per-column to_numpy + np.stack) in moderate row groups,
    UNCOMPRESSED V1 PLAIN pages so the measured wall is pure DECODE on
    both contenders, never zlib."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) // 2:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    ncol = 20
    nrows = (mb << 20) // (ncol * 4 + 8)
    cols = {"label": pa.array(rng.rand(nrows).astype(np.float32))}
    for c in range(ncol):
        vals = rng.rand(nrows).astype(np.float64)
        mask = rng.rand(nrows) < 0.10
        arr = pa.array(vals, type=pa.float32(),
                       mask=mask)  # 10% nulls, f32 storage
        cols[f"f{c}"] = arr
    pq.write_table(pa.table(cols), path, row_group_size=4000,
                   compression="NONE", use_dictionary=False)
    return os.path.getsize(path)


def make_image_recordio(path: str, mb: int, seed: int = 0,
                        shape=(32, 32, 3)) -> int:
    """Config-18 corpus — the MXNet-style ImageNet ``.rec`` scenario
    (BASELINE config 3) with DECODABLE payloads: uniform-shape raw HWC
    u8 images (frozen ABI-8 payload contract), a sprinkle of pixel
    runs spelling the frame magic so the escaped multi-frame decode
    path runs inside the measured epoch."""
    import struct

    from dmlc_tpu_torch.io.recordio import RECORDIO_MAGIC, ImageRecordWriter
    from dmlc_tpu_torch.io.stream import create_stream
    if os.path.exists(path) and os.path.getsize(path) >= (mb << 20) * 3 // 4:
        return os.path.getsize(path)
    rng = np.random.RandomState(seed)
    magic = np.frombuffer(struct.pack("<I", RECORDIO_MAGIC), np.uint8)
    per_rec = 16 + int(np.prod(shape))
    with create_stream(path, "w") as s:
        w = ImageRecordWriter(s)
        written = 0
        i = 0
        while written < (mb << 20):
            px = rng.randint(0, 256, shape).astype(np.uint8)
            if i % 101 == 0:
                px.reshape(-1)[8:12] = magic  # 4-aligned in the payload
            w.write(float(i % 1000), px)
            written += per_rec + 8
            i += 1
    return os.path.getsize(path)


def _criteo(prefix: str, mb: int) -> str:
    """The criteo-shaped corpus of every config (written once)."""
    path = f"{prefix}.criteo.libsvm"
    make_libsvm(path, mb, seed=7, nnz_range=(25, 45), index_space=10 ** 6,
                real_values=True)
    return path


def _put(arrays: Dict[str, np.ndarray], device: torch.device):
    """Enqueue the copy of ``arrays`` to ``device``: on the card each
    array is copied into pinned memory and sent by a non-blocking copy,
    with one event behind the copies. Returns (tensors, event)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in arrays.items()}, None
    out = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
           for k, v in arrays.items()}
    event = torch.cuda.Event()
    event.record()
    return out, event


def _done(put) -> None:
    if put[1] is not None:
        put[1].synchronize()


def format_stages(s: Dict[str, int], size: int) -> Optional[str]:
    """One-line per-stage breakdown from an engine stats dict."""
    parse_key = "parse_busy_ns" if "parse_busy_ns" in s else "decode_busy_ns"
    cpu_key = "parse_cpu_ns" if "parse_busy_ns" in s else "decode_cpu_ns"
    rd, pb, wall = s["reader_busy_ns"], s[parse_key], s["wall_ns"]
    if not (rd and pb and wall):
        return None
    stage = parse_key.split("_")[0]
    pc = s.get(cpu_key, 0)
    # the cpu rate is the honest per-core kernel speed: wall-based busy
    # inflates whenever workers are preempted (1-core hosts)
    cpu_part = (f" {stage}-cpu={pc / 1e9:.2f}s ({size / pc:.2f} GB/s/core)"
                if pc else "")
    extra = ""
    if "max_chunk_queue_depth" in s:
        extra = (f" depth(chunkq={s['max_chunk_queue_depth']}, "
                 f"reorder={s['max_reorder_depth']})")
    return (f"stages: read={rd / 1e9:.2f}s ({size / rd:.2f} GB/s) "
            f"{stage}={pb / 1e9:.2f}s ({size / pb:.2f} GB/s summed)"
            f"{cpu_part} wall={wall / 1e9:.2f}s chunks={s['chunks']}"
            f"{extra}")


def _stage_line(parser_or_reader, size: int) -> Optional[str]:
    stats = getattr(parser_or_reader, "stats", None)
    if stats is None:
        return None
    return format_stages(stats(), size)


PREFETCH_IN_FLIGHT = 4  # device copies in flight a part (config 4)


def bench_prefetch(mb: int, device=None,
                   work: Optional[str] = None) -> Dict:
    """Multi-host shape: every part parsed with the prefetch pipeline
    (one process enumerates all part_index values). Parts run on
    CONCURRENT threads — the engine's calls release the GIL, so a
    multi-core host overlaps the per-part pipelines the way real hosts
    would. Each part copies each block's offset, index and value to
    ``device`` (``cuda`` unless the caller asks; the reference's
    ``--device`` run) through its own pinned HostStaging pool and copy
    stream, at most ``PREFETCH_IN_FLIGHT`` copies in flight: a block's
    arrays are copied into a slot before the parser's next call, so no
    copy reads an arena the parser reuses."""
    from concurrent.futures import ThreadPoolExecutor

    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.parallel.device_iter import (
        HostStaging, copy_to_device,
    )

    path = _criteo(_prefix(work), mb)
    size = os.path.getsize(path)
    nhosts = 4
    dev = torch.device("cuda" if device is None else device)
    on_cuda = dev.type == "cuda"

    # split cores between concurrent parts; a 1-core host degenerates to
    # serial parts (threading 8 pipelines onto 1 core only adds churn)
    ncores = os.cpu_count() or 1
    part_workers = min(nhosts, max(1, ncores // 2))
    nthreads = max(1, ncores // part_workers)

    def run_part(k: int) -> int:
        rows = 0
        in_flight: List = []
        pool = HostStaging(PREFETCH_IN_FLIGHT + 1, pin=on_cuda,
                           alias_unsafe=not on_cuda)
        stream = torch.cuda.Stream(dev) if on_cuda else None
        p = Parser.create(path, k, nhosts, format="libsvm",
                          chunk_size=32 << 20, nthreads=nthreads)
        try:
            while p.next():
                b = p.value()
                rows += b.size
                slot = pool.stage({"offset": b.offset, "index": b.index,
                                   "value": b.value})
                out = copy_to_device(slot, dev, stream)
                pool.release(slot, out.event)
                in_flight.append(out)
                if len(in_flight) > PREFETCH_IN_FLIGHT:
                    _landed(in_flight.pop(0))
            for out in in_flight:
                _landed(out)
        finally:
            if hasattr(p, "destroy"):
                p.destroy()
        return rows

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=part_workers) as pool_:
        results = list(pool_.map(run_part, range(nhosts)))
    dt = time.perf_counter() - t0
    return {"config": "prefetch_criteo_multihost",
            "gbps": size / dt / 1e9, "bytes": size, "rows": sum(results),
            "hosts": nhosts, "to_device": True,
            "hash": _content_hash(path, "libsvm")}


def _landed(batch) -> None:
    if batch.event is not None:
        batch.event.synchronize()


def bench_multiprocess_ingest(mb: int, device=None,
                              work: Optional[str] = None,
                              backend: str = "gloo") -> Dict:
    """REAL 2-process collective ingest throughput: a ``launch_local``
    gang streams its parts through ShardedRowBlockIter for 3 epochs
    (``bench_mp_worker.py``), each rank a ``Mesh`` of 2 parts on
    ``device`` (``cuda`` unless the caller asks), as each of the
    reference's workers holds 2 host devices. Epoch 1 carries the
    one-time round-count agreement (one all-gather); epochs 2+ run with
    no collective, so their cadence is the steady-state number.

    The gang's group is gloo by default: NCCL needs a card a rank and
    refuses two ranks on one card, so ``backend="nccl"`` raises unless
    the host has a card for each rank (each rank then takes card
    ``rank``)."""
    from dmlc_tpu_torch.parallel.launch import launch_local
    from dmlc_tpu_torch.utils.logging import DMLCError

    procs = 2
    dev = torch.device("cuda" if device is None else device)
    if backend not in ("gloo", "nccl"):
        raise DMLCError(f"config 7: backend must be gloo or nccl, got "
                        f"{backend!r}")
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < procs):
        raise DMLCError(
            f"config 7 over NCCL needs a card a rank: {procs} ranks, "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "card(s); NCCL refuses two ranks on one card (run it over "
            "gloo)")
    path = _criteo(_prefix(work), mb)
    size = os.path.getsize(path)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench_mp_worker.py")
    out_dir = tempfile.mkdtemp(prefix="dmlc_torch_bench_mp_", dir=work)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}  # empty entries would inject cwd
    try:
        launch_local(procs, [sys.executable, worker, path, out_dir,
                             str(dev), backend], env=env, timeout=900)
        results = []
        for rank in range(procs):
            with open(os.path.join(out_dir, f"bench-mp-{rank}.json")) as f:
                results.append(json.load(f))
    finally:
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
    assert results[0]["batches"] == results[1]["batches"]
    walls = np.array([r["epoch_walls"] for r in results])
    # the gang finishes an epoch together: the slower rank's wall is the
    # epoch's wall
    epoch_walls = walls.max(axis=0)
    steady = float(np.min(epoch_walls[1:]))
    first = float(epoch_walls[0])
    return {"config": "multiprocess_ingest", "procs": procs,
            "gbps": size / steady / 1e9, "bytes": size,
            "batches_per_epoch": results[0]["batches"],
            "first_epoch_gbps": round(size / first / 1e9, 4),
            "steady_over_first": round(first / steady, 2),
            "replay_epochs": results[0].get("replay_epochs", 0),
            "replay_tier": results[0].get("replay_tier")}


def bench_page_replay(mb: int, rows_per_page: int = 8 << 10,
                      gauge_fn=None, device=None,
                      work: Optional[str] = None) -> Dict:
    """Binary page replay → device memory, parse skipped.

    The reference's own larger-than-RAM answer to "parse is expensive"
    (src/data/disk_row_iter.h): parse once, spill versioned binary
    pages, replay pages on every later epoch. Build pass (untimed):
    text → DiskRowIter page cache. Timed region: page reads → copies of
    the CSR arrays from pinned memory to ``device`` (``cuda`` unless the
    caller asks), 4 pages in flight. Parity: the replayed stream
    concatenates to the SAME content hash as a direct parse of the text
    (checked untimed).

    Reports gbps over PAGE bytes (the IO this path performs) and
    text_equiv_gbps over the text bytes the replay stands in for. Three
    replay passes are timed; ``gauge_fn`` (e.g.
    ``bench_transfer.memcpy_gauge``) tags each with a gauge read just
    before it (``epoch_gauges``, None without one)."""
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.row_iter import DiskRowIter
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer

    dev = torch.device("cuda" if device is None else device)
    tmp = _prefix(work)
    path = _criteo(tmp, mb)
    size = os.path.getsize(path)
    # page size is baked into the cache at build time: key the filename
    # by it so a run with a different rows_per_page never silently
    # reuses pages of another size
    cache = f"{tmp}.pagerep.rp{rows_per_page}.pages"
    if os.path.exists(cache) and \
            os.path.getmtime(cache) < os.path.getmtime(path):
        os.remove(cache)  # text regenerated: the page cache is stale
    t_build0 = time.perf_counter()
    it = DiskRowIter(lambda: Parser.create(path, 0, 1, format="libsvm"),
                     cache, rows_per_page=rows_per_page)
    build_s = time.perf_counter() - t_build0
    page_bytes = os.path.getsize(cache)

    def replay_epoch() -> float:
        it.before_first()
        in_flight: List = []
        t0 = time.perf_counter()
        while it.next():
            b = it.value()
            arrays = {"offset": b.offset, "label": b.label,
                      "index": b.index}
            if b.value is not None:
                arrays["value"] = b.value
            in_flight.append(_put(arrays, dev))
            if len(in_flight) > 4:
                _done(in_flight.pop(0))
        for put in in_flight:
            _done(put)
        return time.perf_counter() - t0

    gauges = []
    walls = []
    for _ in range(3):
        if gauge_fn is not None:
            gauges.append(round(float(gauge_fn()), 2))
        walls.append(replay_epoch())
    best = min(walls)
    # parity: replayed pages == direct parse, byte-identical CSR
    c = RowBlockContainer(np.uint32)
    it.before_first()
    while it.next():
        c.push_block(it.value())
    replay_hash = c.get_block().content_hash()
    parse_hash = _content_hash(path, "libsvm")
    assert replay_hash == parse_hash, \
        f"page replay diverged from parse: {replay_hash} != {parse_hash}"
    return {"config": "page_replay_to_hbm", "gbps": page_bytes / best / 1e9,
            "bytes": page_bytes, "text_bytes": size,
            "text_equiv_gbps": round(size / best / 1e9, 4),
            "build_s": round(build_s, 3),
            "epoch_walls": [round(w, 3) for w in walls],
            # rates from the UNROUNDED walls
            "epoch_rates_text_gbps": [round(size / w / 1e9, 4)
                                      for w in walls],
            "epoch_gauges": gauges or None,
            "platform": _platform(dev),
            "hash": replay_hash}


def bench_spill_replay(mb: int, gauge_fn=None, replay_epochs: int = 5,
                       row_bucket: int = 1 << 14,
                       nnz_bucket: int = 1 << 19, device=None,
                       work: Optional[str] = None) -> Dict:
    """Page-SPILL steady replay — the larger-than-RAM training shape: a
    ShardedRowBlockIter on a one-part ``Mesh`` on ``device`` (``cuda``
    unless the caller asks) whose ``agreement_cache_bytes`` sits far
    below the shard's round bytes, so the replay tee spills the epoch's
    rounds to a binary page file and every steady epoch serves pages
    instead of re-parsing text. Epoch 1 is the parse epoch, epoch 2
    re-parses + spills (the tee), epochs 3+ are page-replay epochs
    reported as best AND sustained (>= 3 epochs). speedup_vs_parse is
    the best replay epoch over the parse epoch. ``gauge_fn`` (e.g.
    ``bench_transfer.memcpy_gauge``) tags the parse epoch and each
    replay epoch with a gauge read just before it (None without one).
    The spill file goes under ``work`` when one is given, else under
    the port's page store root."""
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

    dev = torch.device("cuda" if device is None else device)
    path = _criteo(_prefix(work), mb)
    size = os.path.getsize(path)
    mesh = Mesh((1,), ("data",), device=dev)
    it = ShardedRowBlockIter(path, mesh, format="libsvm",
                             row_bucket=row_bucket, nnz_bucket=nnz_bucket,
                             agreement_cache_bytes=1 << 20,  # << shard
                             first_epoch_cache="never",
                             spill_dir=(os.path.join(work, "spill")
                                        if work else None))

    def epoch() -> float:
        t0 = time.perf_counter()
        for _batch in it:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    parse_gauge = (round(float(gauge_fn()), 2)
                   if gauge_fn is not None else None)
    parse_wall = epoch()          # parse epoch 1 (no tee: "never")
    spill_wall = epoch()          # re-parse + spill write (the tee)
    assert it.replay_tier == "parse", it.replay_tier
    gauges = []
    replay_walls = []
    for _ in range(max(3, replay_epochs)):
        if gauge_fn is not None:
            gauges.append(round(float(gauge_fn()), 2))
        replay_walls.append(epoch())
    assert it.replay_tier == "pages", it.replay_tier
    assert it.page_replay_epochs >= 3, it.page_replay_epochs
    spill_file = it._round_store.file
    page_bytes = os.path.getsize(spill_file.path)
    it.close()
    rates = sorted(size / w / 1e9 for w in replay_walls)
    best = rates[-1]
    k = len(rates) // 5
    sustained = sum(rates[k:len(rates) - k]) / len(rates[k:len(rates) - k])
    parse_gbps = size / parse_wall / 1e9
    return {"config": "page_spill_steady_replay", "mode": "pages",
            "gbps": best,                        # text-equivalent
            "replay_sustained_gbps": round(sustained, 4),
            "bytes": size, "page_bytes": page_bytes,
            "parse_epoch_gbps": round(parse_gbps, 4),
            "parse_epoch_gauge": parse_gauge,
            "spill_epoch_gbps": round(size / spill_wall / 1e9, 4),
            "replay_epoch_walls": [round(w, 3) for w in replay_walls],
            "epoch_gauges": gauges or None,
            "speedup_vs_parse": round(best / parse_gbps, 2),
            "rounds": spill_file.rounds,
            "platform": _platform(dev)}


def bench_remote_hydrate(mb: int, work: Optional[str] = None) -> Dict:
    """Remote object-store hydration (config 11): the criteo-shaped
    corpus uploaded to the on-disk emulator behind a modeled wire (2 ms
    a request, 4 GB/s), then a COLD epoch over the ``obj://`` URI —
    every block arrives via coalesced ranged GETs and hydrates into the
    page store — against three WARM epochs that replay the hydrated
    pages with ZERO emulator GETs (the counters prove it; under an
    armed ``--chaos`` plan the retry seams keep the run byte-identical
    and the GET count merely grows), and the codec variant (level 6:
    ranges travel as codec frames, fewer wire bytes, a wire-free second
    epoch). Every epoch's sha256 must equal the local file's.
    hydrate_gbps is wire-bound by construction; gbps (warm page replay)
    is what steady training over object storage sees. The reference's
    JSON keys."""
    import hashlib

    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu_torch.io.input_split import InputSplit
    from dmlc_tpu_torch.io.objstore import fs as _objfs
    from dmlc_tpu_torch.io.pagestore import PageStore
    from dmlc_tpu_torch.obs.metrics import REGISTRY

    tmp = _prefix(work)
    path = _criteo(tmp, mb)
    size = os.path.getsize(path)
    uri = "obj://bench/criteo/train.libsvm"
    em = objstore.configure(root=f"{tmp}.objroot", latency_s=0.002,
                            bandwidth_gbps=4.0)
    try:
        em.put_file("bench", "criteo/train.libsvm", path)
        store = PageStore.default()

        def drop_hydrated():
            # a genuinely cold epoch: drop any hydrated generation a
            # previous run left behind
            for name in os.listdir(store.root) \
                    if os.path.isdir(store.root) else []:
                if name.startswith("obj-"):
                    store.delete(name)

        def epoch():
            h = hashlib.sha256()
            n = 0
            split = InputSplit.create(uri, 0, 1)
            t0 = time.perf_counter()
            while (chunk := split.next_chunk()) is not None:
                h.update(chunk)
                n += len(chunk)
            return time.perf_counter() - t0, h.hexdigest(), n

        drop_hydrated()
        em.reset_counters()
        cold_wall, cold_hash, _ = epoch()
        cold = em.counters()
        with open(path, "rb") as f:
            local_hash = hashlib.sha256(f.read()).hexdigest()
        check(cold_hash == local_hash,
              "remote epoch diverged from the local bytes")
        walls = []
        hit0 = REGISTRY.counter("pagestore.hit").value
        miss0 = REGISTRY.counter("pagestore.miss").value
        em.reset_counters()
        for _ in range(3):
            w, h, _ = epoch()
            check(h == local_hash, "warm remote epoch diverged")
            walls.append(w)
        warm = em.counters()
        hits = REGISTRY.counter("pagestore.hit").value - hit0
        misses = REGISTRY.counter("pagestore.miss").value - miss0
        best = min(walls)

        # the codec variant: the SAME cold epoch with the page codec on
        # — ranges travel as codec frames (decoded under the
        # io.objstore.get retry seam), hydrated blocks land encoded
        prev_level = objstore.options().get("codec_level")
        objstore.configure(codec_level=6)
        try:
            drop_hydrated()
            em.reset_counters()
            czw, czh, _ = epoch()
            ccold = em.counters()
            check(czh == local_hash,
                  "compressed remote epoch diverged from the local bytes")
            em.reset_counters()
            czw2, czh2, _ = epoch()
            cwarm = em.counters()
            check(czh2 == local_hash, "compressed warm epoch diverged")
        finally:
            # configure() treats None as "keep": restore the option
            # directly, so no later config reads compressed
            _objfs._options["codec_level"] = prev_level
        compressed = {
            "hydrate_gbps": round(size / czw / 1e9, 4),
            "cold_gets": ccold["gets"],
            "cold_wire_bytes": ccold["get_bytes"],
            "wire_ratio": round(
                cold["get_bytes"] / max(ccold["get_bytes"], 1), 2),
            "warm_gets": cwarm["gets"],
            "warm_wall_s": round(czw2, 3),
        }
        check(ccold["get_bytes"] < cold["get_bytes"],
              "codec moved no fewer wire bytes")
        check(cwarm["gets"] == 0,
              f"compressed warm epoch hit the wire: {cwarm['gets']} GETs")
        check(warm["gets"] == 0,
              f"warm epochs hit the wire: {warm['gets']} GETs")
        return {"config": "remote_hydrate", "gbps": size / best / 1e9,
                "bytes": size,
                "hydrate_gbps": round(size / cold_wall / 1e9, 4),
                "cold_gets": cold["gets"],
                "cold_get_bytes": cold["get_bytes"],
                "warm_gets": warm["gets"],
                "pagestore_hit_rate": round(
                    hits / max(hits + misses, 1), 4),
                "replay_epoch_walls": [round(w, 3) for w in walls],
                "wire": {"latency_s": em.latency_s,
                         "bandwidth_gbps": em.bandwidth_gbps},
                "compressed": compressed,
                "hash": cold_hash}
    finally:
        objstore.configure(None)


def bench_recordio(mb: int, work: Optional[str] = None) -> Dict:
    """Config 3: the RecordIO split over 4 parts of an ImageNet-.rec-
    shaped corpus, through the native record reader when the engine is
    built (else the Python split). Each chunk's records are kept (the
    native leases held) so the coverage hash, sha256 over every record's
    sha256, is computed outside the timed region."""
    import hashlib

    paths = make_recordio(f"{_prefix(work)}.imagenet", mb, nparts=4)
    uri = ";".join(paths)
    size = sum(os.path.getsize(p) for p in paths)
    from dmlc_tpu_torch.native import native_available
    engine = "native" if native_available() else "python"
    t0 = time.perf_counter()
    nrec = 0
    batches: List = []  # (payload bytes-like, spans, lease) per chunk
    readers: List = []
    if engine == "native":
        from dmlc_tpu_torch.native.bindings import NativeRecordIOReader
        for k in range(4):
            r = NativeRecordIOReader(uri, k, 4)
            readers.append(r)  # keep alive: leased views hashed below
            while True:
                batch = r.next_batch()
                if batch is None:
                    break
                data, starts, ends = batch
                nrec += len(starts)
                batches.append((data, (starts, ends), r.detach()))
            line = _stage_line(r, size // 4)
            if line and k == 0:
                _log(f"  part0 {line}")
    else:
        from dmlc_tpu_torch.io.input_split import InputSplit
        for k in range(4):
            for rec in InputSplit.create(uri, k, 4, "recordio"):
                nrec += 1
                batches.append((rec, None, None))
    dt = time.perf_counter() - t0
    digest = hashlib.sha256()
    for data, spans, _lease in batches:
        if spans is None:
            digest.update(hashlib.sha256(data).digest())
        else:
            starts, ends = spans
            view = memoryview(data)
            for i in range(len(starts)):
                digest.update(hashlib.sha256(
                    view[int(starts[i]):int(ends[i])]).digest())
    for _, _, lease in batches:
        if lease is not None:
            lease.release()
    for r in readers:
        r.destroy()
    return {"config": "recordio_imagenet", "gbps": size / dt / 1e9,
            "bytes": size, "records": nrec, "engine": engine,
            "hash": digest.hexdigest()[:16]}


def _decode_contest(path: str, fmt: str, rows: int, nnz_bucket: int,
                    gauge_fn) -> Dict:
    """Configs 14 and 18: ``path`` through ``parse(format=fmt) →
    batch(rows, pad=True, nnz_bucket=...)`` three ways, engine=python
    (the golden), engine=native and engine=native with ``shards=2``, each
    epoch tagged by ``gauge_fn`` (default ``bench_transfer.memcpy_gauge``),
    the two native contenders' 3 epochs interleaved. Every stream's
    padded batches are hashed in an untimed pass and must be
    sha256-identical; the native paths must assemble in the engine and
    leave no lease out after an epoch (``outstanding()``). Returns the
    reference's keys but ``config``, ``bytes`` and its shape keys."""
    import hashlib

    from dmlc_tpu_torch.pipeline import Pipeline

    if gauge_fn is None:
        from dmlc_tpu_torch.bench_transfer import memcpy_gauge
        gauge_fn = memcpy_gauge
    size = os.path.getsize(path)

    def build(engine, shards=None):
        kw = {"shards": shards} if shards else {}
        return (Pipeline.from_uri(path)
                .parse(format=fmt, engine=engine, **kw)
                .batch(rows, pad=True, nnz_bucket=nnz_bucket)
                .build())

    def measure(built, state):
        state.setdefault("gauges", []).append(round(gauge_fn(), 2))
        t0 = time.perf_counter()
        for _ in built:
            pass
        state.setdefault("walls", []).append(time.perf_counter() - t0)
        # leak probe: between epochs NO lease may stay out (the last
        # padded lease releases on the epoch's terminal pull)
        parser = getattr(built._runners[0], "_parser", None)
        if parser is not None and hasattr(parser, "outstanding"):
            state["outstanding"] = int(parser.outstanding())

    def finish(built, state):
        snap = built.stats()
        apath = next((x["assembly_path"] for s in snap["stages"]
                      if (x := s.get("extra") or {}).get("assembly_path")),
                     None)
        h = hashlib.sha256()
        n = 0
        for b in built:
            for k in sorted(b):
                h.update(k.encode())
                h.update(np.ascontiguousarray(b[k]).tobytes())
            n += 1
        built.close()
        return {"gbps": round(size / min(state["walls"]) / 1e9, 4),
                "epoch_walls": [round(w, 3) for w in state["walls"]],
                "epoch_gauges": state["gauges"],
                "assembly_path": apath, "batches": n,
                "outstanding_after_epoch": state.get("outstanding"),
                "hash": h.hexdigest()}

    from dmlc_tpu_torch import native
    py_built, py_state = build("python"), {}
    measure(py_built, py_state)
    py = finish(py_built, py_state)
    out = {"python": py, "gbps": py["gbps"], "hash": py["hash"],
           "epoch_gauges": py["epoch_gauges"]}
    if not native.native_available():
        out.update({"native": None, "sharded": None,
                    "speedup_native_vs_python": None,
                    "speedup_sharded_vs_native": None})
        return out
    contenders = {"native": build("native"),
                  "sharded": build("native", shards=2)}
    states = {k: {} for k in contenders}
    for _ in range(3):
        for k, b in contenders.items():
            measure(b, states[k])
    nat = finish(contenders["native"], states["native"])
    sh = finish(contenders["sharded"], states["sharded"])
    check(nat["assembly_path"] == "native-padded",
          f"native {fmt} decode fell back to {nat['assembly_path']}")
    for name, r in (("native", nat), ("sharded", sh)):
        check(r["hash"] == py["hash"],
              f"{name} {fmt} stream diverged from the python golden")
        check(r["outstanding_after_epoch"] == 0,
              f"{name}: {r['outstanding_after_epoch']} leases leaked")
    out.update({
        "native": nat, "sharded": sh, "gbps": nat["gbps"],
        "epoch_gauges": nat["epoch_gauges"],
        "speedup_native_vs_python": round(nat["gbps"] / py["gbps"], 3),
        "speedup_sharded_vs_native": round(sh["gbps"] / nat["gbps"], 3)})
    return out


def bench_recio_native(mb: int, gauge_fn=None,
                       work: Optional[str] = None) -> Dict:
    """Config 14: the native dense-RecordIO decode (ABI 6) vs the Python
    golden vs the sharded gang on a dense .rec corpus (24-48 values a
    row, a value carrying the frame magic's bits every 251st row, so the
    escaped multi-frame decode runs in the measured epochs), 8192 rows a
    batch (``_decode_contest``)."""
    path = f"{_prefix(work)}.dense.rec"
    make_dense_recordio(path, mb, seed=11)
    rows = 8 << 10
    nnz_bucket = rows * 48
    out = {"config": "recio_native", "bytes": os.path.getsize(path),
           "rows": rows, "nnz_bucket": nnz_bucket}
    out.update(_decode_contest(path, "recordio_dense", rows, nnz_bucket,
                               gauge_fn))
    return out


def bench_image_record(mb: int, gauge_fn=None,
                       work: Optional[str] = None) -> Dict:
    """Config 18: the native image-payload decode (ABI 8), config 3's
    ImageNet-.rec scenario with decodable payloads: uniform 32x32x3 raw
    HWC u8 images (pixel runs spelling the frame magic every 101st
    record), 256 rows a batch, decoded to padded f32 batches
    (``_decode_contest``)."""
    path = f"{_prefix(work)}.images.rec"
    shape = (32, 32, 3)
    make_image_recordio(path, mb, seed=18, shape=shape)
    rows = 256
    nnz_bucket = rows * int(np.prod(shape))
    out = {"config": "image_record", "bytes": os.path.getsize(path),
           "shape": list(shape), "rows": rows}
    out.update(_decode_contest(path, "recordio_image", rows, nnz_bucket,
                               gauge_fn))
    return out


# ------------------------------------------------- the format matrix

def bench_libsvm(mb: int, work: Optional[str] = None) -> Dict:
    """Config 1: LibSVMParser -> RowBlockIter on an a1a-shaped single
    file (the blocks drained into a materialized container, as
    BasicRowIter does)."""
    from dmlc_tpu_torch.data.parser import Parser
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    path = f"{_prefix(work)}.a1a.libsvm"
    size = make_libsvm(path, mb)
    t0 = time.perf_counter()
    p = Parser.create(path, 0, 1, format="libsvm")
    c = RowBlockContainer(np.uint32)
    can_detach = hasattr(p, "detach")
    leases = []
    while p.next():
        # hold the native leases across the drain: push_block then keeps
        # zero-copy views and get_block's single concatenation is the one
        # materializing copy (same copy count as the reference's C++
        # Push(RowBlock) path)
        c.push_block(p.value(), copy=not can_detach)
        if can_detach:
            leases.append(p.detach())
    block = c.get_block()
    for lease in leases:
        lease.release()
    rows, nnz = block.size, block.nnz
    dt = time.perf_counter() - t0
    line = _stage_line(p, size)
    if line:
        _log(f"  {line}")
    if hasattr(p, "destroy"):
        p.destroy()
    return {"config": "libsvm_a1a", "gbps": size / dt / 1e9,
            "bytes": size, "rows": rows, "nnz": nnz,
            "hash": _content_hash(path, "libsvm")}


def bench_csv(mb: int, work: Optional[str] = None) -> Dict:
    """Config 2: CSVParser dense RowBlocks on a HIGGS-shaped file (label
    + 28 columns), then the sparse mode (zero cells dropped at parse) on
    a variant with 30% exact zeros; the dense stream's content hash."""
    from dmlc_tpu_torch.data.parser import Parser
    path = f"{_prefix(work)}.higgs.csv"
    size = make_csv(path, mb)
    t0 = time.perf_counter()
    p = Parser.create(path, 0, 1, format="csv", label_column=0)
    rows = nnz = 0
    while p.next():
        b = p.value()
        rows += b.size
        nnz += b.nnz
    dt = time.perf_counter() - t0
    line = _stage_line(p, size)
    if line:
        _log(f"  {line}")
    if hasattr(p, "destroy"):
        p.destroy()
    spath = f"{_prefix(work)}.higgs_sparse.csv"
    ssize = make_csv(spath, mb, seed=1, zero_frac=0.3)
    t0 = time.perf_counter()
    sp = Parser.create(spath, 0, 1, format="csv", label_column=0,
                       sparse=True)
    srows = snnz = 0
    while sp.next():
        b = sp.value()
        srows += b.size
        snnz += b.nnz
    sdt = time.perf_counter() - t0
    if hasattr(sp, "destroy"):
        sp.destroy()
    return {"config": "csv_higgs", "gbps": size / dt / 1e9,
            "bytes": size, "rows": rows, "nnz": nnz,
            "sparse_gbps": round(ssize / sdt / 1e9, 4),
            "sparse_nnz_frac": round(snnz / max(srows * 28, 1), 3),
            "hash": _content_hash(path, "csv", label_column=0)}


def bench_parquet(mb: int, work: Optional[str] = None) -> Dict:
    """Config 5: Parquet columnar ingest through the pyarrow golden
    (``format="parquet"``). Its corpus is written by pyarrow too, so it
    runs only where pyarrow is installed (not on the card's machine)."""
    from dmlc_tpu_torch.data.parser import Parser
    path = f"{_prefix(work)}.table.parquet"
    size = make_parquet(path, mb)
    t0 = time.perf_counter()
    p = Parser.create(path, 0, 1, format="parquet", label_column="label")
    rows = nnz = 0
    while p.next():
        b = p.value()
        rows += b.size
        nnz += b.nnz
    dt = time.perf_counter() - t0
    if hasattr(p, "destroy"):
        p.destroy()
    return {"config": "parquet_columnar", "gbps": size / dt / 1e9,
            "bytes": size, "rows": rows, "nnz": nnz,
            "hash": _content_hash(path, "parquet", label_column="label")}


def bench_indexed_shuffled(mb: int, work: Optional[str] = None) -> Dict:
    """Config 6: shuffled indexed-RecordIO reads — the ImageNet .rec
    TRAINING access pattern (reference: src/io/indexed_recordio_split.cc):
    seeded per-epoch batch shuffle (seed 11, 64 records a batch),
    index-driven seeks. The native reader vs the Python split, their
    record order and content equal by digest (sha256 over each record's
    sha256, computed outside the timed reads)."""
    import hashlib

    path = f"{_prefix(work)}.imagenet.indexed.rec"
    size = make_indexed_recordio(path, mb)
    from dmlc_tpu_torch.native import native_available

    def py_epoch(seed):
        from dmlc_tpu_torch.io.indexed_recordio_split import (
            IndexedRecordIOSplit)
        sp = IndexedRecordIOSplit(path, 0, 1, shuffle=True, seed=seed,
                                  batch_size=64)
        recs = []
        t0 = time.perf_counter()
        while True:
            rec = sp.next_record()
            if rec is None:
                break
            recs.append(rec)
        dt = time.perf_counter() - t0
        digest = hashlib.sha256()
        for rec in recs:
            digest.update(hashlib.sha256(rec).digest())
        return dt, len(recs), digest.hexdigest()[:16]

    def native_epoch(seed):
        from dmlc_tpu_torch.native.bindings import NativeIndexedRecordIOReader
        r = NativeIndexedRecordIOReader(path, 0, 1, shuffle=True,
                                        seed=seed, batch_size=64)
        digest = hashlib.sha256()
        nrec = 0
        t0 = time.perf_counter()
        batches = []
        while True:
            batch = r.next_batch()
            if batch is None:
                break
            data, starts, ends = batch
            nrec += len(starts)
            batches.append((data, starts, ends, r.detach()))
        dt = time.perf_counter() - t0
        for data, starts, ends, lease in batches:
            view = memoryview(data)
            for i in range(len(starts)):
                digest.update(hashlib.sha256(
                    view[int(starts[i]):int(ends[i])]).digest())
            if lease is not None:
                lease.release()
        r.destroy()
        return dt, nrec, digest.hexdigest()[:16]

    py_dt, py_n, py_h = py_epoch(11)
    if not native_available():
        return {"config": "indexed_recordio_shuffled", "engine": "python",
                "gbps": size / py_dt / 1e9, "bytes": size,
                "records": py_n, "hash": py_h}
    nat_dt, nat_n, nat_h = native_epoch(11)
    check((py_n, py_h) == (nat_n, nat_h),
          f"order/content mismatch: py={py_n}/{py_h} native={nat_n}/{nat_h}")
    return {"config": "indexed_recordio_shuffled", "engine": "native",
            "gbps": size / nat_dt / 1e9, "bytes": size, "records": nat_n,
            "python_gbps": round(size / py_dt / 1e9, 4),
            "speedup_vs_python": round(py_dt / nat_dt, 2),
            "hash": nat_h}


# Config 17's acceptance: the native page decode at least this many times
# the pyarrow golden's GB/s on its decode-bound corpus.
PARQUET_NATIVE_MIN_SPEEDUP = 3.0


def bench_parquet_native(mb: int, gauge_fn=None,
                         work: Optional[str] = None) -> Dict:
    """Config 17: native Parquet PAGE decode vs the pyarrow golden on a
    decode-bound corpus (null-bearing f32 columns, UNCOMPRESSED V1 PLAIN
    pages — see make_parquet_decode_bound) through
    ``format="parquet_native"`` four ways — engine=python (the pyarrow
    golden), engine=native, and native with shards=2 and shards=4
    (row-group-aligned byte ranges) — every contender's 3 epochs
    INTERLEAVED, each tagged by ``gauge_fn`` (default
    ``bench_transfer.memcpy_gauge``). Checks that all four streams are
    sha256-identical, ``outstanding()`` == 0 after the native epochs,
    and native >= PARQUET_NATIVE_MIN_SPEEDUP x the golden. The corpus is
    written by
    pyarrow, so it runs only where pyarrow is installed (not on the card's
    machine)."""
    import hashlib

    from dmlc_tpu_torch.data.parser import Parser

    if gauge_fn is None:
        from dmlc_tpu_torch.bench_transfer import memcpy_gauge
        gauge_fn = memcpy_gauge
    path = f"{_prefix(work)}.decode.parquet"
    size = make_parquet_decode_bound(path, mb, seed=17)

    def build(engine, shards=None):
        kw = {"shards": shards} if shards else {}
        return Parser.create(path, 0, 1, format="parquet_native",
                             engine=engine, label_column="label", **kw)

    def measure(parser, state):
        state.setdefault("gauges", []).append(round(gauge_fn(), 2))
        t0 = time.perf_counter()
        parser.before_first()
        rows = 0
        while parser.next():
            rows += parser.value().size
        state.setdefault("walls", []).append(time.perf_counter() - t0)
        state["rows"] = rows
        if hasattr(parser, "outstanding"):
            state["outstanding"] = int(parser.outstanding())

    def stream_hash(parser):
        h = hashlib.sha256()
        parser.before_first()
        while parser.next():
            b = parser.value()
            h.update(np.diff(np.asarray(b.offset))
                     .astype("<i8").tobytes())
            h.update(np.ascontiguousarray(b.label).tobytes())
            h.update(np.ascontiguousarray(b.index)
                     .astype("<u4").tobytes())
            h.update(np.ascontiguousarray(b.value).tobytes())
        return h.hexdigest()

    def finish(parser, state):
        out = {"gbps": round(size / min(state["walls"]) / 1e9, 4),
               "epoch_walls": [round(w, 3) for w in state["walls"]],
               "epoch_gauges": state["gauges"],
               "rows": state["rows"],
               "outstanding_after_epoch": state.get("outstanding"),
               "hash": stream_hash(parser)}
        if hasattr(parser, "destroy"):
            parser.destroy()
        return out

    from dmlc_tpu_torch.native import native_available
    have_native = native_available()
    contenders = {"python": build("python")}
    if have_native:
        contenders.update({"native": build("native"),
                           "sharded2": build("native", shards=2),
                           "sharded4": build("native", shards=4)})
    states: Dict[str, Dict] = {k: {} for k in contenders}
    for _ in range(3):  # interleaved: one credit climate for all
        for k, p in contenders.items():
            measure(p, states[k])
    results = {k: finish(p, states[k]) for k, p in contenders.items()}
    py = results["python"]
    out = {"config": "parquet_native", "bytes": size,
           "decode_path_golden": "pyarrow",
           "python": py, "gbps": py["gbps"], "hash": py["hash"],
           "epoch_gauges": py["epoch_gauges"]}
    if not have_native:
        out.update({"native": None, "sharded2": None, "sharded4": None,
                    "speedup_native_vs_pyarrow": None})
        return out
    nat = results["native"]
    for name in ("native", "sharded2", "sharded4"):
        r = results[name]
        check(r["hash"] == py["hash"],
              f"{name} parquet stream diverged from the pyarrow golden")
        check(r["outstanding_after_epoch"] == 0,
              f"{name}: {r['outstanding_after_epoch']} leases leaked")
    speedup = nat["gbps"] / py["gbps"]
    check(speedup >= PARQUET_NATIVE_MIN_SPEEDUP,
          f"native page decode {nat['gbps']} GB/s is only "
          f"{speedup:.2f}x the pyarrow golden {py['gbps']} GB/s "
          f"(acceptance: >= {PARQUET_NATIVE_MIN_SPEEDUP}x on the "
          "decode-bound corpus)")
    out.update({
        "native": nat, "sharded2": results["sharded2"],
        "sharded4": results["sharded4"], "gbps": nat["gbps"],
        "epoch_gauges": nat["epoch_gauges"],
        "speedup_native_vs_pyarrow": round(speedup, 3),
        "speedup_sharded2_vs_native": round(
            results["sharded2"]["gbps"] / nat["gbps"], 3),
        "speedup_sharded4_vs_native": round(
            results["sharded4"]["gbps"] / nat["gbps"], 3)})
    return out


CONFIGS = {
    1: ("libsvm", lambda mb: bench_libsvm(mb)),
    2: ("csv", lambda mb: bench_csv(mb)),
    3: ("recordio", lambda mb: bench_recordio(mb)),
    4: ("prefetch", lambda mb: bench_prefetch(mb)),
    5: ("parquet", lambda mb: bench_parquet(mb)),
    6: ("indexed_shuffled", lambda mb: bench_indexed_shuffled(mb)),
    7: ("multiprocess", lambda mb: bench_multiprocess_ingest(mb)),
    8: ("page_replay", lambda mb: bench_page_replay(mb)),
    10: ("spill_replay", lambda mb: bench_spill_replay(mb)),
    11: ("remote_hydrate", lambda mb: bench_remote_hydrate(mb)),
    14: ("recio_native", lambda mb: bench_recio_native(mb)),
    17: ("parquet_native", lambda mb: bench_parquet_native(mb)),
    18: ("image_record", lambda mb: bench_image_record(mb)),
}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", type=int, default=0,
                    help=f"one of {sorted(CONFIGS)} (0 = all)")
    ap.add_argument("--mb", type=int, default=64,
                    help="approx data size per config in MB")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="arm a dmlc_tpu_torch.resilience fault plan "
                         "(DMLC_TPU_FAULTS grammar) for the whole "
                         "run; configs must degrade gracefully, not "
                         "abort")
    args = ap.parse_args(argv)
    from dmlc_tpu_torch.resilience import inject as _inject
    from dmlc_tpu_torch.resilience import retry_counts
    chaos_plan = None
    chaos_injected0 = 0
    chaos_retries0: Dict[str, int] = {}
    if args.chaos:
        chaos_plan = _inject.install(args.chaos)
        _log(f"chaos: fault plan armed: {chaos_plan.spec()} "
             f"(seed {chaos_plan.seed})")
    picks = [args.config] if args.config else sorted(CONFIGS)
    for n in picks:
        name, fn = CONFIGS[n]
        _log(f"— config {n} ({name}), ~{args.mb} MB —")
        try:
            out = fn(args.mb)
            out["gbps"] = round(out["gbps"], 4)
            if chaos_plan is not None:
                # per-config DELTAS: cumulative totals would miscredit
                # one config's faults/retries to every later config
                now = retry_counts()
                out["chaos"] = {
                    "plan": chaos_plan.spec(),
                    "seed": chaos_plan.seed,
                    "injected": chaos_plan.injected - chaos_injected0,
                    "retries": {k: d for k, v in now.items()
                                if (d := v - chaos_retries0.get(k, 0))},
                }
            _emit(out)
        except Exception as e:  # noqa: BLE001 — one config's failure
            # is reported on its line; the suite goes on
            _emit({"config": name, "error": str(e)[:200]})
        finally:
            if chaos_plan is not None:
                # advance the delta baselines on BOTH outcomes: a
                # failed config's faults must not be credited to the
                # next config's accounting
                chaos_injected0 = chaos_plan.injected
                chaos_retries0 = retry_counts()


if __name__ == "__main__":
    main()
