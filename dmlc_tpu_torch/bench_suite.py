"""The page-tier configs of the benchmark suite, on the port.

Counterpart of ``dmlc_tpu/bench_suite.py``, holding only the configs
whose planes are ported; each emits one JSON line with the reference's
keys, ``"platform"`` naming the device the numbers came from (``gpu``
on the card):

  8. page_replay — binary page cache replay → device memory, parse
               skipped (DiskRowIter pages; the repeated-epoch shape)
 10. spill_replay — page-SPILL steady replay: ShardedRowBlockIter
               forced over its agreement_cache_bytes budget, steady
               epochs served from the spilled round pages (the
               larger-than-RAM training shape)

Run: python -m dmlc_tpu_torch.bench_suite [--config N] [--mb MB]

Trimmed from the reference: every other config (4 and 7 wait for the
transfer probe, ROADMAP A8; the rest for planes not ported), the warm-up
pass, ``--trace`` and ``--chaos``. Data files go under
``<tempdir>/dmlc_tpu_torch_bench_suite.*`` unless a config is given a
``work`` directory. Configs 8 and 10 read one corpus file, the
reference's criteo shape from seed 7 (the file its configs 4, 9 and 12
share; it writes the same bytes under two more names for 8 and 10):
``make_libsvm`` draws each row's indices by a permutation of 10^6, so
writing it takes minutes whatever ``mb`` is, and a second copy would
double that.
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

__all__ = ["make_libsvm", "bench_page_replay", "bench_spill_replay",
           "CONFIGS", "main"]


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


def _criteo(prefix: str, mb: int) -> str:
    """The criteo-shaped corpus of configs 8 and 10 (written once)."""
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


def bench_page_replay(mb: int, rows_per_page: int = 8 << 10,
                      device=None, work: Optional[str] = None) -> Dict:
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
    replay passes are timed. ``epoch_gauges`` is None: the reference's
    pre-epoch gauge has no caller in the port yet."""
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

    walls = [replay_epoch() for _ in range(3)]
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
            "epoch_gauges": None,
            "platform": _platform(dev),
            "hash": replay_hash}


def bench_spill_replay(mb: int, replay_epochs: int = 5,
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
    the best replay epoch over the parse epoch. The gauge keys are None:
    the reference's pre-epoch gauge has no caller in the port yet.
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

    parse_wall = epoch()          # parse epoch 1 (no tee: "never")
    spill_wall = epoch()          # re-parse + spill write (the tee)
    assert it.replay_tier == "parse", it.replay_tier
    replay_walls = [epoch() for _ in range(max(3, replay_epochs))]
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
            "parse_epoch_gauge": None,
            "spill_epoch_gbps": round(size / spill_wall / 1e9, 4),
            "replay_epoch_walls": [round(w, 3) for w in replay_walls],
            "epoch_gauges": None,
            "speedup_vs_parse": round(best / parse_gbps, 2),
            "rounds": spill_file.rounds,
            "platform": _platform(dev)}


CONFIGS = {
    8: ("page_replay", lambda mb: bench_page_replay(mb)),
    10: ("spill_replay", lambda mb: bench_spill_replay(mb)),
}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", type=int, default=0,
                    help=f"one of {sorted(CONFIGS)} (0 = all)")
    ap.add_argument("--mb", type=int, default=64,
                    help="approx data size per config in MB")
    args = ap.parse_args(argv)
    picks = [args.config] if args.config else sorted(CONFIGS)
    for n in picks:
        name, fn = CONFIGS[n]
        _log(f"— config {n} ({name}), ~{args.mb} MB —")
        try:
            out = fn(args.mb)
            out["gbps"] = round(out["gbps"], 4)
            _emit(out)
        except Exception as e:  # noqa: BLE001 — one config's failure
            # is reported on its line; the suite goes on
            _emit({"config": name, "error": str(e)[:200]})


if __name__ == "__main__":
    main()
