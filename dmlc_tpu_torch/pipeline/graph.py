"""Declarative dataset-pipeline graph → compiled, probed, tunable runs.

Counterpart of ``dmlc_tpu/pipeline/graph.py``. ``Pipeline`` is the
tf.data-style composition layer over the port's machinery: chaining
builds an immutable stage-spec tuple (``dmlc_tpu_torch.pipeline.stages``),
``build()`` lowers it onto Parser / ThreadedIter / pad_single / the
native engine's padded batch assembly / pinned async H2D. Every stage
boundary carries a :class:`~dmlc_tpu_torch.pipeline.stats.StageProbe`
(wait time, rows/bytes, queue occupancy) and every ``"auto"`` depth
becomes an :class:`~dmlc_tpu_torch.pipeline.autotune.Knob` the
between-epoch :class:`~dmlc_tpu_torch.pipeline.autotune.Autotuner`
adjusts.

    pipe = (Pipeline.from_uri("train.libsvm")
            .parse(format="libsvm", engine="native")
            .batch(8192, pad=True, nnz_bucket=368640)
            .to_device(window="auto"))      # cuda unless device= says
    built = pipe.build(autotune=True)
    for epoch in range(epochs):
        for device_batch in built:          # one epoch
            model.train_step(device_batch)
        print(built.stats())                # per-stage snapshot
    built.close()

Ownership contract (the RowBlock lifetime rules, composed once here so
every stage agrees): a stage yields items valid until the consumer's
next pull. Buffering stages (``prefetch``) take ownership of ephemeral
native-engine blocks by detaching their arena lease (falling back to a
copy); ``to_device`` holds the lease until the block's bytes are staged
or its copy to the card has completed.

``shard(mesh, ...)`` lowers source + parse into
:class:`~dmlc_tpu_torch.parallel.sharded.ShardedRowBlockIter`, which
yields ``[L, ...]`` batches on the mesh's device (its serve thread
stages and copies them); only ``map`` and ``prefetch`` may follow it.
``cache(...)`` after ``parse`` replays later epochs from raw blocks in
RAM or from a :class:`~dmlc_tpu_torch.data.row_iter.DiskRowIter` page
cache under the port's page store.

``shuffle(num_shuffle_parts, seed)`` lowers to an injected
:class:`~dmlc_tpu_torch.io.input_split_shuffle.InputSplitShuffle` under
the python parse engine (the native reader owns its own split), with the
reference's seed law, so its order is the reference's;
``shuffle(global_seed=..., window_bytes=...)`` lowers to the gang-wide
sample-level :class:`~dmlc_tpu_torch.shuffle.split.GlobalShuffleSplit`
under the same engine, so its order is the reference's too.

Observability (``dmlc_tpu_torch.obs``): with a trace recorder active
(``built.trace(path)``) every delivered item is a ``pull/<stage>`` span,
each epoch's terminal wait a ``pull/<stage>.end`` span, the native
engine's span ring and counters join the timeline, and ``to_device``
emits ``to_device.drain`` and ``device.xfer`` spans; the compiled
pipeline's last snapshot is a ``pipeline`` collector of the metrics
registry.

Every pull registers with the stall watchdog (``obs.watchdog``) while it
blocks, with the stage's queue state as its detail, and a raising stage
leaves no wait behind. An installed verdict-driven controller
(``obs.control``) adopts the pipeline's knobs after each complete epoch
in place of its autotuner.

``Pipeline.from_stream(uri, ...)`` roots a chain on an EOF-less
:class:`~dmlc_tpu_torch.io.streaming_split.StreamingSplit` under the
python parse engine, with its watermark in the parse stage's extras;
``build(tenant=...)`` admits the compiled pipeline under a tenant of the
installed :mod:`dmlc_tpu_torch.pipeline.scheduler`, which bills every
delivered batch one pull credit and owns the queue-capacity knobs.
``to_device(sharding=...)`` places every array of a batch under a
:class:`~dmlc_tpu_torch.parallel.placement.NamedSharding` (each a
``PlacedTensor`` on the mesh's device); ``shuffle`` with ``cache`` keeps
the reference's own refusal.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.input_split_shuffle import InputSplitShuffle
from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.obs import watchdog as _watchdog
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.parallel.device_iter import (
    DeviceBatch, copy_to_device, resolve_device, wait_copy,
)
from dmlc_tpu_torch.parallel.placement import NamedSharding, device_put
from dmlc_tpu_torch.pipeline.autotune import Autotuner, Knob
from dmlc_tpu_torch.pipeline.stages import StageSpec, validate_chain
from dmlc_tpu_torch.pipeline.stats import StageProbe, _item_stats, snapshot
from dmlc_tpu_torch.shuffle import DEFAULT_WINDOW_BYTES, GlobalShuffleSplit
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["Pipeline", "CompiledPipeline", "DeviceBatch"]

_END = object()


def _probed(runner) -> Iterator:
    """Pull a runner's epoch through its probe: every boundary crossing
    records wait time, volume, and (when queue-backed) occupancy.

    Observability contract (the reference's): with a trace recorder
    active, every DELIVERED item emits exactly one complete span named
    ``pull/<stage>`` whose duration is the SAME perf_counter pair the
    probe accumulates into ``wait_s`` — so per-stage span totals and
    probe waits agree by construction (the terminal end-of-stream wait
    goes to ``pull/<stage>.end`` to keep the span-count == items
    invariant exact). Each pull also registers with the stall watchdog
    while it blocks."""
    gen = runner.epoch()
    probe = runner.probe
    pull_name = f"pull/{probe.name}"      # loop-invariant: built once,
    end_name = pull_name + ".end"         # not per delivered item
    while True:
        rec = _trace.active()
        token = _watchdog.begin_wait(pull_name, runner.wait_detail)
        t0 = time.perf_counter()
        try:
            item = next(gen, _END)
        finally:
            # a raising stage must not leave a phantom wait registered
            # — the watchdog would later report a stall that never was
            _watchdog.end_wait(token)
        dt = time.perf_counter() - t0
        if item is _END:
            probe.record_wait_only(dt)
            if rec is not None:
                rec.complete(end_name, t0, dt, "pipeline")
            return
        probe.record(item, dt, runner.queue)
        if rec is not None:
            rec.complete(pull_name, t0, dt, "pipeline")
        yield item


class _RunnerBase:
    """One lowered stage: re-enterable epochs + probe + optional knobs."""

    kind = "?"
    owned = True          # items survive past the consumer's next pull
    up: Optional["_RunnerBase"] = None

    def __init__(self, name: str):
        self.probe = StageProbe(name, self.kind)

    @property
    def queue(self):
        """Live bounded queue for occupancy sampling, or None."""
        return None

    def wait_detail(self) -> Dict[str, Any]:
        """Watchdog diagnosis sample for a blocked pull at this stage:
        queue state when queue-backed, plus stage extras (replay tier,
        serve stats) the runner recorded so far."""
        out: Dict[str, Any] = {"kind": self.kind,
                               "items": self.probe.items}
        q = self.queue
        if q is not None:
            try:
                out["qsize"] = q.qsize()
                out["capacity"] = q.capacity
            except Exception:  # noqa: BLE001 — diagnostics only
                pass
        if self.probe.extra:
            out["extra"] = dict(self.probe.extra)
        return out

    def epoch(self) -> Iterator:
        raise NotImplementedError

    def detach_last(self):
        """Take ownership of the last yielded item's arena lease
        (native engine); None when items are already owned."""
        return None

    def knobs(self) -> List[Knob]:
        return []

    def finalize_epoch(self) -> None:
        """Stage-specific snapshot extras (engine stats, drain waits)."""

    def close(self) -> None:
        pass


def _finalize_parser(parser, probe) -> None:
    """Stamp a parser's end-of-epoch telemetry into ``probe``: engine
    stats (+ counter track), the native span-ring drain onto the active
    timeline, and bytes_read. Shared by _ParseRunner and the fused
    _NativeAssembleRunner so both stages report the engine the same
    way."""
    stats_fn = getattr(parser, "stats", None)
    if stats_fn is not None:
        engine = stats_fn()
        probe.extra["engine"] = engine
        # native-engine counters as a trace counter track: the
        # reader/parse busy split rides next to the spans
        _trace.counter("engine", engine, "native")
    rec = _trace.active()
    drain = getattr(parser, "drain_trace", None)
    if rec is not None and drain is not None:
        # the engine's span ring (chunk read/tokenize/assemble events)
        # joins the Python spans on ONE timeline
        drain(rec)
    probe.extra["bytes_read"] = int(parser.bytes_read())


class _ParseRunner(_RunnerBase):
    """source [+ shuffle] + parse → Parser.create (native or python)."""

    kind = "parse"

    def __init__(self, source: StageSpec, shuffle: Optional[StageSpec],
                 parse: StageSpec):
        super().__init__("parse")
        sp = source.params
        p = dict(parse.params)
        fmt = p.pop("format", None)
        depth = p.pop("prefetch_depth", "auto")
        self._auto_depth = depth == "auto"
        kwargs = {k: v for k, v in p.items() if v is not None}
        self._stream_split = None
        stream = sp.get("stream")
        if stream is not None:
            # streaming source (Pipeline.from_stream): an EOF-less
            # windowed split injected under the python engine (the
            # native reader owns its own split, and a growing file has
            # no frozen byte range for it to own)
            from dmlc_tpu_torch.io.streaming_split import StreamingSplit
            kwargs["engine"] = "python"
            split = StreamingSplit(sp["uri"], **stream)
            self._stream_split = split
            kwargs["split_factory"] = lambda: split
        if shuffle is not None:
            # shuffled read order lowers to an injected split under the
            # python engine (the native reader owns its own split):
            # global_seed → the sample-level GlobalShuffleSplit, else
            # the chunk-level InputSplitShuffle
            kwargs["engine"] = "python"
            chunk = kwargs.get("chunk_size", 8 << 20)
            shp = shuffle.params

            if shp.get("global_seed") is not None:
                def factory():
                    wb = shp.get("window_bytes") or DEFAULT_WINDOW_BYTES
                    return GlobalShuffleSplit(
                        sp["uri"], sp["part_index"], sp["num_parts"],
                        sp["split_type"], seed=shp["global_seed"],
                        window_bytes=wb)
            else:
                def factory():
                    return InputSplitShuffle.create(
                        sp["uri"], sp["part_index"], sp["num_parts"],
                        sp["split_type"],
                        num_shuffle_parts=shp["num_shuffle_parts"],
                        seed=shp["seed"], chunk_size=chunk)

            kwargs["split_factory"] = factory
        if sp["split_type"] != "text":
            kwargs["split_type"] = sp["split_type"]
        from dmlc_tpu_torch.data.parser import Parser
        self._parser = Parser.create(
            sp["uri"], sp["part_index"], sp["num_parts"], format=fmt,
            prefetch_depth=4 if self._auto_depth else int(depth), **kwargs)
        self.owned = not hasattr(self._parser, "detach")
        if self._stream_split is not None:
            # formats whose parser ignores split_factory would silently
            # read the frozen file instead of the stream — refuse (the
            # shuffle-injection precedent below)
            if getattr(self._parser, "_split", None) \
                    is not self._stream_split:
                self.close()
                raise DMLCError(
                    f"pipeline: from_stream is not supported by the "
                    f"{fmt or 'default'} parser (it ignores the "
                    "injected split); streaming works with record-"
                    "stream formats (libsvm/csv/libfm)")
        if shuffle is not None:
            # formats whose parser ignores split_factory would silently
            # yield UNshuffled data — refuse instead
            split = getattr(self._parser, "_split", None)
            wants = (shuffle.params.get("global_seed") is not None
                     or shuffle.params["num_shuffle_parts"] > 1)
            if wants and not isinstance(
                    split, (InputSplitShuffle, GlobalShuffleSplit)):
                self.close()
                raise DMLCError(
                    f"pipeline: shuffle is not supported by the "
                    f"{fmt or 'default'} parser (it ignores the "
                    "injected split); shuffle works with record-stream "
                    "formats (libsvm/csv/libfm)")

    @property
    def queue(self):
        return getattr(self._parser, "_prefetch", None)

    def epoch(self) -> Iterator:
        p = self._parser
        p.before_first()
        while p.next():
            yield p.value()

    def detach_last(self):
        detach = getattr(self._parser, "detach", None)
        return detach() if detach is not None else None

    def knobs(self) -> List[Knob]:
        ti = self.queue
        if self._auto_depth and ti is not None:
            return [Knob("parse.chunk_prefetch", "parse",
                         lambda: ti.capacity, ti.set_capacity,
                         lo=1, hi=32)]
        return []

    def finalize_epoch(self) -> None:
        _finalize_parser(self._parser, self.probe)
        if self._stream_split is not None:
            # the monotonic watermark rides the stage extras (and the
            # scheduler's /tenants rows read it live mid-epoch)
            self.probe.extra["stream"] = self._stream_split.watermark()

    def close(self) -> None:
        if self._stream_split is not None:
            self._stream_split.stop()
        if hasattr(self._parser, "destroy"):
            self._parser.destroy()


def _rechunk(up: _RunnerBase, rows: int, drop: bool, cut) -> Iterator:
    """The block stream of ``up`` cut into batches of ``rows`` rows (the
    last one short unless ``drop``), each passed through ``cut``."""
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    pending = None
    for block in _probed(up):
        if pending is None:
            pending = RowBlockContainer(block.index.dtype)
        start = 0
        while start < block.size:
            take = min(block.size - start, rows - pending.size)
            pending.push_block(block.slice(start, start + take))
            start += take
            if pending.size >= rows:
                yield cut(pending)
                pending = RowBlockContainer(block.index.dtype)
    if pending is not None and pending.size and not drop:
        yield cut(pending)


class _BatchRunner(_RunnerBase):
    """Re-chunk the block stream to fixed row counts (owned output)."""

    kind = "batch"

    def __init__(self, up: _RunnerBase, rows: int, drop_remainder: bool):
        super().__init__("batch")
        check(rows >= 1, "batch(rows) needs rows >= 1")
        self.up = up
        self._rows = rows
        self._drop = drop_remainder

    def epoch(self) -> Iterator:
        return _rechunk(self.up, self._rows, self._drop,
                        lambda pending: pending.get_block())


def _pad_params(runner, spec: StageSpec) -> None:
    p = spec.params
    runner._rows = p["rows"]
    runner._drop = p["drop_remainder"]
    runner._row_bucket = p["row_bucket"] or p["rows"]
    runner._nnz_bucket = p["nnz_bucket"]
    runner._want_qid = p["want_qid"]
    runner._want_field = p["want_field"]
    check(runner._rows >= 1, "batch(rows) needs rows >= 1")
    check(runner._row_bucket >= runner._rows,
          "batch(row_bucket) must be >= rows")


class _PadBatchRunner(_RunnerBase):
    """Padded batch assembly, the Python fused golden: re-chunk the
    block stream to ``rows`` rows, then pad each batch to
    (row_bucket, nnz_bucket) device layout in ONE pass
    (data.padding.pad_single). Output dicts own their arrays. This is
    the fallback, and the byte-parity reference, for the native ABI-5
    path (_NativeAssembleRunner)."""

    kind = "assemble"

    def __init__(self, up: _RunnerBase, spec: StageSpec):
        super().__init__("assemble")
        self.up = up
        _pad_params(self, spec)
        self._assemble_s = 0.0

    def epoch(self) -> Iterator:
        from dmlc_tpu_torch.data.padding import pad_single
        self._assemble_s = 0.0

        def cut(pending):
            t0 = time.perf_counter()
            padded = pad_single(pending.get_block(), self._row_bucket,
                                self._nnz_bucket, self._want_qid,
                                self._want_field)
            self._assemble_s += time.perf_counter() - t0
            return padded

        return _rechunk(self.up, self._rows, self._drop, cut)

    def finalize_epoch(self) -> None:
        # which rung assembled the epoch's batches
        self.probe.extra["assembly_path"] = "python-fused"
        self.probe.extra["assemble_s"] = round(self._assemble_s, 6)


class _NativeAssembleRunner(_RunnerBase):
    """source + parse + batch(pad=True) fused onto the native engine's
    ABI-5 batch assembly: ``next_padded`` emits bucket-padded,
    device-layout blocks directly from the parse arena (the pad+stack
    memcpy runs in C with the GIL released). Each yielded PaddedBatch is
    a dict of ZERO-COPY views into a leased padded block, valid until
    the next pull; downstream prefetch/to_device detach the lease."""

    kind = "assemble"
    owned = False  # items are leased engine views

    def __init__(self, parse_runner: _ParseRunner, spec: StageSpec):
        super().__init__("assemble")
        # take over the already-constructed parser; the parse stage folds
        # into this one
        self._parser = parse_runner._parser
        _pad_params(self, spec)

    def epoch(self) -> Iterator:
        p = self._parser
        p.before_first()
        while True:
            batch = p.next_padded(self._rows, self._row_bucket,
                                  self._nnz_bucket, self._want_qid,
                                  self._want_field)
            if batch is None:
                return
            if self._drop and int(batch["num_rows"]) < self._rows:
                continue  # short tail at end of stream
            yield batch

    def detach_last(self):
        return self._parser.detach()

    def finalize_epoch(self) -> None:
        _finalize_parser(self._parser, self.probe)
        self.probe.extra["assembly_path"] = "native-padded"
        # consumer-side pad+stack memcpy time, measured in the engine
        self.probe.extra["assemble_s"] = round(
            self.probe.extra["engine"]["assemble_ns"] / 1e9, 6)

    def close(self) -> None:
        self._parser.destroy()


class _CacheRunner(_RunnerBase):
    """parse + cache → replayed epochs with no re-parse, the tier
    picked by budget (the ShardedRowBlockIter steady-replay story at
    the single-stream level): blocks whose raw bytes fit
    ``memory_budget_bytes`` are retained owned in RAM; larger datasets
    build a DiskRowIter binary page cache (parse once at build, replay
    pages every epoch). An explicit ``path`` forces the page tier; with
    ``path=None`` the page file is derived under the port's page store
    root, fingerprint-keyed so a changed source gets a fresh cache, with
    a sidecar stamp for sweep_stale_spill."""

    kind = "cache"

    def __init__(self, source: StageSpec, shuffle: Optional[StageSpec],
                 parse: StageSpec, cache: StageSpec):
        super().__init__("cache")
        check(shuffle is None,
              "pipeline: shuffle + cache is not lowerable (the page "
              "cache replays one fixed order); shuffle after cache via "
              "a map stage, or drop the cache")
        from dmlc_tpu_torch.data.row_iter import DiskRowIter
        sp = source.params
        self._source_uri = sp["uri"]
        self._source_parts = sp["num_parts"]
        p = {k: v for k, v in parse.params.items() if v is not None}
        p.pop("prefetch_depth", None)
        fmt = p.pop("format", None)
        if sp["split_type"] != "text":
            p["split_type"] = sp["split_type"]

        def make_parser():
            from dmlc_tpu_torch.data.parser import Parser
            return Parser.create(sp["uri"], sp["part_index"],
                                 sp["num_parts"], format=fmt, **p)

        path = cache.params["path"]
        budget = cache.params["memory_budget_bytes"]
        if budget is None:  # not `or`: an explicit 0 must force pages
            budget = 1 << 30
        self._blocks: Optional[List] = None
        self._it = None
        self.tier = "pages"
        fingerprint = self._source_fingerprint(sp)
        if path is None:
            if self._try_memory(make_parser, budget):
                self.tier = "memory"
                return
            path = self._derived_page_path(
                sp, fmt, cache.params["rows_per_page"], fingerprint)
        page_budget = cache.params["page_budget_bytes"]
        if page_budget is not None:
            # the store owning this cache's root gets the byte budget
            # (LRU eviction of cold committed entries down to it)
            from dmlc_tpu_torch.io.pagestore import PageStore
            PageStore.for_path(path)[0].set_budget(page_budget)
        # DiskRowIter stamps the sidecar itself at commit (and a
        # stamped cache whose sources changed is rebuilt, not replayed)
        self._it = DiskRowIter(make_parser, path,
                               rows_per_page=cache.params["rows_per_page"],
                               fingerprint=fingerprint)

    def _try_memory(self, make_parser, budget: int) -> bool:
        """Drain the parser into owned raw blocks within the budget;
        False (with nothing retained) when the dataset is larger — the
        caller then builds the page tier from a fresh parser. A stat
        pre-check skips the doomed drain outright when the source's
        byte share already exceeds the budget (raw CSR is rarely
        smaller than its text)."""
        if not self._memory_precheck_ok(budget):
            return False
        parser = make_parser()
        blocks: List = []
        used = 0
        ok = True
        parser.before_first()
        while parser.next():
            blk = parser.value()
            if blk.lease is not None:
                blk = blk.copy()  # own past the parser's next()
            used += blk.memory_cost_bytes()
            if used > budget:
                ok = False
                break
            blocks.append(blk)
        if hasattr(parser, "destroy"):
            parser.destroy()
        if ok:
            self._blocks = blocks
        return ok

    def _memory_precheck_ok(self, budget: int) -> bool:
        from dmlc_tpu_torch.io.input_split import list_split_files
        try:
            total = sum(size for _, size in
                        list_split_files(self._source_uri))
        except (OSError, DMLCError):  # non-stat-able: try the drain
            return True
        return total // max(self._source_parts, 1) <= budget

    @staticmethod
    def _source_fingerprint(sp):
        """``[[path, size, mtime_ns], ...]`` of the source's backing
        files, or None when non-stat-able."""
        from dmlc_tpu_torch.io.input_split import list_split_files
        from dmlc_tpu_torch.io.pagestore import stat_fingerprint
        try:
            return stat_fingerprint(
                p for p, _ in list_split_files(sp["uri"]))
        except (OSError, DMLCError):
            return None

    @staticmethod
    def _derived_page_path(sp, fmt, rows_per_page: int, fingerprint):
        """Page path under the port's default store root —
        fingerprint-keyed so a changed source derives a fresh cache
        file (the stamp DiskRowIter writes catches in-place mutation of
        an unchanged name too)."""
        import hashlib
        import os

        from dmlc_tpu_torch.io.pagestore import default_store_dir
        key = hashlib.sha256(repr(
            (sp["uri"], sp["part_index"], sp["num_parts"], fmt,
             rows_per_page, fingerprint)).encode()).hexdigest()[:16]
        d = default_store_dir()
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"cache-{key}.pages")

    @property
    def queue(self):
        return getattr(self._it, "_iter", None)

    def epoch(self) -> Iterator:
        if self._blocks is not None:
            yield from self._blocks
            return
        it = self._it
        it.before_first()
        while it.next():
            yield it.value()

    def finalize_epoch(self) -> None:
        # which replay tier served the epoch — the autotuner must not
        # judge a knob trial across a tier flip
        self.probe.extra["replay_tier"] = self.tier

    def close(self) -> None:
        self._blocks = None
        if self._it is not None:
            self._it._close()


class _ShardRunner(_RunnerBase):
    """source [+ parse opts] + shard → ShardedRowBlockIter batches
    ([L, ...] tensors on the mesh's device)."""

    kind = "shard"

    def __init__(self, source: StageSpec, parse: Optional[StageSpec],
                 shard: StageSpec):
        super().__init__("shard")
        from dmlc_tpu_torch.parallel.sharded import ShardedRowBlockIter
        sp = source.params
        p = dict(parse.params) if parse is not None else {}
        p.pop("prefetch_depth", None)
        fmt = p.pop("format", None)
        p = {k: v for k, v in p.items() if v is not None}
        if sp["split_type"] != "text":
            p["split_type"] = sp["split_type"]
        shp = dict(shard.params)
        mesh = shp.pop("mesh")
        self._it = ShardedRowBlockIter(sp["uri"], mesh, format=fmt,
                                       **shp, **p)

    def epoch(self) -> Iterator:
        return iter(self._it)

    @property
    def queue(self):
        # the live serve ThreadedIter while an epoch runs: occupancy
        # samples land in the probe, which is what lets the autotuner
        # drive the shard.prefetch knob
        return getattr(self._it, "_serve_queue", None)

    def knobs(self) -> List[Knob]:
        it = self._it

        def _set(n: int) -> None:
            it.prefetch_depth = n

        return [Knob("shard.prefetch", "shard",
                     lambda: it.prefetch_depth, _set, lo=1, hi=8)]

    def finalize_epoch(self) -> None:
        it = self._it
        if it.replay_tier is not None:
            self.probe.extra["replay_tier"] = it.replay_tier
        self.probe.extra["replay_epochs"] = it.replay_epochs
        self.probe.extra["page_replay_epochs"] = it.page_replay_epochs
        self.probe.extra["raw_page_epochs"] = it.raw_page_epochs
        if it._serve_stats:
            self.probe.extra["serve"] = dict(it._serve_stats)

    def close(self) -> None:
        self._it.close()


class _MapRunner(_RunnerBase):
    """User fn over each item. The fn sees the upstream item under the
    upstream's lifetime contract; ownership passes through unchanged."""

    kind = "map"

    def __init__(self, up: _RunnerBase, fn: Callable, name: str):
        super().__init__(name)
        self.up = up
        self._fn = fn
        self.owned = up.owned  # lifetime contract passes through

    def epoch(self) -> Iterator:
        fn = self._fn
        for item in _probed(self.up):
            yield fn(item)

    def detach_last(self):
        return self.up.detach_last()


class _PrefetchRunner(_RunnerBase):
    """Bounded background queue (ThreadedIter). Converts ephemeral
    upstream items to owned ones: the producer thread detaches each
    native arena lease (or copies), and the consumer releases a lease
    when the NEXT item is pulled — preserving the valid-until-next-pull
    contract downstream."""

    kind = "prefetch"

    def __init__(self, up: _RunnerBase, depth):
        super().__init__("prefetch")
        self.up = up
        self._auto = depth == "auto"
        from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
        self._ti = ThreadedIter(
            max_capacity=4 if self._auto else int(depth), name="prefetch")
        self._src: Optional[Iterator] = None
        self._started = False

    @property
    def queue(self):
        return self._ti

    def _restart(self) -> None:
        gen = _probed(self.up)
        if self.up.owned:
            self._src = gen
            return

        def owning():
            for item in gen:
                lease = self.up.detach_last()
                if lease is not None:
                    item.lease = lease
                else:
                    item = item.copy()
                yield item

        self._src = owning()

    def epoch(self) -> Iterator:
        if not self._started:
            self._restart()
            self._ti.init(lambda: next(self._src, None), self._restart)
            self._started = True
        else:
            self._ti.before_first()
        prev = None

        def release_prev():
            if prev is not None and getattr(prev, "lease", None) is not None:
                prev.lease.release()
                prev.lease = None

        try:
            while True:
                item = self._ti.next()
                release_prev()
                if item is None:
                    return
                prev = item  # before the yield: an abandoned epoch's
                yield item   # finally must release the CURRENT item too
        finally:
            release_prev()  # the epoch's last lease (or an abandon)

    def knobs(self) -> List[Knob]:
        if not self._auto:
            return []
        return [Knob("prefetch.depth", "prefetch",
                     lambda: self._ti.capacity, self._ti.set_capacity,
                     lo=1, hi=64)]

    def finalize_epoch(self) -> None:
        if self._started:
            # epoch-scoped producer counters: blocked-on-full-queue time
            # tells consumer-bound from producer-bound
            self.probe.extra["producer"] = self._ti.stats()

    def close(self) -> None:
        self._ti.destroy()


class _DeviceRunner(_RunnerBase):
    """Async host→device copies with a bounded in-flight window, on the
    port's pieces (parallel.device_iter): each batch's copies are
    enqueued on a copy stream with one CUDA event behind them, ``window``
    batches ride in flight under the upstream's work, and a batch is
    yielded once drained — the consumer's stream waits on its event
    (``record_stream`` tells the caching allocator). A native-engine
    arena lease is held until the block's bytes are staged into a pinned
    slot, or, unstaged, until its copy has completed.

    On the CPU the copy is ``torch.from_numpy``, which ALIASES host
    memory (as the reference's CPU ``device_put`` may): a leased item is
    copied before its lease is released, and a staging slot handed to
    the consumer is never reused."""

    kind = "to_device"

    def __init__(self, up: _RunnerBase, device, window, staging="auto",
                 sharding=None):
        super().__init__("to_device")
        self.up = up
        self._auto = window == "auto"
        self.window = 4 if self._auto else int(window)
        check(self.window >= 1, "to_device(window) needs window >= 1")
        check(device is None or sharding is None,
              "to_device: pass device OR sharding, not both")
        check(sharding is None or isinstance(sharding, NamedSharding),
              "to_device(sharding=) takes a "
              "dmlc_tpu_torch.parallel.placement.NamedSharding, got "
              f"{type(sharding).__name__}")
        self._sharding = sharding
        # staging: route batches through reusable pinned host slots
        # (parallel.device_iter.HostStaging) so the source buffers are
        # free at COPY time and the H2D copy of batch N overlaps batch
        # N+1's assembly. "auto" = on for dict batches (the fixed-shape
        # padded steady path, where slot reuse pays), off for RowBlock
        # streams (variable shapes defeat the pool).
        check(staging in (True, False, "auto"),
              "to_device(staging) must be True, False or 'auto'")
        self._staging = staging
        self._device = (sharding.device if sharding is not None else
                        resolve_device(device))

    @staticmethod
    def _host_arrays(item) -> Dict[str, np.ndarray]:
        if isinstance(item, dict):
            return item
        out = {"offset": item.offset, "label": item.label,
               "index": item.index}
        for k in ("value", "weight", "qid", "field"):
            v = getattr(item, k)
            if v is not None:
                out[k] = v
        return out

    def epoch(self) -> Iterator:
        from dmlc_tpu_torch.parallel.device_iter import HostStaging
        device = self._device
        on_cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if on_cuda else None
        # one pool per epoch, window+1 slots (window in flight + one being
        # staged), pinned on the card, never reused on the aliasing CPU
        pool: Optional[HostStaging] = None

        def new_pool():
            return HostStaging(self.window + 1, pin=on_cuda,
                               alias_unsafe=not on_cuda)

        if self._staging is True:
            pool = new_pool()
        in_flight: deque = deque()
        xfer_wait = 0.0

        def drain_one():
            nonlocal xfer_wait
            out, lease, staged, t_enq = in_flight.popleft()
            t0 = time.perf_counter()
            if out.event is not None and lease is not None:
                # the copy reads the leased arena: it must have
                # completed before the arena returns to the engine
                out.event.synchronize()
            wait_copy(out, device)
            if lease is not None:
                lease.release()
            if self._sharding is not None:
                # the batch is on the mesh's device: each array's owned
                # slices are copies on the card, a replicated spec one
                placed = DeviceBatch({
                    k: device_put(t, self._sharding, name=k)
                    for k, t in out.items()})
                placed.counts = out.counts
                out = placed
            now = time.perf_counter()
            dt = now - t0
            xfer_wait += dt
            self.probe.extra["xfer_wait_s"] = round(xfer_wait, 6)
            rec = _trace.active()
            if rec is not None:
                rec.complete("to_device.drain", t0, dt, "transfer",
                             {"in_flight": len(in_flight) + 1})
                if staged:
                    # the batch's window in flight, enqueue → hand-off
                    # to the consumer (whose stream then waits on the
                    # copy's event): it overlaps the NEXT batch's
                    # device.assemble span — the Perfetto-visible proof
                    # the double-buffer works
                    rec.complete("device.xfer", t_enq, now - t_enq,
                                 "transfer")
            return out

        for item in _probed(self.up):
            if self.up.owned:
                # an OWNED item may still carry a detached arena lease
                # (prefetch over a native parse): take it over so the
                # upstream's release-on-next-pull cannot return the arena
                # while this copy is in flight
                lease = getattr(item, "lease", None)
                if lease is not None:
                    item.lease = None
            else:
                lease = self.up.detach_last()
            counts = _item_stats(item)[:2]
            arrs = self._host_arrays(item)
            if pool is None and self._staging == "auto" \
                    and isinstance(item, dict):
                pool = new_pool()
            slot = None
            if pool is not None:
                # staged path: one copy into the reusable slot frees the
                # source NOW — a leased padded block returns to the
                # engine pool while its bytes are still in flight
                slot = pool.stage(arrs)
                src = slot
                if lease is not None:
                    lease.release()
                    lease = None
                self.probe.extra["staging_assemble_s"] = round(
                    pool.assemble_s, 6)
            else:
                if lease is not None and not on_cuda:
                    # the CPU aliasing rule: from_numpy would alias an
                    # arena that is recycled after release — copy now
                    # and free the arena at once
                    arrs = {k: np.array(v, copy=True)
                            for k, v in arrs.items()}
                    lease.release()
                    lease = None
                src = {k: torch.from_numpy(np.asarray(v))
                       for k, v in arrs.items()}
            t_enq = time.perf_counter()
            out = copy_to_device(src, device, copy_stream)
            out.counts = counts
            if slot is not None:
                pool.release(slot, out.event)
            in_flight.append((out, lease, slot is not None, t_enq))
            # window is re-read each round: the autotuner adjusts it
            # between epochs (and a mid-epoch change is simply honored)
            while len(in_flight) > self.window:
                yield drain_one()
        while in_flight:
            yield drain_one()

    def knobs(self) -> List[Knob]:
        if not self._auto:
            return []

        def _set(n: int) -> None:
            self.window = n

        return [Knob("device.window", "to_device",
                     lambda: self.window, _set, lo=1, hi=32)]


class CompiledPipeline:
    """Executable form of a Pipeline: iterate for one epoch, read
    ``stats()``, let the bound autotuner retune depths between epochs."""

    def __init__(self, runners: List[_RunnerBase],
                 autotuner: Optional[Autotuner],
                 tenant: Optional[str] = None):
        self._runners = runners
        self.autotuner = autotuner
        # multi-tenant contract (pipeline.scheduler): the tenant this
        # pipeline bills its pulls to, and the queue-capacity knobs
        # the scheduler owns (the autotuner/controller must not move
        # them — one owner per knob)
        self.tenant = tenant
        self.scheduler_owned: tuple = ()
        self._epoch = 0
        self._last: Optional[Dict[str, Any]] = None
        # one-way hand-off flag: a controller that raised on this
        # pipeline never gets it back (see the epoch hook below)
        self._control_failed = False
        # the pipeline's stats() registers as an obs metrics collector:
        # one REGISTRY.snapshot() sees the last epoch's stage stats
        # next to the queue and profiler surfaces
        self._metrics_key = _METRICS.register(
            "pipeline", self, CompiledPipeline._last_snapshot)

    def _last_snapshot(self) -> Optional[Dict[str, Any]]:
        return self._last

    # -- iteration

    def __iter__(self) -> Iterator:
        """One epoch. At a COMPLETE epoch the stats snapshot is frozen
        and the autotuner (if bound) takes its between-epoch step; an
        abandoned epoch leaves the previous snapshot in place."""
        for r in self._runners:
            r.probe.reset()
        sched = None
        if self.tenant is not None:
            from dmlc_tpu_torch.pipeline import scheduler as _sched
            sched = _sched.active()
        t0 = time.perf_counter()
        if sched is None:
            yield from _probed(self._runners[-1])
        else:
            # multi-tenant discipline: every delivered batch costs one
            # pull credit FIRST (a credit-blocked tenant stops pulling
            # — its bounded queues fill and the throttle propagates up
            # to its readers), then bills its latency + volume to the
            # tenant's accounting. The billed latency is the
            # tenant-EXPERIENCED wait — credit wait included — because
            # that is what a declared latency SLO (obs.slo) judges.
            # The pull itself runs under pulling(): lighter tenants
            # hold at their yield points while it is in flight
            gen = _probed(self._runners[-1])
            while True:
                tb = time.perf_counter()
                sched.acquire(self.tenant)
                with sched.pulling(self.tenant):
                    item = next(gen, _END)
                if item is _END:
                    break
                rows, _nnz, nbytes = _item_stats(item)
                sched.note_batch(self.tenant,
                                 time.perf_counter() - tb,
                                 rows=rows, nbytes=nbytes)
                yield item
        wall = time.perf_counter() - t0
        for r in self._runners:
            r.finalize_epoch()
        self._epoch += 1
        self._last = snapshot([r.probe for r in self._runners], wall,
                              self._epoch, self.knob_values())
        if self.tenant is not None:
            # the tenant label rides the snapshot (obs/analyze emits
            # per-tenant bound verdicts from it; /tenants rows cite it)
            self._last["tenant"] = self.tenant
        if sched is not None:
            sched.note_epoch(self.tenant, self._last)
        # one mover per process: an installed verdict-driven
        # controller (obs.control) adopts this pipeline's knobs and
        # subsumes the blind hill-climber — the bound verdict picks
        # WHICH family moves; otherwise the bound autotuner takes its
        # between-epoch step as before
        ctl = None
        if not self._control_failed:
            from dmlc_tpu_torch.obs import control as _control
            ctl = _control.active()
        if ctl is not None:
            if self.autotuner is not None \
                    and self.autotuner.rail.pending is not None:
                # a controller installed MID-RUN takes over from the
                # autotuner: its in-flight trial would never be judged
                # again — discard it (value restored, no freeze) so no
                # knob is stranded at an unjudged trial value
                self.autotuner.rail.discard()
            try:
                ctl.observe_pipeline(self, self._last)
            except Exception as e:  # noqa: BLE001 — a controller bug
                # must not take down the epoch loop, and it must not
                # SILENTLY disable tuning either. The hand-off is
                # ONE-WAY (this pipeline never returns to the
                # controller): alternating movers would let the
                # autotuner arm a trial the controller's epoch never
                # resolves — a knob stranded at an unjudged value
                from dmlc_tpu_torch.obs.log import warn_limited
                warn_limited(
                    "control-observe-failed",
                    f"obs.control: observe_pipeline failed ({e!r}); "
                    "this pipeline falls back to its own autotuner "
                    "permanently",
                    min_interval_s=60)
                self._control_failed = True
                try:
                    # release this pipeline's controller state: an
                    # unresolved pending trial would wedge every
                    # OTHER source into no-ops, and the controller
                    # must stop moving knobs the autotuner now owns
                    ctl.abandon_pipeline(self)
                except Exception:  # noqa: BLE001
                    pass
                ctl = None
        if ctl is None and self.autotuner is not None:
            self.autotuner.after_epoch(self._last)

    def run_epoch(self) -> Dict[str, Any]:
        """Drain one epoch and return its stats snapshot."""
        for _ in self:
            pass
        assert self._last is not None
        return self._last

    # -- telemetry / tuning

    def stats(self) -> Optional[Dict[str, Any]]:
        """Snapshot of the last COMPLETE epoch (None before the first)."""
        return self._last

    def knobs(self) -> List[Knob]:
        return [k for r in self._runners for k in r.knobs()]

    def knob_values(self) -> Dict[str, int]:
        return {k.name: k.get() for k in self.knobs()}

    def autotune_report(self) -> Optional[Dict[str, Any]]:
        return (self.autotuner.report()
                if self.autotuner is not None else None)

    def trace(self, path: str, capacity: int = 1 << 20):
        """Record a Chrome/Perfetto trace of everything run inside the
        block and export it to ``path`` on exit::

            with built.trace("epoch.json"):
                for batch in built:
                    step(batch)

        Every stage pull becomes a ``pull/<stage>`` span, queue waits
        and transfer drains appear on their own threads, and native
        engine counters ride as counter tracks (dmlc_tpu_torch.obs.trace;
        installs the global recorder for the duration)."""
        return _trace.trace_to(path, capacity)

    def stream_stats(self) -> Optional[Dict[str, Any]]:
        """Live watermark of a streaming source (None for finite
        pipelines) — readable MID-epoch, unlike stats()."""
        src = self._runners[0]
        split = getattr(src, "_stream_split", None)
        return split.watermark() if split is not None else None

    @property
    def epochs(self) -> int:
        return self._epoch

    def close(self) -> None:
        if self.tenant is not None:
            from dmlc_tpu_torch.pipeline import scheduler as _sched
            sched = _sched.active()
            if sched is not None:
                sched.release(self)
        if self._metrics_key is not None:
            _METRICS.unregister(self._metrics_key)
            self._metrics_key = None
        for r in reversed(self._runners):
            r.close()

    def __enter__(self) -> "CompiledPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Pipeline:
    """Immutable declarative stage chain; see the module docstring."""

    __slots__ = ("_stages",)

    def __init__(self, stages: Tuple[StageSpec, ...]):
        self._stages = stages

    # -- construction

    @staticmethod
    def from_uri(uri: str, part_index: int = 0, num_parts: int = 1,
                 split_type: str = "text") -> "Pipeline":
        """Root of every pipeline: one shard of a (multi-file) URI —
        the InputSplit sharding contract."""
        check(0 <= part_index < num_parts,
              f"part_index {part_index} out of range for {num_parts}")
        return Pipeline((StageSpec("source", uri=uri,
                                   part_index=part_index,
                                   num_parts=num_parts,
                                   split_type=split_type),))

    @staticmethod
    def from_stream(uri: str, *, window_records: Optional[int] = None,
                    window_s: Optional[float] = None,
                    poll_interval_s: float = 0.05,
                    idle_timeout_s: Optional[float] = None,
                    chunk_size: int = 8 << 20) -> "Pipeline":
        """Root of a STREAMING pipeline: an EOF-less windowed read of
        one growing text source (:class:`dmlc_tpu_torch.io.
        streaming_split.StreamingSplit`). Appended records accumulate
        into windows closed by ``window_records`` and/or ``window_s``;
        each window feeds the unchanged parse/batch/to_device machinery,
        with a monotonic watermark in the parse stage's
        ``extra["stream"]``. The epoch ends when the split's ``stop()``
        is called and the committed bytes are drained, or after
        ``idle_timeout_s`` with no growth (None = stream forever).
        Streaming sources are single-part and cannot be shuffled,
        cached, or sharded (the chain validator rejects those
        stages)."""
        return Pipeline((StageSpec(
            "source", uri=uri, part_index=0, num_parts=1,
            split_type="text",
            stream={"window_records": window_records,
                    "window_s": window_s,
                    "poll_interval_s": poll_interval_s,
                    "idle_timeout_s": idle_timeout_s,
                    "chunk_size": chunk_size}),))

    def _with(self, spec: StageSpec) -> "Pipeline":
        return Pipeline(self._stages + (spec,))

    def parse(self, format: Optional[str] = None, engine: str = "auto",
              chunk_size: int = 8 << 20, nthreads: Optional[int] = None,
              index_dtype=np.uint32, prefetch_depth="auto",
              **kwargs: Any) -> "Pipeline":
        """Bytes → CSR RowBlock stream (Parser.create; format kwargs
        such as indexing_mode pass through). prefetch_depth="auto" makes
        the python engine's chunk-prefetch queue an autotuner knob."""
        return self._with(StageSpec("parse", format=format, engine=engine,
                                    chunk_size=chunk_size,
                                    nthreads=nthreads,
                                    index_dtype=index_dtype,
                                    prefetch_depth=prefetch_depth,
                                    **kwargs))

    def shuffle(self, num_shuffle_parts: int = 4, seed: int = 0,
                global_seed: Optional[int] = None,
                window_bytes: Optional[int] = None) -> "Pipeline":
        """Shuffled read order. Default: chunk-level
        (InputSplitShuffle) — the shard subdivides into
        num_shuffle_parts sub-shards whose order reshuffles each
        epoch, deterministically from ``seed`` (the reference's seed
        law, so the same order as the reference's).

        ``global_seed`` switches to the gang-wide SAMPLE-level shuffle
        (dmlc_tpu_torch.shuffle.GlobalShuffleSplit): a seeded global
        permutation over every record of the dataset, identical at any
        world size, window-bounded to ``window_bytes`` resident bytes
        (default dmlc_tpu_torch.shuffle.DEFAULT_WINDOW_BYTES), with
        window pages exchanged through the peer /pages tier. Both lower
        onto the python parse engine."""
        check(num_shuffle_parts >= 1, "num_shuffle_parts must be >= 1")
        check(window_bytes is None or window_bytes > 0,
              "shuffle: window_bytes must be > 0")
        check(window_bytes is None or global_seed is not None,
              "shuffle: window_bytes applies to the global shuffle — "
              "pass global_seed")
        return self._with(StageSpec("shuffle",
                                    num_shuffle_parts=num_shuffle_parts,
                                    seed=seed, global_seed=global_seed,
                                    window_bytes=window_bytes))

    def cache(self, path: Optional[str] = None,
              rows_per_page: int = 64 << 10,
              memory_budget_bytes: Optional[int] = None,
              page_budget_bytes: Optional[int] = None) -> "Pipeline":
        """Parse once; later epochs replay instead of re-parsing text.
        The tier is picked by budget (default 1 GiB; an explicit 0
        forces pages): raw blocks within ``memory_budget_bytes`` are
        retained in RAM, larger datasets spill to binary row pages
        (DiskRowIter) under the port's page store
        (``io.pagestore.default_store_dir``), fingerprint-keyed AND
        fingerprint-stamped (a changed source rebuilds instead of
        replaying). An explicit ``path`` forces the page tier at that
        location. ``page_budget_bytes`` sets the owning page store's
        byte budget: committed entries LRU-evict down to it (pinned
        live caches are skipped).

        The memory tier serves the SAME RowBlock objects every epoch —
        RowBlock is immutable by contract, so downstream ``map`` fns
        must not mutate blocks in place."""
        return self._with(StageSpec("cache", path=path,
                                    rows_per_page=rows_per_page,
                                    memory_budget_bytes=memory_budget_bytes,
                                    page_budget_bytes=page_budget_bytes))

    def batch(self, rows: int, drop_remainder: bool = False,
              pad: bool = False, row_bucket: Optional[int] = None,
              nnz_bucket: Optional[int] = None, want_qid: bool = False,
              want_field: bool = False) -> "Pipeline":
        """Re-chunk the block stream to exactly ``rows`` rows per block
        (last partial block kept unless drop_remainder).

        ``pad=True`` (or passing ``nnz_bucket``) switches the stage to
        PADDED batch assembly: each batch is a fixed-shape,
        device-layout dict padded to (row_bucket, nnz_bucket) — the
        data.padding layout contract (offset/label/weight/index/value
        + num_rows/num_nnz, optional qid/field). ``row_bucket``
        defaults to ``rows``; ``nnz_bucket`` is required (it bounds the
        batch's nnz — a batch that exceeds it raises). When the stage
        sits directly on a native-engine parse, assembly lowers onto
        the engine's ABI-5 ``next_padded`` (zero-copy leased views);
        otherwise the Python fused golden pads — byte-identical. The
        lowering that ran is reported as ``assembly_path`` in the stage
        stats."""
        pad = pad or nnz_bucket is not None
        if pad:
            check(nnz_bucket is not None,
                  "batch(pad=True) needs nnz_bucket (the padded batch's "
                  "fixed nnz capacity)")
            check(row_bucket is None or row_bucket >= rows,
                  "batch(row_bucket) must be >= rows")
        return self._with(StageSpec("batch", rows=rows,
                                    drop_remainder=drop_remainder,
                                    pad=pad, row_bucket=row_bucket,
                                    nnz_bucket=nnz_bucket,
                                    want_qid=want_qid,
                                    want_field=want_field))

    def map(self, fn: Callable, name: Optional[str] = None) -> "Pipeline":
        """Apply ``fn`` to every item. ``fn`` sees items under the
        upstream lifetime contract (copy before retaining ephemeral
        native blocks)."""
        return self._with(StageSpec("map", fn=fn, name=name or "map"))

    def prefetch(self, depth="auto") -> "Pipeline":
        """Decouple producer and consumer with a bounded background
        queue; depth="auto" is an autotuner knob."""
        return self._with(StageSpec("prefetch", depth=depth))

    def shard(self, mesh, axis: str = "data", row_bucket: int = 1 << 14,
              nnz_bucket: int = 1 << 18, **kwargs: Any) -> "Pipeline":
        """Part-granular multi-process ingest: lowers source+parse into
        ShardedRowBlockIter and yields ``[L, ...]`` batch dicts of this
        process's parts along the mesh's ``axis``, on the mesh's
        device."""
        return self._with(StageSpec("shard", mesh=mesh, axis=axis,
                                    row_bucket=row_bucket,
                                    nnz_bucket=nnz_bucket, **kwargs))

    def to_device(self, device=None, sharding=None,
                  window="auto", staging="auto") -> "Pipeline":
        """Async host→device copies, ``window`` batches in flight, to
        ``device`` (``cuda`` by default; ``"cpu"`` runs on the host);
        window="auto" is an autotuner knob. ``staging`` routes batches
        through reusable pinned host slots (the copy into a slot frees
        the source at once; the H2D copy of batch N overlaps the
        assembly of N+1): True, False, or "auto" (on for dict batches —
        the fixed-shape padded steady path — off for RowBlock
        streams). ``sharding`` (a ``parallel.placement.NamedSharding``,
        not with ``device``) places every array of a batch under it
        instead: each a ``PlacedTensor`` holding this process's slices
        on the mesh's device."""
        return self._with(StageSpec("to_device", device=device,
                                    sharding=sharding, window=window,
                                    staging=staging))

    # -- compilation

    def build(self, autotune: bool = False,
              tenant: Optional[str] = None,
              **autotune_opts: Any) -> CompiledPipeline:
        """Validate the chain and lower it onto the port's machinery.
        ``autotune=True`` binds an Autotuner over every "auto" depth
        knob (no-op when the chain has none).

        ``tenant`` admits the compiled pipeline under that tenant of
        the installed :mod:`dmlc_tpu_torch.pipeline.scheduler`
        (admission control applies — past the tenant's budget this
        RAISES AdmissionError or queues, per the tenant's policy).
        Every delivered batch then costs one scheduler pull credit,
        volume and latency bill to the tenant, and the scheduler owns
        the pipeline's queue-capacity knobs (withheld from the
        autotuner here — one owner per knob)."""
        specs = self._stages
        validate_chain(specs)
        kinds = [s.kind for s in specs]
        if "parse" not in kinds and "shard" not in kinds:
            raise DMLCError(
                "pipeline: nothing to run — add .parse(...) or "
                ".shard(mesh)")
        i = 1
        shuffle_spec = None
        parse_spec = None
        if specs[i].kind == "shuffle":
            shuffle_spec = specs[i]
            i += 1
        if specs[i].kind == "parse":
            parse_spec = specs[i]
            i += 1
        runners: List[_RunnerBase]
        if i < len(specs) and specs[i].kind == "cache":
            runners = [_CacheRunner(specs[0], shuffle_spec, parse_spec,
                                    specs[i])]
            i += 1
        elif i < len(specs) and specs[i].kind == "shard":
            runners = [_ShardRunner(specs[0], parse_spec, specs[i])]
            i += 1
        else:
            runners = [_ParseRunner(specs[0], shuffle_spec, parse_spec)]
        for spec in specs[i:]:
            up = runners[-1]
            if spec.kind == "batch" and spec.params["pad"]:
                # padded assembly sitting DIRECTLY on a native-engine
                # parse fuses into the engine's batch assembly; anything
                # else (python engine, cache upstream, map between) pads
                # through the Python fused golden — byte-identical
                if (len(runners) == 1 and isinstance(up, _ParseRunner)
                        and hasattr(up._parser, "next_padded")):
                    runners[-1] = _NativeAssembleRunner(up, spec)
                else:
                    runners.append(_PadBatchRunner(up, spec))
            elif spec.kind == "batch":
                runners.append(_BatchRunner(up, spec.params["rows"],
                                            spec.params["drop_remainder"]))
            elif spec.kind == "map":
                runners.append(_MapRunner(up, spec.params["fn"],
                                          spec.params["name"]))
            elif spec.kind == "prefetch":
                runners.append(_PrefetchRunner(up, spec.params["depth"]))
            else:  # to_device; validate_chain rejects anything else here
                runners.append(_DeviceRunner(
                    up, spec.params["device"], spec.params["window"],
                    spec.params["staging"], spec.params["sharding"]))
        sched = None
        owned: tuple = ()
        if tenant is not None:
            from dmlc_tpu_torch.pipeline import scheduler as _sched
            sched = _sched.active()
            if sched is None:
                for r in reversed(runners):
                    r.close()
                raise DMLCError(
                    "pipeline: build(tenant=...) needs an installed "
                    "scheduler (dmlc_tpu_torch.pipeline.scheduler."
                    f"install() or {_sched.ENV_SCHED}=1)")
            owned = _sched.MANAGED_KNOBS
        tuner = None
        if autotune:
            knobs = [k for r in runners for k in r.knobs()
                     if k.name not in owned]
            if knobs:
                tuner = Autotuner(knobs, **autotune_opts)
        built = CompiledPipeline(runners, tuner, tenant=tenant)
        built.scheduler_owned = owned
        if sched is not None:
            try:
                sched.admit(tenant, built)
            except BaseException:
                built.close()  # free the runners a failed admission
                raise          # would otherwise leak
        return built

    # -- introspection

    @property
    def stages(self) -> Tuple[StageSpec, ...]:
        return self._stages

    def __repr__(self) -> str:
        return "Pipeline(" + " → ".join(map(repr, self._stages)) + ")"
