"""Row-block iterators: in-RAM and disk-cached, plus the round spill
store backing ShardedRowBlockIter's page-tier steady replay.

Counterpart of ``dmlc_tpu/data/row_iter.py``. Reference:
src/data/basic_row_iter.h (BasicRowIter<I> — drain parser into one
RowBlockContainer at construction), src/data/disk_row_iter.h
(DiskRowIter<I> — parse once, spill binary pages to a '#cache' file,
then replay pages with ThreadedIter prefetch), include/dmlc/data.h
(RowBlockIter<I>::Create).

The spill store (RoundSpillWriter / RoundSpillFile) is DiskRowIter's
page format generalized to ROUNDS: each round is a fixed-width row of
``nparts`` raw (unpadded) RowBlocks, written round-major as the replay
tee assembles them, fingerprint-stamped in the header so staleness is
self-describing (``sweep_stale_spill``), committed atomically via
tmp + rename. ShardedRowBlockIter replays these rounds on steady epochs
when the in-memory tier would exceed ``agreement_cache_bytes``, one
round's bytes at a time (``RoundSpillFile.read_round_into``), located
by the :class:`RoundTable` the writer keeps (or a header scan builds):
the file's bytes stay the reference's.

Both tiers route their on-disk bytes through the port's
:class:`dmlc_tpu_torch.io.pagestore.PageStore`: one atomic tmp+rename
commit protocol, one fingerprint-stamped sidecar, one byte budget with
LRU eviction, and ONE stale sweep. Files are byte-identical to the
reference's for the same blocks, rounds and meta, and each package
reads the other's; ``RowBlockIter.create(uri + "#cache")`` names its
cache entry as the reference does, so either package replays the
other's.

DiskRowIter's build is the reference's retry site ``data.pages.build``;
its commit publishes under ``data.pages.commit`` and a round spill's
under ``spill.commit``, inside a ``spill.commit`` trace span.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.data.parser import DataIter, Parser
from dmlc_tpu_torch.data.rowblock import (
    _PAGE_MAGIC, _PAGE_VERSION, RowBlock, RowBlockContainer,
)
from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io import codec as _codec
from dmlc_tpu_torch.io.pagestore import PageStore, default_store_dir
from dmlc_tpu_torch.io.stream import MemoryStream, create_stream
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter",
           "RoundSpillWriter", "RoundSpillFile", "RoundTable",
           "RoundReadAhead", "default_spill_dir", "read_spill_meta",
           "sweep_stale_spill"]


class RowBlockIter(DataIter):
    """DataIter over RowBlocks with num_col introspection
    (reference: RowBlockIter<IndexType>)."""

    @staticmethod
    def create(uri: str, part_index: int = 0, num_parts: int = 1,
               format: Optional[str] = None, index_dtype=np.uint32,
               **kwargs: Any) -> "RowBlockIter":
        """Reference: RowBlockIter<I>::Create — '#cache' in the URI selects
        the disk-spill path, else everything is held in RAM."""
        spec = URISpec(uri)
        # '#cache' at this level selects the row-page cache (DiskRowIter);
        # strip it from the parser's URI so the chunk-level CachedInputSplit
        # does not also claim the same file (the page cache already makes
        # the source single-pass).
        parser_uri = spec.uri
        if spec.args:
            parser_uri += "?" + "&".join(
                f"{k}={v}" for k, v in spec.args.items())

        def make_parser() -> Parser:
            return Parser.create(parser_uri, part_index, num_parts,
                                 format=format, index_dtype=index_dtype,
                                 **kwargs)

        if spec.cache_file:
            # namespace by shard so parts never mix (same scheme as
            # CachedInputSplit), and by role so a chunk cache using the
            # same hint stays distinct
            cache = f"{spec.cache_file}.pages.p{part_index}-{num_parts}"
            return DiskRowIter(make_parser, cache,
                               fingerprint=_source_fingerprint(parser_uri))
        return BasicRowIter(make_parser())

    def num_col(self) -> int:
        raise NotImplementedError


class BasicRowIter(RowBlockIter):
    """All-in-RAM single-block iterator (reference: BasicRowIter<I>)."""

    def __init__(self, parser: Parser):
        container = RowBlockContainer(parser.index_dtype)
        parser.before_first()
        while parser.next():
            container.push_block(parser.value())
        if hasattr(parser, "destroy"):
            parser.destroy()
        self._block = container.get_block()
        self._max_index = container.max_index
        self._at_head = True
        self._taken = False

    def before_first(self) -> None:
        self._at_head = True
        self._taken = False

    def next(self) -> bool:
        if self._at_head and not self._taken:
            self._taken = True
            return True
        return False

    def value(self) -> RowBlock:
        check(self._taken, "value() before next()")
        return self._block

    def num_col(self) -> int:
        return int(self._max_index) + 1


def _source_fingerprint(uri: str):
    """Best-effort ``[[path, size, mtime_ns], ...]`` stamp of a
    parser's backing files — None when the source cannot be stat'ed
    (the cache then trusts its existence, the pre-pagestore
    contract)."""
    try:
        from dmlc_tpu_torch.io.input_split import list_split_files
        from dmlc_tpu_torch.io.pagestore import stat_fingerprint
        return stat_fingerprint(p for p, _ in list_split_files(uri))
    except Exception:  # noqa: BLE001 — non-stat-able source
        return None


class DiskRowIter(RowBlockIter):
    """Parse once → binary page cache → threaded page replay
    (reference: DiskRowIter<I>, pages via RowBlockContainer::Save/Load).

    The cache is a :class:`~dmlc_tpu_torch.io.pagestore.PageStore`
    entry: built into a pid-unique tmp and published atomically,
    stamped with the source ``fingerprint`` when the caller provides one
    (a stamped cache whose sources changed is rebuilt instead of
    replayed — and reclaimed by the one stale sweep), accounted against
    the store's byte budget, and pinned against LRU eviction while this
    iterator lives. ``parser_factory`` is a Parser or a callable that
    makes one; with a callable the build retries under the
    ``data.pages.build`` site's policy, a Parser gets one attempt."""

    def __init__(self, parser_factory, cache_file: str,
                 rows_per_page: int = 64 << 10, fingerprint=None):
        self.cache_file = cache_file
        self._store, self._entry = PageStore.for_path(cache_file)
        self._max_index = 0
        present = (self._store.lookup(self._entry, fingerprint=fingerprint)
                   is not None)
        if not present:
            if callable(parser_factory):
                # the build is THE retry site of this iterator: each
                # policy attempt re-creates the parser and rebuilds
                # into a fresh pid-named tmp (site data.pages.build)
                from dmlc_tpu_torch.resilience.policy import guarded

                def build_once() -> None:
                    self._max_index = 0
                    self._build_cache(parser_factory(), fingerprint,
                                      rows_per_page)

                guarded("data.pages.build", build_once)
            else:
                # a pre-built parser cannot be re-created: one shot
                self._build_cache(parser_factory, fingerprint,
                                  rows_per_page)
        else:
            # scan cached pages once for num_col
            with create_stream(cache_file, "r") as s:
                while True:
                    blk = RowBlockContainer.load_block(s)
                    if blk is None:
                        break
                    if len(blk.index):
                        self._max_index = max(self._max_index,
                                              int(blk.index.max()))
        self._store.pin(self._entry)
        self._iter: Optional[ThreadedIter] = None
        self._stream = None
        self._value: Optional[RowBlock] = None

    def _build_cache(self, parser: Parser, fingerprint,
                     rows_per_page: int) -> None:
        # the PageStore writer owns the pid-unique tmp discipline: two
        # processes racing to build the same cache each build their own
        # tmp, the replaces are atomic, last complete build wins
        w = self._store.writer(self._entry, fingerprint=fingerprint,
                               commit_site="data.pages.commit")
        ok = False
        try:
            out = w.stream
            pending = RowBlockContainer(parser.index_dtype)
            parser.before_first()
            while parser.next():
                block = parser.value()
                if len(block.index):
                    self._max_index = max(self._max_index,
                                          int(block.index.max()))
                start = 0
                while start < block.size:
                    take = min(block.size - start,
                               rows_per_page - pending.size)
                    pending.push_block(block.slice(start,
                                                   start + take))
                    start += take
                    if pending.size >= rows_per_page:
                        pending.save(out)
                        pending.clear()
            if pending.size:
                pending.save(out)
            ok = True
        finally:
            # destroy in a finally: a mid-parse failure under the
            # data.pages.build retry policy must not leak this
            # attempt's native parser
            if hasattr(parser, "destroy"):
                parser.destroy()
            if not ok:
                w.abort()
        w.commit()

    def _open(self) -> None:
        self._close()
        self._stream = self._store.open_read(self._entry)
        if self._stream is None:
            raise DMLCError(
                f"DiskRowIter: page cache {self.cache_file} vanished "
                "(evicted or swept underneath a live iterator?)")

        def _next_page():
            return RowBlockContainer.load_block(self._stream)

        def _rewind():
            self._stream.seek(0)

        self._iter = ThreadedIter(max_capacity=4, name="pages.prefetch")
        self._iter.init(_next_page, _rewind)

    def _close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def before_first(self) -> None:
        if self._iter is None:
            self._open()
        else:
            self._iter.before_first()
        self._value = None

    def next(self) -> bool:
        if self._iter is None:
            self._open()
        block = self._iter.next()
        if block is None:
            return False
        self._value = block
        return True

    def value(self) -> RowBlock:
        check(self._value is not None, "value() before successful next()")
        return self._value

    def num_col(self) -> int:
        return int(self._max_index) + 1

    def __del__(self):
        try:
            self._close()
            self._store.unpin(self._entry)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


# ---------------------------------------------------------------------------
# Round spill store — the page tier of ShardedRowBlockIter steady replay
# ---------------------------------------------------------------------------

_SPILL_MAGIC = 0x53504C4C      # "SPLL"
_SPILL_END_MAGIC = 0x454E4453  # "ENDS"
_SPILL_VERSION = 1        # raw rounds
_SPILL_VERSION_CODEC = 2  # rounds wrapped in io.codec pages: each round
                          # is u64 encoded_len | encode_page(blocks)


def default_spill_dir() -> str:
    """Where fingerprint-keyed spill files live unless the caller names
    a directory (ShardedRowBlockIter(spill_dir=...)) — the port's page
    store root (:func:`~dmlc_tpu_torch.io.pagestore.default_store_dir`,
    ``DMLC_TPU_TORCH_PAGESTORE_DIR``)."""
    return default_store_dir()


# The round table: where each round lies in a spill file and where each
# block's arrays lie inside its round. One row a block, one column each:
# the block's byte position (its page magic), its flags byte, its rows n
# and nonzeros nnz, its index width in bytes, then the byte position of
# each array's data (-1 for an absent one). Positions are relative to
# the round's first byte (for a codec-paged round, of its decoded page).
ROUND_TABLE_COLUMNS = ("block", "flags", "n", "nnz", "index_bytes",
                       "offset", "label", "index", "value", "weight",
                       "qid", "field")
_COL = {name: i for i, name in enumerate(ROUND_TABLE_COLUMNS)}
_MAGIC_BYTES = np.frombuffer(_PAGE_MAGIC.to_bytes(4, "little"), np.uint8)
# the arrays of a RowBlock page in their serialized order, each with the
# flag bit that marks it present (0: always) and the dtypes it may have
_PAGE_ARRAYS = (("offset", 0, ("<i8",)), ("label", 0, ("<f4",)),
                ("index", 0, ("<u4", "<u8")), ("value", 1, ("<f4",)),
                ("weight", 2, ("<f4",)), ("qid", 4, ("<i8",)),
                ("field", 8, ("<i8",)))
# the arrays one a row long (offset n + 1); the others one a nonzero
_ROWS_LONG = ("label", "weight", "qid")


def _block_row(block: RowBlock) -> tuple:
    """(page bytes, table row relative to the page) of ``block`` as
    ``RowBlockContainer.save_block`` writes it: a 6-byte head (magic,
    version, flags), then per array its dtype string, ndim and shape
    (``serializer.write_ndarray``) before its data."""
    flags = ((1 if block.value is not None else 0)
             | (2 if block.weight is not None else 0)
             | (4 if block.qid is not None else 0)
             | (8 if block.field is not None else 0))
    row = [0, flags, block.size, block.nnz, block.index.dtype.itemsize
           ] + [-1] * 7
    pos = 6
    for name, bit, _ in _PAGE_ARRAYS:
        if bit and not flags & bit:
            continue
        a = np.asarray(getattr(block, name))
        pos += 8 + len(a.dtype.newbyteorder("<").str) + 1 + 8 * a.ndim
        row[_COL[name]] = pos
        pos += a.nbytes
    return pos, row


class RoundTable:
    """Where each round of a spill file lies, and each block's arrays in
    it (``ROUND_TABLE_COLUMNS``): ``start`` and ``length`` of the
    round's bytes in the file, ``size`` of the round once decoded (the
    length itself in the raw layout), ``blocks`` int64 ``[rounds,
    nparts, len(ROUND_TABLE_COLUMNS)]``. It lives in memory only: the
    file's bytes are the reference's."""

    def __init__(self, start, length, size, blocks, coded: bool):
        self.start = np.asarray(start, np.int64)
        self.length = np.asarray(length, np.int64)
        self.size = np.asarray(size, np.int64)
        self.blocks = np.asarray(blocks, np.int64)
        self.coded = bool(coded)

    @property
    def max_size(self) -> int:
        """The largest decoded round, in bytes (0 with no round)."""
        return int(self.size.max()) if len(self.size) else 0

    def __eq__(self, other) -> bool:
        return (isinstance(other, RoundTable)
                and self.coded == other.coded
                and all(np.array_equal(getattr(self, k), getattr(other, k))
                        for k in ("start", "length", "size", "blocks")))

    @staticmethod
    def scan(path: str, nparts: int, rounds: int) -> "RoundTable":
        """The table of the spill file at ``path`` by one pass over its
        headers: each array's data is sought past, not read (a codec
        round's page is read and decoded). A header that is not a
        RowBlock page's, or a file that ends early, raises DMLCError."""
        start, length, size, blocks = [], [], [], []
        with create_stream(path, "r") as s:
            meta = _read_spill_header(s)
            coded = meta["_version"] == _SPILL_VERSION_CODEC
            for _ in range(rounds):
                if coded:
                    n = ser.read_u64(s)
                    start.append(s.tell())
                    length.append(n)
                    src = MemoryStream(_codec.decode_page(_read_n(s, n,
                                                                  path)))
                else:
                    start.append(s.tell())
                    src = s
                base = src.tell()
                rows = [_scan_block(src, base, path) for _ in range(nparts)]
                size.append(src.tell() - base)
                if not coded:
                    length.append(size[-1])
                blocks.append(rows)
        return RoundTable(start, length, size,
                          np.asarray(blocks, np.int64).reshape(
                              rounds, nparts, len(ROUND_TABLE_COLUMNS)),
                          coded)


def _read_n(s, n: int, path: str) -> bytes:
    b = s.read(n)
    if len(b) != n:
        raise DMLCError(f"round spill {path}: truncated page stream (file "
                        "changed under an armed replay cache?)")
    return b


def _scan_block(s, base: int, path: str) -> list:
    """One RowBlock page's table row (positions relative to ``base``),
    leaving ``s`` at the page's end."""
    at = s.tell() - base
    head = _read_n(s, 6, path)
    check_eq(int.from_bytes(head[:4], "little"), _PAGE_MAGIC,
             "RowBlock page: bad magic")
    check_eq(head[4], _PAGE_VERSION, "RowBlock page: bad version")
    flags = head[5]
    row = [at, flags, 0, 0, 0] + [-1] * 7
    lengths = {}
    for name, bit, dtypes in _PAGE_ARRAYS:
        if bit and not flags & bit:
            continue
        dt = _read_n(s, int.from_bytes(_read_n(s, 8, path), "little"),
                     path).decode("utf-8", "replace")
        ndim = _read_n(s, 1, path)[0]
        check(dt in dtypes and ndim == 1,
              f"round spill {path}: a block's {name} is {dt!r} of {ndim} "
              f"dims, not 1-D {' or '.join(dtypes)}")
        count = int.from_bytes(_read_n(s, 8, path), "little")
        row[_COL[name]] = s.tell() - base
        lengths[name] = count
        if name == "index":
            row[_COL["index_bytes"]] = int(dt[2:])
        s.seek(s.tell() + count * int(dt[2:]))
    n, nnz = lengths["offset"] - 1, lengths["index"]
    for name, count in lengths.items():
        want = (n + 1 if name == "offset" else
                n if name in _ROWS_LONG else nnz)
        check_eq(count, want, f"round spill {path}: a block's {name} "
                 "length does not match its offset")
    row[_COL["n"]], row[_COL["nnz"]] = n, nnz
    return row


class RoundSpillWriter:
    """Append rounds of raw RowBlocks to a page-store entry; commit
    atomically.

    Layout: header (magic, version, nparts, JSON meta carrying the
    source fingerprint) → ``rounds`` × ``nparts`` RowBlock pages
    (RowBlockContainer.save_block — the DiskRowIter page format) →
    footer (end magic, round count). Writes go to a pid-unique tmp and
    land via an atomic replace only on commit, the fingerprint is
    stamped in the sidecar as well as the header, and committed bytes
    count against the store's byte budget — so a crashed or aborted
    spill never masquerades as a complete cache. As it writes, it keeps
    the file's :class:`RoundTable`, which ``commit`` hands to the
    :class:`RoundSpillFile` it returns.
    """

    def __init__(self, path: str, nparts: int,
                 meta: Optional[dict] = None,
                 codec_level: Optional[int] = None):
        check(1 <= nparts <= 255, "spill nparts out of range")
        self.path = path
        self.nparts = nparts
        self.rounds = 0
        # codec_level None = the process default (DMLC_TPU_PAGE_CODEC_
        # LEVEL); 0 writes the v1 raw layout, >0 the v2 codec-paged one
        self._codec_level = (_codec.default_level() if codec_level is None
                             else int(codec_level))
        version = (_SPILL_VERSION_CODEC if self._codec_level > 0
                   else _SPILL_VERSION)
        meta = dict(meta or {})
        meta["codec"] = _codec.tag(self._codec_level)
        store, entry = PageStore.for_path(path)
        self._w = store.writer(
            entry, fingerprint=meta.get("fingerprint"),
            meta={k: v for k, v in meta.items() if k != "fingerprint"},
            commit_site="spill.commit")
        self._s = self._w.stream
        text = json.dumps(meta)
        ser.write_u32(self._s, _SPILL_MAGIC)
        ser.write_u8(self._s, version)
        ser.write_u8(self._s, nparts)
        ser.write_str(self._s, text)
        # the round table, kept as the rounds are written
        self._pos = 4 + 1 + 1 + 8 + len(text.encode("utf-8"))
        self._start: List[int] = []
        self._length: List[int] = []
        self._size: List[int] = []
        self._blocks: List[list] = []

    def add_row(self, blocks: List[RowBlock]) -> None:
        """One round: exactly ``nparts`` blocks (empty pads included).
        Arrays are serialized immediately, so ephemeral (leased) blocks
        need no copy. With a codec level the round serializes through
        one in-memory page encoded as a self-describing io.codec frame
        (decoded round by round at replay — never the whole file in
        RAM)."""
        check_eq(len(blocks), self.nparts, "spill row width mismatch")
        rows, size = [], 0
        for b in blocks:
            nbytes, row = _block_row(b)
            # the page's positions, from the round's first byte
            row[0] = size
            row[_COL["offset"]:] = [x + size if x >= 0 else x
                                    for x in row[_COL["offset"]:]]
            rows.append(row)
            size += nbytes
        if self._codec_level > 0:
            buf = MemoryStream()
            for b in blocks:
                RowBlockContainer.save_block(b, buf)
            page = _codec.encode_page(buf.getvalue(), self._codec_level)
            ser.write_u64(self._s, len(page))
            self._s.write(page)
            self._start.append(self._pos + 8)
            self._length.append(len(page))
            self._pos += 8 + len(page)
        else:
            for b in blocks:
                RowBlockContainer.save_block(b, self._s)
            self._start.append(self._pos)
            self._length.append(size)
            self._pos += size
        self._size.append(size)
        self._blocks.append(rows)
        self.rounds += 1

    def _table(self) -> RoundTable:
        """The table of the rounds written so far."""
        return RoundTable(self._start, self._length, self._size,
                          np.asarray(self._blocks, np.int64).reshape(
                              self.rounds, self.nparts,
                              len(ROUND_TABLE_COLUMNS)),
                          self._codec_level > 0)

    def commit(self) -> "RoundSpillFile":
        with _trace.span("spill.commit", "io",
                         {"rounds": self.rounds, "path": self.path}):
            ser.write_u32(self._s, _SPILL_END_MAGIC)
            ser.write_u64(self._s, self.rounds)
            self._s = None
            # the PageWriter publishes under the spill.commit retry
            # site: the atomic rename is idempotent, so transient
            # errors (and injected chaos) retry under policy instead
            # of abandoning the spill tier
            self._w.commit()
        return RoundSpillFile(self.path, self.nparts, self.rounds,
                              table=self._table())

    def abort(self) -> None:
        self._s = None
        self._w.abort()


class RoundSpillFile:
    """A committed spill file: sequential round-major replay
    (``iter_rows``), or one round's bytes at a time into a caller's
    buffer (``read_round_into``), located by its :class:`RoundTable`
    (the writer's, or one header scan at first use)."""

    def __init__(self, path: str, nparts: int, rounds: int,
                 table: Optional[RoundTable] = None):
        self.path = path
        self.nparts = nparts
        self.rounds = rounds
        self._table = table
        self._stream = None

    @property
    def table(self) -> RoundTable:
        if self._table is None:
            self._table = RoundTable.scan(self.path, self.nparts,
                                          self.rounds)
        return self._table

    def read_round_into(self, r: int, buf) -> int:
        """Fill the head of ``buf`` (a writable uint8 buffer: a numpy
        array, or a pinned tensor's ``.numpy()``, of at least
        ``table.max_size`` bytes) with round ``r``'s bytes, as
        ``table.blocks[r]`` places its arrays: one ``readinto`` from the
        file (a codec round is read, then decoded into ``buf``). Returns
        the round's size. The stream stays open for the next round until
        :meth:`close`. A file that ends early, or whose pages' heads no
        longer match the table, raises the DMLCError ``iter_rows``
        would."""
        spans, error = self.read_rounds_into(r, r + 1, buf)
        if error is not None:
            raise error
        return spans[0][1]

    def read_rounds_into(self, r0: int, r1: int, buf, stream=None):
        """Rounds ``r0``…``r1 - 1`` into ``buf`` back to back: the raw
        layout's by one ``readinto`` of their span of the file (they lie
        there back to back), a codec file's round by round, each decoded.
        It reads through ``stream`` (one of ``create_stream(path, "r")``,
        the caller's to close), or else through the file's own stream,
        which stays open for the next read until :meth:`close`. Every
        round's page heads are checked against the table. Returns
        ``(spans, error)``: ``spans`` the ``(offset in buf, size)`` of
        each round from ``r0`` on that arrived whole and matches the
        table, and ``error`` None, or the DMLCError ``iter_rows`` would
        raise for the next round (a file that ends early, or pages whose
        heads no longer match the table)."""
        t = self.table
        starts, lengths = t.start[r0:r1], t.length[r0:r1]
        sizes = t.size[r0:r1].tolist()
        if t.coded:
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        else:
            offsets = starts - starts[0]
        total = int(offsets[-1]) + sizes[-1]
        view = memoryview(buf).cast("B")
        check(len(view) >= total, f"round spill: a buffer of {len(view)} "
              f"bytes cannot hold rounds {r0}-{r1 - 1} ({total} bytes)")
        if stream is None:
            if self._stream is None:
                self._stream = create_stream(self.path, "r")
            stream = self._stream
        truncated = DMLCError(
            f"round spill {self.path}: truncated page stream (file changed "
            "under an armed replay cache?)")

        def changed(r):
            return DMLCError(
                f"round spill {self.path}: round {r}'s pages do not match "
                "its table (file changed under an armed replay cache?)")

        whole, error = len(sizes), None
        if t.coded:
            for i in range(len(sizes)):
                stream.seek(int(starts[i]))
                page = stream.read(int(lengths[i]))
                if len(page) != int(lengths[i]):
                    whole, error = i, truncated
                    break
                try:
                    page = _codec.decode_page(page)
                except DMLCError as e:  # a torn frame
                    whole, error = i, e
                    break
                if len(page) != sizes[i]:
                    whole, error = i, changed(r0 + i)
                    break
                at = int(offsets[i])
                view[at:at + sizes[i]] = page
        else:
            stream.seek(int(starts[0]))
            got = 0
            while got < total:
                n = stream.readinto(view[got:total])
                if not n:
                    break
                got += n
            if got < total:
                whole = int(np.searchsorted(offsets + sizes, got,
                                            side="right"))
                error = truncated
        # each block's 6-byte head: magic, version, flags
        rows = t.blocks[r0:r0 + whole]
        at = (offsets[:whole, None] + rows[:, :, _COL["block"]]).reshape(-1)
        heads = np.frombuffer(view, np.uint8, total)[at[:, None]
                                                     + np.arange(6)]
        bad = ((heads[:, :4] != _MAGIC_BYTES).any(1)
               | (heads[:, 4] != _PAGE_VERSION)
               | (heads[:, 5] != rows[:, :, _COL["flags"]].reshape(-1)))
        if bad.any():
            whole = int(np.argmax(bad)) // self.nparts
            error = changed(r0 + whole)
        return list(zip(offsets[:whole].tolist(), sizes[:whole])), error

    def close(self) -> None:
        """Close the stream ``read_round_into`` keeps open."""
        s, self._stream = self._stream, None
        if s is not None:
            s.close()

    def iter_rows(self) -> Iterator[List[RowBlock]]:
        """Yield each round's ``nparts`` raw blocks in written order.
        The header's version picks the layout: v1 rounds are raw block
        pages; v2 rounds are io.codec frames decoded one round at a
        time (memory stays bounded by ONE round either way). Every
        block owns its arrays."""
        s = create_stream(self.path, "r")
        try:
            meta = _read_spill_header(s)  # validates magic + version
            coded = meta["_version"] == _SPILL_VERSION_CODEC

            def load_round() -> List[RowBlock]:
                src = s
                if coded:
                    n = ser.read_u64(s)
                    src = MemoryStream(_codec.decode_page(s.read_exact(n)))
                row = []
                for _ in range(self.nparts):
                    blk = RowBlockContainer.load_block(src)
                    if blk is None:
                        raise DMLCError(
                            f"round spill {self.path}: truncated page "
                            "stream (file changed under an armed "
                            "replay cache?)")
                    row.append(blk)
                return row

            for _ in range(self.rounds):
                yield load_round()
        finally:
            s.close()

    def delete(self) -> None:
        self.close()
        store, entry = PageStore.for_path(self.path)
        store.delete(entry)  # entry + sidecar stamp


class RoundReadAhead:
    """Rounds of a :class:`RoundSpillFile` read ahead on ``readers``
    threads (at least 1), each through a stream of its own
    (``create_stream``, so the ``io.stream.read`` seam and its fault
    plans apply to every read). ``submit(r0, r1, buf, after)`` starts
    ``read_rounds_into(r0, r1, buf)`` on a free reader, then
    ``after(spans)`` there (when given), and returns its Future:
    ``result()`` is ``(spans, error, what after returned)``, or raises
    what the read or ``after`` raised (an I/O error past its retries) in
    the thread that asks. The caller keeps ``buf`` untouched until then,
    and takes the results in its own order. :meth:`close` drops the
    reads not started, waits for the running ones and closes the
    readers' streams."""

    def __init__(self, spill: "RoundSpillFile", readers: int):
        check(readers >= 1, f"RoundReadAhead: readers must be >= 1, got "
              f"{readers}")
        self.file = spill
        self._pool = ThreadPoolExecutor(readers,
                                        thread_name_prefix="spill.read")
        self._local = threading.local()
        self._streams: list = []
        self._lock = threading.Lock()

    def _read(self, r0: int, r1: int, buf, after):
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = create_stream(self.file.path, "r")
            with self._lock:
                self._streams.append(s)
        spans, error = self.file.read_rounds_into(r0, r1, buf, stream=s)
        return spans, error, after(spans) if after is not None else None

    def submit(self, r0: int, r1: int, buf, after=None) -> Future:
        return self._pool.submit(self._read, r0, r1, buf, after)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        with self._lock:
            streams, self._streams = self._streams, []
        for s in streams:
            s.close()


def _read_spill_header(s) -> dict:
    magic = ser.read_u32(s)
    check_eq(magic, _SPILL_MAGIC, "round spill: bad magic")
    version = ser.read_u8(s)
    check(version in (_SPILL_VERSION, _SPILL_VERSION_CODEC),
          f"round spill: bad version {version}")
    nparts = ser.read_u8(s)
    meta = json.loads(ser.read_str(s))
    meta["_nparts"] = nparts
    meta["_version"] = version
    return meta


def read_spill_meta(path: str) -> Optional[dict]:
    """Header meta of a spill file, or None when it is not one."""
    try:
        with create_stream(path, "r") as s:
            return _read_spill_header(s)
    except (OSError, ValueError, DMLCError):  # not a spill file
        return None


def sweep_stale_spill(spill_dir: Optional[str] = None,
                      max_tmp_age_s: float = 600.0) -> int:
    """THE stale sweep, delegated to :meth:`PageStore.sweep`: entries
    whose recorded source fingerprint no longer matches a stat of the
    backing files (sidecar stamp, or the round-spill header via
    ``read_spill_meta``), files whose writer process is dead (crashed
    before its close() could delete them), and orphaned .tmp files
    older than ``max_tmp_age_s`` (younger ones may belong to a live
    writer). Returns entries removed. With ``spill_dir=None`` the sweep
    covers the default store root plus every page-store root this
    process has touched (custom spill dirs, explicit cache paths,
    hydrated remote blocks), and the configured object store's staged
    multipart uploads whose writer process is dead."""
    if spill_dir is None:
        dirs = {default_store_dir()} | set(PageStore.known_roots())
        removed = sum(sweep_stale_spill(d, max_tmp_age_s) for d in dirs)
        try:
            # the multipart leg: a crashed writer's staged objstore
            # parts go by the same pid liveness rule as its .tmp pages
            from dmlc_tpu_torch.io.objstore.multipart import sweep_uploads
            removed += sweep_uploads()
        except Exception:  # noqa: BLE001 — sweep is best-effort
            pass
        return removed
    return PageStore.at(spill_dir).sweep(max_tmp_age_s,
                                         header_meta=read_spill_meta)
