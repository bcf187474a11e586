"""Disk-cached row-block iteration, plus the round spill store backing
ShardedRowBlockIter's page-tier steady replay.

Counterpart of ``dmlc_tpu/data/row_iter.py``. Reference:
src/data/disk_row_iter.h (DiskRowIter<I> — parse once, spill binary
pages to a cache file, then replay pages with ThreadedIter prefetch).

The spill store (RoundSpillWriter / RoundSpillFile) is DiskRowIter's
page format generalized to ROUNDS: each round is a fixed-width row of
``nparts`` raw (unpadded) RowBlocks, written round-major as the replay
tee assembles them, fingerprint-stamped in the header so staleness is
self-describing (``sweep_stale_spill``), committed atomically via
tmp + rename. ShardedRowBlockIter replays these rounds on steady epochs
when the in-memory tier would exceed ``agreement_cache_bytes``.

Both tiers route their on-disk bytes through the port's
:class:`dmlc_tpu_torch.io.pagestore.PageStore`: one atomic tmp+rename
commit protocol, one fingerprint-stamped sidecar, one byte budget with
LRU eviction, and ONE stale sweep. Files are byte-identical to the
reference's for the same blocks, rounds and meta, and each package
reads the other's.

Trimmed from the reference:
- ``RowBlockIter.create`` (the ``#cache`` URI hint) and
  ``BasicRowIter``: ``Pipeline.cache`` keeps its memory tier itself;
- the retry of DiskRowIter's build (site ``data.pages.build``) and of
  the commits (``data.pages.commit``, ``spill.commit``): the port makes
  one attempt, as the resilience plane is not ported;
- the ``spill.commit`` trace span and ``sweep_stale_spill``'s objstore
  multipart leg (the obs and objstore planes are not ported).
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional

from dmlc_tpu_torch.data.parser import DataIter, Parser
from dmlc_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io import codec as _codec
from dmlc_tpu_torch.io.pagestore import PageStore, default_store_dir
from dmlc_tpu_torch.io.stream import MemoryStream, create_stream
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq

__all__ = ["DiskRowIter", "RoundSpillWriter", "RoundSpillFile",
           "default_spill_dir", "read_spill_meta", "sweep_stale_spill"]


class DiskRowIter(DataIter):
    """Parse once → binary page cache → threaded page replay
    (reference: DiskRowIter<I>, pages via RowBlockContainer::Save/Load).

    The cache is a :class:`~dmlc_tpu_torch.io.pagestore.PageStore`
    entry: built into a pid-unique tmp and published atomically,
    stamped with the source ``fingerprint`` when the caller provides one
    (a stamped cache whose sources changed is rebuilt instead of
    replayed — and reclaimed by the one stale sweep), accounted against
    the store's byte budget, and pinned against LRU eviction while this
    iterator lives. ``parser_factory`` is a Parser or a callable that
    makes one; the build makes one attempt."""

    def __init__(self, parser_factory, cache_file: str,
                 rows_per_page: int = 64 << 10, fingerprint=None):
        self.cache_file = cache_file
        self._store, self._entry = PageStore.for_path(cache_file)
        self._max_index = 0
        present = (self._store.lookup(self._entry, fingerprint=fingerprint)
                   is not None)
        if not present:
            parser = (parser_factory() if callable(parser_factory)
                      else parser_factory)
            self._build_cache(parser, fingerprint, rows_per_page)
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
        w = self._store.writer(self._entry, fingerprint=fingerprint)
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
            # a mid-parse failure must not leak the native parser
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
    spill never masquerades as a complete cache.
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
            meta={k: v for k, v in meta.items() if k != "fingerprint"})
        self._s = self._w.stream
        ser.write_u32(self._s, _SPILL_MAGIC)
        ser.write_u8(self._s, version)
        ser.write_u8(self._s, nparts)
        ser.write_str(self._s, json.dumps(meta))

    def add_row(self, blocks: List[RowBlock]) -> None:
        """One round: exactly ``nparts`` blocks (empty pads included).
        Arrays are serialized immediately, so ephemeral (leased) blocks
        need no copy. With a codec level the round serializes through
        one in-memory page encoded as a self-describing io.codec frame
        (decoded round by round at replay — never the whole file in
        RAM)."""
        check_eq(len(blocks), self.nparts, "spill row width mismatch")
        if self._codec_level > 0:
            buf = MemoryStream()
            for b in blocks:
                RowBlockContainer.save_block(b, buf)
            page = _codec.encode_page(buf.getvalue(), self._codec_level)
            ser.write_u64(self._s, len(page))
            self._s.write(page)
        else:
            for b in blocks:
                RowBlockContainer.save_block(b, self._s)
        self.rounds += 1

    def commit(self) -> "RoundSpillFile":
        ser.write_u32(self._s, _SPILL_END_MAGIC)
        ser.write_u64(self._s, self.rounds)
        self._s = None
        self._w.commit()
        return RoundSpillFile(self.path, self.nparts, self.rounds)

    def abort(self) -> None:
        self._s = None
        self._w.abort()


class RoundSpillFile:
    """A committed spill file: sequential round-major replay."""

    def __init__(self, path: str, nparts: int, rounds: int):
        self.path = path
        self.nparts = nparts
        self.rounds = rounds

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
        store, entry = PageStore.for_path(self.path)
        store.delete(entry)  # entry + sidecar stamp


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
    process has touched."""
    if spill_dir is None:
        dirs = {default_store_dir()} | set(PageStore.known_roots())
        return sum(sweep_stale_spill(d, max_tmp_age_s) for d in dirs)
    return PageStore.at(spill_dir).sweep(max_tmp_age_s,
                                         header_meta=read_spill_meta)
