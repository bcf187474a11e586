"""Deterministic sharded input splitting with record-boundary realignment.

Reference: src/io/input_split_base.{h,cc} (InputSplitBase: prefix-sum file
sizes → per-part byte range → SeekRecordBegin realignment; Chunk reads),
src/io/line_split.{h,cc} (LineSplitter), include/dmlc/io.h (InputSplit decl).

### The sharding contract (frozen; the same rule as dmlc_tpu's)

Files are logically concatenated in listing order into a global byte space of
size ``total``. For ``num_parts`` parts, with
``nstep = ceil(total / num_parts)``, part ``k`` owns the raw byte range
``[min(nstep*k, total), min(nstep*(k+1), total))``, each endpoint aligned
down to ``align_bytes`` and then *realigned forward* to a record boundary by
the shared rule ``boundary(x)``:

- ``boundary(x) = x`` if x is 0, total, or a file boundary;
- otherwise scan forward from x **through** the next record terminator to
  the start of the following record (clipped at the containing file's end).

Because both a part's begin and its predecessor's end are computed by the
*same* ``boundary`` function, every record lands in exactly one part —
coverage and no-overlap hold for any (num_parts, chunk size, file layout).

Record definitions:
- text: a record is a maximal run of bytes containing no '\\n'/'\\r'
  (empty lines yield no records; CRLF-safe). Terminator scan = skip to
  first newline byte, then past the newline run.
- recordio: a record is a RecordIO frame sequence (multi-frame records are
  kept whole); boundary scan = next 4-aligned magic whose frame cflag is
  whole(0) or start(1) — continuation frames are not record starts
  (reference: src/io/recordio_split.cc).

The text, recordio and indexed-recordio splits, the stdin split (``"-"``)
and '#cache' URIs (``CachedInputSplit``) are ported.
"""

from __future__ import annotations

import struct
import sys
from bisect import bisect_right
from typing import Iterator, List, Optional, Tuple

from dmlc_tpu_torch.io.filesys import FileSystem, URI
from dmlc_tpu_torch.io.recordio import (
    RECORDIO_MAGIC, RecordIOChunkReader, decode_flag, decode_length,
)
from dmlc_tpu_torch.io.stream import SeekStream
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_lt

__all__ = ["InputSplit", "list_split_files"]

_DEFAULT_CHUNK = 8 << 20  # 8 MiB — reference uses MB-scale chunk buffers
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)


def list_split_files(uri: str) -> List[Tuple[str, int]]:
    """Expand a (possibly ';'-joined, possibly directory) URI into
    [(path, size)] with size>0, sorted within each directory.

    Reference: InputSplitBase::Init's ListDirectory expansion.
    """
    spec = URISpec(uri)
    out: List[Tuple[str, int]] = []
    for path in spec.paths():
        u = URI(path)
        fs = FileSystem.get_instance(u)
        info = fs.get_path_info(u)
        if info.type == "directory":
            for fi in fs.list_directory(u):
                if fi.type == "file" and fi.size > 0:
                    out.append((fi.path, fi.size))
        elif info.size > 0:
            out.append((info.path, info.size))
    if not out:
        raise DMLCError(f"InputSplit: no non-empty input files match {uri!r}")
    return out


class InputSplit:
    """Pull-based reader over one shard of a sharded dataset.

    Reference: dmlc::InputSplit (include/dmlc/io.h) — NextRecord/NextChunk/
    BeforeFirst/ResetPartition/GetTotalSize. Create via :meth:`create`.
    """

    # -- factory

    @staticmethod
    def create(uri: str, part_index: int, num_parts: int,
               split_type: str = "text", *, chunk_size: int = _DEFAULT_CHUNK,
               shuffle: bool = False, seed: int = 0,
               batch_size: int = 256) -> "InputSplit":
        """Reference: InputSplit::Create (src/io.cc).

        split_type: "text" | "recordio" | "indexed_recordio". The URI
        "-" reads text records from stdin (one part). A '#cachefile' URI
        suffix wraps the split in a disk cache (reference:
        CachedInputSplit); shuffle, seed and batch_size apply to
        indexed_recordio (its seeded per-epoch batch shuffle)."""
        check_lt(part_index, num_parts, "part_index must be < num_parts")
        spec = URISpec(uri)
        if spec.uri == "-":
            check(split_type == "text",
                  f"stdin split supports only text records, "
                  f"not {split_type!r}")
            check(num_parts == 1,
                  "stdin split has exactly one part (a pipe cannot be "
                  "byte-range sharded)")
            return _StdinSplit(chunk_size=chunk_size)
        if split_type == "text":
            split: InputSplit = _TextSplit(uri, part_index, num_parts,
                                           chunk_size=chunk_size)
        elif split_type == "recordio":
            split = _RecordIOSplit(uri, part_index, num_parts,
                                   chunk_size=chunk_size)
        elif split_type == "indexed_recordio":
            from dmlc_tpu_torch.io.indexed_recordio_split import (
                IndexedRecordIOSplit)
            split = IndexedRecordIOSplit(
                uri, part_index, num_parts, shuffle=shuffle, seed=seed,
                batch_size=batch_size)
        else:
            raise DMLCError(f"unknown split_type {split_type!r}")
        if spec.cache_file:
            from dmlc_tpu_torch.io.cached_split import CachedInputSplit
            split = CachedInputSplit(split, spec.cache_file)
        return split

    # -- interface

    def next_record(self) -> Optional[bytes]:
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        """A buffer of whole records (zero or more chunks per shard)."""
        raise NotImplementedError

    def next_batch(self, n_records: int) -> Optional[List[bytes]]:
        """Up to n_records records; None at end of shard (reference:
        InputSplit::NextBatch, include/dmlc/io.h)."""
        check(n_records > 0,
              "next_batch(n_records) needs n_records >= 1: a zero-size "
              "request would be indistinguishable from end-of-shard (None)")
        out: List[bytes] = []
        while len(out) < n_records:
            rec = self.next_record()
            if rec is None:
                break
            out.append(rec)
        return out or None

    def before_first(self) -> None:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise NotImplementedError

    def get_total_size(self) -> int:
        raise NotImplementedError

    @property
    def bytes_read(self) -> int:
        raise NotImplementedError

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        """Split a chunk (as produced by next_chunk) into records."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[bytes]:
        self.before_first()
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


class _StdinSplit(InputSplit):
    """Degenerate single-part split over stdin (reference:
    src/io/single_file_split.h — the "-" URI path). One pass only;
    before_first after consumption raises (a pipe cannot rewind)."""

    rewindable = False  # a pipe cannot seek; parsers skip prefetch

    def __init__(self, chunk_size: int = _DEFAULT_CHUNK):
        self._consumed = False
        self._recbuf: List[bytes] = []
        self._recpos = 0
        self._bytes = 0
        self._chunk_size = max(chunk_size, 64 * 1024)
        self._leftover = b""
        self._eof = False

    def next_chunk(self) -> Optional[bytes]:
        """Bounded streaming read with partial-line carry — a piped
        50 GB stream never lives in memory at once."""
        while not self._eof:
            self._consumed = True
            raw = sys.stdin.buffer.read(self._chunk_size)
            if not raw:
                self._eof = True
                break
            self._bytes += len(raw)
            combined = self._leftover + raw
            cut = max(combined.rfind(b"\n"), combined.rfind(b"\r")) + 1
            if cut == 0:
                self._leftover = combined
                continue
            self._leftover = combined[cut:]
            return combined[:cut]
        if self._leftover:
            tail, self._leftover = self._leftover, b""
            return tail
        return None

    def next_record(self) -> Optional[bytes]:
        while self._recpos >= len(self._recbuf):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._recbuf = list(self.extract_records(chunk))
            self._recpos = 0
        rec = self._recbuf[self._recpos]
        self._recpos += 1
        return rec

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for line in chunk.splitlines():
            if line:
                yield line

    def before_first(self) -> None:
        if not self._consumed:
            return  # fresh stream: nothing to rewind
        if self._recbuf:
            self._recpos = 0  # replay buffered records
        else:
            raise DMLCError("stdin split cannot rewind")

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check(num_parts == 1, "stdin split has exactly one part")

    def get_total_size(self) -> int:
        return self._bytes

    @property
    def bytes_read(self) -> int:
        return self._bytes


class _AlignedSplitBase(InputSplit):
    """Byte-range sharding engine (reference: InputSplitBase)."""

    def __init__(self, uri: str, part_index: int, num_parts: int, *,
                 align_bytes: int, chunk_size: int):
        self._uri = uri
        self._files = list_split_files(uri)
        self._prefix = [0]
        for _, size in self._files:
            self._prefix.append(self._prefix[-1] + size)
        self._total = self._prefix[-1]
        self._align = align_bytes
        self._chunk_size = max(chunk_size, 64 * 1024)
        self._fs_cache: dict = {}
        self._bytes_read = 0
        self.reset_partition(part_index, num_parts)

    # -- shared machinery

    def _open_at(self, global_offset: int) -> Tuple[SeekStream, int, int]:
        """(stream positioned at global_offset, file_index, file_end_global)."""
        i = bisect_right(self._prefix, global_offset) - 1
        if i >= len(self._files):
            i = len(self._files) - 1
        path = self._files[i][0]
        u = URI(path)
        fs = FileSystem.get_instance(u)
        stream = fs.open_for_read(u)
        stream.seek(global_offset - self._prefix[i])
        return stream, i, self._prefix[i + 1]

    def _boundary(self, x: int) -> int:
        """First record start at-or-after raw offset x (the shared rule)."""
        if x <= 0:
            return 0
        if x >= self._total:
            return self._total
        i = bisect_right(self._prefix, x) - 1
        if x == self._prefix[i]:
            return x  # file boundary is a record boundary
        stream, _, file_end = self._open_at(x)
        try:
            skipped = self._seek_record_begin(stream)
        finally:
            stream.close()
        return min(x + skipped, file_end)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check_lt(part_index, num_parts)
        nstep = (self._total + num_parts - 1) // num_parts
        raw_begin = min(nstep * part_index, self._total)
        raw_end = min(nstep * (part_index + 1), self._total)
        if self._align > 1:
            raw_begin -= raw_begin % self._align
            raw_end -= raw_end % self._align
        self._begin = self._boundary(raw_begin)
        self._end = self._boundary(raw_end)
        self.part_index = part_index
        self.num_parts = num_parts
        self.before_first()

    def before_first(self) -> None:
        old = getattr(self, "_stream", None)
        if old is not None:
            old.close()
        self._cur = self._begin
        self._stream: Optional[SeekStream] = None
        self._file_end = 0
        self._leftover = b""
        self._record_buf: List[bytes] = []
        self._record_pos = 0
        self._bytes_read = 0

    def get_total_size(self) -> int:
        return self._total

    @property
    def bytes_read(self) -> int:
        return self._bytes_read

    def next_chunk(self) -> Optional[bytes]:
        """Next buffer of whole records within [begin, end)."""
        while True:
            if self._cur >= self._end and not self._leftover:
                return None
            if self._stream is None and self._cur < self._end:
                self._stream, _, self._file_end = self._open_at(self._cur)
            want = min(self._chunk_size,
                       self._file_end - self._cur,
                       self._end - self._cur)
            raw = self._stream.read(want) if want > 0 else b""
            if want > 0 and not raw:
                # EOF inside the recorded byte range: the backing file
                # SHRANK after the split captured its sizes. Without
                # this check the loop would spin forever re-reading 0
                # bytes (cur never advances to the recorded end).
                raise DMLCError(
                    f"InputSplit: unexpected EOF at global offset "
                    f"{self._cur} ({min(self._file_end, self._end) - self._cur} "
                    f"bytes short of the recorded range) — the backing "
                    f"file shrank after the split was created; recreate "
                    f"the split after mutating inputs")
            self._bytes_read += len(raw)
            self._cur += len(raw)
            at_file_end = self._cur >= min(self._file_end, self._end)
            combined = self._leftover + raw if self._leftover else raw
            if at_file_end:
                # file (or shard) exhausted: everything left is whole records
                self._stream.close()
                self._stream = None
                self._leftover = b""
                if self._cur >= self._end:
                    self._cur = self._end
                if combined:
                    return combined
                continue
            cut = self._find_last_record_end(combined)
            if cut == 0:
                # no complete record in buffer: grow it
                self._leftover = combined
                continue
            self._leftover = combined[cut:]
            return combined[:cut]

    def next_record(self) -> Optional[bytes]:
        while self._record_pos >= len(self._record_buf):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._record_buf = list(self.extract_records(chunk))
            self._record_pos = 0
        rec = self._record_buf[self._record_pos]
        self._record_pos += 1
        return rec

    # -- format-specific hooks

    def _seek_record_begin(self, stream: SeekStream) -> int:
        """Bytes to skip from the stream position to the next record start
        (reference: LineSplitter/RecordIOSplitter::SeekRecordBegin)."""
        raise NotImplementedError

    def _find_last_record_end(self, buf: bytes) -> int:
        """Largest prefix length of buf consisting of whole records
        (reference: InputSplitBase::FindLastRecordBegin)."""
        raise NotImplementedError


class _TextSplit(_AlignedSplitBase):
    """Line records (reference: src/io/line_split.cc)."""

    def __init__(self, uri: str, part_index: int, num_parts: int, *,
                 chunk_size: int = _DEFAULT_CHUNK):
        super().__init__(uri, part_index, num_parts, align_bytes=1,
                         chunk_size=chunk_size)

    def _seek_record_begin(self, stream: SeekStream) -> int:
        nstep = 0
        found = False
        while True:
            buf = stream.read(64 * 1024)
            if not buf:
                return nstep
            i = 0
            if not found:
                jn = buf.find(b"\n")
                jr = buf.find(b"\r")
                j = min(x for x in (jn, jr) if x >= 0) if (jn >= 0 or jr >= 0) else -1
                if j < 0:
                    nstep += len(buf)
                    continue
                nstep += j + 1
                found = True
                i = j + 1
            while i < len(buf):
                if buf[i] in (10, 13):
                    nstep += 1
                    i += 1
                else:
                    return nstep
            # buffer ended inside newline run: keep scanning

    def _find_last_record_end(self, buf: bytes) -> int:
        n = max(buf.rfind(b"\n"), buf.rfind(b"\r"))
        return n + 1 if n >= 0 else 0

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for line in chunk.splitlines():
            if line:
                yield line


class _RecordIOSplit(_AlignedSplitBase):
    """RecordIO frame records (reference: src/io/recordio_split.cc)."""

    def __init__(self, uri: str, part_index: int, num_parts: int, *,
                 chunk_size: int = _DEFAULT_CHUNK):
        super().__init__(uri, part_index, num_parts, align_bytes=4,
                         chunk_size=chunk_size)

    def _seek_record_begin(self, stream: SeekStream) -> int:
        """Scan 4-aligned words for a frame head that *starts* a record."""
        nstep = 0
        window = b""
        while True:
            buf = stream.read(64 * 1024)
            if not buf:
                return nstep + len(window)
            window += buf
            pos = 0
            while pos + 8 <= len(window):
                if window[pos:pos + 4] == _MAGIC_BYTES:
                    lrec = struct.unpack_from("<I", window, pos + 4)[0]
                    if decode_flag(lrec) in (0, 1):
                        return nstep + pos
                pos += 4
            nstep += pos
            window = window[pos:]

    def _find_last_record_end(self, buf: bytes) -> int:
        pos = 0
        complete_end = 0
        n = len(buf)
        in_multi = False
        while pos + 8 <= n:
            magic, lrec = struct.unpack_from("<II", buf, pos)
            check(magic == RECORDIO_MAGIC,
                  "RecordIO split: lost frame alignment")
            clen = decode_length(lrec)
            cflag = decode_flag(lrec)
            frame_end = pos + 8 + clen + ((-clen) % 4)
            if frame_end > n:
                break
            if cflag == 0:
                complete_end = frame_end
                in_multi = False
            elif cflag == 1:
                in_multi = True
            elif cflag == 3:
                check(in_multi, "RecordIO split: end-frame without start")
                complete_end = frame_end
                in_multi = False
            pos = frame_end
        return complete_end

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return iter(RecordIOChunkReader(chunk))
