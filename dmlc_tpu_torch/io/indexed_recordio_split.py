"""Indexed RecordIO split: random access by index file, shuffled batch reads.

Reference: src/io/indexed_recordio_split.{h,cc} — IndexedRecordIOSplitter;
index file is text lines ``key\\toffset`` (offsets ascending, byte offset of
each record's first frame in the data file).

Partitioning: each index entry (a record) belongs to the part whose raw
byte range [nstep*k, nstep*(k+1)) contains its offset — same contract as
the byte-range splits, exact at record granularity. With ``shuffle=True``
records are read in batches of ``batch_size`` whose order is permuted by a
seeded RNG, reshuffled every epoch (reference: shuffled batched reads with
derandomizable seed). The shuffle draws from
:func:`dmlc_tpu_torch.shuffle.permutation.epoch_rng`, the reference's
seed law, so one seed gives the reference's order.

A copy of ``dmlc_tpu/io/indexed_recordio_split.py``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch.io.filesys import FileSystem, URI
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.recordio import RecordIOReader
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read, create_stream
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_lt

__all__ = ["IndexedRecordIOSplit"]


class IndexedRecordIOSplit(InputSplit):
    def __init__(self, uri: str, part_index: int, num_parts: int, *,
                 index_uri: Optional[str] = None, shuffle: bool = False,
                 seed: int = 0, batch_size: int = 256):
        spec = URISpec(uri)
        paths = spec.paths()
        check(len(paths) == 1,
              "indexed_recordio expects a single data file")
        self._data_uri = paths[0]
        self._index_uri = index_uri or spec.args.get("index") or (
            self._data_uri + ".idx")
        u = URI(self._data_uri)
        self._file_size = FileSystem.get_instance(u).get_path_info(u).size
        self._entries = self._read_index(self._index_uri, self._file_size)
        self._total = self._file_size
        self._shuffle = shuffle
        self._seed = seed
        self._batch_size = max(1, batch_size)
        self._epoch = 0
        self._bytes_read = 0
        self.reset_partition(part_index, num_parts)

    @staticmethod
    def _read_index(index_uri: str, file_size: int) -> List[Tuple[int, int, int]]:
        """[(key, offset, size)] with sizes from consecutive offsets."""
        with create_stream(index_uri, "r") as s:
            text = s.read_all().decode("utf-8")
        raw: List[Tuple[int, int]] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            check(len(parts) >= 2, f"bad index line {line!r}")
            raw.append((int(parts[0]), int(parts[1])))
        raw.sort(key=lambda kv: kv[1])
        out = []
        for i, (key, off) in enumerate(raw):
            end = raw[i + 1][1] if i + 1 < len(raw) else file_size
            check(end >= off, "index offsets not ascending")
            out.append((key, off, end - off))
        return out

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check_lt(part_index, num_parts)
        nstep = (self._total + num_parts - 1) // num_parts
        lo, hi = nstep * part_index, nstep * (part_index + 1)
        self._mine = [e for e in self._entries if lo <= e[1] < hi]
        self.part_index, self.num_parts = part_index, num_parts
        self.before_first()

    def before_first(self) -> None:
        order = np.arange(len(self._mine))
        if self._shuffle:
            from dmlc_tpu_torch.shuffle.permutation import epoch_rng
            nbatch = (len(order) + self._batch_size - 1) // self._batch_size
            rng = epoch_rng(self._seed, self._epoch)
            batches = [order[b * self._batch_size:(b + 1) * self._batch_size]
                       for b in rng.permutation(nbatch)]
            order = np.concatenate(batches) if batches else order
            self._epoch += 1
        self._order = order
        self._pos = 0
        self._stream = None

    def keys(self) -> List[int]:
        """Index keys of this part's records, in current read order."""
        return [self._mine[i][0] for i in self._order]

    def record_windows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets, sizes) int64 arrays of this part's record windows in
        table order — the data-plane contract for block readers (the
        native engine maps the file and reads windows by id)."""
        offs = np.array([e[1] for e in self._mine], np.int64)
        sizes = np.array([e[2] for e in self._mine], np.int64)
        return offs, sizes

    def next_order_batch(self) -> Optional[np.ndarray]:
        """Record ids (into the part's window table) of the next batch in
        the current epoch order; advances the cursor. None when the epoch
        is exhausted. Shares the cursor with next_record/next_chunk."""
        if self._pos >= len(self._order):
            return None
        b = self._order[self._pos:self._pos + self._batch_size]
        self._pos += len(b)
        return np.ascontiguousarray(b, np.int64)

    def next_record(self) -> Optional[bytes]:
        if self._pos >= len(self._order):
            return None
        _, off, size = self._mine[self._order[self._pos]]
        self._pos += 1
        if self._stream is None:
            self._stream = create_seek_stream_for_read(self._data_uri)
        self._stream.seek(off)
        payload = self._stream.read_exact(size)
        self._bytes_read += size
        rec = RecordIOReader(_BytesStream(payload)).next_record()
        check(rec is not None, "indexed_recordio: empty record at offset")
        return rec

    def next_chunk(self) -> Optional[bytes]:
        """One batch of framed records as a raw chunk."""
        if self._pos >= len(self._order):
            return None
        out = []
        for _ in range(self._batch_size):
            if self._pos >= len(self._order):
                break
            _, off, size = self._mine[self._order[self._pos]]
            self._pos += 1
            if self._stream is None:
                self._stream = create_seek_stream_for_read(self._data_uri)
            self._stream.seek(off)
            out.append(self._stream.read_exact(size))
            self._bytes_read += size
        return b"".join(out)

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        from dmlc_tpu_torch.io.recordio import RecordIOChunkReader
        return iter(RecordIOChunkReader(chunk))

    def get_total_size(self) -> int:
        return self._total

    @property
    def bytes_read(self) -> int:
        return self._bytes_read


class _BytesStream:
    """Minimal read-only Stream over bytes for RecordIOReader."""

    def __init__(self, data: bytes):
        self._d = data
        self._p = 0

    def read(self, n: int) -> bytes:
        b = self._d[self._p:self._p + n]
        self._p += len(b)
        return b

    def read_exact(self, n: int) -> bytes:
        b = self.read(n)
        if len(b) != n:
            raise DMLCError("unexpected EOF in record window")
        return b
