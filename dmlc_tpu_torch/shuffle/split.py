"""`GlobalShuffleSplit` — the InputSplit face of the global shuffle.

Copy of ``dmlc_tpu/shuffle/split.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Adapts a :class:`~dmlc_tpu_torch.shuffle.exchange.ShuffleReader` to the
InputSplit pull contract so the python parse engine (and therefore
``Pipeline.from_uri(...).shuffle(global_seed=...)``) consumes the
seeded global order like any other split.  ``part_index/num_parts``
play the gang's ``rank/world``: each part delivers the positions
``p % num_parts == part_index`` of the SAME global order, so the
parts' streams round-robin-merge back into one world-independent
sequence (the determinism contract).

Epoch law matches IndexedRecordIOSplit's shuffled mode: the first
``before_first()`` serves the constructed epoch (resuming from
``start_position`` if given); every later ``before_first()`` advances
to the next epoch's order.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.pagestore import PageStore
from dmlc_tpu_torch.shuffle.exchange import (
    DEFAULT_WINDOW_BYTES, ShuffleReader, install_view,
)
from dmlc_tpu_torch.shuffle.index import build_record_index
from dmlc_tpu_torch.utils.logging import check

__all__ = ["GlobalShuffleSplit"]

_RECORDIO_TYPES = ("recordio", "recordio_dense", "recordio_image",
                   "indexed_recordio")


class GlobalShuffleSplit(InputSplit):
    rewindable = True

    def __init__(self, uri: str, part_index: int, num_parts: int,
                 split_type: str = "text", *, seed: int = 0,
                 window_bytes: int = DEFAULT_WINDOW_BYTES,
                 epoch: int = 0, start_position: int = 0,
                 chunk_records: int = 256,
                 store: Optional[PageStore] = None,
                 install: bool = True):
        self._index = build_record_index(uri, split_type, store=store)
        self._reader = ShuffleReader(
            self._index, seed, window_bytes, rank=part_index,
            world=num_parts, epoch=epoch,
            start_position=start_position, store=store)
        if install:
            install_view(self._reader)
        self._split_type = split_type
        self._chunk_records = max(1, int(chunk_records))
        self._bytes_read = 0
        self._started = False
        self.part_index, self.num_parts = part_index, num_parts

    @property
    def reader(self) -> ShuffleReader:
        """The underlying cursor (reshard hooks, /shuffle view,
        position watermark for mid-epoch checkpointing)."""
        return self._reader

    # -- InputSplit interface

    def before_first(self) -> None:
        if self._started:
            self._reader.next_epoch()
        self._started = True

    def next_record(self) -> Optional[bytes]:
        span = self._reader.next_record_span()
        if span is None:
            return None
        self._started = True
        self._bytes_read += len(span)
        if self._split_type in _RECORDIO_TYPES:
            recs = list(self.extract_records(span))
            check(len(recs) == 1,
                  f"shuffle: window slice held {len(recs)} records, "
                  "expected exactly one (index out of step with data?)")
            return recs[0]
        return span

    def next_chunk(self) -> Optional[bytes]:
        """Up to ``chunk_records`` raw spans of the rank's order as
        one parseable chunk (framed for the RecordIO family, newline
        re-joined for text)."""
        spans: List[bytes] = []
        for _ in range(self._chunk_records):
            span = self._reader.next_record_span()
            if span is None:
                break
            spans.append(span)
            self._bytes_read += len(span)
        if not spans:
            return None
        self._started = True
        if self._split_type in _RECORDIO_TYPES:
            return b"".join(spans)
        return b"\n".join(spans) + b"\n"

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        if self._split_type in _RECORDIO_TYPES:
            from dmlc_tpu_torch.io.recordio import RecordIOChunkReader
            return iter(RecordIOChunkReader(chunk))
        return iter([ln for ln in chunk.splitlines() if ln])

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Re-partition and rewind to the epoch's start.  (Elastic
        mid-epoch resharding goes through ``reader.reshard``, which
        keeps the position watermark.)"""
        self._reader.reshard(part_index, num_parts, position=0)
        self.part_index, self.num_parts = part_index, num_parts

    def get_total_size(self) -> int:
        return self._index.total_bytes

    @property
    def bytes_read(self) -> int:
        return self._bytes_read
