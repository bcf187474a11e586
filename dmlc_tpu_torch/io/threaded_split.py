"""Background chunk-prefetch wrapper for any InputSplit.

Reference: src/io/threaded_input_split.h — ThreadedInputSplit wraps an
InputSplitBase in a ThreadedIter<Chunk> so disk/network reads overlap with
parsing on the consumer thread.

Copy of ``dmlc_tpu/io/threaded_split.py`` over the port's ThreadedIter.
"""

from __future__ import annotations

from typing import Iterator, Optional

from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.input_split import InputSplit

__all__ = ["ThreadedInputSplit"]


class ThreadedInputSplit(InputSplit):
    def __init__(self, base: InputSplit, max_capacity: int = 4):
        self._base = base
        self._iter = ThreadedIter(max_capacity=max_capacity,
                                  name="split.chunks")
        self._iter.init(base.next_chunk, base.before_first)
        self._recbuf = []
        self._recpos = 0

    def next_chunk(self) -> Optional[bytes]:
        return self._iter.next()

    def next_record(self) -> Optional[bytes]:
        while self._recpos >= len(self._recbuf):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._recbuf = list(self._base.extract_records(chunk))
            self._recpos = 0
        rec = self._recbuf[self._recpos]
        self._recpos += 1
        return rec

    def before_first(self) -> None:
        self._iter.before_first()
        self._recbuf, self._recpos = [], 0

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._iter.destroy()
        self._base.reset_partition(part_index, num_parts)
        self._iter = ThreadedIter(max_capacity=4, name="split.chunks")
        self._iter.init(self._base.next_chunk, self._base.before_first)
        self._recbuf, self._recpos = [], 0

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return self._base.extract_records(chunk)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    @property
    def bytes_read(self) -> int:
        return self._base.bytes_read

    def destroy(self) -> None:
        self._iter.destroy()
