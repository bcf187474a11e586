"""Chunk-level shuffled input split.

Reference: include/dmlc/input_split_shuffle.h — InputSplitShuffle::Create(
uri, part_index, num_parts, type, num_shuffle_parts, seed): the shard is
subdivided into ``num_shuffle_parts`` sub-shards whose read order is
permuted by a seeded RNG, reshuffled each epoch — coarse-grained shuffling
with deterministic replay (same seed + epoch ⇒ same order), which is the
property that makes data-side recovery trivial.

Copy of ``dmlc_tpu/io/input_split_shuffle.py``: the order is drawn from
the one seed law (``shuffle.permutation.epoch_rng``), so the port's
shuffled record sequence is the reference's.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.utils.logging import check

__all__ = ["InputSplitShuffle"]


class InputSplitShuffle(InputSplit):
    def __init__(self, uri: str, part_index: int, num_parts: int,
                 split_type: str = "text", num_shuffle_parts: int = 4,
                 seed: int = 0, **kwargs):
        check(num_shuffle_parts >= 1, "num_shuffle_parts must be >= 1")
        self._subs: List[InputSplit] = [
            InputSplit.create(uri, part_index * num_shuffle_parts + i,
                              num_parts * num_shuffle_parts, split_type,
                              **kwargs)
            for i in range(num_shuffle_parts)]
        self._seed = seed
        self._epoch = 0
        self.part_index, self.num_parts = part_index, num_parts
        self._num_shuffle_parts = num_shuffle_parts
        self._split_type = split_type
        self._uri = uri
        self._kwargs = kwargs
        self.before_first()

    @staticmethod
    def create(uri: str, part_index: int, num_parts: int,
               split_type: str = "text", num_shuffle_parts: int = 4,
               seed: int = 0, **kwargs) -> "InputSplitShuffle":
        """Reference: InputSplitShuffle::Create."""
        if num_shuffle_parts <= 1:
            return InputSplit.create(uri, part_index, num_parts, split_type,
                                     **kwargs)
        return InputSplitShuffle(uri, part_index, num_parts, split_type,
                                 num_shuffle_parts, seed, **kwargs)

    def before_first(self) -> None:
        from dmlc_tpu_torch.shuffle.permutation import epoch_rng
        rng = epoch_rng(self._seed, self._epoch)
        self._order = rng.permutation(len(self._subs))
        self._epoch += 1
        self._cursor = 0
        for s in self._subs:
            s.before_first()

    def _current(self) -> Optional[InputSplit]:
        if self._cursor >= len(self._order):
            return None
        return self._subs[self._order[self._cursor]]

    def next_record(self) -> Optional[bytes]:
        while True:
            cur = self._current()
            if cur is None:
                return None
            rec = cur.next_record()
            if rec is not None:
                return rec
            self._cursor += 1

    def next_chunk(self) -> Optional[bytes]:
        while True:
            cur = self._current()
            if cur is None:
                return None
            chunk = cur.next_chunk()
            if chunk is not None:
                return chunk
            self._cursor += 1

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return self._subs[0].extract_records(chunk)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self.__init__(self._uri, part_index, num_parts, self._split_type,
                      self._num_shuffle_parts, self._seed, **self._kwargs)

    def get_total_size(self) -> int:
        return self._subs[0].get_total_size()

    @property
    def bytes_read(self) -> int:
        return sum(s.bytes_read for s in self._subs)
