"""Write-through local chunk cache for remote splits.

Reference: src/io/cached_input_split.h — CachedInputSplit (URI suffix
``#cache.file``): first pass streams from the source while writing chunks
to a local cache file; later passes replay the cache (pure local reads).

Cache format: sequence of ``u64 length | chunk bytes``; the cache path is
suffixed with ``.pK-N`` so different (part, num_parts) shards never mix.

Copy of ``dmlc_tpu/io/cached_split.py`` over the port's page store
(:mod:`dmlc_tpu_torch.io.pagestore`): the first pass writes through a
:class:`~dmlc_tpu_torch.io.pagestore.PageWriter` (pid-unique tmp, atomic
commit) and the committed entry is STAMPED with the source fingerprint
(``[[path, size, mtime_ns], ...]`` of the base split's files). A lookup
against the current fingerprint detects a changed source and RE-RUNS the
first pass instead of replaying stale bytes, and the entry participates
in the one store sweep and byte budget. The byte format and the entry
names are the reference's, so either package replays the other's cache.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.pagestore import PageStore, stat_fingerprint
from dmlc_tpu_torch.utils.logging import check

__all__ = ["CachedInputSplit"]


class CachedInputSplit(InputSplit):
    def __init__(self, base: InputSplit, cache_file: str):
        self._base = base
        self._cache_template = cache_file
        self._configure_paths()
        self._reader = None
        self._writer = None
        self._bytes = 0

    def _configure_paths(self) -> None:
        part = getattr(self._base, "part_index", 0)
        npart = getattr(self._base, "num_parts", 1)
        self._cache_path = f"{self._cache_template}.p{part}-{npart}"
        self._store, self._entry = PageStore.for_path(self._cache_path)

    def _fingerprint(self):
        """Current ``[[path, size, mtime_ns], ...]`` of the base
        split's backing files, or None when they cannot be stat'ed
        (the cache then trusts its existence — the fallback when a
        base split does not expose its file list)."""
        files = getattr(self._base, "_files", None)
        if not files:
            return None
        try:
            return stat_fingerprint(p for p, _ in files)
        except Exception:  # noqa: BLE001 — non-stat-able source
            return None

    def before_first(self) -> None:
        self._recbuf = None
        self._recpos = 0
        self._bytes = 0
        if self._writer is not None:
            # torn pass: discard partial cache
            self._writer.abort()
            self._writer = None
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        # one lookup per pass: a committed entry whose stamp matches
        # the CURRENT source fingerprint replays; a stale stamp deletes
        # the entry (lookup counts the miss) and the first pass re-runs
        fp = self._fingerprint()
        cached = self._store.lookup(self._entry, fingerprint=fp)
        if cached is None:
            self._base.before_first()
            self._writer = self._store.writer(self._entry,
                                              fingerprint=fp)
        else:
            self._reader = self._store.open_read(self._entry)
            if self._reader is None:  # evicted between lookup and open
                self._base.before_first()
                self._writer = self._store.writer(self._entry,
                                                  fingerprint=fp)

    def next_chunk(self) -> Optional[bytes]:
        if self._reader is None and self._writer is None:
            self.before_first()
        if self._reader is not None:
            head = self._reader.read(8)
            if len(head) < 8:
                return None
            (n,) = struct.unpack("<Q", head)
            chunk = self._reader.read_exact(n) if n else b""
            check(len(chunk) == n, "cache file truncated")
            self._bytes += n
            return chunk
        chunk = self._base.next_chunk()
        if chunk is None:
            # atomic commit + fingerprint stamp (replaces the old
            # trust-forever .done marker)
            self._writer.commit()
            self._writer = None
            return None
        self._writer.write(struct.pack("<Q", len(chunk)))
        self._writer.write(chunk)
        self._bytes += len(chunk)
        return chunk

    def next_record(self) -> Optional[bytes]:
        while True:
            buf = getattr(self, "_recbuf", None)
            pos = getattr(self, "_recpos", 0)
            if buf is not None and pos < len(buf):
                self._recpos = pos + 1
                return buf[pos]
            chunk = self.next_chunk()
            if chunk is None:
                self._recbuf = None
                return None
            self._recbuf = list(self.extract_records(chunk))
            self._recpos = 0

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return self._base.extract_records(chunk)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._base.reset_partition(part_index, num_parts)
        if self._writer is not None:
            self._writer.abort()
            self._writer = None
        self._configure_paths()
        self._reader = None
        self.before_first()

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    @property
    def bytes_read(self) -> int:
        return self._bytes
