"""The index plane: per-format record indexes with committed sidecars.

Copy of ``dmlc_tpu/shuffle/index.py`` with its imports rewritten to
``dmlc_tpu_torch``: the same scans, the same sidecar bytes and the same
``digest``, so a record table built by either package is the other's.

Indexed RecordIO ships its index as a ``.idx`` text file; every other
format has to earn one.  :func:`build_record_index` generalizes the
``.idx`` idea to the whole io/ format family by scanning the source
ONCE and committing the resulting offset/size table through the page
store as a ``shuffle.idx.*`` sidecar, stamped with the source files'
fingerprint — rebuilt automatically when the data changes, reused for
free (one ``lookup``) when it hasn't.

A :class:`RecordIndex` describes every record of a (possibly
multi-file) dataset in the dataset's **global byte space**: files are
logically concatenated in listing order (the InputSplit sharding
contract) and ``offsets[k]/sizes[k]`` give record ``k``'s raw source
span in that space — frames and padding included for RecordIO family
formats, the line bytes without terminators for text.  Raw spans are
what the exchange plane moves: a window of records is a contiguous
byte range computable from this table alone, so a peer can serve it
with exact length validation and the reader can slice records out
without re-parsing.

Formats:

- ``indexed_recordio`` — the template: the ``.idx`` file IS the index
  (offsets ascending, sizes from consecutive offsets).
- ``recordio`` / ``recordio_dense`` / ``recordio_image`` — one frame
  walk: a record starts at a frame with cflag whole(0)/start(1) and
  runs through its cflag whole(0)/end(3) frame, size including every
  frame header and the 4-byte padding.
- ``text`` — a newline scan: a record is a maximal run without
  ``\\n``/``\\r`` (empty lines yield no records), size excluding the
  terminator.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch.io.input_split import list_split_files
from dmlc_tpu_torch.io.pagestore import PageStore, stat_fingerprint
from dmlc_tpu_torch.io.recordio import (
    RECORDIO_MAGIC, decode_flag, decode_length,
)
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["RecordIndex", "build_record_index", "SPLIT_TYPES"]

#: formats the index plane understands (recordio_dense/recordio_image
#: share RecordIO framing — one scanner covers all three)
SPLIT_TYPES = ("text", "recordio", "recordio_dense", "recordio_image",
               "indexed_recordio")

_SCAN_CHUNK = 4 << 20
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)


class RecordIndex:
    """Immutable record table of one dataset in global byte space."""

    def __init__(self, uri: str, split_type: str,
                 files: List[Tuple[str, int]], offsets: np.ndarray,
                 sizes: np.ndarray, fingerprint: List[List]):
        self.uri = uri
        self.split_type = split_type
        self.files = [(str(p), int(s)) for p, s in files]
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.sizes = np.ascontiguousarray(sizes, dtype=np.int64)
        check(len(self.offsets) == len(self.sizes),
              "RecordIndex: offsets/sizes length mismatch")
        self.fingerprint = [list(e) for e in fingerprint]
        # file start offsets in the concatenated space (prefix sums)
        self._starts = np.zeros(len(self.files) + 1, dtype=np.int64)
        np.cumsum([s for _, s in self.files], out=self._starts[1:])

    @property
    def n(self) -> int:
        """Record count."""
        return int(len(self.offsets))

    @property
    def total_bytes(self) -> int:
        """Total source bytes (all files, global byte space extent)."""
        return int(self._starts[-1])

    @property
    def digest(self) -> str:
        """Short stable identity of (uri, split_type) — sidecar and
        window page entry names hang off this."""
        h = hashlib.sha256(
            json.dumps([self.uri, self.split_type]).encode())
        return h.hexdigest()[:16]

    def segments(self, begin: int, end: int) -> Iterator[Tuple[str, int, int]]:
        """Map global byte span [begin, end) to per-file segments
        ``(path, local_offset, length)`` in order."""
        check(0 <= begin <= end <= self.total_bytes,
              f"RecordIndex: span [{begin}, {end}) outside "
              f"[0, {self.total_bytes})")
        fi = int(np.searchsorted(self._starts, begin, side="right")) - 1
        pos = begin
        while pos < end:
            fstart, fend = int(self._starts[fi]), int(self._starts[fi + 1])
            take = min(end, fend) - pos
            if take > 0:
                yield self.files[fi][0], pos - fstart, take
            pos += max(take, 0)
            fi += 1

    # -- sidecar serialization

    def to_bytes(self) -> bytes:
        header = json.dumps({
            "v": 1, "uri": self.uri, "split_type": self.split_type,
            "n": self.n, "files": self.files,
        }, sort_keys=True).encode("utf-8")
        return b"\n".join([header, self.offsets.tobytes()
                           + self.sizes.tobytes()])

    @classmethod
    def from_bytes(cls, blob: bytes,
                   fingerprint: List[List]) -> "RecordIndex":
        nl = blob.index(b"\n")
        head = json.loads(blob[:nl].decode("utf-8"))
        check(head.get("v") == 1, "RecordIndex: unknown sidecar version")
        n = int(head["n"])
        body = blob[nl + 1:]
        check(len(body) == 2 * 8 * n,
              f"RecordIndex: sidecar body {len(body)}B != {2 * 8 * n}B "
              f"for {n} records")
        offsets = np.frombuffer(body[:8 * n], dtype=np.int64)
        sizes = np.frombuffer(body[8 * n:], dtype=np.int64)
        return cls(head["uri"], head["split_type"],
                   [tuple(f) for f in head["files"]], offsets, sizes,
                   fingerprint)


# -- per-format scanners (offsets are file-local; caller adds the base)


def _scan_text(path: str) -> Tuple[List[int], List[int]]:
    offsets: List[int] = []
    sizes: List[int] = []
    base = 0
    prev_term = True  # file start behaves like "after a terminator"
    with create_stream(path, "r") as s:
        while True:
            chunk = s.read(_SCAN_CHUNK)
            if not chunk:
                break
            arr = np.frombuffer(chunk, dtype=np.uint8)
            term = (arr == 0x0A) | (arr == 0x0D)
            tprev = np.empty_like(term)
            tprev[0] = prev_term
            tprev[1:] = term[:-1]
            for st in (np.flatnonzero(~term & tprev) + base):
                offsets.append(int(st))
            for en in (np.flatnonzero(term & ~tprev) + base):
                sizes.append(int(en) - offsets[len(sizes)])
            base += len(chunk)
            prev_term = bool(term[-1])
    if len(offsets) > len(sizes):  # file ended mid-record
        sizes.append(base - offsets[-1])
    return offsets, sizes


def _scan_recordio(path: str, file_size: int) -> Tuple[List[int], List[int]]:
    """Frame walk — every RecordIO-framed format (plain, dense,
    image) tiles its file with 4-byte-aligned frames, so offsets and
    sizes cover the file exactly."""
    offsets: List[int] = []
    sizes: List[int] = []
    pos = 0
    rec_start: Optional[int] = None
    with create_stream(path, "r") as s:
        buf = b""
        bufpos = 0

        def read_header() -> Optional[bytes]:
            nonlocal buf, bufpos
            while len(buf) - bufpos < 8:
                more = s.read(_SCAN_CHUNK)
                if not more:
                    return None
                buf = buf[bufpos:] + more
                bufpos = 0
            h = buf[bufpos:bufpos + 8]
            bufpos += 8
            return h

        def skip(nbytes: int) -> None:
            nonlocal buf, bufpos
            avail = len(buf) - bufpos
            if nbytes <= avail:
                bufpos += nbytes
                return
            nbytes -= avail
            buf, bufpos = b"", 0
            while nbytes > 0:
                got = s.read(min(nbytes, _SCAN_CHUNK))
                if not got:
                    raise DMLCError(
                        f"recordio index scan: truncated frame payload "
                        f"in {path!r}")
                nbytes -= len(got)

        while pos < file_size:
            header = read_header()
            if header is None:
                break
            magic, lrec = struct.unpack("<II", header)
            check(magic == RECORDIO_MAGIC,
                  f"recordio index scan: bad magic at byte {pos} "
                  f"of {path!r}")
            cflag, ln = decode_flag(lrec), decode_length(lrec)
            padded = (ln + 3) & ~3
            if cflag in (0, 1):
                check(rec_start is None,
                      f"recordio index scan: record start inside an "
                      f"open record at byte {pos} of {path!r}")
                rec_start = pos
            else:
                check(rec_start is not None,
                      f"recordio index scan: continuation frame with "
                      f"no open record at byte {pos} of {path!r}")
            pos += 8 + padded
            skip(padded)
            if cflag in (0, 3):
                offsets.append(rec_start)
                sizes.append(pos - rec_start)
                rec_start = None
    check(rec_start is None,
          f"recordio index scan: unterminated record in {path!r}")
    return offsets, sizes


def _indexed_entries(uri: str) -> Tuple[str, List[Tuple[int, int, int]]]:
    """(data_path, [(key, offset, size)]) via the format's own .idx."""
    from dmlc_tpu_torch.io.indexed_recordio_split import (
        IndexedRecordIOSplit,
    )
    spec = URISpec(uri)
    paths = spec.paths()
    check(len(paths) == 1,
          "shuffle index: indexed_recordio expects a single data file")
    data_path = paths[0]
    index_uri = spec.args.get("index") or (data_path + ".idx")
    files = list_split_files(data_path)
    entries = IndexedRecordIOSplit._read_index(index_uri, files[0][1])
    return data_path, entries


# -- the builder


def build_record_index(uri: str, split_type: str = "text", *,
                       store: Optional[PageStore] = None) -> RecordIndex:
    """Build (or reuse) the record index of ``uri``.

    The index is committed to the page store as
    ``shuffle.idx.<digest>`` with the source files' stat fingerprint;
    a fresh sidecar short-circuits the scan entirely.
    """
    check(split_type in SPLIT_TYPES,
          f"shuffle index: unknown split_type {split_type!r} "
          f"(one of {SPLIT_TYPES})")
    store = store or PageStore.default()
    if split_type == "indexed_recordio":
        data_path, _ = _indexed_entries(uri)
        files = list_split_files(data_path)
    else:
        files = list_split_files(uri)
    fingerprint = stat_fingerprint([p for p, _ in files])
    probe = RecordIndex(uri, split_type, files,
                        np.empty(0, np.int64), np.empty(0, np.int64),
                        fingerprint)
    name = f"shuffle.idx.{probe.digest}"
    if store.lookup(name, fingerprint) is not None:
        rs = store.open_read(name)
        if rs is not None:
            with rs:
                blob = rs.read_all()
            return RecordIndex.from_bytes(blob, fingerprint)

    offsets: List[int] = []
    sizes: List[int] = []
    base = 0
    if split_type == "indexed_recordio":
        _, entries = _indexed_entries(uri)
        offsets = [e[1] for e in entries]
        sizes = [e[2] for e in entries]
    else:
        for path, fsize in files:
            if split_type == "text":
                offs, szs = _scan_text(path)
            else:
                offs, szs = _scan_recordio(path, fsize)
            offsets.extend(o + base for o in offs)
            sizes.extend(szs)
            base += fsize
    index = RecordIndex(uri, split_type, files,
                        np.asarray(offsets, np.int64),
                        np.asarray(sizes, np.int64), fingerprint)
    store.commit_bytes(name, index.to_bytes(), fingerprint=fingerprint,
                       meta={"kind": "shuffle.index", "uri": uri,
                             "split_type": split_type, "n": index.n})
    return index
