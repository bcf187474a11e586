"""Byte-stream abstraction over local files and memory.

Reference: include/dmlc/io.h — Stream (Read/Write), SeekStream (Seek/Tell);
include/dmlc/memory_io.h — MemoryStringStream.

Python semantics: ``read(n)`` returns up to ``n`` bytes (b"" at EOF), matching
the reference's size_t-returning Read; ``read_exact``/``write`` helpers carry
the serializer. ``create_stream`` opens local paths and ``file://`` URIs;
other schemes are not ported yet (see io/filesys.py).

Trimmed from ``dmlc_tpu/io/stream.py``: the resilience seams (retry and
fault injection around reads and opens), ``as_file`` and
``create_seek_stream_for_read``.
"""

from __future__ import annotations

from typing import Optional, Union

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["Stream", "SeekStream", "MemoryStream", "FileStream",
           "create_stream"]


class Stream:
    """Abstract byte stream (reference: dmlc::Stream)."""

    def read(self, nbytes: int) -> bytes:
        """Read up to nbytes; b"" at EOF."""
        raise NotImplementedError

    def write(self, data: Union[bytes, bytearray, memoryview]) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # -- helpers shared by all streams

    def read_exact(self, nbytes: int) -> bytes:
        """Read exactly nbytes or raise (short read = corrupt stream)."""
        chunks = []
        remaining = nbytes
        while remaining > 0:
            b = self.read(remaining)
            if not b:
                raise DMLCError(
                    f"Stream: unexpected EOF (wanted {nbytes}, "
                    f"got {nbytes - remaining})")
            chunks.append(b)
            remaining -= len(b)
        return b"".join(chunks)

    def read_all(self, chunk_size: int = 1 << 20) -> bytes:
        chunks = []
        while True:
            b = self.read(chunk_size)
            if not b:
                break
            chunks.append(b)
        return b"".join(chunks)

    def readinto(self, b) -> int:
        """Read up to len(b) bytes INTO a caller buffer; returns the
        count (0 at EOF). The base implementation reads-then-copies;
        file-backed streams override with a true in-place read."""
        data = self.read(len(b))
        n = len(data)
        b[:n] = data
        return n

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SeekStream(Stream):
    """Stream with random access (reference: dmlc::SeekStream)."""

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError


class MemoryStream(SeekStream):
    """Seekable stream over an in-RAM buffer (reference: MemoryStringStream).

    Construct empty for writing, or over initial bytes for reading. The
    buffer is reachable via :meth:`getvalue`.
    """

    def __init__(self, data: Union[bytes, bytearray, None] = None):
        self._buf = bytearray(data if data is not None else b"")
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        b = bytes(self._buf[self._pos:self._pos + nbytes])
        self._pos += len(b)
        return b

    def write(self, data) -> int:
        n = len(data)
        end = self._pos + n
        if self._pos == len(self._buf):
            self._buf += bytes(data)
        else:
            if end > len(self._buf):
                self._buf += b"\x00" * (end - len(self._buf))
            self._buf[self._pos:end] = bytes(data)
        self._pos = end
        return n

    def seek(self, pos: int) -> None:
        check(0 <= pos <= len(self._buf), f"seek {pos} out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class FileStream(SeekStream):
    """Local-file stream over a Python file object (reference:
    src/io/local_filesys.cc FileStream over stdio)."""

    def __init__(self, fileobj, path: str = ""):
        self._f = fileobj
        self.path = path

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes)

    def readinto(self, b) -> int:
        ri = getattr(self._f, "readinto", None)
        if ri is None:
            return super().readinto(b)
        return int(ri(b))

    def write(self, data) -> int:
        return self._f.write(data)

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def create_stream(uri: str, mode: str = "r",
                  allow_null: bool = False) -> Optional[Stream]:
    """URI-dispatched stream factory (reference: Stream::Create in src/io.cc).

    mode: "r" read, "w" write (truncate), "a" append. "-" maps to
    stdin/stdout. A missing file raises FileNotFoundError, or gives None
    with ``allow_null``.
    """
    from dmlc_tpu_torch.io.filesys import FileSystem, URI  # cycle-free
    check(mode in ("r", "w", "a"), f"invalid stream mode {mode!r}")
    if uri == "-":
        import sys
        return FileStream(sys.stdin.buffer if mode == "r" else sys.stdout.buffer,
                          path="-")
    u = URI(uri)
    fs = FileSystem.get_instance(u, allow_null=allow_null)
    if fs is None:
        return None
    try:
        return fs.open(u, mode)
    except FileNotFoundError:
        if allow_null:
            return None
        raise
