"""Byte-stream abstraction over local files and memory.

Reference: include/dmlc/io.h — Stream (Read/Write), SeekStream (Seek/Tell);
include/dmlc/memory_io.h — MemoryStringStream.

Python semantics: ``read(n)`` returns up to ``n`` bytes (b"" at EOF), matching
the reference's size_t-returning Read. Local files and memory only: other
schemes are not ported yet (see io/filesys.py).
"""

from __future__ import annotations

from typing import Union

from dmlc_tpu_torch.utils.logging import check

__all__ = ["Stream", "SeekStream", "MemoryStream", "FileStream"]


class Stream:
    """Abstract byte stream (reference: dmlc::Stream)."""

    def read(self, nbytes: int) -> bytes:
        """Read up to nbytes; b"" at EOF."""
        raise NotImplementedError

    def write(self, data: Union[bytes, bytearray, memoryview]) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

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
