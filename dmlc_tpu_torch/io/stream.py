"""Byte-stream abstraction over files, memory and remote objects.

Reference: include/dmlc/io.h — Stream (Read/Write), SeekStream (Seek/Tell);
include/dmlc/memory_io.h — MemoryStringStream.

Python semantics: ``read(n)`` returns up to ``n`` bytes (b"" at EOF), matching
the reference's size_t-returning Read; ``read_exact``/``write`` helpers carry
the serializer. ``create_stream`` opens any scheme the VFS registry
knows (see io/filesys.py): local paths, ``file://``, ``cuda://``, and
``obj://``/``s3://`` through the object-store plane.
``Stream.as_file`` adapts any stream to a Python binary file (the
reference's ``dmlc::istream``); the Parquet golden hands pyarrow one
over a non-local scheme.

Reads and opens are the reference's resilience seams (sites
``io.stream.read`` and ``io.stream.open``, see :class:`FileStream` and
:func:`create_stream`).
"""

from __future__ import annotations

import io as _pyio
from typing import Optional, Union

from dmlc_tpu_torch.resilience import inject as _inject
from dmlc_tpu_torch.resilience.policy import guarded
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["Stream", "SeekStream", "MemoryStream", "FileStream",
           "create_stream", "create_seek_stream_for_read"]


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

    def as_file(self, size: Optional[int] = None,
                own_stream: bool = False) -> "_StreamFile":
        """Adapt to a Python binary-file-like object (reference
        dmlc::istream). Pass the object's total ``size`` to enable
        seek-from-end (whence=2) on SeekStreams — consumers like
        pyarrow discover file size that way.

        Ownership: by default the adapter does NOT own the stream —
        closing the adapter (or letting it be GC'd; RawIOBase.__del__
        calls close()) leaves the stream open, so a temporary
        ``s.as_file().write(...)`` cannot close ``s`` out from under its
        owner mid-``with``. Pass ``own_stream=True`` to transfer
        ownership: the adapter then closes the underlying stream with
        itself (the right mode when the adapter is handed off, e.g. to
        pyarrow)."""
        return _StreamFile(self, size=size, own_stream=own_stream)


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
    src/io/local_filesys.cc FileStream over stdio).

    Reads are a resilience seam (site ``io.stream.read``): transient
    OSErrors retry under the site's RetryPolicy and an armed FaultPlan
    can raise/delay/truncate here. Two position rules keep chaos
    DETECTABLE instead of silently corrupting:

    - a retried attempt SEEKS BACK to the pre-read position first — a
      buffered read that failed after consuming k bytes advances the
      offset, and re-reading from there would return a stream missing
      those bytes (fixed-size payload reads would then load shifted,
      wrong data);
    - an injected truncation shortens the returned bytes AND pins the
      stream at EOF — simulating a truncated SOURCE object whose tail
      is gone, which framing layers surface as an unexpected-EOF
      error. Shortening alone would leave the offset past the dropped
      bytes: the next read would return shifted data and fixed-size
      readers would succeed with silently wrong payloads.

    Unseekable fileobjs (stdin/pipes) fall back to plain re-read and
    skip truncation. The quiet path costs one tell + global read +
    try/except per call."""

    def __init__(self, fileobj, path: str = ""):
        self._f = fileobj
        self.path = path

    def _tell(self):
        try:
            return self._f.tell()
        except OSError:
            return None  # unseekable (stdin/pipe)

    def _restoring(self, pos, fn):
        """Wrap a read op so every RETRY attempt starts at the same
        file position. The first attempt skips the restore (the
        position cannot have moved yet — the quiet path stays at one
        tell per call)."""
        first = [True]

        def attempt():
            if first[0]:
                first[0] = False
            elif pos is not None:
                self._f.seek(pos)
            return fn()

        return attempt

    def _truncated_len(self, pos, nread: int, payload) -> int:
        """Armed truncate clauses: shortened length, stream pinned at
        EOF (see class docstring); ``nread`` when chaos is off. The
        payload is materialized only when a truncate clause is scoped
        here — a plan targeting other sites must not cost the hot
        readinto path a copy per chunk."""
        plan = _inject.active()
        if plan is None or not nread or pos is None \
                or not plan.has_truncate("io.stream.read"):
            return nread
        short = plan.corrupt("io.stream.read", payload())
        if len(short) != nread:
            self._f.seek(0, 2)  # the source's tail is GONE
            return len(short)
        return nread

    def read(self, nbytes: int) -> bytes:
        pos = self._tell()
        out = guarded("io.stream.read",
                      self._restoring(pos, lambda: self._f.read(nbytes)))
        if _inject.active() is not None:
            out = out[:self._truncated_len(pos, len(out), lambda: out)]
        return out

    def readinto(self, b) -> int:
        ri = getattr(self._f, "readinto", None)
        if ri is None:
            return super().readinto(b)  # routes through read() above
        pos = self._tell()
        n = guarded("io.stream.read",
                    self._restoring(pos, lambda: int(ri(b))))
        if _inject.active() is not None:
            n = self._truncated_len(pos, n,
                                    lambda: bytes(memoryview(b)[:n]))
        return n

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


class _StreamFile(_pyio.RawIOBase):
    """Binary file adapter over a Stream (reference dmlc::istream/ostream)."""

    def __init__(self, stream: Stream, size: Optional[int] = None,
                 own_stream: bool = False):
        self._s = stream
        self._size = size
        self._own = own_stream

    def close(self) -> None:
        # with own_stream, propagate to the underlying Stream (fd/
        # socket/remote handle) — RawIOBase.close() alone would strand
        # it until GC; without it, the stream's owner keeps control
        # (see Stream.as_file)
        try:
            if self._own:
                self._s.close()
        finally:
            super().close()

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._s.read(len(b))
        b[:len(data)] = data
        return len(data)

    def write(self, b) -> int:
        return self._s.write(bytes(b))

    def seekable(self) -> bool:
        return isinstance(self._s, SeekStream)

    def seek(self, pos, whence=0):
        if not isinstance(self._s, SeekStream):
            raise _pyio.UnsupportedOperation("seek")
        if whence == 0:
            self._s.seek(pos)
        elif whence == 1:
            self._s.seek(self._s.tell() + pos)
        elif whence == 2 and self._size is not None:
            self._s.seek(self._size + pos)
        else:
            raise _pyio.UnsupportedOperation(
                "seek from end needs as_file(size=...)")
        return self._s.tell()


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
        # resilience seam io.stream.open: transient open errors retry
        # under policy; FileNotFoundError is classified permanent and
        # propagates immediately (the allow_null contract below)
        return guarded("io.stream.open", lambda: fs.open(u, mode))
    except FileNotFoundError:
        if allow_null:
            return None
        raise


def create_seek_stream_for_read(uri: str,
                                allow_null: bool = False) -> Optional[SeekStream]:
    """Reference: SeekStream::CreateForRead."""
    from dmlc_tpu_torch.io.filesys import FileSystem, URI
    u = URI(uri)
    fs = FileSystem.get_instance(u, allow_null=allow_null)
    if fs is None:
        return None
    try:
        return guarded("io.stream.open", lambda: fs.open_for_read(u))
    except FileNotFoundError:
        if allow_null:
            return None
        raise
