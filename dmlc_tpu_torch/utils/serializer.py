"""Binary (de)serialization onto Streams.

Copy of ``dmlc_tpu/utils/serializer.py`` with its imports rewritten to
``dmlc_tpu_torch``. The typed helpers carry the RowBlock page and
round-spill formats, so a file written by either package reads in the
other.

Trimmed from the reference: the tagged ``serialize``/``deserialize``
pair, which has no caller in the port yet (checkpoints, ROADMAP A9,
will bring it back with a parity test).

Reference: include/dmlc/serializer.h — serializer::Handler<T>::Write/Read with
a POD fast path and container recursion, plus the Stream::Write(T)/Read(T&)
sugar in io.h. Byte order is little-endian always (reference: endian.h,
DMLC_IO_NO_ENDIAN_SWAP on LE hosts; we define the format as LE so files are
portable, the reference's intent).

The typed helpers (write_u64/read_f32/...) are the reference's
compile-time-typed path, used by RowBlockContainer pages where the schema is
known on both sides (no per-element overhead).
"""

from __future__ import annotations

import struct

import numpy as np

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = [
    "write_u8", "write_u32", "write_u64", "write_i32", "write_i64",
    "write_f32", "write_f64", "read_u8", "read_u32", "read_u64", "read_i32",
    "read_i64", "read_f32", "read_f64", "write_str", "read_str",
    "write_bytes", "read_bytes", "write_ndarray", "read_ndarray",
]


def _w(stream: Stream, fmt: str, v) -> None:
    stream.write(struct.pack(fmt, v))


def _r(stream: Stream, fmt: str, size: int):
    return struct.unpack(fmt, stream.read_exact(size))[0]


def write_u8(s: Stream, v: int) -> None: _w(s, "<B", v)
def write_u32(s: Stream, v: int) -> None: _w(s, "<I", v)
def write_u64(s: Stream, v: int) -> None: _w(s, "<Q", v)
def write_i32(s: Stream, v: int) -> None: _w(s, "<i", v)
def write_i64(s: Stream, v: int) -> None: _w(s, "<q", v)
def write_f32(s: Stream, v: float) -> None: _w(s, "<f", v)
def write_f64(s: Stream, v: float) -> None: _w(s, "<d", v)
def read_u8(s: Stream) -> int: return _r(s, "<B", 1)
def read_u32(s: Stream) -> int: return _r(s, "<I", 4)
def read_u64(s: Stream) -> int: return _r(s, "<Q", 8)
def read_i32(s: Stream) -> int: return _r(s, "<i", 4)
def read_i64(s: Stream) -> int: return _r(s, "<q", 8)
def read_f32(s: Stream) -> float: return _r(s, "<f", 4)
def read_f64(s: Stream) -> float: return _r(s, "<d", 8)


def write_bytes(s: Stream, b: bytes) -> None:
    write_u64(s, len(b))
    s.write(b)


def read_bytes(s: Stream) -> bytes:
    n = read_u64(s)
    return s.read_exact(n)


def write_str(s: Stream, v: str) -> None:
    write_bytes(s, v.encode("utf-8"))


def read_str(s: Stream) -> str:
    return read_bytes(s).decode("utf-8")


def write_ndarray(s: Stream, a: np.ndarray) -> None:
    """dtype-string + shape + raw LE bytes (the POD-vector fast path)."""
    a = np.asarray(a)
    if a.ndim and not a.flags.c_contiguous:
        # (ascontiguousarray would silently promote 0-d to shape (1,))
        a = np.ascontiguousarray(a)
    dt = a.dtype.newbyteorder("<")
    write_str(s, dt.str)
    write_u8(s, a.ndim)
    for d in a.shape:
        write_u64(s, d)
    s.write(a.astype(dt, copy=False).tobytes())


def read_ndarray(s: Stream) -> np.ndarray:
    dtype = np.dtype(read_str(s))
    ndim = read_u8(s)
    shape = tuple(read_u64(s) for _ in range(ndim))
    count = int(np.prod(shape)) if ndim else 1
    raw = s.read_exact(dtype.itemsize * count)
    return np.frombuffer(raw, dtype=dtype, count=count).reshape(shape).copy()
