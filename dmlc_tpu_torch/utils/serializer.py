"""Binary (de)serialization onto Streams.

Copy of ``dmlc_tpu/utils/serializer.py`` with its imports rewritten to
``dmlc_tpu_torch``. Both surfaces write the reference's bytes, so a file
written by either package reads in the other.

Reference: include/dmlc/serializer.h — serializer::Handler<T>::Write/Read with
a POD fast path and container recursion, plus the Stream::Write(T)/Read(T&)
sugar in io.h. Byte order is little-endian always (reference: endian.h,
DMLC_IO_NO_ENDIAN_SWAP on LE hosts; we define the format as LE so files are
portable, the reference's intent).

Two surfaces:
- typed helpers (write_u64/read_f32/...): the reference's compile-time-typed
  path; used by RowBlockContainer pages and the round-spill files, where the
  schema is known on both sides (no per-element overhead).
- ``serialize``/``deserialize``: a tagged self-describing container format for
  Python convenience (dict/list/tuple/str/bytes/int/float/bool/None/ndarray),
  the analogue of Handler<T> recursion over STL containers. A
  ``torch.Tensor`` is not one of its types: it raises as any other
  unsupported type does (pass ``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = [
    "write_u8", "write_u32", "write_u64", "write_i32", "write_i64",
    "write_f32", "write_f64", "read_u8", "read_u32", "read_u64", "read_i32",
    "read_i64", "read_f32", "read_f64", "write_str", "read_str",
    "write_bytes", "read_bytes", "write_ndarray", "read_ndarray",
    "serialize", "deserialize",
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


# -- tagged self-describing format

_T_NONE, _T_BOOL, _T_INT, _T_FLOAT, _T_STR, _T_BYTES = 0, 1, 2, 3, 4, 5
_T_LIST, _T_DICT, _T_TUPLE, _T_NDARRAY = 6, 7, 8, 9


def serialize(obj: Any, s: Stream) -> None:
    """Recursively write a Python container tree (Handler<T> analogue)."""
    if obj is None:
        write_u8(s, _T_NONE)
    elif isinstance(obj, bool):
        write_u8(s, _T_BOOL)
        write_u8(s, 1 if obj else 0)
    elif isinstance(obj, int):
        write_u8(s, _T_INT)
        write_i64(s, obj)
    elif isinstance(obj, float):
        write_u8(s, _T_FLOAT)
        write_f64(s, obj)
    elif isinstance(obj, str):
        write_u8(s, _T_STR)
        write_str(s, obj)
    elif isinstance(obj, (bytes, bytearray)):
        write_u8(s, _T_BYTES)
        write_bytes(s, bytes(obj))
    elif isinstance(obj, list):
        write_u8(s, _T_LIST)
        write_u64(s, len(obj))
        for x in obj:
            serialize(x, s)
    elif isinstance(obj, tuple):
        write_u8(s, _T_TUPLE)
        write_u64(s, len(obj))
        for x in obj:
            serialize(x, s)
    elif isinstance(obj, dict):
        write_u8(s, _T_DICT)
        write_u64(s, len(obj))
        for k, v in obj.items():
            serialize(k, s)
            serialize(v, s)
    elif isinstance(obj, np.ndarray):
        write_u8(s, _T_NDARRAY)
        write_ndarray(s, obj)
    elif isinstance(obj, (np.integer,)):
        serialize(int(obj), s)
    elif isinstance(obj, (np.floating,)):
        serialize(float(obj), s)
    else:
        raise DMLCError(f"serialize: unsupported type {type(obj).__name__}")


def deserialize(s: Stream) -> Any:
    tag = read_u8(s)
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return bool(read_u8(s))
    if tag == _T_INT:
        return read_i64(s)
    if tag == _T_FLOAT:
        return read_f64(s)
    if tag == _T_STR:
        return read_str(s)
    if tag == _T_BYTES:
        return read_bytes(s)
    if tag == _T_LIST:
        return [deserialize(s) for _ in range(read_u64(s))]
    if tag == _T_TUPLE:
        return tuple(deserialize(s) for _ in range(read_u64(s)))
    if tag == _T_DICT:
        n = read_u64(s)
        out = {}
        for _ in range(n):
            k = deserialize(s)
            out[k] = deserialize(s)
        return out
    if tag == _T_NDARRAY:
        return read_ndarray(s)
    raise DMLCError(f"deserialize: bad tag {tag}")
