"""RecordIO framed binary record format.

Copy of ``dmlc_tpu/io/recordio.py`` with its imports rewritten to
``dmlc_tpu_torch``; files written by either package are byte-identical
and each reads the other's (tests/test_torch_recordio.py).

Reference: include/dmlc/recordio.h + src/recordio.cc —
RecordIOWriter::WriteRecord (kMagic = 0xced7230a, EncodeLRec(cflag,len) =
cflag<<29 | len, cflag ∈ {0 whole, 1 start, 2 middle, 3 end}),
RecordIOReader::NextRecord, RecordIOChunkReader.

Format contract (frozen):

- A record is written as one or more *frames*. Each frame is
  ``magic(u32 LE) | lrec(u32 LE) | payload | pad-to-4B``, where
  ``lrec = cflag<<29 | payload_len`` (payload_len < 2^29).
- Magic-collision escaping: before writing, the payload is scanned at
  4-byte-aligned positions for the magic u32; each aligned occurrence is
  *removed* and becomes a frame boundary (the reader re-inserts the magic
  bytes when stitching frames back together). Hence the byte stream never
  contains the magic at a 4-byte-aligned position except at frame heads —
  which is what makes shard realignment by magic-scan sound
  (reference: src/io/recordio_split.cc SeekRecordBegin).
- cflag: 0 = whole record in one frame; multi-frame records use
  1 (start), 2 (middle), 3 (end).

Dense-record payload encoding (ABI 6, frozen — the native engine's
``recordio_dense`` decoder and the Python golden
``data/dense_record_parser.py`` both speak exactly this)::

    u32 n_values (LE) | f32 label (LE) | f32[n_values] values (LE)

A payload whose length is not exactly ``8 + 4 * n_values`` is corrupt
and must raise DMLCError (the engine raises EngineError) — never a
silently short row. ``DenseRecordWriter``/:func:`decode_dense_record`
are the round-trip pair the parity tests pin.

Image-record payload encoding (ABI 8, frozen — the native engine's
``recordio_image`` decoder and the Python golden
``data/image_record_parser.py`` both speak exactly this; the MXNet-
style ImageNet ``.rec`` scenario's raw/uniform-shape lane)::

    u32 h (LE) | u32 w (LE) | u32 c (LE) | f32 label (LE) |
    u8[h*w*c] pixels (HWC, row-major)

Same strict length contract: a payload whose byte length is not
exactly ``16 + h*w*c`` raises DMLCError/EngineError. Pixel bytes that
happen to spell the frame magic at a 4-aligned position escape into
multi-frame records exactly like any other payload — the framing layer
owns that, both decoders stitch it back.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import check

__all__ = [
    "RECORDIO_MAGIC", "RecordIOWriter", "RecordIOReader",
    "RecordIOChunkReader", "encode_lrec", "decode_flag", "decode_length",
    "DenseRecordWriter", "encode_dense_record", "decode_dense_record",
    "ImageRecordWriter", "encode_image_record", "decode_image_record",
]

RECORDIO_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)


def encode_lrec(cflag: int, length: int) -> int:
    """Reference: RecordIOWriter::EncodeLRec."""
    check(0 <= cflag < 4 and 0 <= length < (1 << 29),
          f"bad lrec cflag={cflag} len={length}")
    return (cflag << 29) | length


def decode_flag(rec: int) -> int:
    return (rec >> 29) & 7


def decode_length(rec: int) -> int:
    return rec & ((1 << 29) - 1)


class RecordIOWriter:
    """Reference: RecordIOWriter (src/recordio.cc)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self.escaped_magic_count = 0  # number of magic collisions escaped

    @property
    def except_counter(self) -> int:
        """Alias for ``escaped_magic_count``: the reference
        RecordIOWriter's name (src/recordio.cc ``except_counter()``)."""
        return self.escaped_magic_count

    def write_record(self, data: Union[bytes, bytearray, memoryview]) -> None:
        data = bytes(data)
        size = len(data)
        check(size < (1 << 29), "RecordIO: record too large (>= 2^29 bytes)")
        s = self._stream
        # scan 4-byte-aligned positions for the magic word; each aligned
        # occurrence is removed and becomes a frame boundary (the reader
        # re-inserts it when stitching) — only positions before the last
        # aligned word can hold a full aligned magic
        scan_end = (size >> 2) << 2
        frame_start = 0  # start of the not-yet-written remainder
        hit = data.find(_MAGIC_BYTES)
        while hit != -1 and hit < scan_end:
            if hit % 4 == 0:
                lrec = encode_lrec(1 if frame_start == 0 else 2,
                                   hit - frame_start)
                s.write(_MAGIC_BYTES)
                s.write(struct.pack("<I", lrec))
                if hit != frame_start:
                    s.write(data[frame_start:hit])
                frame_start = hit + 4
                self.escaped_magic_count += 1
                hit = data.find(_MAGIC_BYTES, frame_start)
            else:
                hit = data.find(_MAGIC_BYTES, hit + 1)
        lrec = encode_lrec(3 if frame_start != 0 else 0, size - frame_start)
        s.write(_MAGIC_BYTES)
        s.write(struct.pack("<I", lrec))
        if size != frame_start:
            s.write(data[frame_start:size])
        pad = (-size) % 4
        if pad:
            s.write(b"\x00" * pad)


class IndexedRecordIOWriter(RecordIOWriter):
    """RecordIO writer that also maintains a key→offset index.

    Reference: the ``key\\toffset`` index files consumed by
    src/io/indexed_recordio_split.cc (upstream generates them with
    MXNet-side tooling; here the writer produces them directly).
    The stream must be fresh (offsets count from its current position 0).
    """

    class _CountingStream:
        def __init__(self, inner: Stream):
            self.inner = inner
            self.written = 0

        def write(self, data) -> int:
            n = self.inner.write(data)
            self.written += len(data)
            return n

    def __init__(self, stream: Stream, index_stream: Stream):
        self._counter = self._CountingStream(stream)
        super().__init__(self._counter)
        self._index_stream = index_stream
        self._auto_key = 0

    def write_record(self, data, key: Optional[int] = None) -> None:
        if key is None:
            key = self._auto_key
            self._auto_key += 1
        self._index_stream.write(
            f"{key}\t{self._counter.written}\n".encode())
        super().write_record(data)


_DENSE_HDR = struct.Struct("<If")  # n_values, label


def encode_dense_record(label: float, values) -> bytes:
    """One dense record payload: ``u32 n | f32 label | f32[n] values``
    (all little-endian). ``values`` is any 1-D float sequence; the f32
    cast here IS the stored precision (decode returns the exact
    bits)."""
    vals = np.ascontiguousarray(values, dtype="<f4")
    check(vals.ndim == 1, "dense record: values must be 1-D")
    return _DENSE_HDR.pack(len(vals), float(label)) + vals.tobytes()


def decode_dense_record(payload) -> Tuple[np.float32, np.ndarray]:
    """Decode one dense payload to ``(label, values)``. The length
    contract is strict: a payload whose byte length disagrees with its
    recorded ``n_values`` raises DMLCError (byte parity with the
    engine's EngineError)."""
    n_bytes = len(payload)
    check(n_bytes >= _DENSE_HDR.size,
          f"dense record: payload shorter than its 8-byte header "
          f"({n_bytes} bytes)")
    n, label = _DENSE_HDR.unpack_from(payload)
    check(n_bytes == _DENSE_HDR.size + 4 * n,
          f"dense record: n_values {n} disagrees with payload length "
          f"{n_bytes}")
    values = np.frombuffer(payload, dtype="<f4", count=n,
                           offset=_DENSE_HDR.size)
    return np.float32(label), values


class DenseRecordWriter:
    """RecordIO writer of dense records — the Python golden for the
    engine's ABI-6 ``recordio_dense`` fast path. Magic-collision
    escaping comes free from :class:`RecordIOWriter` (a value whose f32
    bits equal the frame magic at a 4-aligned payload position becomes
    a multi-frame record; the decoders stitch it back)."""

    def __init__(self, stream: Stream):
        self._w = RecordIOWriter(stream)

    @property
    def escaped_magic_count(self) -> int:
        return self._w.escaped_magic_count

    def write(self, label: float, values) -> None:
        self._w.write_record(encode_dense_record(label, values))


_IMAGE_HDR = struct.Struct("<IIIf")  # h, w, c, label


def encode_image_record(label: float, pixels) -> bytes:
    """One image record payload: ``u32 h | u32 w | u32 c | f32 label |
    u8[h*w*c] pixels`` (HWC row-major, all little-endian). ``pixels``
    is any array-like coercible to a 3-D uint8 HWC array (a 2-D
    grayscale array gains a trailing channel axis of 1)."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    if px.ndim == 2:
        px = px[:, :, None]
    check(px.ndim == 3, "image record: pixels must be HWC (or HW)")
    h, w, c = px.shape
    return _IMAGE_HDR.pack(h, w, c, float(label)) + px.tobytes()


def decode_image_record(payload) -> Tuple[np.float32, np.ndarray]:
    """Decode one image payload to ``(label, pixels)`` — pixels an
    ``[h, w, c]`` uint8 view over the payload bytes. The length
    contract is strict: a payload whose byte length disagrees with its
    recorded shape raises DMLCError (byte parity with the engine's
    EngineError)."""
    n_bytes = len(payload)
    check(n_bytes >= _IMAGE_HDR.size,
          f"image record: payload shorter than its 16-byte header "
          f"({n_bytes} bytes)")
    h, w, c, label = _IMAGE_HDR.unpack_from(payload)
    npix = h * w * c
    check(n_bytes == _IMAGE_HDR.size + npix,
          f"image record: shape {h}x{w}x{c} disagrees with payload "
          f"length {n_bytes}")
    pixels = np.frombuffer(payload, dtype=np.uint8, count=npix,
                           offset=_IMAGE_HDR.size).reshape(h, w, c)
    return np.float32(label), pixels


class ImageRecordWriter:
    """RecordIO writer of raw HWC u8 image records — the Python golden
    for the engine's ABI-8 ``recordio_image`` decode lane (the MXNet-
    style ``.rec`` shape, raw/uniform pixels). Pixel runs that spell
    the frame magic at a 4-aligned payload position escape into
    multi-frame records via :class:`RecordIOWriter`, decoders stitch
    them back."""

    def __init__(self, stream: Stream):
        self._w = RecordIOWriter(stream)

    @property
    def escaped_magic_count(self) -> int:
        return self._w.escaped_magic_count

    def write(self, label: float, pixels) -> None:
        self._w.write_record(encode_image_record(label, pixels))


class RecordIOReader:
    """Reference: RecordIOReader (src/recordio.cc)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._eos = False

    def next_record(self) -> Optional[bytes]:
        """Next record payload, or None at end of stream."""
        if self._eos:
            return None
        s = self._stream
        parts: List[bytes] = []
        while True:
            head = s.read(4)
            if len(head) == 0:
                self._eos = True
                check(not parts, "RecordIO: truncated multi-frame record")
                return None
            check(len(head) == 4, "RecordIO: truncated magic")
            check(struct.unpack("<I", head)[0] == RECORDIO_MAGIC,
                  "RecordIO: invalid magic number")
            lrec = struct.unpack("<I", s.read_exact(4))[0]
            cflag, clen = decode_flag(lrec), decode_length(lrec)
            payload = s.read_exact(clen)
            pad = (-clen) % 4
            if pad:
                s.read_exact(pad)
            if cflag == 0:
                check(not parts, "RecordIO: whole-frame inside multi-frame")
                return payload
            if cflag == 1:
                check(not parts, "RecordIO: start-frame inside multi-frame")
                parts.append(payload)
            elif cflag == 2:
                check(bool(parts), "RecordIO: middle-frame without start")
                parts.append(payload)
            else:  # end
                check(bool(parts), "RecordIO: end-frame without start")
                parts.append(payload)
                # re-insert the escaped magic between frames
                return _MAGIC_BYTES.join(parts)


class RecordIOChunkReader:
    """Extract records from an in-memory chunk of whole frames.

    Reference: RecordIOChunkReader(InputSplit::Blob) — used on the
    parse side where InputSplit hands us chunk buffers aligned to frame
    boundaries.
    """

    def __init__(self, chunk: Union[bytes, memoryview]):
        self._data = memoryview(chunk)
        self._pos = 0

    def next_record(self) -> Optional[bytes]:
        d, n = self._data, len(self._data)
        parts: List[bytes] = []
        while True:
            if self._pos >= n:
                check(not parts, "RecordIO chunk: truncated multi-frame record")
                return None
            check(self._pos + 8 <= n, "RecordIO chunk: truncated frame header")
            magic, lrec = struct.unpack_from("<II", d, self._pos)
            check(magic == RECORDIO_MAGIC, "RecordIO chunk: invalid magic")
            cflag, clen = decode_flag(lrec), decode_length(lrec)
            start = self._pos + 8
            check(start + clen <= n, "RecordIO chunk: truncated payload")
            payload = bytes(d[start:start + clen])
            self._pos = start + clen + ((-clen) % 4)
            if cflag == 0:
                check(not parts, "RecordIO chunk: whole-frame inside multi-frame")
                return payload
            if cflag == 1:
                check(not parts, "RecordIO chunk: start inside multi-frame")
                parts.append(payload)
            elif cflag == 2:
                check(bool(parts), "RecordIO chunk: middle without start")
                parts.append(payload)
            else:
                check(bool(parts), "RecordIO chunk: end without start")
                parts.append(payload)
                return _MAGIC_BYTES.join(parts)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec
