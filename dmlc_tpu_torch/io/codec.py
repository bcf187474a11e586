"""ONE compressed-page codec for every on-disk page byte.

Copy of ``dmlc_tpu/io/codec.py`` with its imports rewritten to
``dmlc_tpu_torch``: the frame and its contract are the reference's byte
for byte, so a page either package encodes decodes in the other. A
zlib-backed page codec with a self-describing header; in the port its
one seam is ``RoundSpillWriter``'s v2 round pages (``data/row_iter.py``):
steady spill replay reads fewer bytes per round at the cost of one
decode. Trimmed: the reference's other two seams (hydrated objstore
blocks and the objstore wire), whose planes are not ported.

Page frame (little-endian, 20-byte header)::

    magic  u32  0x43505444 ("DTPC")
    ver    u8   1
    codec  u8   0 = stored (raw payload), 1 = zlib
    level  u16  zlib level (0 for stored)
    rawlen u64  decoded payload length
    crc    u32  zlib.crc32 of the decoded payload
    <payload>

Contract (pinned by tests/test_torch_codec.py against the reference):

- ``decode_page(encode_page(x, level)) == x`` for every level and every
  input — level 0 is a raw PASSTHROUGH (bytes unchanged) unless the
  input itself begins with the frame magic, which is wrapped in a
  stored frame so decode stays unambiguous;
- incompressible input (already-compressed data, random bytes) never
  grows more than the 20-byte header: when zlib does not shrink the
  page, the encoder falls back to a stored frame (or the passthrough);
- ``decode_page`` of a corrupt frame — bad version/codec id, truncated
  payload, a crc or length mismatch, undecompressable bytes — raises
  :class:`~dmlc_tpu_torch.utils.logging.DMLCError`, never returns
  shifted or partial bytes;
- bytes that do not start with the magic pass through ``decode_page``
  unchanged, so raw legacy pages stay readable.

Enable globally with ``DMLC_TPU_PAGE_CODEC_LEVEL=<1..9>`` (0 = raw,
the default; the reference's variable, so one setting gives both
packages the same format). Compression pays when an epoch waits on
the disk, and costs when it already waits on the CPU.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["encode_page", "decode_page", "is_encoded", "default_level",
           "tag", "PAGE_CODEC_MAGIC", "ENV_LEVEL", "HEADER_BYTES"]

PAGE_CODEC_MAGIC = 0x43505444  # b"DTPC" little-endian
ENV_LEVEL = "DMLC_TPU_PAGE_CODEC_LEVEL"

_HDR = struct.Struct("<IBBHQI")  # magic, ver, codec, level, rawlen, crc
HEADER_BYTES = _HDR.size
_MAGIC_BYTES = struct.pack("<I", PAGE_CODEC_MAGIC)
_VERSION = 1
_CODEC_STORED = 0
_CODEC_ZLIB = 1


def default_level() -> int:
    """The process default codec level: ``DMLC_TPU_PAGE_CODEC_LEVEL``
    clamped to [0, 9]; 0 (raw) on unset or unparseable."""
    env = os.environ.get(ENV_LEVEL)
    if not env:
        return 0
    try:
        return max(0, min(9, int(env)))
    except ValueError:
        return 0


def tag(level: int) -> str:
    """The sidecar/meta codec stamp for a level: "raw" or "zlib:N"."""
    return "raw" if level <= 0 else f"zlib:{int(level)}"


def is_encoded(data: bytes) -> bool:
    """Whether ``data`` carries the self-describing page frame."""
    return len(data) >= 4 and bytes(data[:4]) == _MAGIC_BYTES


def _frame(codec: int, level: int, raw: bytes, payload: bytes) -> bytes:
    return _HDR.pack(PAGE_CODEC_MAGIC, _VERSION, codec, level,
                     len(raw), zlib.crc32(raw)) + payload


def encode_page(data, level: Optional[int] = None) -> bytes:
    """Encode one page. ``level`` None resolves :func:`default_level`;
    0 is the raw passthrough (bytes unchanged — except raw input that
    itself starts with the frame magic, which is wrapped in a stored
    frame so :func:`decode_page` stays unambiguous). Levels 1-9
    compress with zlib, falling back to a stored frame when the page
    does not shrink (incompressible input)."""
    data = bytes(data)
    if level is None:
        level = default_level()
    check(0 <= level <= 9, f"codec: bad zlib level {level}")
    if level <= 0:
        if is_encoded(data):
            return _frame(_CODEC_STORED, 0, data, data)
        return data
    comp = zlib.compress(data, level)
    if len(comp) + HEADER_BYTES < len(data):
        return _frame(_CODEC_ZLIB, level, data, comp)
    if is_encoded(data):
        return _frame(_CODEC_STORED, 0, data, data)
    return data


def decode_page(data) -> bytes:
    """Decode one page: framed pages are validated (version, codec id,
    length, crc) and decompressed; anything else passes through
    unchanged (raw pages stay readable). A corrupt or truncated frame
    raises DMLCError — never shifted/partial bytes."""
    data = bytes(data)
    if not is_encoded(data):
        return data
    check(len(data) >= HEADER_BYTES,
          f"codec: truncated page header ({len(data)} of "
          f"{HEADER_BYTES} bytes)")
    magic, ver, codec, level, rawlen, crc = _HDR.unpack_from(data)
    check(ver == _VERSION, f"codec: unknown page version {ver}")
    payload = data[HEADER_BYTES:]
    if codec == _CODEC_STORED:
        raw = payload
    elif codec == _CODEC_ZLIB:
        try:
            raw = zlib.decompress(payload)
        except zlib.error as e:
            raise DMLCError(f"codec: corrupt compressed page ({e})") \
                from e
    else:
        raise DMLCError(f"codec: unknown codec id {codec}")
    check(len(raw) == rawlen,
          f"codec: decoded length {len(raw)} != recorded {rawlen} "
          "(truncated or torn page)")
    check(zlib.crc32(raw) == crc,
          "codec: page crc mismatch (corrupt payload)")
    return raw
