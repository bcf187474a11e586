"""Numeric text parsing — the frozen golden semantics.

Reference: include/dmlc/strtonum.h (ParseFloat/ParseDouble/ParseSignedIndex,
locale-free isspace/isdigit). The reference's float parse is a hand-rolled
accumulate-and-scale loop that is NOT exactly IEEE-rounded for long
mantissas; rather than reproduce that accident, this framework FREEZES the
parity contract as:

    decimal string --strtod--> nearest float64 --cast--> float32

Both the Python golden (this file: Python ``float`` is exactly strtod) and
the C++ engine (std::from_chars<double>, correctly rounded, then
static_cast<float>) implement this contract, so CSR value arrays are
byte-identical across paths. tests/test_strtonum.py locks it with property
tests over adversarial decimal strings.

Integer parse: base-10, optional sign, no locale (C++ from_chars<int64>).
"""

from __future__ import annotations

import numpy as np

__all__ = ["parse_float32", "parse_float64", "parse_index", "parse_uint64",
           "F32"]

F32 = np.float32


def parse_float64(token: bytes) -> float:
    """strtod semantics (Python float is correctly-rounded strtod).

    Python's float() additionally tolerates digit-group underscores
    ("1_0" == 10.0) which strtod/from_chars reject; the contract is
    strtod, so underscores are rejected here for engine parity.
    """
    if (b"_" if isinstance(token, (bytes, bytearray)) else "_") in token:
        raise ValueError(f"invalid float literal {token!r}")
    return float(token)


_F32_MAX = float(np.finfo(np.float32).max)


def parse_float32(token: bytes) -> np.float32:
    """The frozen contract: nearest-double, then cast to float32."""
    d = parse_float64(token)
    if -_F32_MAX <= d <= _F32_MAX:
        return np.float32(d)
    # overflow saturates to ±inf BY CONTRACT (strtof semantics); the
    # errstate guard silences numpy's RuntimeWarning, entered only on
    # this rare branch — not per token in the hot loop
    with np.errstate(over="ignore"):
        return np.float32(d)


def parse_uint64(token: bytes) -> int:
    """Frozen unsigned-index contract: optional leading '+', ASCII digits
    only (no '-', no underscores, no whitespace), must fit uint64 —
    exactly the C++ engine's inline digit scan / from_chars<uint64>."""
    t = bytes(token)
    if t[:1] == b"+" and len(t) > 1:
        t = t[1:]
    if not t or not t.isdigit():  # bytes.isdigit() is ASCII-only
        raise ValueError(f"invalid index literal {token!r}")
    v = int(t)
    if v > 0xFFFFFFFFFFFFFFFF:
        raise ValueError(f"index out of uint64 range: {token!r}")
    return v


def parse_index(token: bytes) -> int:
    """Base-10 signed int64 (reference: ParseSignedIndex): optional
    '+'/'-', ASCII digits only — matches C++ from_chars<int64>."""
    t = bytes(token)
    body = t[1:] if t[:1] in (b"+", b"-") and len(t) > 1 else t
    if not body or not body.isdigit():
        raise ValueError(f"invalid integer literal {token!r}")
    v = int(t)
    if not (-(2 ** 63) <= v < 2 ** 63):
        raise ValueError(f"integer out of int64 range: {token!r}")
    return v
