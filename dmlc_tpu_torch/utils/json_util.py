"""JSON (de)serialization over Streams.

Copy of ``dmlc_tpu/utils/json_util.py`` with its imports rewritten to
``dmlc_tpu_torch``: ``json_dump`` writes ``indent=2, sort_keys=True``, so
the checkpoints' ``meta.json`` and shard indexes are byte-identical to
the reference's.

Reference: include/dmlc/json.h — JSONReader/JSONWriter (hand-rolled
recursive descent with STL-container type-traits), JSONObjectReadHelper
(DeclareField/ReadAllFields), DMLC_JSON_ENABLE_ANY.

Python has a JSON parser; the value here is the reference's ergonomics:
stream-bound read/write, numpy-aware encoding, and a typed field helper
that validates required/unknown keys when loading structured metadata
(used by checkpoints). Parsing is Python's own.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["json_dump", "json_load", "JSONObjectReadHelper", "to_jsonable"]


def to_jsonable(obj: Any) -> Any:
    """Recursively convert numpy scalars/arrays to JSON-encodable values.
    Arrays become {"__ndarray__": {dtype, shape, data(b64)}}."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__ndarray__": {
            "dtype": a.dtype.newbyteorder("<").str,
            "shape": list(a.shape),
            "data": base64.b64encode(
                a.astype(a.dtype.newbyteorder("<"), copy=False)
                .tobytes()).decode("ascii")}}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode("ascii")}
    return obj


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__ndarray__" in obj and len(obj) == 1:
            meta = obj["__ndarray__"]
            raw = base64.b64decode(meta["data"])
            return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(
                meta["shape"]).copy()
        if "__bytes__" in obj and len(obj) == 1:
            return base64.b64decode(obj["__bytes__"])
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


def json_dump(obj: Any, stream: Stream, indent: Optional[int] = 2) -> None:
    """Write obj as JSON onto a Stream (reference: JSONWriter)."""
    text = json.dumps(to_jsonable(obj), indent=indent, sort_keys=True)
    stream.write(text.encode("utf-8"))


def json_load(stream: Stream) -> Any:
    """Read one JSON document from a Stream (reference: JSONReader)."""
    raw = stream.read_all()
    try:
        return _from_jsonable(json.loads(raw.decode("utf-8")))
    except json.JSONDecodeError as e:
        raise DMLCError(f"invalid JSON: {e}") from None


class JSONObjectReadHelper:
    """Typed field extraction from a JSON object
    (reference: JSONObjectReadHelper::DeclareField/ReadAllFields)."""

    def __init__(self):
        self._fields: Dict[str, tuple] = {}

    def declare_field(self, name: str, dtype: Optional[Type] = None,
                      optional: bool = False, default: Any = None,
                      convert: Optional[Callable[[Any], Any]] = None
                      ) -> "JSONObjectReadHelper":
        self._fields[name] = (dtype, optional, default, convert)
        return self

    def read_all_fields(self, obj: Dict[str, Any],
                        allow_unknown: bool = False) -> Dict[str, Any]:
        check(isinstance(obj, dict), "JSON object expected")
        out: Dict[str, Any] = {}
        for name, (dtype, optional, default, convert) in self._fields.items():
            if name not in obj:
                if not optional:
                    raise DMLCError(f"JSON: required field {name!r} missing; "
                                    f"declared: {sorted(self._fields)}")
                out[name] = default
                continue
            v = obj[name]
            if convert is not None:
                v = convert(v)
            if dtype is not None and not isinstance(v, dtype):
                raise DMLCError(
                    f"JSON: field {name!r} expected {dtype.__name__}, "
                    f"got {type(v).__name__}")
            out[name] = v
        if not allow_unknown:
            unknown = set(obj) - set(self._fields)
            if unknown:
                raise DMLCError(f"JSON: unknown field(s) {sorted(unknown)}")
        return out
