"""Native C++ engine loader.

The hot byte path (InputSplit sharding, text→CSR parse, padded batch
assembly) has a C++ implementation (native/src/engine.cc) built as a
shared library and bound via ctypes. This module builds it at first use
(``native/build.py``, into ``dmlc_tpu_torch/build/``) and loads it; when
it cannot be built, ``engine="auto"`` parsers use the pure-Python golden
engines with identical semantics and ``engine="native"`` raises.
"""

from __future__ import annotations

import threading
from typing import Optional

_lib = None
_tried = False
_load_error: Optional[str] = None
_lock = threading.Lock()


def native_available() -> bool:
    """Build (at first use) and load the engine; False when that fails
    (the reason is kept for :func:`get_lib`'s error)."""
    global _lib, _tried, _load_error
    with _lock:
        if not _tried:
            _tried = True
            try:
                from dmlc_tpu_torch.native import bindings, build
                _lib = bindings.load(build.build())
            except Exception as e:  # noqa: BLE001
                _lib = None
                _load_error = str(e)
                from dmlc_tpu_torch.utils.logging import log_warning
                log_warning(f"native engine unusable ({_load_error}); "
                            "engine='auto' parsers use the Python engines")
    return _lib is not None


def get_lib():
    if not native_available():
        from dmlc_tpu_torch.utils.logging import DMLCError
        raise DMLCError(f"native engine unavailable: {_load_error}")
    return _lib
