"""Logging and CHECK utilities.

TPU-native analogue of the reference's glog-subset (reference:
include/dmlc/logging.h — LOG(severity), CHECK/CHECK_EQ..., dmlc::Error,
DMLC_LOG_CUSTOMIZE pluggable sink, fatal-throws behavior).

Design decisions vs the reference:
- Fatal always raises ``DMLCError`` (the reference's DMLC_LOG_FATAL_THROW=1
  mode) — idiomatic for Python, and what downstream (XGBoost) relies on.
- The sink is pluggable via :func:`set_log_sink` (DMLC_LOG_CUSTOMIZE analogue).
- CHECK failures include the stringified operands, like the reference's
  ``CHECK_EQ(a, b) << msg`` streaming output.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Any, Callable, Optional

__all__ = [
    "DMLCError", "check", "check_eq", "check_ne", "check_lt", "check_le",
    "check_gt", "check_ge", "check_notnone", "log_info", "log_warning",
    "log_error", "log_fatal", "set_log_sink",
]


class DMLCError(RuntimeError):
    """Raised on CHECK failure / LOG(FATAL) (reference: dmlc::Error in logging.h)."""


_logger = logging.getLogger("dmlc_tpu_torch")
if not _logger.handlers:  # default sink: stderr with glog-ish format
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "[%(asctime)s] %(levelname)s %(filename)s:%(lineno)d: %(message)s",
        datefmt="%H:%M:%S"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)

# Optional custom sink: fn(level: str, message: str). When set, replaces the
# stdlib logger for non-fatal messages (DMLC_LOG_CUSTOMIZE analogue).
_custom_sink: Optional[Callable[[str, str], None]] = None


def set_log_sink(sink: Optional[Callable[[str, str], None]]) -> None:
    """Install a custom log sink ``fn(level, message)``; ``None`` restores default."""
    global _custom_sink
    _custom_sink = sink


def _emit(level: int, levelname: str, msg: str) -> None:
    if _custom_sink is not None:
        _custom_sink(levelname, msg)
    else:
        _logger.log(level, msg, stacklevel=3)


def log_info(msg: str) -> None:
    _emit(logging.INFO, "INFO", msg)


def log_warning(msg: str) -> None:
    _emit(logging.WARNING, "WARNING", msg)


def log_error(msg: str) -> None:
    _emit(logging.ERROR, "ERROR", msg)


def log_fatal(msg: str) -> None:
    """LOG(FATAL): emit and raise DMLCError (reference fatal-throw mode)."""
    _emit(logging.CRITICAL, "FATAL", msg)
    raise DMLCError(msg)


def check(cond: Any, msg: str = "") -> None:
    """CHECK(cond): raise DMLCError if cond is falsy."""
    if not cond:
        raise DMLCError(f"Check failed: {msg}" if msg else "Check failed")


def _check_bin(op: str, ok: bool, a: Any, b: Any, msg: str) -> None:
    if not ok:
        detail = f"Check failed: {a!r} {op} {b!r}"
        raise DMLCError(f"{detail}: {msg}" if msg else detail)


def check_eq(a: Any, b: Any, msg: str = "") -> None:
    _check_bin("==", a == b, a, b, msg)


def check_ne(a: Any, b: Any, msg: str = "") -> None:
    _check_bin("!=", a != b, a, b, msg)


def check_lt(a: Any, b: Any, msg: str = "") -> None:
    _check_bin("<", a < b, a, b, msg)


def check_le(a: Any, b: Any, msg: str = "") -> None:
    _check_bin("<=", a <= b, a, b, msg)


def check_gt(a: Any, b: Any, msg: str = "") -> None:
    _check_bin(">", a > b, a, b, msg)


def check_ge(a: Any, b: Any, msg: str = "") -> None:
    _check_bin(">=", a >= b, a, b, msg)


def check_notnone(a: Any, msg: str = "") -> Any:
    """CHECK_NOTNULL analogue: raises if a is None, else returns a."""
    if a is None:
        raise DMLCError(f"Check notnone failed: {msg}" if msg else
                        "Check notnone failed")
    return a
