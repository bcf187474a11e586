"""One rate-limited warn channel for the whole package.

Copy of ``dmlc_tpu/obs/log.py``:

- :func:`warn_once` — emit a key's message at most once per process;
- :func:`warn_limited` — emit a key at most once per ``min_interval_s``
  (for conditions that can recur meaningfully, e.g. spill failures);
- gang deduplication — by default only rank 0 of a launch gang emits
  (``all_ranks=True`` opts out for rank-local facts); suppressed
  messages still count in the ``obs`` metrics registry
  (``log.suppressed`` counter) so they are not silently lost.

Messages flow through :func:`dmlc_tpu_torch.utils.logging.log_warning`,
so ``set_log_sink`` hooks and the glog-style formatting keep working.
Every EMITTED warning also lands on the trace timeline as an instant
event (``warn/<key>``, category ``log``) when a recorder is active.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["warn_once", "warn_limited", "reset"]

_lock = threading.Lock()
_last_emit: Dict[str, float] = {}


def _rank() -> int:
    from dmlc_tpu_torch.obs.metrics import worker_rank
    return worker_rank() or 0


def _suppress_count(reason: str) -> None:
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    REGISTRY.counter(f"log.suppressed.{reason}").inc()


def warn_limited(key: str, msg: str, min_interval_s: float = 60.0,
                 all_ranks: bool = False) -> bool:
    """Emit ``msg`` as a warning unless ``key`` fired within
    ``min_interval_s`` (or this is a nonzero gang rank and the message
    is not rank-local). Returns True when the message was emitted."""
    if not all_ranks and _rank() != 0:
        _suppress_count("rank")
        return False
    now = time.monotonic()
    with _lock:
        last = _last_emit.get(key)
        if last is not None and now - last < min_interval_s:
            _suppress_count("rate")
            return False
        _last_emit[key] = now
    from dmlc_tpu_torch.obs.trace import instant
    instant(f"warn/{key}", "log", {"msg": msg})
    from dmlc_tpu_torch.utils.logging import log_warning
    log_warning(msg)
    return True


def warn_once(key: str, msg: str, all_ranks: bool = False) -> bool:
    """Emit ``msg`` at most once per process for this ``key``."""
    return warn_limited(key, msg, min_interval_s=float("inf"),
                        all_ranks=all_ranks)


def reset() -> None:
    """Forget emission history (tests)."""
    with _lock:
        _last_emit.clear()
