"""Wall-clock timer (reference: include/dmlc/timer.h — dmlc::GetTime()).

Copy of ``dmlc_tpu/utils/timer.py``."""

import time

__all__ = ["get_time"]


def get_time() -> float:
    """Seconds since an arbitrary epoch, monotonic, high resolution."""
    return time.perf_counter()
