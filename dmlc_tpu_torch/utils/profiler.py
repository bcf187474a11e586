"""DEPRECATED shim — the span API lives in :mod:`dmlc_tpu_torch.obs.trace`.

Counterpart of ``dmlc_tpu/utils/profiler.py``. Its whole API
(``Profiler``/``StageStats``/the global ``profiler``/``trace``) lives in
``dmlc_tpu_torch.obs.trace``, where ``Profiler.stage()`` also feeds the
trace-event ring buffer, so there is ONE span vocabulary. Importing
names from here keeps working but warns; ``trace`` is the old name of
the device-timeline hook, :func:`dmlc_tpu_torch.obs.trace.cuda_trace`.
"""

from __future__ import annotations

import warnings

_EXPORTS = {"Profiler", "StageStats", "profiler", "trace"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        warnings.warn(
            "dmlc_tpu_torch.utils.profiler is deprecated; use "
            "dmlc_tpu_torch.obs (obs.trace.Profiler / obs.trace.cuda_trace)",
            DeprecationWarning, stacklevel=2)
        from dmlc_tpu_torch.obs import trace as _trace
        return _trace.cuda_trace if name == "trace" else getattr(_trace,
                                                                 name)
    raise AttributeError(name)
