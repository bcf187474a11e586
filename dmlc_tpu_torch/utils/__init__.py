"""Core utilities layer (reference: include/dmlc/{logging,registry,parameter,
config,serializer,timer}.h).

Counterpart of ``dmlc_tpu/utils/__init__.py``, with the same exports;
``Profiler``/``profiler`` come from the port's ``obs/trace.py``.
"""

from dmlc_tpu_torch.utils.logging import (
    DMLCError, check, check_eq, check_ne, check_lt, check_le, check_gt,
    check_ge, check_notnone, log_info, log_warning, log_error, log_fatal,
    set_log_sink,
)
from dmlc_tpu_torch.utils.registry import Registry
from dmlc_tpu_torch.utils.parameter import Parameter, field, get_env, ParamError
from dmlc_tpu_torch.utils.config import Config
from dmlc_tpu_torch.utils.timer import get_time
from dmlc_tpu_torch.utils.concurrency import (
    ConcurrentBlockingQueue, PriorityBlockingQueue,
)
from dmlc_tpu_torch.utils.thread_group import (
    ManualEvent, ThreadGroup, ThreadLocalStore,
)
from dmlc_tpu_torch.utils.memory import BufferPool, thread_local_pool
# canonical home since the obs/ subsystem; utils.profiler is a
# deprecation shim over these same objects
from dmlc_tpu_torch.obs.trace import Profiler, profiler

__all__ = [
    "DMLCError", "check", "check_eq", "check_ne", "check_lt", "check_le",
    "check_gt", "check_ge", "check_notnone", "log_info", "log_warning",
    "log_error", "log_fatal", "set_log_sink", "Registry", "Parameter",
    "field", "get_env", "ParamError", "Config", "get_time",
    "ConcurrentBlockingQueue", "PriorityBlockingQueue", "ManualEvent",
    "ThreadGroup", "ThreadLocalStore", "BufferPool", "thread_local_pool",
    "Profiler", "profiler",
]
