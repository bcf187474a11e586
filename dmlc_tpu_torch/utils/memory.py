"""Reusable host-buffer pools.

Copy of ``dmlc_tpu/utils/memory.py`` with its imports rewritten to
``dmlc_tpu_torch``. Reference: include/dmlc/memory.h — MemoryPool
(size-classed), ThreadlocalAllocator/ThreadlocalSharedPtr. What gets
recycled here are the host staging buffers of ``io/cuda_fs.py``'s
device chunks: allocation churn on the host→device edge is the
analogue of the reference's free-list concern.

Trimmed from the reference: ``thread_local_pool`` does not register its
pool with the obs metrics registry (``buffer_pool/<thread>``), which is
not ported. Added: ``pin=True`` pools hold page-locked buffers, so a
copy from one to the card runs asynchronously (``cuda_fs.device_chunks``
stages through them).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from dmlc_tpu_torch.utils.logging import check

__all__ = ["BufferPool", "thread_local_pool"]


class BufferPool:
    """Size-classed pool of reusable numpy buffers (reference: MemoryPool).

    acquire() rounds the request up to the next power of two and reuses a
    released buffer of that class when available; release() returns it.
    Buffers are 1-D uint8; view/reshape at the call site. With ``pin``
    they are numpy views of page-locked torch tensors (which needs a
    CUDA build of torch).
    """

    def __init__(self, max_buffers_per_class: int = 8, pin: bool = False):
        self._lock = threading.Lock()
        self._free: Dict[int, List[np.ndarray]] = {}
        self._max_per_class = max_buffers_per_class
        self.pin = pin
        self.allocated = 0
        self.reused = 0

    @staticmethod
    def _size_class(nbytes: int) -> int:
        c = 256
        while c < nbytes:
            c <<= 1
        return c

    def acquire(self, nbytes: int) -> np.ndarray:
        check(nbytes >= 0, "negative buffer size")
        cls = self._size_class(nbytes)
        with self._lock:
            bucket = self._free.get(cls)
            if bucket:
                self.reused += 1
                return bucket.pop()
        self.allocated += 1
        if self.pin:
            import torch
            # the view keeps its tensor (and so the pinned block) alive
            return torch.empty(cls, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(cls, np.uint8)

    def release(self, buf: np.ndarray) -> None:
        cls = self._size_class(len(buf))
        if len(buf) != cls:
            return  # a view or foreign buffer, not one of ours: drop it
        with self._lock:
            bucket = self._free.setdefault(cls, [])
            if len(bucket) < self._max_per_class:
                bucket.append(buf)

    def stats(self) -> Tuple[int, int]:
        return self.allocated, self.reused


_tls = threading.local()


def thread_local_pool(pin: bool = False) -> BufferPool:
    """Per-thread pool (reference: ThreadlocalAllocator); a thread has
    one pool of pageable and one of pinned buffers."""
    name = "pinned" if pin else "pool"
    pool = getattr(_tls, name, None)
    if pool is None:
        pool = BufferPool(pin=pin)
        setattr(_tls, name, pool)
    return pool
