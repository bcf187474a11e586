"""Concurrency primitives.

Copy of ``dmlc_tpu/utils/concurrency.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Reference: include/dmlc/concurrency.h — ConcurrentBlockingQueue<T,
{kFIFO,kPriority}> with Push/Pop/SignalForKill/Size, Spinlock.

The reference's vendored moodycamel lock-free queues
(include/dmlc/concurrentqueue.h) are an explicit non-goal (SURVEY.md §7):
CPython threads serialize on the GIL, and the C++ engine uses its own
bounded ring (native/src/threaded_iter.cc analogue) — a lock-free MPMC
queue buys nothing here.
"""

from __future__ import annotations

import heapq
import threading
from typing import Any, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")

__all__ = ["ConcurrentBlockingQueue", "PriorityBlockingQueue"]


class ConcurrentBlockingQueue(Generic[T]):
    """Bounded FIFO blocking queue with a kill signal.

    ``pop`` returns None after ``signal_for_kill`` (reference: Pop returns
    false) — consumers use that as shutdown.
    """

    def __init__(self, max_size: int = 0):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._items: List[T] = []
        self._max = max_size
        self._killed = False

    def push(self, item: T) -> bool:
        with self._lock:
            while self._max > 0 and len(self._items) >= self._max:
                if self._killed:
                    return False
                self._not_full.wait(0.1)
            if self._killed:
                return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        with self._lock:
            while not self._items:
                if self._killed:
                    return None
                if not self._not_empty.wait(timeout if timeout else 0.1):
                    if timeout is not None:
                        return None
            item = self._items.pop(0)
            self._not_full.notify()
            return item

    def signal_for_kill(self) -> None:
        with self._lock:
            self._killed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def size(self) -> int:
        with self._lock:
            return len(self._items)


class PriorityBlockingQueue(ConcurrentBlockingQueue[T]):
    """Priority variant (reference: ConcurrentQueueType::kPriority).
    Items are (priority, payload); higher priority pops first."""

    def push(self, item: Tuple[int, Any], priority: Optional[int] = None) -> bool:
        if priority is not None:
            item = (priority, item)
        with self._lock:
            while self._max > 0 and len(self._items) >= self._max:
                if self._killed:
                    return False
                self._not_full.wait(0.1)
            if self._killed:
                return False
            heapq.heappush(self._items, (-item[0], item[1]))
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None):
        with self._lock:
            while not self._items:
                if self._killed:
                    return None
                if not self._not_empty.wait(timeout if timeout else 0.1):
                    if timeout is not None:
                        return None
            neg, payload = heapq.heappop(self._items)
            self._not_full.notify()
            return (-neg, payload)
