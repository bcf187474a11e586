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

``yield_hook``/``set_yield_hook`` are the port's cooperative yield
seam: the thread serving a scheduled pull (pipeline.scheduler) carries
a callback that long CPU-bound Python loops (the golden text parsers)
call every few records, so a lower-priority tenant's parse can be held
at a record boundary while a higher-priority tenant's pull is in
flight. Threads that serve no tenant carry none, and the loops then
run as before.
"""

from __future__ import annotations

import heapq
import threading
from typing import (Any, Callable, Generic, List, Optional, Tuple,
                    TypeVar)

T = TypeVar("T")

__all__ = ["ConcurrentBlockingQueue", "PriorityBlockingQueue",
           "yield_hook", "set_yield_hook", "YieldingRecords"]

_yield = threading.local()


def yield_hook() -> Optional[Callable[[], None]]:
    """This thread's cooperative yield callback, or None."""
    return getattr(_yield, "hook", None)


def set_yield_hook(hook: Optional[Callable[[], None]]
                   ) -> Optional[Callable[[], None]]:
    """Set this thread's yield callback; returns the previous one (so a
    nested setter can restore it)."""
    prev = getattr(_yield, "hook", None)
    _yield.hook = hook
    return prev


class YieldingRecords(list):
    """A record list whose iteration calls ``hook`` before every
    ``EVERY``-th record: a golden parse loop over it (about 50 us a
    libsvm line) reaches a yield point about once a millisecond without
    knowing of the scheduler."""

    EVERY = 16

    def __init__(self, records, hook: Callable[[], None]):
        super().__init__(records)
        self._hook = hook

    def __iter__(self):
        hook = self._hook
        for i, rec in enumerate(super().__iter__()):
            if i % self.EVERY == 0:
                hook()
            yield rec


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
