"""Producer-thread prefetch iterator.

Reference: include/dmlc/threadediter.h — ThreadedIter<DType>: one producer
thread + bounded queue, consumer pulls with Next(); producer exceptions are
captured and rethrown in the consumer's Next() (the semantics locked by the
reference's unittest_threaditer_exc_handling); BeforeFirst() restarts the
producer; Destroy() joins it.

Protocol here: ``next_fn() -> item | None`` (None = end of stream, the
reference's ``Next(DType**) -> false``), ``before_first_fn()`` rewinds the
underlying source. Items flow through a bounded queue tagged with an epoch
so a BeforeFirst mid-stream discards stale items without data races.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, Optional, TypeVar

from dmlc_tpu_torch.utils.logging import check

T = TypeVar("T")

_DATA, _END, _EXC = 0, 1, 2


class ThreadedIter(Generic[T]):
    """Background prefetch with faithful exception semantics."""

    def __init__(self, max_capacity: int = 8):
        check(max_capacity >= 1, "max_capacity must be >= 1")
        self._cap = max_capacity
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue: list = []
        self._epoch = 0           # consumer's current epoch
        self._producer_wake = threading.Event()
        self._destroyed = False
        self._ended = False
        self._thread: Optional[threading.Thread] = None
        self._next_fn: Optional[Callable[[], Optional[T]]] = None
        self._before_first_fn: Optional[Callable[[], None]] = None

    # -- setup (reference: Init(next_fn, beforefirst_fn))

    def init(self, next_fn: Callable[[], Optional[T]],
             before_first_fn: Optional[Callable[[], None]] = None) -> None:
        check(self._thread is None, "ThreadedIter.init called twice")
        self._next_fn = next_fn
        self._before_first_fn = before_first_fn
        self._producer_wake.set()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dmlc_tpu_torch.ThreadedIter")
        self._thread.start()

    # -- producer loop

    def _run(self) -> None:
        while True:
            self._producer_wake.wait()
            if self._destroyed:
                return
            self._producer_wake.clear()
            with self._lock:
                epoch = self._epoch
            if epoch > 0 and self._before_first_fn is not None:
                try:
                    self._before_first_fn()
                except BaseException as e:  # noqa: BLE001
                    self._emit(epoch, _EXC, e)
                    continue
            while True:
                if self._destroyed:
                    return
                with self._lock:
                    if self._epoch != epoch:
                        break  # BeforeFirst happened: restart outer loop
                try:
                    item = self._next_fn()
                except BaseException as e:  # noqa: BLE001
                    self._emit(epoch, _EXC, e)
                    break
                if item is None:
                    self._emit(epoch, _END, None)
                    break
                if not self._emit(epoch, _DATA, item):
                    break
            # wait for next BeforeFirst/destroy
            if not self._destroyed:
                self._producer_wake.wait()
                if self._destroyed:
                    return
                # loop back: epoch changed

    def _emit(self, epoch: int, kind: int, payload: Any) -> bool:
        """Bounded put; returns False if the epoch went stale or destroyed.

        Plain (untimed) waits: every state change that can unblock this —
        consumer pop, before_first's epoch bump, destroy — notifies
        _not_full under the lock, so no polling wake-ups are needed.
        """
        with self._lock:
            while len(self._queue) >= self._cap:
                if self._destroyed or self._epoch != epoch:
                    return False
                self._not_full.wait()
            if self._destroyed or self._epoch != epoch:
                return False
            self._queue.append((epoch, kind, payload))
            self._not_empty.notify()
            return True

    # -- consumer side

    def next(self) -> Optional[T]:
        """Next item; None at end; rethrows producer exceptions
        (reference: Next(DType**) + exception_ptr rethrow)."""
        check(self._thread is not None, "ThreadedIter not initialized")
        if self._ended:
            return None
        while True:
            with self._lock:
                while not self._queue:
                    if self._destroyed:
                        return None
                    self._not_empty.wait()  # _emit/destroy always notify
                epoch, kind, payload = self._queue.pop(0)
                self._not_full.notify()
                if epoch != self._epoch:
                    continue  # stale from before BeforeFirst
            if kind == _DATA:
                return payload
            if kind == _END:
                self._ended = True
                return None
            self._ended = True  # _EXC: stream is dead until BeforeFirst
            raise payload

    def before_first(self) -> None:
        """Restart iteration (reference: BeforeFirst)."""
        check(self._thread is not None, "ThreadedIter not initialized")
        with self._lock:
            self._epoch += 1
            self._queue.clear()
            self._not_full.notify_all()
        self._ended = False
        self._producer_wake.set()

    def destroy(self) -> None:
        """Stop the producer and join (reference: Destroy/dtor)."""
        with self._lock:
            self._destroyed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()
        self._producer_wake.set()
        if self._thread is not None:
            try:
                self._thread.join(timeout=5.0)
            except TypeError:
                # interpreter shutdown: threading internals are already
                # torn down when an abandoned generator's finally runs
                # destroy from a late GC — the daemon thread dies with
                # the process either way
                pass
            self._thread = None

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
