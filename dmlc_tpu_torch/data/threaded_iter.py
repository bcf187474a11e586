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

The queue's occupancy (``qsize``), its bound (``capacity``,
``set_capacity``) and the producer's epoch counters (``stats``) are what
the pipeline's stage probes and autotuner read
(``dmlc_tpu_torch.pipeline``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Generic, Optional, TypeVar

from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.obs import watchdog as _watchdog
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.utils.logging import check

T = TypeVar("T")

_DATA, _END, _EXC = 0, 1, 2


class ThreadedIter(Generic[T]):
    """Background prefetch with faithful exception semantics.

    Observability (dmlc_tpu_torch.obs): BLOCKING producer/consumer waits
    on any ThreadedIter become trace spans (``<name>.producer_wait`` /
    ``<name>.consumer_wait``) and watchdog-registered waits — the
    watchdog must see every queue that can wedge, named or not.
    Unnamed queues record under the generic ``threaded_iter`` label
    (the stall report still distinguishes them by thread and queue
    detail); ``name`` additionally registers the queue's ``stats()``
    as a metrics collector ``queue/<name>`` until destroy(). Cost when
    no recorder/watchdog is installed: one module-global read per
    blocked wait; non-blocking operation is untouched.
    """

    def __init__(self, max_capacity: int = 8, name: Optional[str] = None):
        check(max_capacity >= 1, "max_capacity must be >= 1")
        self._cap = max_capacity
        self.name = name
        self._metrics_key = (
            _METRICS.register(f"queue/{name}", self, ThreadedIter._metrics)
            if name else None)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._queue: list = []
        self._epoch = 0           # consumer's current epoch
        self._produced = 0        # items enqueued this epoch
        self._producer_block_s = 0.0  # producer time blocked on a full
        # queue this epoch: with qsize() this tells producer-bound (empty
        # queue, no block time) from consumer-bound (full queue)
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
            t0 = None
            token = None
            while len(self._queue) >= self._cap:
                if self._destroyed or self._epoch != epoch:
                    _watchdog.end_wait(token)
                    return False
                if t0 is None:
                    t0 = time.perf_counter()
                    token = _watchdog.begin_wait(
                        f"{self.name or 'threaded_iter'}.producer_wait",
                        self._wait_detail)
                self._not_full.wait()
            if t0 is not None:
                _watchdog.end_wait(token)
                dt = time.perf_counter() - t0
                self._producer_block_s += dt
                rec = _trace.active()
                if rec is not None:
                    rec.complete(
                        f"{self.name or 'threaded_iter'}.producer_wait",
                        t0, dt, "queue")
            if self._destroyed or self._epoch != epoch:
                return False
            self._queue.append((epoch, kind, payload))
            if kind == _DATA:
                self._produced += 1
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
                t0 = None
                token = None
                while not self._queue:
                    if self._destroyed:
                        _watchdog.end_wait(token)
                        return None
                    if t0 is None:
                        t0 = time.perf_counter()
                        token = _watchdog.begin_wait(
                            f"{self.name or 'threaded_iter'}"
                            ".consumer_wait", self._wait_detail)
                    self._not_empty.wait()  # _emit/destroy always notify
                if t0 is not None:
                    _watchdog.end_wait(token)
                    rec = _trace.active()
                    if rec is not None:
                        rec.complete(
                            f"{self.name or 'threaded_iter'}"
                            ".consumer_wait", t0,
                            time.perf_counter() - t0, "queue")
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

    def recycle(self, item: T) -> None:
        """API parity with the reference's buffer recycling (no-op here)."""

    # -- introspection/tuning (pipeline probes + autotuner)

    def qsize(self) -> int:
        """Items currently buffered (occupancy sample for stage probes)."""
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """Epoch-scoped producer counters (reset by before_first): items
        produced and seconds the producer spent blocked on a full queue."""
        with self._lock:
            return {"produced": self._produced,
                    "producer_block_s": round(self._producer_block_s, 6)}

    def _metrics(self) -> dict:
        """Registered metrics-collector shape (obs.metrics)."""
        with self._lock:
            return {"qsize": len(self._queue), "capacity": self._cap,
                    "produced": self._produced,
                    "producer_block_s": round(self._producer_block_s, 6)}

    def _wait_detail(self) -> dict:
        """Watchdog diagnosis sample. Lock-free on purpose: called
        from the watchdog thread while a producer/consumer may be
        blocked — approximate-but-deadlock-proof beats exact."""
        return {"qsize": len(self._queue), "capacity": self._cap,
                "produced": self._produced, "ended": self._ended,
                "producer_block_s": round(self._producer_block_s, 6)}

    @property
    def capacity(self) -> int:
        return self._cap

    def set_capacity(self, n: int) -> None:
        """Resize the bounded queue between epochs (autotune knob). A
        grow wakes a producer blocked in _emit; a shrink takes effect as
        the consumer drains below the new bound — queued items are never
        dropped."""
        check(n >= 1, "capacity must be >= 1")
        with self._lock:
            self._cap = n
            self._not_full.notify_all()

    def before_first(self) -> None:
        """Restart iteration (reference: BeforeFirst)."""
        check(self._thread is not None, "ThreadedIter not initialized")
        with self._lock:
            self._epoch += 1
            self._queue.clear()
            self._produced = 0
            self._producer_block_s = 0.0
            self._not_full.notify_all()
        self._ended = False
        self._producer_wake.set()

    def destroy(self) -> None:
        """Stop the producer and join (reference: Destroy/dtor)."""
        if self._metrics_key is not None:
            _METRICS.unregister(self._metrics_key)
            self._metrics_key = None
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
