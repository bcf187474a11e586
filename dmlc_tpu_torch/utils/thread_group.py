"""Managed named threads + events.

Copy of ``dmlc_tpu/utils/thread_group.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Reference: include/dmlc/thread_group.h — ThreadGroup (named joinable
threads with lifecycle management), ManualEvent (set/wait/reset),
CriticalSection; include/dmlc/thread_local.h — ThreadLocalStore.

Python's threading gives most of this; the value preserved is the
group lifecycle contract (create → track by name → request shutdown →
join all) that MXNet-style engines rely on.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["ThreadGroup", "ManualEvent", "ThreadLocalStore"]


class ManualEvent:
    """Manual-reset event (reference: dmlc::ManualEvent)."""

    def __init__(self):
        self._event = threading.Event()

    def signal(self) -> None:
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def reset(self) -> None:
        self._event.clear()

    def is_set(self) -> bool:
        return self._event.is_set()


class _GroupThread:
    """One managed thread (reference: ThreadGroup::Thread)."""

    def __init__(self, group: "ThreadGroup", name: str,
                 fn: Callable[..., Any], args: tuple):
        self.name = name
        self._shutdown_requested = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(fn,) + args, name=name, daemon=True)
        self._group = group
        self._thread.start()

    def _run(self, fn, *args) -> None:
        try:
            fn(*args)
        finally:
            self._group._on_exit(self)

    def request_shutdown(self) -> None:
        self._shutdown_requested.set()

    @property
    def shutdown_requested(self) -> bool:
        return self._shutdown_requested.is_set()

    def joinable(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)


class ThreadGroup:
    """Named, joinable managed threads (reference: dmlc::ThreadGroup).

    Worker functions may poll ``thread.shutdown_requested`` for
    cooperative shutdown (the reference's request_shutdown_all contract).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: Dict[str, _GroupThread] = {}

    def create(self, name: str, fn: Callable[..., Any],
               *args: Any) -> _GroupThread:
        with self._lock:
            if name in self._threads and self._threads[name].joinable():
                raise DMLCError(f"thread {name!r} already running")
            t = _GroupThread(self, name, fn, args)
            self._threads[name] = t
            return t

    def thread(self, name: str) -> Optional[_GroupThread]:
        with self._lock:
            return self._threads.get(name)

    def size(self) -> int:
        with self._lock:
            return sum(1 for t in self._threads.values() if t.joinable())

    def request_shutdown_all(self) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.request_shutdown()

    def join_all(self, timeout_per_thread: Optional[float] = None) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.join(timeout_per_thread)

    def _on_exit(self, thread: _GroupThread) -> None:
        pass  # bookkeeping hook; name stays registered until replaced


class ThreadLocalStore:
    """Registered thread-local singleton store (reference:
    dmlc::ThreadLocalStore<T>::Get)."""

    _local = threading.local()

    @classmethod
    def get(cls, key: str, factory: Callable[[], Any]) -> Any:
        store = getattr(cls._local, "store", None)
        if store is None:
            store = cls._local.store = {}
        if key not in store:
            store[key] = factory()
        return store[key]
