"""Async host→device double-buffered batch iterator.

Counterpart of ``dmlc_tpu/parallel/device_iter.py``. While the model
consumes batch t, batch t+1 is already in flight to the card: each H2D
copy is enqueued ``non_blocking`` on a dedicated copy stream, a CUDA
event is recorded after it, and the consumer's stream waits on that
event before it touches the batch (``record_stream`` tells the caching
allocator that the consumer stream uses the memory).

With ``staging=True`` each batch is first copied into a reusable pinned
host slot (:class:`HostStaging`), the copy to the card is enqueued FROM
the slot, and the source arrays are free the moment the staged copy
lands — so a leased native-engine block returns to its arena while its
bytes are still in flight. A slot is reused only after the event
recorded behind its H2D copy has completed.

On the CPU the "copy" is ``torch.from_numpy``, which ALIASES host
memory (as the reference's CPU ``device_put`` does): a released slot is
then never reused — ownership passes to the consumer.

Each batch is a dict of numpy arrays (or numpy scalars) and comes out
as a dict of tensors with the same keys, shapes and dtypes: the index
keeps its layout dtype (u32 stays 4 bytes an index across the edge).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

__all__ = ["device_prefetch", "DeviceIter", "HostStaging"]


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class HostStaging:
    """Reusable host-side staging slots for H2D double-buffering.

    ``stage(arrs)`` copies a dict of arrays into a free slot whose
    shapes/dtypes match (allocating one when none does) and returns the
    slot: a dict of CPU tensors, pinned when ``pin`` is set. The caller
    enqueues the H2D copy from the slot and hands it back with
    ``release(slot, event)``; the slot is reused once ``event`` (the CUDA
    event recorded after that copy) has completed. Fixed-shape batches
    (the padded steady path) reuse the same slots forever.

    ``alias_unsafe`` marks a target that may ALIAS the slot (the CPU):
    there a released slot is NOT reused, since the consumer's tensors
    are the slot itself.
    """

    def __init__(self, slots: int = 2, pin: bool = False,
                 alias_unsafe: bool = False):
        self.slots = max(2, int(slots))
        self.pin = pin
        self.alias_unsafe = alias_unsafe
        self._free: List[Dict[str, torch.Tensor]] = []
        self._busy: collections.deque = collections.deque()
        self.allocated = 0

    @staticmethod
    def _matches(slot: Dict[str, torch.Tensor],
                 arrs: Dict[str, np.ndarray]) -> bool:
        if slot.keys() != arrs.keys():
            return False
        return all(tuple(slot[k].shape) == a.shape
                   and slot[k].dtype == _torch_dtype(a)
                   for k, a in arrs.items())

    def _reclaim(self, wait: bool) -> None:
        """Move busy slots whose H2D copy has completed to the free list;
        with ``wait``, block on the oldest one first."""
        if wait and self._busy:
            self._busy[0][1].synchronize()
        while self._busy and self._busy[0][1].query():
            self._free.append(self._busy.popleft()[0])

    def _take(self, arrs: Dict[str, np.ndarray]):
        for i, s in enumerate(self._free):
            if self._matches(s, arrs):
                return self._free.pop(i)
        return None

    def stage(self, arrs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Copy ``arrs`` into a staging slot; the source arrays are dead
        to this pool after the call."""
        arrs = {k: np.asarray(v) for k, v in arrs.items()}
        self._reclaim(wait=False)
        slot = self._take(arrs)
        if slot is None and self._busy and self.allocated >= self.slots:
            self._reclaim(wait=True)
            slot = self._take(arrs)
        if slot is None:
            slot = {k: torch.empty(a.shape, dtype=_torch_dtype(a),
                                   pin_memory=self.pin)
                    for k, a in arrs.items()}
            self.allocated += 1
        for k, a in arrs.items():
            slot[k].copy_(torch.from_numpy(a))
        return slot

    def release(self, slot: Dict[str, torch.Tensor],
                event: Optional[torch.cuda.Event] = None) -> None:
        """The H2D copy from ``slot`` was enqueued before ``event``:
        recycle the slot once the event completes (never, on targets
        that alias the slot)."""
        if self.alias_unsafe:
            self.allocated -= 1
        elif event is None:
            self._free.append(slot)
        else:
            self._busy.append((slot, event))


def _to_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def device_prefetch(host_batches: Iterable[Dict[str, Any]], size: int = 2,
                    device=None,
                    staging: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield device-resident batches with ``size`` copies in flight.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the host.
    Without staging, a batch must own its buffers until its copy has
    been enqueued (a pageable-memory H2D copy has read its source when
    it returns); on the CPU the yielded tensors alias the source arrays.
    ``staging=True`` routes every batch through a :class:`HostStaging`
    pool of pinned slots (see the module docstring): the source arrays,
    e.g. leased native views, are free as soon as the batch is pulled.
    """
    device = _device(device)
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    pool = (HostStaging(slots=size, pin=on_cuda, alias_unsafe=not on_cuda)
            if staging else None)
    queue: collections.deque = collections.deque()
    it = iter(host_batches)

    def _enqueue():
        batch = next(it)  # StopIteration propagates to the caller
        src = pool.stage(batch) if pool is not None else _to_tensors(batch)
        if not on_cuda:
            out = {k: t.to(device) for k, t in src.items()}
            if pool is not None:
                pool.release(src)
            return out, None
        with torch.cuda.stream(copy_stream):
            out = {k: t.to(device, non_blocking=True)
                   for k, t in src.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        if pool is not None:
            pool.release(src, event)
        return out, event

    def _drain(entry):
        out, event = entry
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        return out

    try:
        for _ in range(size):
            queue.append(_enqueue())
    except StopIteration:
        pass
    while queue:
        entry = queue.popleft()
        try:
            queue.append(_enqueue())
        except StopIteration:
            pass
        yield _drain(entry)


class DeviceIter:
    """DataIter-protocol wrapper around device_prefetch
    (reference: ThreadedIter's consumer API, device-side)."""

    def __init__(self, host_iter_factory: Callable[[], Iterable],
                 size: int = 2, device=None, staging: bool = False):
        self._factory = host_iter_factory
        self._size = size
        self._device = _device(device)
        self._staging = staging
        self._gen: Optional[Iterator] = None
        self._value = None

    def before_first(self) -> None:
        self._gen = device_prefetch(self._factory(), self._size,
                                    self._device, self._staging)
        self._value = None

    def next(self) -> bool:
        if self._gen is None:
            self.before_first()
        try:
            self._value = next(self._gen)
            return True
        except StopIteration:
            self._value = None
            return False

    def value(self):
        return self._value

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self.value()
