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
as a :class:`DeviceBatch`, a dict of tensors with the same keys, shapes
and dtypes: the index keeps its layout dtype (u32 stays 4 bytes an index
across the edge).

Each stage copy emits a ``device.assemble`` span and each staged batch a
``device.xfer`` span (its window in flight: from its copy's enqueue to
its hand-off to the consumer, whose stream then waits on the copy's
event) into the active ``dmlc_tpu_torch.obs.trace`` recorder; the
``device.staging`` gauge counts the slots handed out and not yet
released.

The copy itself is :func:`copy_to_device` (enqueue, event behind) and
:func:`wait_copy` (the consumer's side); ``device_prefetch``, the
pipeline's ``to_device`` stage and ``parallel.sharded``'s serve thread
all move batches through these two.
"""

from __future__ import annotations

import collections
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS

__all__ = ["device_prefetch", "DeviceIter", "HostStaging", "DeviceBatch",
           "copy_to_device", "wait_copy", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` (``cuda`` when None), a ``cuda`` one with its card's
    index: the calling thread's current card (a rank's own, once
    ``init_from_env`` set it). A thread started later, such as a serve
    thread, has card 0 as its current card, so a bare ``cuda`` there
    would name card 0 whatever card the rank holds."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev



def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class HostStaging:
    """Reusable host-side staging slots for H2D double-buffering.

    ``acquire(spec)`` hands out a free slot of the shapes and dtypes in
    ``spec`` (``{key: (shape, numpy dtype)}``), allocating one when none
    matches: a dict of CPU tensors, pinned when ``pin`` is set, for the
    caller to fill in place (``parallel.sharded`` pads and stacks a round
    straight into it). ``stage(arrs)`` is ``acquire`` plus a copy of a
    dict of arrays into the slot. The caller enqueues the H2D copy from
    the slot and hands it back with ``release(slot, event)``; the slot is
    reused once ``event`` (the CUDA event recorded after that copy) has
    completed, and never handed out before. Fixed-shape batches (the
    padded steady path) reuse the same slots forever.

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
        self.in_flight = 0     # slots handed out and not yet released
        self.assemble_s = 0.0  # seconds spent staging, over the pool's life

    @staticmethod
    def _matches(slot: Dict[str, torch.Tensor],
                 spec: Dict[str, Tuple[tuple, np.dtype]]) -> bool:
        if slot.keys() != spec.keys():
            return False
        return all(tuple(slot[k].shape) == tuple(shape)
                   and slot[k].dtype == _torch_dtype(dtype)
                   for k, (shape, dtype) in spec.items())

    def _reclaim(self, wait: bool) -> None:
        """Move busy slots whose H2D copy has completed to the free list;
        with ``wait``, block on the oldest one first."""
        if wait and self._busy:
            self._busy[0][1].synchronize()
        while self._busy and self._busy[0][1].query():
            self._free.append(self._busy.popleft()[0])

    def _take(self, spec: Dict[str, Tuple[tuple, np.dtype]]):
        for i, s in enumerate(self._free):
            if self._matches(s, spec):
                return self._free.pop(i)
        return None

    def acquire(self, spec: Dict[str, Tuple[tuple, Any]]
                ) -> Dict[str, torch.Tensor]:
        """A free slot of the ``{key: (shape, dtype)}`` in ``spec``: a
        matching one whose copy has completed, else (every slot
        allocated and one busy) the oldest copy is waited on first, else
        a new slot, which takes the place of a free slot of another
        shape when every slot is allocated. Its contents are stale: the
        caller overwrites every element, then copies from it and
        releases it."""
        self._reclaim(wait=False)
        slot = self._take(spec)
        if slot is None and self._busy and self.allocated >= self.slots:
            self._reclaim(wait=True)
            slot = self._take(spec)
        if slot is None:
            while self._free and self.allocated >= self.slots:
                # a free slot of another shape: drop it rather than hold
                # it, so a stream of changing shapes keeps ``slots``
                self._free.pop(0)
                self.allocated -= 1
            slot = {k: torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                                   pin_memory=self.pin)
                    for k, (shape, dtype) in spec.items()}
            self.allocated += 1
        self.in_flight += 1
        _METRICS.gauge("device.staging").set(self.in_flight)
        return slot

    def stage(self, arrs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Copy ``arrs`` into a staging slot (``device.assemble`` span);
        the source arrays are dead to this pool after the call."""
        t0 = time.perf_counter()
        arrs = {k: np.asarray(v) for k, v in arrs.items()}
        slot = self.acquire({k: (a.shape, a.dtype) for k, a in arrs.items()})
        for k, a in arrs.items():
            slot[k].copy_(torch.from_numpy(a))
        dt = time.perf_counter() - t0
        self.assemble_s += dt
        rec = _trace.active()
        if rec is not None:
            rec.complete("device.assemble", t0, dt, "transfer",
                         {"in_flight": self.in_flight})
        return slot

    def release(self, slot: Dict[str, torch.Tensor],
                event: Optional[torch.cuda.Event] = None) -> None:
        """The H2D copy from ``slot`` was enqueued before ``event``:
        recycle the slot once the event completes (never, on targets
        that alias the slot)."""
        self.in_flight -= 1
        _METRICS.gauge("device.staging").set(self.in_flight)
        if self.alias_unsafe:
            self.allocated -= 1
        elif event is None:
            self._free.append(slot)
        else:
            self._busy.append((slot, event))

    def reset_epoch(self) -> None:
        """Zero the staging seconds (``assemble_s``) for a new epoch."""
        self.assemble_s = 0.0


def _to_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class DeviceBatch(dict):
    """One batch on its device: a dict of tensors with the keys, shapes
    and dtypes of the host batch it came from (the index keeps its
    layout dtype). ``counts`` holds that host batch's (rows, nnz), which
    the stage probes read instead of a device tensor; ``event`` is the
    CUDA event recorded behind its copies (None off the card)."""

    __slots__ = ("counts", "event")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.counts: Optional[Tuple[int, int]] = None
        self.event: Optional[torch.cuda.Event] = None


def copy_to_device(src: Dict[str, torch.Tensor], device: torch.device,
                   copy_stream: Optional[torch.cuda.Stream] = None
                   ) -> DeviceBatch:
    """Enqueue the copy of the host tensors ``src`` to ``device``.

    On the card each copy is ``non_blocking`` on ``copy_stream`` (the
    current stream when None) and one CUDA event is recorded behind them
    in the result's ``event``: a pinned source may be reused once it has
    completed, and the consumer must :func:`wait_copy` before it uses the
    batch. Elsewhere the copy is ``Tensor.to``, which on the CPU ALIASES
    the source."""
    if device.type != "cuda":
        return DeviceBatch({k: t.to(device) for k, t in src.items()})
    stream = (copy_stream if copy_stream is not None
              else torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = DeviceBatch({k: t.to(device, non_blocking=True)
                           for k, t in src.items()})
        out.event = torch.cuda.Event()
        out.event.record(stream)
    return out


def wait_copy(batch: DeviceBatch, device: torch.device) -> DeviceBatch:
    """The consumer's side of :func:`copy_to_device`: the current stream
    of ``device`` waits on the batch's copy, and each storage under the
    batch's tensors is recorded once as used by that stream (so the
    caching allocator does not hand its memory out while the consumer's
    work is queued; the raw route's keys are views of one storage).
    Returns ``batch``."""
    if batch.event is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(batch.event)
        seen = set()
        for t in batch.values():
            ptr = t.untyped_storage().data_ptr()
            if ptr not in seen:
                seen.add(ptr)
                t.record_stream(consumer)
    return batch


def _target(sharding, device):
    """(device, NamedSharding or None) of ``device_prefetch``'s
    ``sharding`` and ``device`` arguments."""
    from dmlc_tpu_torch.parallel.placement import NamedSharding
    from dmlc_tpu_torch.utils.logging import check
    check(sharding is None or device is None,
          "device_prefetch: pass device OR sharding, not both")
    if sharding is None:
        return resolve_device(device), None
    if isinstance(sharding, NamedSharding):
        return sharding.device, sharding
    check(isinstance(sharding, torch.device),
          "device_prefetch(sharding=) takes a dmlc_tpu_torch.parallel."
          "placement.NamedSharding or a torch.device, got "
          f"{type(sharding).__name__}")
    return sharding, None


def device_prefetch(host_batches: Iterable[Dict[str, Any]], size: int = 2,
                    sharding=None, staging: bool = False,
                    device=None) -> Iterator[Dict[str, Any]]:
    """Yield device-resident batches with ``size`` copies in flight.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run on the host.
    ``sharding`` (the reference's argument) is a ``parallel.placement.
    NamedSharding``, which places each array of a batch with
    ``placement.device_put`` on the mesh's device (as
    ``Pipeline.to_device(sharding=)`` does; the batch's values are then
    ``PlacedTensor`` objects), or a ``torch.device``, which moves the batch
    there; nothing else is accepted, and not both ``sharding`` and
    ``device``. Without staging, a batch must own its buffers until its copy has
    been enqueued (a pageable-memory H2D copy has read its source when
    it returns); on the CPU the yielded tensors alias the source arrays.
    ``staging=True`` routes every batch through a :class:`HostStaging`
    pool of pinned slots (see the module docstring): the source arrays,
    e.g. leased native views, are free as soon as the batch is pulled.
    """
    device, placement = _target(sharding, device)
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    pool = (HostStaging(slots=size, pin=on_cuda, alias_unsafe=not on_cuda)
            if staging else None)
    queue: collections.deque = collections.deque()
    it = iter(host_batches)

    def _enqueue():
        batch = next(it)  # StopIteration propagates to the caller
        src = pool.stage(batch) if pool is not None else _to_tensors(batch)
        t_enq = time.perf_counter()
        out = copy_to_device(src, device, copy_stream)
        if pool is not None:
            pool.release(src, out.event)
        return out, t_enq

    def _drain(entry):
        out, t_enq = entry
        rec = _trace.active()
        if rec is not None and pool is not None:
            # the batch's window in flight, enqueue → hand-off: it
            # overlaps the NEXT batch's device.assemble span when
            # staging does its job
            rec.complete("device.xfer", t_enq,
                         time.perf_counter() - t_enq, "transfer")
        out = wait_copy(out, device)
        if placement is not None:
            from dmlc_tpu_torch.parallel.placement import device_put
            placed = DeviceBatch({k: device_put(t, placement, name=k)
                                  for k, t in out.items()})
            placed.counts = out.counts
            out = placed
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
        self._device = resolve_device(device)
        self._staging = staging
        self._gen: Optional[Iterator] = None
        self._value = None

    def before_first(self) -> None:
        self._gen = device_prefetch(self._factory(), self._size,
                                    staging=self._staging,
                                    device=self._device)
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
