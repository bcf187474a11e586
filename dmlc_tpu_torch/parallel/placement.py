"""Array placement over the port's part mesh: which slice each part holds.

Counterpart of ``jax.sharding`` as the reference uses it
(``NamedSharding(mesh, PartitionSpec(...))``, ``jax.device_put(x,
sharding)``, ``Array.addressable_shards``, ``np.asarray`` of a global
array), over :class:`~dmlc_tpu_torch.parallel.sharded.Mesh`: D *parts*
(not devices) along named axes, numbered row-major, process r of a
world-W group owning the contiguous run ``mesh._owned`` of them, all on
its one ``mesh.device``.

- :class:`PartitionSpec` (also ``P``) names, for each dimension of an
  array, the mesh axes it is split over (None, an axis name, or a tuple
  of names, the first the major one); dimensions past the spec's length
  are whole.
- :class:`NamedSharding` maps an array shape to each part's index (a
  tuple of slices, ``slice(None)`` for a whole dimension) and
  ``replica_id``, equal to JAX's ``devices_indices_map`` and replica ids
  for the device at the same place of a JAX mesh of the same shape. A
  split dimension whose size does not divide raises a DMLCError naming
  the array.
- :class:`PlacedTensor` is a sharded leaf: the global shape, its
  sharding and one tensor for each distinct index this process owns,
  on ``mesh.device`` (parts holding the same index share one tensor, so
  a replicated array is one copy on the device, not one a part).
  ``addressable_shards`` lists the owned parts as JAX does;
  ``local()`` is the owned slices as one tensor where they form a box;
  ``gather()`` the full array on the host (``np.asarray`` of a global
  array), ``to_full()`` on the device.
- :func:`device_put` places a host array or a tensor.

Not ``torch.distributed.tensor.DTensor``: its ``DeviceMesh`` takes one
device a rank, and the port's mesh holds several parts on one device
(NCCL refuses two ranks on one card, ``parallel/sharded.py``), which is
how one card, or the CPU, stands in for the reference's mesh of chips.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["PartitionSpec", "P", "NamedSharding", "Shard", "PlacedTensor",
           "device_put"]

Index = Tuple[slice, ...]
Spans = Tuple[Tuple[int, int], ...]  # (start, stop) per dimension


class PartitionSpec(tuple):
    """For each array dimension, the mesh axes it is split over: None
    (whole), an axis name, or a tuple of names (the first the major
    one), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class NamedSharding:
    """``spec`` over ``mesh``: each part's slice of an array (module
    docstring)."""

    def __init__(self, mesh, spec: Sequence = PartitionSpec()):
        self.mesh = mesh
        self.spec = (spec if isinstance(spec, PartitionSpec)
                     else PartitionSpec(*spec))
        used: List[str] = []
        for entry in self.spec:
            for a in _axes(entry):
                check(a in mesh.axis_names,
                      f"sharding: axis {a!r} is not one of the mesh's "
                      f"{mesh.axis_names}")
                check(a not in used,
                      f"sharding: axis {a!r} appears twice in {self.spec}")
                used.append(a)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _tiles(self, shape: Tuple[int, ...], name: str) -> List[int]:
        """Along each dimension, the number of tiles; raises where one
        does not divide the dimension."""
        shape = tuple(int(s) for s in shape)
        check(len(self.spec) <= len(shape),
              f"{name}: sharding {self.spec} has more entries than the "
              f"array's {len(shape)} dimensions (shape {shape})")
        tiles = []
        for d, size in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            n = int(np.prod([self.mesh.shape[self.mesh.axis_names.index(a)]
                             for a in _axes(entry)], dtype=np.int64))
            if size % n:
                raise DMLCError(
                    f"{name}: sharding {self.spec} splits dimension {d} "
                    f"into {n} tiles, but its size is {size} (shape "
                    f"{shape}); the tiles must divide it evenly")
            tiles.append(n)
        return tiles

    def index(self, part: int, shape: Tuple[int, ...],
              name: str = "array") -> Index:
        """Part ``part``'s slice of an array of ``shape``."""
        tiles = self._tiles(shape, name)
        coord = np.unravel_index(int(part), self.mesh.shape)
        out = []
        for d, size in enumerate(shape):
            if tiles[d] == 1:
                out.append(slice(None))
                continue
            pos = 0
            for a in _axes(self.spec[d]):
                i = self.mesh.axis_names.index(a)
                pos = pos * self.mesh.shape[i] + int(coord[i])
            step = int(size) // tiles[d]
            out.append(slice(pos * step, (pos + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape: Tuple[int, ...],
                            name: str = "array") -> Dict[int, Index]:
        """Every part's index, in part order (JAX's map, keyed by part
        instead of device)."""
        self._tiles(shape, name)
        return {f: self.index(f, shape, name)
                for f in range(self.mesh.size)}

    def replica_ids(self, shape: Tuple[int, ...],
                    name: str = "array") -> Dict[int, int]:
        """Every part's ``replica_id``: how many earlier parts (in part
        order) hold the same index, as JAX numbers replicas."""
        seen: Dict[Spans, int] = {}
        out = {}
        for f, idx in self.devices_indices_map(shape, name).items():
            sp = _spans(idx, shape)
            out[f] = seen.get(sp, 0)
            seen[sp] = out[f] + 1
        return out

    def addressable_indices_map(self, shape: Tuple[int, ...],
                                name: str = "array") -> Dict[int, Index]:
        """The owned parts' indices (JAX's
        ``addressable_devices_indices_map``)."""
        return {f: self.index(f, shape, name) for f in self.mesh._owned}

    def addressable_placements(self, shape: Tuple[int, ...],
                               name: str = "array") -> Dict[int, Spans]:
        """The owned parts' indices as (start, stop) per dimension."""
        shape = tuple(int(s) for s in shape)
        return {f: _spans(idx, shape) for f, idx in
                self.addressable_indices_map(shape, name).items()}

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


def _spans(idx: Index, shape: Tuple[int, ...]) -> Spans:
    """An index as (start, stop) per dimension: a checkpoint record's
    placement."""
    return tuple((0 if s.start is None else s.start,
                  shape[d] if s.stop is None else s.stop)
                 for d, s in enumerate(idx))


def _volume(spans: Spans) -> int:
    return int(np.prod([hi - lo for lo, hi in spans], dtype=np.int64))


class Shard(NamedTuple):
    """One owned part of a :class:`PlacedTensor` (JAX's ``Shard``, keyed
    by part, with the index's ``placement`` beside it)."""

    part: int
    index: Index
    replica_id: int
    data: torch.Tensor
    placement: Spans


class PlacedTensor:
    """A sharded leaf: global ``shape``, its ``sharding``, and the owned
    slices on ``sharding.mesh.device``, keyed by placement (module
    docstring). Build one with :func:`device_put`; the checkpoint's
    restore builds one from the slices it assembles."""

    def __init__(self, shape: Tuple[int, ...], sharding: NamedSharding,
                 slices: Dict[Spans, torch.Tensor], name: str = "array"):
        self.shape = tuple(int(s) for s in shape)
        self.sharding = sharding
        self.name = name
        self._indices = sharding.addressable_indices_map(self.shape, name)
        self._replicas = sharding.replica_ids(self.shape, name)
        self._slices = {}
        for f, idx in self._indices.items():
            sp = _spans(idx, self.shape)
            t = slices.get(sp)
            want = tuple(hi - lo for lo, hi in sp)
            check(t is not None and tuple(t.shape) == want,
                  f"{name}: part {f} needs a slice of shape {want}, got "
                  f"{None if t is None else tuple(t.shape)}")
            self._slices[sp] = t
        check(bool(self._slices), f"{name}: this process owns no part")
        self.dtype = next(iter(self._slices.values())).dtype

    @property
    def device(self) -> torch.device:
        return self.sharding.mesh.device

    @property
    def np_dtype(self) -> np.dtype:
        return torch.empty(0, dtype=self.dtype).numpy().dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the distinct slices this process holds."""
        return sum(t.numel() * t.element_size()
                   for t in self._slices.values())

    @property
    def addressable_shards(self) -> List[Shard]:
        """The owned parts in part order, each with its index, replica id,
        data and placement (parts with the same index share one
        tensor)."""
        out = []
        for f, idx in self._indices.items():
            sp = _spans(idx, self.shape)
            out.append(Shard(f, idx, self._replicas[f], self._slices[sp],
                             sp))
        return out

    def slices(self) -> List[torch.Tensor]:
        """The distinct owned slices, in the order of their
        placements."""
        return [self._slices[sp] for sp in sorted(self._slices)]

    def _box(self) -> Spans:
        box = tuple((min(sp[d][0] for sp in self._slices),
                     max(sp[d][1] for sp in self._slices))
                    for d in range(len(self.shape)))
        have = sum(_volume(sp) for sp in self._slices)
        if have != _volume(box):
            raise DMLCError(
                f"{self.name}: the slices this process owns do not form "
                f"one box (they cover {have} of the {_volume(box)} "
                f"elements of {box})")
        return box

    def local(self) -> torch.Tensor:
        """The owned slices as one tensor on the device (the slice itself
        when there is one); raises where they do not form a box."""
        box = self._box()
        if len(self._slices) == 1:
            return next(iter(self._slices.values()))
        out = torch.empty(tuple(hi - lo for lo, hi in box),
                          dtype=self.dtype, device=self.device)
        for sp, t in self._slices.items():
            out[tuple(slice(lo - b0, hi - b0)
                      for (lo, hi), (b0, _) in zip(sp, box))] = t
        return out

    def to_full(self) -> torch.Tensor:
        """The whole array on the device; raises unless this process owns
        all of it (as ``np.asarray`` of a global array that is not fully
        addressable does)."""
        box = self._box()
        if box != tuple((0, s) for s in self.shape):
            raise DMLCError(
                f"{self.name}: this process holds {box} of an array of "
                f"shape {self.shape}; the whole array needs every part")
        return self.local()

    def gather(self) -> np.ndarray:
        """The whole array on the host (``np.asarray`` of a global
        array)."""
        return self.to_full().detach().cpu().numpy()

    def __repr__(self) -> str:
        return (f"PlacedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, slices={len(self._slices)}, "
                f"device={self.device})")


def device_put(x: Any, sharding: NamedSharding,
               name: str = "array") -> PlacedTensor:
    """A host array or a tensor placed under ``sharding``: one copy on
    ``sharding.mesh.device`` of each distinct slice this process owns,
    never an alias of ``x``'s memory."""
    if isinstance(x, PlacedTensor):
        x = x.to_full()
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)  # (np.ascontiguousarray lifts a 0-d array)
        x = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    shape = tuple(x.shape)
    device = sharding.mesh.device
    slices: Dict[Spans, torch.Tensor] = {}
    for idx in sharding.addressable_indices_map(shape, name).values():
        sp = _spans(idx, shape)
        if sp not in slices:
            slices[sp] = x[idx].to(device, copy=True).contiguous()
    return PlacedTensor(shape, sharding, slices, name)
