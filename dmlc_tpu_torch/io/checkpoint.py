"""Checkpoint/resume: parameter trees round-tripped over Streams.

Counterpart of ``dmlc_tpu/io/checkpoint.py`` for local roots; a file or
step directory written by either package restores in the other:

- ``save_pytree``/``load_pytree``: a tree (dicts, lists and tuples) of
  tensors or numpy arrays ↔ one Stream (the single-process path);
- ``ShardedCheckpoint``: a step directory ``<root>/step-<N>/`` of
  ``shard-<rank>.bin`` (each record a leaf's placement and data),
  ``shard-<rank>.idx.json`` (a byte index), ``meta.json`` (rank 0) and a
  ``COMMIT`` marker. Every save builds ``step-<N>.new`` and swaps it in
  only once committed, so a torn save is never restored and a crash
  never loses the step's last committed copy. Restore reads only the
  stored records whose placements intersect what it rebuilds, seeking
  through the index (``last_restore_bytes_read`` counts the bytes).

Where the port differs from the reference:

- the tree walk is the port's own (``_flatten``): dict keys in sorted
  order, as jax sorts them (an ``OrderedDict`` such as a ``state_dict``
  too), sequence positions by index, keys joined with ``/``;
- the port's models are replicated across ranks, so a leaf is written
  whole by rank 0 with the full placement (the reference writes replica 0
  of each shard of a sharded ``jax.Array``); restore still assembles
  leaves from any placements, so a reference checkpoint whose leaves
  were sharded over several devices restores here;
- restored leaves are tensors on the device of ``like``'s leaf (numpy
  arrays where ``like``'s leaf is not a tensor, or with no ``like``);
- ranks meet at ``torch.distributed.barrier()`` when a group of more than
  one rank exists.

Trimmed from the reference: roots with ``://`` (its object-store plane:
content-addressed pages, the multipart writer, the gang's restore
fanout), ``prefetch``, the ``writer``/``num_writers`` arguments and
``sharding_tree``, which raise ``DMLCError("... not ported ...")``; the
rendezvous ``gang_metadata`` stamp in ``meta.json`` (the reference adds
it only inside an elastic gang); the resilience retry of the
``checkpoint.save``/``checkpoint.restore`` sites (one attempt); the obs
counters and trace spans.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.json_util import json_dump, json_load
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq

__all__ = ["save_pytree", "load_pytree", "ShardedCheckpoint"]

_FORMAT_VERSION = 1


def _not_ported(what: str) -> DMLCError:
    return DMLCError(f"checkpoint: {what} is not ported to dmlc_tpu_torch "
                     "(local roots only)")


def _intersect(a: tuple, b: tuple) -> Optional[tuple]:
    """Intersection of two per-dim (start, stop) span tuples; None when
    empty. Scalars (zero-dim, empty tuples) always intersect."""
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """[(key, leaf)] of a tree of dicts, lists and tuples, in the order
    and with the keys of the reference's ``tree_flatten_with_path``: dict
    keys sorted, sequence positions by index, joined with ``/`` (a bare
    leaf is ``<root>``); None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    return [("/".join(prefix) or "<root>", tree)]


def _unflatten(like: Any, values: Dict[str, Any],
               prefix: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``values[key]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], values, prefix + (str(k),))
               for k in like}
        return out if type(like) is dict else type(like)(out)
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, values, prefix + (str(i),))
                 for i, v in enumerate(like)]
        return type(like)(items) if type(like) in (list, tuple) else \
            type(like)(*items)
    return values["/".join(prefix) or "<root>"]


def _host(leaf: Any) -> np.ndarray:
    """A leaf's bytes on the host: a tensor leaves its device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like_leaf(proto: Any, arr: np.ndarray) -> Any:
    """A restored array shaped as ``proto`` asks: a tensor on its device
    for a tensor, the array itself otherwise."""
    if isinstance(proto, torch.Tensor):
        return torch.from_numpy(arr).to(proto.device)
    return arr


def save_pytree(tree: Any, uri: str) -> None:
    """Serialize a tree of tensors or arrays to one stream (the
    single-process path): the reference's file, byte for byte."""
    leaves = _flatten(tree)
    with create_stream(uri, "w") as s:
        ser.write_u32(s, _FORMAT_VERSION)
        ser.write_u64(s, len(leaves))
        for key, leaf in leaves:
            ser.write_str(s, key)
            ser.write_ndarray(s, _host(leaf))


def load_pytree(uri: str, like: Optional[Any] = None) -> Any:
    """Load a checkpoint; returns {key: array}, or the structure of
    ``like`` when given (keys must match; a tensor leaf of ``like`` comes
    back as a tensor on its device)."""
    with create_stream(uri, "r") as s:
        version = ser.read_u32(s)
        check_eq(version, _FORMAT_VERSION, "checkpoint version mismatch")
        n = ser.read_u64(s)
        flat: Dict[str, np.ndarray] = {}
        for _ in range(n):
            key = ser.read_str(s)
            flat[key] = ser.read_ndarray(s)
    if like is None:
        return flat
    leaves = _flatten(like)
    missing = [k for k, _ in leaves if k not in flat]
    if missing:
        raise DMLCError(f"checkpoint missing keys {missing}")
    return _unflatten(like, {k: _like_leaf(proto, flat[k])
                             for k, proto in leaves})


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedCheckpoint:
    """Per-rank shard streams for a parameter tree, local roots.

    Layout: ``<root>/step-<N>/shard-<rank>.bin`` + ``meta.json``
    (written by rank 0) + ``COMMIT`` marker. Each shard file holds, per
    leaf, the records this rank writes (a placement in the full array
    and that block's data): rank 0 writes every leaf whole, the others
    none (the port's parameters are replicated).
    """

    def __init__(self, root: str):
        if "://" in root:
            raise _not_ported(f"the remote root {root!r} (objstore plane)")
        self.root = root
        self.last_restore_bytes_read = 0  # data bytes read by restore()
        os.makedirs(root, exist_ok=True)

    # -- paths

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step-{step:08d}")

    def _committed(self, d: str) -> bool:
        return os.path.exists(os.path.join(d, "COMMIT"))

    def _resolve_step_dir(self, step: int) -> str:
        """Committed directory for a step. Every save writes into
        ``step-N.new`` and swaps it in only once fully committed; if a
        crash interrupted the swap, the committed ``.new`` IS the step.
        When BOTH are committed (crash between .new's COMMIT and the
        swap renames), the .new wins: save() strips COMMIT from .new
        before reusing it, so a committed .new is always the newer save
        of this step."""
        d = self._step_dir(step)
        if self._committed(d + ".new"):
            return d + ".new"
        return d  # the caller's commit check reports the right error

    def _committed_steps(self) -> List[int]:
        steps = set()
        for name in os.listdir(self.root):
            if not name.startswith("step-"):
                continue
            base = name.split("-", 1)[1]
            if base.endswith(".new"):
                base = base[:-len(".new")]
            try:
                step = int(base)
            except ValueError:
                continue
            if self._committed(self._resolve_step_dir(step)):
                steps.add(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return self._committed_steps()

    # -- save

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None,
             writer: Optional[int] = None,
             num_writers: Optional[int] = None) -> str:
        """Write ``tree`` as step ``step`` (every rank of the group
        calls it); returns the step's directory."""
        if writer is not None or num_writers is not None:
            raise _not_ported("save(writer=, num_writers=) (remote roots)")
        rank, world = _rank_world()
        # each leaf on the host once (a tensor leaves its device here)
        leaves = [(k, _host(leaf)) for k, leaf in _flatten(tree)]
        final = self._step_dir(step)
        # Every save builds in step-N.new and swaps it in only after ITS
        # commit, whatever the filesystem says of step-N (ranks on a
        # shared filesystem with attribute caching could disagree).
        d = final + ".new"
        # a crash between the commit-time renames can leave the step's
        # ONLY committed copy in step-N.new: finish that swap before
        # touching .new
        if rank == 0 and self._committed(d):
            self._swap_in(final)
        self._barrier()  # .new is settled before anyone creates into it
        existed = os.path.isdir(d)
        os.makedirs(d, exist_ok=True)
        if rank == 0 and existed:
            # stale uncommitted leftovers (torn save or re-save):
            # invalidate NOW and drop shard files of ranks outside the
            # new world so restore cannot mix worlds
            commit = os.path.join(d, "COMMIT")
            if os.path.exists(commit):
                os.remove(commit)
            for name in os.listdir(d):
                if not name.startswith("shard-"):
                    continue
                try:
                    owner = int(name.split("-", 1)[1].split(".", 1)[0])
                except ValueError:
                    continue
                if owner >= world:
                    os.remove(os.path.join(d, name))
        self._barrier()  # nobody writes until the workdir is clean
        shard_path = os.path.join(d, f"shard-{rank}.bin")
        tmp = shard_path + ".tmp"
        index_entries = []  # byte index: restore seeks straight to records
        with create_stream(tmp, "w") as s:
            ser.write_u32(s, _FORMAT_VERSION)
            ser.write_u64(s, len(leaves))
            for key, leaf in leaves:
                ser.write_str(s, key)
                shards = self._addressable_shards(leaf)
                ser.write_u64(s, len(shards))
                for index, data in shards:
                    # the record's placement: (start, stop) per dim
                    ser.write_u8(s, len(index))
                    for (start, stop) in index:
                        ser.write_u64(s, start)
                        ser.write_u64(s, stop)
                    off = s.tell()
                    ser.write_ndarray(s, data)
                    index_entries.append({
                        "key": key,
                        "placement": [list(p) for p in index],
                        "offset": off,
                        "nbytes": s.tell() - off,
                    })
        idx_path = os.path.join(d, f"shard-{rank}.idx.json")
        # publish order keeps every crash window restorable: drop any
        # stale index first (restore falls back to scanning the .bin),
        # then the .bin, then the new index, each by atomic replace; the
        # recorded bin_size lets restore reject an index of another .bin
        if os.path.exists(idx_path):
            os.remove(idx_path)
        os.replace(tmp, shard_path)
        with create_stream(idx_path + ".tmp", "w") as s:
            json_dump({"version": _FORMAT_VERSION,
                       "entries": index_entries,
                       "bin_size": os.path.getsize(shard_path)}, s)
        os.replace(idx_path + ".tmp", idx_path)
        if rank == 0:
            meta = {
                "version": _FORMAT_VERSION,
                "step": step,
                "num_processes": world,
                "leaves": [{"key": k, "shape": list(leaf.shape),
                            "dtype": leaf.dtype.str}
                           for k, leaf in leaves],
                "user": metadata or {},
            }
            with create_stream(os.path.join(d, "meta.json"), "w") as s:
                json_dump(meta, s)
        self._barrier()           # all shard files durable
        if rank == 0:
            open(os.path.join(d, "COMMIT"), "wb").close()
            self._swap_in(final)
        self._barrier()           # COMMIT visible before any rank returns
        return final

    @staticmethod
    def _swap_in(final: str) -> None:
        """Make a fully committed ``final + ".new"`` become ``final``.

        Any old committed data leaves only AFTER its replacement is
        committed: a crash between the renames leaves a committed .new,
        which ``_resolve_step_dir`` serves and the NEXT ``save`` finishes
        swapping before it reuses .new. An orphaned .trash (crash after
        the second rename) is swept by the next swap."""
        d = final + ".new"
        trash = final + ".trash"
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        if os.path.isdir(final):
            os.rename(final, trash)
        os.rename(d, final)
        if os.path.isdir(trash):
            shutil.rmtree(trash)

    @staticmethod
    def _addressable_shards(leaf: Any):
        """[(placement, data)] this rank writes for ``leaf``, a placement
        being ((start, stop), ...) per dim of the full array: rank 0
        writes the leaf whole (the port's parameters are replicated, so
        one copy a checkpoint, as the reference writes replica 0)."""
        arr = _host(leaf)
        placement = tuple((0, s) for s in arr.shape)
        return [(placement, arr)] if _rank_world()[0] == 0 else []

    @staticmethod
    def _barrier() -> None:
        import torch.distributed as dist
        if _rank_world()[1] > 1:
            dist.barrier()

    # -- restore

    def restore(self, step: Optional[int] = None, like: Any = None,
                sharding_tree: Any = None) -> Tuple[Any, Dict[str, Any]]:
        """Load (tree, user_metadata). ``like`` supplies the structure:
        each of its tensor leaves comes back as a tensor of the stored
        dtype on that leaf's device, rebuilt from only the stored
        records that intersect it (seeking via the shard-*.idx.json byte
        index); other leaves, or every leaf with ``like=None``, come
        back as host arrays, reading only the keys asked for.
        ``last_restore_bytes_read`` records the data bytes read.

        Restore also sweeps the port's replay page-spill files
        (best-effort): a restore marks a resume boundary, and spill files
        written against inputs that have since changed must not be
        adopted by the resumed run. Only files whose recorded fingerprint
        fails a re-stat (plus crashed writers' orphaned .tmp files) are
        deleted."""
        if sharding_tree is not None:
            raise _not_ported("restore(sharding_tree=)")
        try:
            from dmlc_tpu_torch.data.row_iter import sweep_stale_spill
            sweep_stale_spill()
        except Exception:  # noqa: BLE001 — hygiene must not block restore
            pass
        if step is None:
            step = self.latest_step()
            check(step is not None,
                  f"no committed checkpoint under {self.root}")
        self.last_restore_bytes_read = 0
        d = self._resolve_step_dir(step)
        check(os.path.exists(os.path.join(d, "COMMIT")),
              f"checkpoint step {step} is not committed")
        with create_stream(os.path.join(d, "meta.json"), "r") as s:
            meta = json_load(s)
        index = self._load_index(d)
        meta_shapes = {l["key"]: tuple(l["shape"])
                       for l in meta.get("leaves", [])}
        meta_dtypes = {l["key"]: np.dtype(l["dtype"])
                       for l in meta.get("leaves", [])}
        if like is None:
            host = self._assemble_full(index, meta_shapes, meta_dtypes)
            return host, meta.get("user", {})
        leaves = _flatten(like)
        on_device = {key for key, proto in leaves
                     if isinstance(proto, torch.Tensor)
                     and key in index and key in meta_shapes}
        full_keys = [key for key, _ in leaves if key not in on_device]
        full_cache = (self._assemble_full(index, meta_shapes, meta_dtypes,
                                          keys=full_keys)
                      if full_keys else {})
        values = {}
        for key, proto in leaves:
            if key in on_device:
                values[key] = self._restore_sharded(
                    index, key, meta_shapes[key], meta_dtypes[key],
                    proto.device)
                continue
            check(key in full_cache, f"checkpoint missing leaf {key!r}")
            values[key] = _like_leaf(proto, full_cache[key])
        return _unflatten(like, values), meta.get("user", {})

    def prefetch(self, step: Optional[int] = None) -> None:
        """The reference warms a remote restore's page fanout; the port
        has no remote roots."""
        raise _not_ported("prefetch() (remote roots)")

    # -- restore internals

    def _load_index(self, d: str) -> Dict[str, List[dict]]:
        """key -> [{file, placement, offset, nbytes}] covering EVERY
        shard-*.bin in the step dir: from its .idx.json when present and
        matching the .bin's size, else by a structural scan of the .bin
        (headers read, payloads seeked over — no data loaded)."""
        out: Dict[str, List[dict]] = {}
        for name in sorted(os.listdir(d)):
            if not (name.startswith("shard-") and name.endswith(".bin")):
                continue
            bin_path = os.path.join(d, name)
            idx_path = bin_path[:-len(".bin")] + ".idx.json"
            entries = None
            if os.path.exists(idx_path):
                with create_stream(idx_path, "r") as s:
                    idx = json_load(s)
                if (idx.get("bin_size") == os.path.getsize(bin_path)
                        and idx.get("version", _FORMAT_VERSION)
                        == _FORMAT_VERSION):
                    entries = [{
                        "file": bin_path,
                        "key": e["key"],
                        "placement": tuple(tuple(p)
                                           for p in e["placement"]),
                        "offset": int(e["offset"]),
                        "nbytes": int(e["nbytes"]),
                    } for e in idx.get("entries", [])]
            if entries is None:
                entries = self._scan_bin(bin_path)
            for e in entries:
                out.setdefault(e["key"], []).append(e)
        return out

    @staticmethod
    def _scan_bin(bin_path: str) -> List[dict]:
        """Build index entries by walking a shard file's structure,
        seeking past payloads (reads headers only)."""
        entries: List[dict] = []
        with create_stream(bin_path, "r") as s:
            version = ser.read_u32(s)
            check_eq(version, _FORMAT_VERSION, "shard version mismatch")
            nleaf = ser.read_u64(s)
            for _ in range(nleaf):
                key = ser.read_str(s)
                nsh = ser.read_u64(s)
                for _ in range(nsh):
                    ndim = ser.read_u8(s)
                    placement = tuple(
                        (ser.read_u64(s), ser.read_u64(s))
                        for _ in range(ndim))
                    off = s.tell()
                    dtype = np.dtype(ser.read_str(s))
                    adim = ser.read_u8(s)
                    shape = tuple(ser.read_u64(s) for _ in range(adim))
                    count = int(np.prod(shape)) if adim else 1
                    s.seek(s.tell() + dtype.itemsize * count)
                    entries.append({"file": bin_path, "key": key,
                                    "placement": placement,
                                    "offset": off,
                                    "nbytes": s.tell() - off})
        return entries

    def _read_entry(self, streams: Dict[str, Any], entry: dict,
                    cache: Optional[Dict[tuple, np.ndarray]] = None
                    ) -> np.ndarray:
        loc = (entry["file"], entry["offset"])
        if cache is not None and loc in cache:
            return cache[loc]
        s = streams.get(entry["file"])
        if s is None:
            s = streams[entry["file"]] = create_stream(entry["file"], "r")
        s.seek(entry["offset"])
        self.last_restore_bytes_read += entry["nbytes"]
        data = ser.read_ndarray(s)
        if cache is not None:
            cache[loc] = data
        return data

    def _restore_sharded(self, index: Dict[str, List[dict]], key: str,
                         shape: tuple, dtype, device: torch.device
                         ) -> torch.Tensor:
        """One leaf as a tensor on ``device``, assembled on the host from
        only the stored records that intersect it (the whole leaf: this
        rank holds the parameters replicated), each read once."""
        spans = tuple((0, s) for s in shape)
        streams: Dict[str, Any] = {}
        read_cache: Dict[tuple, np.ndarray] = {}
        try:
            local = np.empty(tuple(shape), dtype)
            filled = 0
            for entry in index.get(key, []):
                inter = _intersect(spans, entry["placement"])
                if inter is None:
                    continue
                data = self._read_entry(streams, entry, read_cache)
                dst = tuple(slice(lo - start, hi - start)
                            for (lo, hi), (start, _) in zip(inter, spans))
                src = tuple(slice(lo - pstart, hi - pstart)
                            for (lo, hi), (pstart, _) in zip(
                                inter, entry["placement"]))
                local[dst] = data[src]
                filled += local[dst].size
            check_eq(filled, local.size,
                     f"leaf {key!r}: stored shards do not cover this "
                     "process's slice")
        finally:
            for s in streams.values():
                s.close()
        return torch.from_numpy(local).to(device)

    def _assemble_full(self, index: Dict[str, List[dict]],
                       meta_shapes: Dict[str, tuple],
                       meta_dtypes: Dict[str, Any],
                       keys: Optional[List[str]] = None
                       ) -> Dict[str, np.ndarray]:
        """Full host assembly of ``keys`` (default: every key). Reads
        only the listed keys' records, so one scalar in a tree of large
        leaves does not pull the whole model to the host."""
        shards: Dict[str, List[tuple]] = {}
        streams: Dict[str, Any] = {}
        try:
            for key, entries in index.items():
                if keys is not None and key not in keys:
                    continue
                for entry in entries:
                    shards.setdefault(key, []).append(
                        (entry["placement"],
                         self._read_entry(streams, entry)))
        finally:
            for s in streams.values():
                s.close()
        return {key: self._reassemble(key, parts, meta_shapes.get(key),
                                      meta_dtypes.get(key))
                for key, parts in shards.items()}

    @staticmethod
    def _reassemble(key: str, parts: List[tuple],
                    full_shape, dtype) -> np.ndarray:
        """Rebuild the full host array from its records' placements."""
        if full_shape is None:
            full_shape = tuple(max(stop for (_, stop) in
                                   (pl[d] for pl, _ in parts))
                               for d in range(len(parts[0][0])))
        if dtype is None:
            dtype = parts[0][1].dtype
        out = np.empty(tuple(full_shape), dtype)
        covered = 0
        for placement, data in parts:
            slices = tuple(slice(start, stop) for (start, stop) in placement)
            out[slices] = data.reshape(out[slices].shape)
            covered += data.size
        if covered < out.size:
            raise DMLCError(
                f"checkpoint leaf {key!r}: shards cover {covered} of "
                f"{out.size} elements (missing shard files?)")
        return out
