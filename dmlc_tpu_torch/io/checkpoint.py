"""Checkpoint/resume: parameter trees round-tripped over Streams.

Counterpart of ``dmlc_tpu/io/checkpoint.py``; a file, step directory or
remote step written by either package restores in the other:

- ``save_pytree``/``load_pytree``: a tree (dicts, lists and tuples) of
  tensors or numpy arrays ↔ one Stream (the single-process path);
- ``ShardedCheckpoint``: a step directory ``<root>/step-<N>/`` of
  ``shard-<rank>.bin`` (each record a leaf's placement and data),
  ``shard-<rank>.idx.json`` (a byte index), ``meta.json`` (rank 0) and a
  ``COMMIT`` marker. Every save builds ``step-<N>.new`` and swaps it in
  only once committed, so a torn save is never restored and a crash
  never loses the step's last committed copy. Restore reads only the
  stored records whose placements intersect what it rebuilds, seeking
  through the index (``last_restore_bytes_read`` counts the bytes);
- a root containing ``://`` (``obj://bucket/prefix``) switches
  ``ShardedCheckpoint`` to the object-store plane: every record is a
  CONTENT-ADDRESSED page object ``<root>/pages/<digest>.pg`` (digest
  over dtype, shape and bytes) written through the objstore write plane
  (multipart past ``put_part_bytes``), so a re-save uploads only the
  records that changed (``last_save_bytes_written`` against
  ``last_save_bytes_reused``; an unchanged digest is recognized from
  the page store's committed ``ckptpg-<digest>.pages`` entry, or a HEAD
  probe). Each writer publishes ``<step>/shard-<w>.idx.json``; writer 0
  waits for ``num_writers`` indexes, writes ``meta.json``, then the
  ``COMMIT`` object. Restore verifies every page against its digest and
  splits ``last_restore_bytes_read`` into
  ``last_restore_{local,peer,wire}_bytes``. Object keys and contents
  are the reference's byte for byte for the same tree.

Restore fanout (a gang whose ranks serve ``/pages``,
``launch_local(serve_ports=...)``): each rank's :meth:`prefetch` (and
the restore's own first pass) wire-fetches only the pages
``rendezvous.elastic.content_owner`` assigns to it at the CURRENT world
and commits them to its page store; every other page comes from its
owner's ``/pages`` through the objstore peer tier, then from the wire
if the owner cannot serve it. Each of M restoring ranks pays about 1/M
of the wire, at any world size, different from the saving gang's or
not. Inside a rendezvous gang, ``meta.json`` carries the membership
stamp (``rendezvous.elastic.gang_metadata``) of the gang that saved.

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

Trimmed from the reference: ``sharding_tree``, which raises
``DMLCError("... not ported ...")`` (it waits for a placement plane).

As in the reference, ``save_pytree`` and ``load_pytree`` are resilience
seams (``checkpoint.save``, ``checkpoint.restore``: the whole file is
rewritten or re-read under the site's policy), while
``ShardedCheckpoint``'s save and restore are not retried whole (a gang's
barriers forbid one rank's re-entry) and ride the ``io.stream.*`` seams
of their streams. Each is a trace span (``checkpoint.save_pytree``,
``checkpoint.load_pytree``, ``checkpoint.save``,
``checkpoint.restore``), and restore counts its data bytes in the
``checkpoint.restore_bytes`` counter.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.stream import MemoryStream, create_stream
from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.resilience.policy import guarded
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.json_util import json_dump, json_load
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq

__all__ = ["save_pytree", "load_pytree", "ShardedCheckpoint"]

_FORMAT_VERSION = 1

# local page-store namespace for content-addressed checkpoint pages:
# fingerprint=None entries (immortal to the stale sweep)
_PAGE_PREFIX = "ckptpg-"


def _ckpt_count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"checkpoint.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


def _obj_count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"objstore.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


def _spanned(name: str):
    """Record the call as one obs trace span (no-op when tracing is
    off) — checkpoint save/restore shows up on the timeline next to
    the pipeline's pulls."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _trace.span(name, "checkpoint"):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _stamp_gang(meta: Dict[str, Any]) -> None:
    """Elastic gangs stamp WHO wrote this step (gang, member, rank,
    membership epoch, world) into ``meta["rendezvous"]``: a restore
    after an N→M reshard reads the stamp and re-derives shard ownership
    from the same pure contract (``rendezvous/elastic.py``) instead of
    assuming the world never changed. Nothing outside a rendezvous
    gang; a save never fails for the stamp."""
    try:
        from dmlc_tpu_torch.rendezvous.elastic import gang_metadata
        stamp = gang_metadata()
        if stamp is not None:
            meta["rendezvous"] = stamp
    except Exception:  # noqa: BLE001 — the stamp is additive
        pass


def _not_ported(what: str) -> DMLCError:
    return DMLCError(f"checkpoint: {what} is not ported to dmlc_tpu_torch")


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


@_spanned("checkpoint.save_pytree")
def save_pytree(tree: Any, uri: str) -> None:
    """Serialize a tree of tensors or arrays to one stream (the
    single-process path): the reference's file, byte for byte.

    The whole write is a resilience seam (site ``checkpoint.save``):
    idempotent, so a transient I/O failure rewrites from scratch under
    the site's RetryPolicy. The leaves leave the device once, before the
    first attempt: no retry touches the card."""
    leaves = [(key, _host(leaf)) for key, leaf in _flatten(tree)]

    def write() -> None:
        with create_stream(uri, "w") as s:
            ser.write_u32(s, _FORMAT_VERSION)
            ser.write_u64(s, len(leaves))
            for key, arr in leaves:
                ser.write_str(s, key)
                ser.write_ndarray(s, arr)

    guarded("checkpoint.save", write)


@_spanned("checkpoint.load_pytree")
def load_pytree(uri: str, like: Optional[Any] = None) -> Any:
    """Load a checkpoint; returns {key: array}, or the structure of
    ``like`` when given (keys must match; a tensor leaf of ``like`` comes
    back as a tensor on its device, after the read)."""
    def read() -> Dict[str, np.ndarray]:
        with create_stream(uri, "r") as s:
            version = ser.read_u32(s)
            check_eq(version, _FORMAT_VERSION,
                     "checkpoint version mismatch")
            n = ser.read_u64(s)
            out: Dict[str, np.ndarray] = {}
            for _ in range(n):
                key = ser.read_str(s)
                out[key] = ser.read_ndarray(s)
        return out

    # resilience seam checkpoint.restore: a transient read failure
    # re-reads the whole (immutable) file under the site's policy
    flat = guarded("checkpoint.restore", read)
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
    """Per-rank shard streams for a parameter tree.

    Local layout: ``<root>/step-<N>/shard-<rank>.bin`` + ``meta.json``
    (written by rank 0) + ``COMMIT`` marker. Each shard file holds, per
    leaf, the records this rank writes (a placement in the full array
    and that block's data): rank 0 writes every leaf whole, the others
    none (the port's parameters are replicated). Remote (``obj://``)
    layout: ``<root>/pages/<digest>.pg`` per record and
    ``<root>/step-<N>/{shard-<w>.idx.json, meta.json, COMMIT}``.
    """

    def __init__(self, root: str):
        self.root = root.rstrip("/") if "://" in root else root
        self.last_restore_bytes_read = 0  # data bytes read by restore()
        self.last_save_bytes_written = 0  # payload bytes uploaded
        self.last_save_bytes_reused = 0   # payload bytes deduped away
        # split of last_restore_bytes_read by source tier (remote roots)
        self.last_restore_local_bytes = 0
        self.last_restore_peer_bytes = 0
        self.last_restore_wire_bytes = 0
        self._remote = "://" in root
        if self._remote:
            from dmlc_tpu_torch.io.filesys import URI
            u = URI(self.root)
            self._bucket = u.host
            self._obj_prefix = u.name.strip("/")
        else:
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
        if self._remote:
            return self._committed_steps_remote()
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

    @_spanned("checkpoint.save")
    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None,
             writer: Optional[int] = None,
             num_writers: Optional[int] = None) -> str:
        """Write ``tree`` as step ``step`` (every rank of the group
        calls it); returns the step's directory (or URI). ``writer`` and
        ``num_writers`` name this process's part of a remote save
        (default: the group's rank and world)."""
        if self._remote:
            return self._save_remote(step, tree, metadata, writer,
                                     num_writers)
        check(writer is None and num_writers is None,
              "checkpoint: writer/num_writers apply to remote (obj://) "
              "roots; local saves shard by the torch.distributed rank")
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
            _stamp_gang(meta)
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

    @_spanned("checkpoint.restore")
    def restore(self, step: Optional[int] = None, like: Any = None,
                sharding_tree: Any = None) -> Tuple[Any, Dict[str, Any]]:
        """Load (tree, user_metadata). ``like`` supplies the structure:
        each of its tensor leaves comes back as a tensor of the stored
        dtype on that leaf's device, rebuilt from only the stored
        records that intersect it (seeking via the shard-*.idx.json byte
        index); other leaves, or every leaf with ``like=None``, come
        back as host arrays, reading only the keys asked for.
        ``last_restore_bytes_read`` records the data bytes read (on a
        remote root also split by source, ``last_restore_local_bytes``
        and ``last_restore_wire_bytes``); every remote page is checked
        against its digest before it is used.

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
        self.last_restore_local_bytes = 0
        self.last_restore_peer_bytes = 0
        self.last_restore_wire_bytes = 0
        if self._remote:
            sd = self._step_key(step)
            check(self._remote_committed(sd),
                  f"checkpoint step {step} is not committed")
            meta = json_load(MemoryStream(
                self._get_object(f"{sd}/meta.json")))
            index = self._load_index_remote(sd)
            # the fanout cut: stage the digests THIS rank owns (none
            # without a peer tier), so peers can take them from us
            self._prefetch_owned_pages(index)
        else:
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
        """Warm this rank's fanout cut ahead of ``restore()``: wire-fetch
        the pages ``content_owner`` assigns to this rank into the local
        page store, so gang peers can take them from our ``/pages``
        tier. Remote roots only; a no-op without a peer tier. A
        restoring gang that barriers between ``prefetch()`` and
        ``restore()`` guarantees every page is staged at its owner
        before anyone assembles — no rank races ahead and pays wire for
        a page its peer has not fetched yet. The prefetched pages still
        report as "wire" (once) in the restore split: the wire cost was
        paid, just earlier."""
        check(self._remote,
              "checkpoint.prefetch applies to remote (obj://) roots")
        if step is None:
            step = self.latest_step()
            check(step is not None,
                  f"no committed checkpoint under {self.root}")
        sd = self._step_key(step)
        check(self._remote_committed(sd),
              f"checkpoint step {step} is not committed")
        self._prefetch_owned_pages(self._load_index_remote(sd))

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
        loc = (entry.get("file"), entry.get("offset", entry.get("digest")))
        if cache is not None and loc in cache:
            return cache[loc]
        if "digest" in entry:
            data = self._read_page_record(entry)
        else:
            s = streams.get(entry["file"])
            if s is None:
                s = streams[entry["file"]] = create_stream(
                    entry["file"], "r")
            s.seek(entry["offset"])
            self.last_restore_bytes_read += entry["nbytes"]
            _ckpt_count("restore_bytes", entry["nbytes"])
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

    # -------------------------------------- remote (obj://) plane

    def _step_key(self, step: int) -> str:
        return f"step-{step:08d}"

    def _key(self, rel: str) -> str:
        return f"{self._obj_prefix}/{rel}" if self._obj_prefix else rel

    def _client(self):
        from dmlc_tpu_torch.io.objstore.fs import client
        c = client()
        check(c is not None,
              f"checkpoint root {self.root!r}: no object store "
              "configured (DMLC_TPU_OBJSTORE_ROOT / _ENDPOINT, or "
              "dmlc_tpu_torch.io.objstore.configure)")
        return c

    @staticmethod
    def _pages_store():
        try:
            from dmlc_tpu_torch.io.pagestore import PageStore
            return PageStore.default()
        except Exception:  # noqa: BLE001 — cache trouble != checkpoint failure
            return None

    @staticmethod
    def _record_digest(arr: np.ndarray) -> str:
        """Content address of one record: dtype + shape + bytes. The
        digest, not the (step, writer) coordinates, names the page
        object — an unchanged record hashes to the SAME object across
        saves (incremental reuse) and across writers."""
        h = hashlib.sha256()
        h.update(arr.dtype.str.encode())
        h.update(repr(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr))
        return h.hexdigest()[:32]

    @staticmethod
    def _serialize_record(arr: np.ndarray) -> bytes:
        buf = MemoryStream()
        ser.write_ndarray(buf, arr)
        return buf.getvalue()

    def _get_object(self, rel: str,
                    expected_len: Optional[int] = None) -> bytes:
        """One whole-object GET under the ``io.objstore.get`` seam
        (chaos injects here; a short payload retries under policy)."""
        from dmlc_tpu_torch.resilience import inject as _inject
        c = self._client()
        key = self._key(rel)

        def attempt():
            data = _inject.corrupt(
                "io.objstore.get", c.get(self._bucket, key, 0, None))
            if expected_len is not None and len(data) != expected_len:
                raise IOError(
                    f"objstore: short GET on {self.root}/{rel}: got "
                    f"{len(data)}/{expected_len} bytes")
            return data

        data = guarded("io.objstore.get", attempt)
        _obj_count("get")
        _obj_count("bytes", len(data))
        _obj_count("bytes_served", len(data))
        return data

    def _remote_committed(self, sd: str) -> bool:
        c = self._client()
        try:
            guarded("io.objstore.stat",
                    lambda: c.head(self._bucket,
                                   self._key(f"{sd}/COMMIT")))
        except FileNotFoundError:
            return False
        _obj_count("stat")
        return True

    def _committed_steps_remote(self) -> List[int]:
        c = self._client()
        infos = guarded("io.objstore.list",
                        lambda: c.list(self._bucket, self._obj_prefix))
        _obj_count("list")
        pat = re.compile(r"step-(\d+)/COMMIT$")
        steps = {int(m.group(1)) for o in infos
                 for m in [pat.search(o.key)] if m}
        return sorted(steps)

    # -- remote save

    def _save_remote(self, step: int, tree: Any,
                     metadata: Optional[Dict[str, Any]],
                     writer: Optional[int],
                     num_writers: Optional[int]) -> str:
        """Each record streams to ``<root>/pages/<digest>.pg`` through
        the objstore write plane (multipart past ``put_part_bytes``);
        digests already present (this or any earlier save, locally
        committed or HEAD-probed) upload NOTHING. The leaves leave the
        device once, before the first wire call."""
        rank, world = _rank_world()
        if writer is None:
            writer = rank
        if num_writers is None:
            num_writers = world
        check(0 <= writer < num_writers,
              f"checkpoint: writer {writer} outside num_writers "
              f"{num_writers}")
        c = self._client()
        sd = self._step_key(step)
        if writer == 0 and hasattr(c, "delete"):
            # re-save of an existing step: it must not look committed
            # while its indexes are being rebuilt
            try:
                c.delete(self._bucket, self._key(f"{sd}/COMMIT"))
            except Exception:  # noqa: BLE001 — probe is best-effort
                pass
        leaves = [(k, _host(leaf)) for k, leaf in _flatten(tree)]
        store = self._pages_store()
        written = reused = 0
        entries = []
        for key, leaf in leaves:
            for placement, data in self._addressable_shards(leaf):
                arr = np.ascontiguousarray(data)
                digest = self._record_digest(arr)
                nbytes = self._reusable_nbytes(c, store, digest)
                if nbytes is None:
                    payload = self._serialize_record(arr)
                    nbytes = len(payload)
                    with create_stream(
                            f"{self.root}/pages/{digest}.pg", "w") as s:
                        s.write(payload)
                    written += nbytes
                    self._commit_local_page(store, digest, payload)
                else:
                    reused += nbytes
                entries.append(
                    {"key": key,
                     "placement": [list(p) for p in placement],
                     "digest": digest, "nbytes": nbytes})
        with create_stream(
                f"{self.root}/{sd}/shard-{writer}.idx.json", "w") as s:
            json_dump({"version": _FORMAT_VERSION, "writer": writer,
                       "entries": entries}, s)
        self.last_save_bytes_written = written
        self.last_save_bytes_reused = reused
        _ckpt_count("save_bytes", written)
        if writer == 0:
            self._commit_remote(c, sd, step, leaves, metadata,
                                num_writers)
        return f"{self.root}/{sd}"

    def _reusable_nbytes(self, c, store, digest: str) -> Optional[int]:
        """Payload size when ``pages/<digest>.pg`` already exists — the
        incremental-save dedup. A locally committed page stamped with
        THIS root answers without any wire op; otherwise a HEAD probe
        asks the store. None = upload needed."""
        name = _PAGE_PREFIX + digest + ".pages"
        if store is not None and store.exists(name):
            stamp = store.stamp(name)
            if (stamp and stamp.get("digest") == digest
                    and stamp.get("root") == self.root
                    and "nbytes" in stamp):
                return int(stamp["nbytes"])
        try:
            info = guarded(
                "io.objstore.stat",
                lambda: c.head(self._bucket,
                               self._key(f"pages/{digest}.pg")))
        except FileNotFoundError:
            return None
        _obj_count("stat")
        return int(info.size)

    def _commit_local_page(self, store, digest: str,
                           payload: bytes) -> None:
        """Best-effort page-store commit of a page this process just
        moved (saved or fetched): what the next incremental save and a
        restore in this process recognize without a wire op.
        fingerprint None = content-addressed, immortal to the stale
        sweep."""
        if store is None:
            return
        from dmlc_tpu_torch.io.codec import encode_page, tag
        try:
            store.commit_bytes(
                _PAGE_PREFIX + digest + ".pages",
                encode_page(payload, 0), fingerprint=None,
                meta={"digest": digest, "nbytes": len(payload),
                      "codec": tag(0), "root": self.root})
        except Exception:  # noqa: BLE001 — cache trouble != I/O failure
            pass

    def _commit_remote(self, c, sd: str, step: int, leaves,
                       metadata: Optional[Dict[str, Any]],
                       num_writers: int) -> None:
        """Writer 0's commit: meta.json, then wait for every writer's
        index (the remote analogue of the local save's barrier), then
        the COMMIT marker — a torn or in-flight save never lists as a
        committed step."""
        meta = {
            "version": _FORMAT_VERSION,
            "step": step,
            "num_processes": num_writers,
            "leaves": [{"key": k, "shape": list(leaf.shape),
                        "dtype": leaf.dtype.str}
                       for k, leaf in leaves],
            "user": metadata or {},
        }
        _stamp_gang(meta)
        with create_stream(f"{self.root}/{sd}/meta.json", "w") as s:
            json_dump(meta, s)
        pat = re.compile(r"shard-(\d+)\.idx\.json$")
        deadline = time.monotonic() + 120.0
        while True:
            infos = guarded("io.objstore.list",
                            lambda: c.list(self._bucket, self._key(sd)))
            _obj_count("list")
            have = {int(m.group(1)) for o in infos
                    for m in [pat.search(o.key)] if m}
            if len(have & set(range(num_writers))) == num_writers:
                break
            check(time.monotonic() < deadline,
                  f"checkpoint step {step}: waited 120s for "
                  f"{num_writers} shard indexes, have {sorted(have)}")
            time.sleep(0.05)
        with create_stream(f"{self.root}/{sd}/COMMIT", "w") as s:
            s.write(b"")

    # -- remote restore

    def _load_index_remote(self, sd: str) -> Dict[str, List[dict]]:
        c = self._client()
        infos = guarded("io.objstore.list",
                        lambda: c.list(self._bucket, self._key(sd)))
        _obj_count("list")
        pat = re.compile(r"shard-\d+\.idx\.json$")
        out: Dict[str, List[dict]] = {}
        for o in infos:
            if not pat.search(o.key):
                continue
            rel = (o.key[len(self._obj_prefix):].lstrip("/")
                   if self._obj_prefix else o.key)
            idx = json_load(MemoryStream(
                self._get_object(rel, expected_len=o.size)))
            check(idx.get("version", _FORMAT_VERSION) == _FORMAT_VERSION,
                  "checkpoint shard index version mismatch")
            for e in idx.get("entries", []):
                out.setdefault(e["key"], []).append({
                    "key": e["key"],
                    "placement": tuple(tuple(p)
                                       for p in e["placement"]),
                    "digest": e["digest"],
                    "nbytes": int(e["nbytes"]),
                })
        return out

    @staticmethod
    def _tier():
        """The gang peer tier when this process is one rank of a gang
        of two or more that it can find itself in, else None (no
        fanout: every page comes from the page store or the wire)."""
        try:
            from dmlc_tpu_torch.io.objstore import peer as _peer_mod
            t = _peer_mod.tier()
        except Exception:  # noqa: BLE001 — no tier = no fanout, not an error
            return None
        if t is None or t.self_index is None or t.world <= 1:
            return None
        return t

    def _prefetch_owned_pages(self, index: Dict[str, List[dict]]) -> None:
        """The fanout cut: of all the checkpoint's digests, wire-fetch
        (and page-commit) the ones ``content_owner`` assigns to THIS
        rank at the CURRENT world — any world, including one different
        from the saving gang's. Peers then take these pages from our
        ``/pages`` tier, so each of M restoring ranks pays ~1/M of the
        wire. Best-effort: a failed prefetch leaves the page to the
        assembly pass's peer-then-wire ladder."""
        # preserve marks from an explicit prefetch(): those pages'
        # wire cost is still unreported, and the first store-read
        # must say "wire", not "local"
        self._prefetched = getattr(self, "_prefetched", None) or set()
        t = self._tier()
        if t is None:
            return
        from dmlc_tpu_torch.rendezvous.elastic import content_owner
        store = self._pages_store()
        digests: Dict[str, int] = {}
        for entries in index.values():
            for e in entries:
                digests[e["digest"]] = e["nbytes"]
        for digest in sorted(digests):
            if content_owner(digest, t.world) != t.self_index:
                continue
            name = _PAGE_PREFIX + digest + ".pages"
            if store is not None and store.exists(name):
                continue
            try:
                payload = self._wire_page(digest, digests[digest])
            except Exception:  # noqa: BLE001 — assembly retries
                continue
            self._commit_local_page(store, digest, payload)
            self._prefetched.add(digest)

    def _read_page_record(self, entry: dict) -> np.ndarray:
        digest, nbytes = entry["digest"], entry["nbytes"]
        payload, src = self._page_payload(digest, nbytes)
        arr = ser.read_ndarray(MemoryStream(payload))
        if self._record_digest(arr) != digest:
            raise DMLCError(
                f"checkpoint page {digest}: content mismatch "
                "(corrupt page object)")
        # a 0-d leaf's page holds it as one element (the saver's
        # np.ascontiguousarray, which the digest covers): give the
        # record its placement's shape back
        shape = tuple(hi - lo for lo, hi in entry["placement"])
        if arr.shape != shape:
            arr = arr.reshape(shape)
        self.last_restore_bytes_read += nbytes
        _ckpt_count("restore_bytes", nbytes)
        _ckpt_count(f"restore.{src}_bytes", nbytes)
        attr = f"last_restore_{src}_bytes"
        setattr(self, attr, getattr(self, attr) + nbytes)
        return arr

    def _page_payload(self, digest: str,
                      nbytes: int) -> Tuple[bytes, str]:
        """One content-addressed page, tiered: local page store →
        singleflight → peer owner's /pages → wire. Returns (payload,
        source) with source in {"local", "peer", "wire"} — a page this
        rank itself prefetched over the wire reports as "wire" once
        (the honest split), then "local"."""
        from dmlc_tpu_torch.io.objstore.fs import _SINGLEFLIGHT, _count_sf
        name = _PAGE_PREFIX + digest + ".pages"
        store = self._pages_store()
        payload = self._local_page(store, name, nbytes)
        if payload is not None:
            if digest in getattr(self, "_prefetched", ()):
                self._prefetched.discard(digest)
                return payload, "wire"
            return payload, "local"
        key = (_PAGE_PREFIX, digest)
        if _SINGLEFLIGHT.lead(key):
            _count_sf("lead")
            try:
                return self._peer_or_wire_page(store, name, digest,
                                               nbytes)
            finally:
                _SINGLEFLIGHT.done(key)
        _count_sf("dedup")
        payload = self._local_page(store, name, nbytes)
        if payload is not None:
            return payload, "local"
        return self._peer_or_wire_page(store, name, digest, nbytes)

    def _local_page(self, store, name: str,
                    nbytes: int) -> Optional[bytes]:
        if store is None:
            return None
        from dmlc_tpu_torch.io.codec import decode_page
        s = store.open_read(name)
        if s is None:
            return None
        with s:
            data = s.read_all()
        try:
            data = decode_page(data)
        except DMLCError:
            data = b""  # corrupt frame: treat as torn below
        if len(data) != nbytes:
            store.delete(name)
            return None
        return data

    def _peer_or_wire_page(self, store, name: str, digest: str,
                           nbytes: int) -> Tuple[bytes, str]:
        t = self._tier()
        if t is not None:
            from dmlc_tpu_torch.rendezvous.elastic import content_owner
            owner = content_owner(digest, t.world)
            if owner != t.self_index:
                data = t.fetch_entry(owner, name, None, nbytes)
                if data is not None:
                    self._commit_local_page(store, digest, data)
                    return data, "peer"
        payload = self._wire_page(digest, nbytes)
        self._commit_local_page(store, digest, payload)
        return payload, "wire"

    def _wire_page(self, digest: str, nbytes: int) -> bytes:
        return self._get_object(f"pages/{digest}.pg",
                                expected_len=nbytes)
