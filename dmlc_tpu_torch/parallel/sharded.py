"""Data-parallel sharded ingest: local shards → per-part batches on the card.

Counterpart of ``dmlc_tpu/parallel/sharded.py``. The reference shards at
*device* granularity: global device d of a ``jax.sharding.Mesh`` parses
part d of D, and each field assembles into one global ``[D, ...]``
jax.Array sharded on the mesh's data axis. One process may own several
devices of the mesh.

The port keeps that granularity with its own :class:`Mesh`: a mesh of D
*parts* (not devices) along its axes, a ``torch.distributed`` process
group (or None), and this process's one device. A process owns a
contiguous range of L = D / world parts, all on its device, and a
global batch is a dict of ``[L, ...]`` tensors on that device: this
process's slice of the reference's ``[D, ...]`` array. So one process
can hold D = 8 parts on the CPU against the reference's 8-device mesh,
and D parts on one card over a world-1 NCCL group (NCCL refuses two
ranks on one card, and ``torch.distributed.device_mesh.DeviceMesh``
takes one device a rank).

Layout contract (one padded CSR block a part):
  offset [L, row_bucket+1] int64
  label/weight [L, row_bucket] f32
  index [L, nnz_bucket] u32/u64, value [L, nnz_bucket] f32
  num_rows/num_nnz [L] int32       (true sizes under the padding)
Consumers run each part on its block with static shapes and all-reduce
across the group (``models.common.SparseModelBase.
make_sharded_train_step``, ``ops.csr.sharded_spmv``). Padded rows are
compute-neutral: weight 0, empty; padded nnz: value 0.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from dmlc_tpu_torch.data.padding import (  # noqa: F401 — re-exported, as
    # the reference re-exports them from its sharded module
    ensure_schema, pad_to_bucket, stack_padded_rows, stack_spec,
)
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.parallel.device_iter import (
    DeviceBatch, HostStaging, copy_to_device, resolve_device, wait_copy,
)
from dmlc_tpu_torch.utils.logging import (
    DMLCError, check, check_eq, log_warning,
)

__all__ = ["Mesh", "pad_to_bucket", "stack_device_batches",
           "make_global_batch", "make_replicated", "stack_padded_rows",
           "ShardedRowBlockIter", "next_pow2_bucket", "empty_block",
           "ensure_schema", "collective_device", "stage_round",
           "RawRoundStager", "PAGE_READERS", "PAGE_GROUP_BYTES",
           "round_groups"]


class Mesh:
    """D parts along named axes, for one process of a gang.

    ``shape`` gives the parts along each of ``axis_names`` (the
    reference's mesh shape, in parts instead of devices). ``group`` is
    the ``torch.distributed`` process group (None: one process, no
    collective). ``device`` is this process's device (``cuda`` by
    default: the card current when the mesh is made, the rank's own
    under ``init_from_env``). The parts are numbered in row-major order over ``shape``,
    and process r of the group's world W owns the contiguous run
    ``[r·D/W, (r+1)·D/W)`` of them, all on ``device``; along an axis
    it owns the coordinates of that run (``local_parts``)."""

    def __init__(self, shape, axis_names: Sequence[str] = ("data",),
                 group=None, device=None):
        shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list))
                                       else (shape,)))
        check(len(shape) == len(axis_names) and all(s >= 1 for s in shape),
              f"mesh shape {shape} must give >= 1 part along each of "
              f"{tuple(axis_names)}")
        self.shape = shape
        self.axis_names = tuple(axis_names)
        self.group = group
        self.device = resolve_device(device)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        size = self.size
        check(size % self.world == 0,
              f"a mesh of {size} parts does not split over {self.world} "
              "processes")
        per = size // self.world
        self._owned = range(self.rank * per, (self.rank + 1) * per)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def parts(self, axis: str = "data") -> int:
        """The number of parts along ``axis``."""
        return self.shape[self.axis_names.index(axis)]

    def local_parts(self, axis: str = "data") -> List[int]:
        """The coordinates along ``axis`` of the parts this process owns,
        sorted (the reference's data-axis coordinates of its local
        devices)."""
        i = self.axis_names.index(axis)
        return sorted({int(np.unravel_index(f, self.shape)[i])
                       for f in self._owned})

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"rank={self.rank}/{self.world}, device={self.device})")


def collective_device(mesh: Mesh) -> torch.device:
    """Where a tensor for one of ``mesh.group``'s collectives must lie:
    the card for NCCL, the CPU for gloo."""
    import torch.distributed as dist
    check(mesh.group is not None, "the mesh has no process group")
    backend = dist.get_backend(mesh.group)
    return mesh.device if backend == "nccl" else torch.device("cpu")


def next_pow2_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum) — bounds compile count."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def empty_block(index_dtype=np.uint32) -> RowBlock:
    """A zero-row block (pads out exhausted shards on skewed data)."""
    return RowBlock(offset=np.zeros(1, np.int64),
                    label=np.zeros(0, np.float32),
                    index=np.zeros(0, index_dtype))


def stack_device_batches(batches: List[Dict[str, np.ndarray]]
                         ) -> Dict[str, np.ndarray]:
    """Per-part padded dicts → one local dict with leading part dim."""
    check(len(batches) > 0, "no device batches")
    keys = batches[0].keys()
    for b in batches[1:]:
        check_eq(set(b.keys()), set(keys), "inconsistent batch keys")
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def make_global_batch(local: Dict[str, Any], mesh: Mesh,
                      axis: str = "data",
                      staging: Optional[HostStaging] = None,
                      copy_stream=None, staged: bool = False) -> DeviceBatch:
    """Local stacked batch ``[L, ...]`` (numpy) → a :class:`DeviceBatch`
    of tensors ``[L, ...]`` on ``mesh.device``, L = this process's parts
    along ``axis``. Dtypes are kept: the index stays u32/u64.

    The copy is ``device_iter.copy_to_device``: with ``staging`` (a
    HostStaging pool owned by the calling thread) each array is first
    copied into a pinned slot, the slot is released behind the copy's
    event, and a consumer on another thread must call
    ``device_iter.wait_copy`` on the batch before using it. ``staged``
    says ``local`` already IS a slot of ``staging``, filled in place
    (``stage_round``): it is copied to the device as it stands. Without
    staging the batch is ready for the current stream when returned.
    The batch's ``counts`` are the host's (rows, nnz) summed over the
    parts."""
    want = len(mesh.local_parts(axis))
    check(not staged or staging is not None,
          "make_global_batch(staged=True) needs the slot's staging pool")
    arrs = {}
    for k, v in local.items():
        v = v if staged else np.asarray(v)
        check(v.ndim >= 1 and v.shape[0] == want,
              f"{k}: batch arrays need a leading part dim of {want} (this "
              f"process's parts along {axis!r}), got shape "
              f"{tuple(v.shape)}")
        arrs[k] = v
    if staged:
        src = arrs
    elif staging is not None:
        src = staging.stage(arrs)
    else:
        src = {k: torch.from_numpy(v) for k, v in arrs.items()}
    out = copy_to_device(src, mesh.device, copy_stream)
    if staging is not None:
        staging.release(src, out.event)
    elif copy_stream is None:
        wait_copy(out, mesh.device)
    rows = arrs.get("num_rows")
    nnz = arrs.get("num_nnz")
    out.counts = (int(rows.sum()) if rows is not None else 0,
                  int(nnz.sum()) if nnz is not None else 0)
    return out


def stage_round(blocks: List[RowBlock], row_bucket: int, nnz_bucket: int,
                want_qid: bool, want_field: bool,
                staging: HostStaging) -> Dict[str, torch.Tensor]:
    """Pad and stack one round straight into a free slot of ``staging``
    (``HostStaging.acquire`` of the round's ``stack_spec``): each byte is
    written once, into the memory the copy to the card reads. The bytes
    are ``stack_padded_rows``'s. Hand the slot to ``make_global_batch(
    ..., staging=staging, staged=True)``."""
    slot = staging.acquire(stack_spec(blocks, row_bucket, nnz_bucket,
                                      want_qid, want_field))
    stack_padded_rows(blocks, row_bucket, nnz_bucket, want_qid, want_field,
                      out={k: t.numpy() for k, t in slot.items()})
    return slot


# a page epoch's reader threads (RawRoundStager), and the bytes one read
# of consecutive rounds covers at most (a round of more is read alone)
PAGE_READERS = 3
PAGE_GROUP_BYTES = 32 << 20


def round_groups(sizes, group_bytes: int) -> List[tuple]:
    """Consecutive rounds in groups ``(r0, r1)``, each read at once: round
    0 alone (the epoch's first batch waits on one round's read), then
    groups of at most twice the bytes of the group before, up to
    ``group_bytes``, each of at least one round."""
    groups, r, cap = [], 0, 0
    while r < len(sizes):
        r1, total = r + 1, int(sizes[r])
        while r1 < len(sizes) and total + int(sizes[r1]) <= cap:
            total += int(sizes[r1])
            r1 += 1
        groups.append((r, r1))
        cap = min(2 * max(total, cap), group_bytes)
        r = r1
    return groups


class RawRoundStager:
    """The raw route of a page epoch: round r of a committed spill file
    (``data.row_iter.RoundSpillFile``) → a :class:`DeviceBatch` on
    ``device``, holding ``stack_padded_rows``'s bytes for the round.

    The rounds' bytes go from the file into pinned slots of ``staging``
    on PAGE_READERS reader threads (``RoundReadAhead``), a group of
    consecutive rounds (:func:`round_groups`, up to PAGE_GROUP_BYTES) a
    read, PAGE_READERS groups ahead of the round being staged, so a
    reader takes the GIL from the serve thread a few times a group, not
    a round (``staging`` holds a slot for each); a reader does the read
    and nothing else. Staging round r is one call of an
    ``ops.pages.RoundStage`` made for the epoch: the copy of its bytes
    to a device byte buffer reused round after round and one
    ``round_unpack`` launch that writes the padded batch from it, both
    enqueued on ``copy_stream`` (the current stream at construction when
    None) by one C call. The batches of a group's rounds are views of
    one fresh allocation on that stream, of the largest group's size
    (so any buffer the caching allocator has back fits any group), made
    when the group is taken from the group's ``ops.pages.group_layout``,
    worked out at construction for the keys ``want`` asks for (a round
    whose keys differ from those asked for when the read started gets
    its own). The caching allocator gives that memory out again only
    once the consumer has dropped the batch and its work on it is done
    (``wait_copy`` records it on the consumer's stream). One event
    recorded behind them is the batch's ``event`` (the consumer calls
    ``wait_copy``); the last round's releases its group's slot. The
    round table goes to the
    device once, at construction; each round's counts, index dtype,
    bucket checks and schema are taken from it then too. A read's error
    (a truncated or rewritten file) is raised at its round. On the CPU
    the same bytes go through ``round_unpack_plain``. Rounds must be
    asked for in order, 0, 1, …; :meth:`close` stops the readers."""

    def __init__(self, pages, device: torch.device, row_bucket: int,
                 nnz_bucket: int, staging: HostStaging, copy_stream=None,
                 want: tuple = (False, False)):
        from dmlc_tpu_torch.data.row_iter import (ROUND_TABLE_COLUMNS,
                                                  RoundReadAhead)
        from dmlc_tpu_torch.ops.pages import INDEX_DTYPES, RoundStage
        col = {c: i for i, c in enumerate(ROUND_TABLE_COLUMNS)}
        self.pages = pages
        self.table = pages.table
        self.device = device
        self.row_bucket, self.nnz_bucket = row_bucket, nnz_bucket
        self.staging = staging
        self.copy_stream = copy_stream
        blocks = self.table.blocks
        n, nnz = blocks[:, :, col["n"]], blocks[:, :, col["nnz"]]
        flags = blocks[:, :, col["flags"]]
        # (rows, nnz), the bucket checks, the index dtype and the schema
        # (carries qid, carries field) of each round
        self._counts = list(zip(n.sum(1).tolist(), nnz.sum(1).tolist()))
        self._fits = list(zip((n.max(1, initial=0) <= row_bucket).tolist(),
                              (nnz.max(1, initial=0) <= nnz_bucket).tolist()))
        self._index_dtype = [INDEX_DTYPES[b] for b in
                             blocks[:, 0, col["index_bytes"]].tolist()]
        self._schema = list(zip((flags & 4).any(1).tolist(),
                                (flags & 8).any(1).tolist()))
        self._groups = round_groups(self.table.size, PAGE_GROUP_BYTES)
        # a slot holds a group's rounds back to back; a raw group spans
        # its rounds' bytes in the file
        spans = [int(self.table.start[r1 - 1] + self.table.size[r1 - 1]
                     - self.table.start[r0]) if not self.table.coded
                 else int(self.table.size[r0:r1].sum())
                 for r0, r1 in self._groups]
        self._spec = {"raw": ((max(spans, default=0),), np.dtype(np.uint8))}
        # on the copy stream, where they are used: the allocator then
        # reuses neither while a copy or launch of it is pending
        with torch.cuda.stream(copy_stream) if copy_stream is not None \
                else contextlib.nullcontext():
            self._table = torch.from_numpy(blocks).to(device)
            self._raw = torch.empty(self.table.max_size, dtype=torch.uint8,
                                    device=device)
        self._stage = RoundStage(self._raw, self._table, row_bucket,
                                 nnz_bucket, copy_stream)
        self._stream = getattr(self._stage, "stream", None)
        # each group's batches placed in one buffer, every view's
        # arguments worked out here, for the keys ``want`` asks for
        # (want_qid, want_field)
        self._want = want
        self._layouts = [self._layout(g, want)
                         for g in range(len(self._groups))]
        # every group's buffer is made at the largest group's size, so
        # any buffer the caching allocator has back fits any group
        self._group_bytes = max((x.nbytes for x in self._layouts),
                                default=0)
        self.readers = PAGE_READERS
        self._reads = RoundReadAhead(pages, self.readers)
        # group → (slot, the keys its batches were planned with, its read)
        self._pending: Dict[int, Any] = {}
        self._next_read = 0   # the next group to read
        self._next_group = 0  # ... to stage
        self._next_round = 0
        # the group being staged: (slot, spans, error, r0, r1, its
        # batches, their keys), and the event behind its last copy
        self._group = None
        self._event = None
        # a call and close() (from the consumer's thread, while an
        # abandoned epoch's serve thread may still be in a call) take
        # turns
        self._lock = threading.Lock()
        self._closed = False

    def reserve(self, n: int) -> None:
        """Have the caching allocator keep ``n`` group buffers for the
        copy stream: made together and dropped at once, they stay cached
        there, so a later page epoch that holds up to ``n`` at once finds
        each without a ``cudaMalloc``. Nothing on the CPU."""
        if self.device.type != "cuda" or not self._group_bytes:
            return
        with torch.cuda.stream(self._stream):
            held = [torch.empty(self._group_bytes, dtype=torch.uint8,
                                device=self.device) for _ in range(n)]
        del held

    def _layout(self, g: int, flags: tuple):
        """Group g's ``ops.pages.group_layout``, its rounds planned with
        ``flags`` (want_qid, want_field)."""
        from dmlc_tpu_torch.ops.pages import group_layout
        r0, r1 = self._groups[g]
        return group_layout(self._stage.parts, self.row_bucket,
                            self.nnz_bucket, tuple(
                                (dt,) + flags
                                for dt in self._index_dtype[r0:r1]))

    def schema(self, r: int):
        """(whether a block of round r carries qid, ... field)."""
        return self._schema[r]

    def _read_ahead(self, last: int, flags: tuple) -> None:
        """Start the reads of every group up to ``last`` not yet started,
        each into a slot of its own, its rounds' batches planned with
        ``flags`` (want_qid, want_field). A reader does the read and
        nothing else."""
        while self._next_read <= min(last, len(self._groups) - 1):
            g = self._next_read
            slot = self.staging.acquire(self._spec)
            r0, r1 = self._groups[g]
            self._pending[g] = (slot, flags, self._reads.submit(
                r0, r1, slot["raw"].numpy(), None))
            self._next_read += 1

    def _take_group(self, flags: tuple) -> None:
        """Wait for the next group's read and make it the current one,
        with its rounds' batches in one allocation placed by its layout
        (made here, where the GIL is already held: a reader would wait
        for it again)."""
        g = self._next_group
        self._next_group += 1
        self._read_ahead(g + self.readers, flags)
        slot, planned, read = self._pending.pop(g)
        try:
            spans, error, _ = read.result()
        except BaseException:
            self.staging.release(slot)
            raise
        outs = self._stage.batches(self._layouts[g] if planned == self._want
                                   else self._layout(g, planned),
                                   self._group_bytes)
        self._group = (slot, spans, error) + self._groups[g] + (outs,
                                                                planned)

    def __call__(self, r: int, want_qid: bool,
                 want_field: bool) -> DeviceBatch:
        with self._lock:
            check(not self._closed, "RawRoundStager: closed")
            return self._stage_round(r, want_qid, want_field)

    def _stage_round(self, r: int, want_qid: bool,
                     want_field: bool) -> DeviceBatch:
        check(r == self._next_round, f"RawRoundStager: round {r} asked "
              f"for where round {self._next_round} is next")
        self._next_round += 1
        if self._group is None:
            self._take_group((want_qid, want_field))
        slot, spans, error, r0, r1, outs, flags = self._group
        if r - r0 >= len(spans):
            self._drop_group()
            raise error  # the read's error, at its round
        fits_rows, fits_nnz = self._fits[r]
        check(fits_rows, "row bucket too small")
        check(fits_nnz, "nnz bucket too small")
        at, size = spans[r - r0]
        # a key that first appears inside the group: this round alone
        out = outs[r - r0] if flags == (want_qid, want_field) else None
        batch = DeviceBatch(self._stage(slot["raw"], r, self._index_dtype[r],
                                        want_qid, want_field, at, size, out))
        if self.device.type == "cuda":
            batch.event = self._event = torch.cuda.Event()
            batch.event.record(self._stream)
        if r == r1 - 1:
            self._drop_group()
        batch.counts = self._counts[r]
        return batch

    def _drop_group(self) -> None:
        """Release the current group's slot behind its last copy."""
        if self._group is not None:
            self.staging.release(self._group[0], self._event)
            self._group = self._event = None

    def close(self) -> None:
        """Stop the readers and hand back the slots not released, once a
        call in progress has ended; a later call raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._reads.close()
            self._drop_group()
            for slot, _, _ in self._pending.values():
                self.staging.release(slot)
            self._pending.clear()


def make_replicated(tree, mesh: Mesh):
    """Host pytree (dicts, lists and tuples of arrays) → the same tree of
    tensors on ``mesh.device``. Every process holds its own copy: callers
    must pass value-identical trees on every process (the usual
    seeded-init contract); nothing verifies it here."""
    if isinstance(tree, dict):
        return {k: make_replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(make_replicated(v, mesh) for v in tree)
    return torch.tensor(np.asarray(tree), device=mesh.device)


class ShardedRowBlockIter:
    """Part-granular sharded ingest: global part d reads part d of D.

    This process parses its parts ``mesh.local_parts(axis)`` (L of
    them), pads each part's block stream to (row_bucket, nnz_bucket),
    stacks, and moves the ``[L, ...]`` batch to ``mesh.device``. Skewed
    shards are padded with empty blocks until every part's stream is
    exhausted, so all processes always agree on batch count (a
    collective requirement).

    Reference seam: InputSplit(uri, rank, world) per worker → here
    num_parts = total parts and the batch is the process's slice.

    Steady-epoch replay (reference: disk_row_iter.h's parse-once/
    replay-epochs, composed in two tiers): epochs after the first serve
    retained rounds of RAW (unpadded) blocks — padded, stacked and
    copied to the device on the serve-prefetch thread — whenever (a)
    ``steady_replay`` is on (default) and (b) a per-file (size,
    mtime_ns, ctime_ns, inode) fingerprint still matches. The tier is
    picked by budget: rounds whose raw bytes fit
    ``agreement_cache_bytes`` stay in memory; larger rounds SPILL to a
    fingerprint-stamped binary page file (``spill_dir``, by default the
    port's page store root, ``data.row_iter.default_spill_dir``), and
    steady epochs replay pages instead of re-parsing text every epoch
    (the larger-than-RAM case). ``page_spill=False`` abandons replay
    past the budget instead. ``replay_tier`` reports which tier served
    the last epoch ("parse" | "memory" | "pages"); ``replay_epochs``
    counts the replayed ones and ``page_replay_epochs`` the page-served
    ones among them, and ``raw_page_epochs`` those the raw route served
    (every page epoch: each round read once into a pinned slot, copied
    to the device and unpacked there by ``ops.pages.round_unpack``,
    :class:`RawRoundStager`). On any fingerprint mismatch the epoch
    transparently re-parses with the replay-count mutation assertions
    (truncation/rewrite raise DMLCError, appended bytes stay invisible)
    and re-earns replay by teeing the clean re-parse. The first epoch of
    a single-process "auto" run streams (fast first batch); its epoch 2
    re-parses and tees; epochs 3+ replay. ``close()`` deletes the spill
    file.
    """

    def __init__(self, uri: str, mesh: Mesh, format: Optional[str] = None,
                 axis: str = "data", row_bucket: int = 1 << 14,
                 nnz_bucket: int = 1 << 18, index_dtype=np.uint32,
                 agreement_cache_bytes: int = 1 << 30,
                 first_epoch_cache: str = "auto",
                 steady_replay: bool = True, page_spill: bool = True,
                 spill_dir: Optional[str] = None, **parser_kwargs):
        from dmlc_tpu_torch.data.parser import Parser
        from dmlc_tpu_torch.io.input_split import list_split_files
        check(first_epoch_cache in ("auto", "always", "never"),
              "first_epoch_cache must be auto|always|never")
        self.mesh = mesh
        self.axis = axis
        self.row_bucket = row_bucket
        self.nnz_bucket = nnz_bucket
        self.index_dtype = np.dtype(index_dtype)
        # rounds-per-epoch, agreed collectively during the FIRST epoch and
        # cached: replay is deterministic (same uri/parts/buckets), so
        # later epochs run with ZERO per-batch collectives. Epoch 1 itself
        # agrees with ONE all-gather (of per-process round counts) when
        # the local shard fits in agreement_cache_bytes of cached blocks;
        # only the over-budget fallback pays the per-round done-flag
        # collective.
        self.agreement_cache_bytes = agreement_cache_bytes
        # "auto": cache only when there IS a collective to save (world >
        # 1) — single-process jobs keep streaming epoch 1 (first batch
        # after one block parse, no cache RSS). "always"/"never" force
        # either path (tests, tuning).
        self.first_epoch_cache = first_epoch_cache
        # steady-epoch replay: keep the epoch-1 rounds as RAW (unpadded)
        # block rows and serve later epochs from them — rounds within
        # agreement_cache_bytes of raw bytes in memory, larger ones
        # spilled to a binary page file — guarded by a per-file
        # fingerprint captured before the cached parse: ANY mismatch
        # falls back to the re-parse epoch, whose count assertions
        # implement the exact mutation semantics — replay is a pure
        # optimization, never a semantics change
        self.steady_replay = steady_replay
        self.page_spill = page_spill
        self._spill_dir = spill_dir
        self.replay_epochs = 0        # replay-served epochs (all tiers)
        self.page_replay_epochs = 0   # ... of which from the page tier
        self.raw_page_epochs = 0      # ... of which by the raw route
        self.replay_tier: Optional[str] = None  # last epoch's server
        self._round_store: Optional["ShardedRowBlockIter._RoundStore"] \
            = None
        self._fingerprint = None
        self._was_pages = False  # last dropped store was page-tier: its
        # re-earn tee starts spilled (the shard is known over budget)
        self._serve_queue = None  # live serve ThreadedIter (probes)
        self._serve_stats: Optional[Dict[str, float]] = None
        # the serve thread's copy stream, made at the first served epoch
        # on the card and kept: the caching allocator hands a freed
        # block only to a request on the stream it was made on, so each
        # epoch's batches then reuse the blocks the epoch before freed
        self._copy_stream = None
        # the page epochs' pinned slots (HostStaging), kept between them,
        # and the size of the group buffers reserved for them
        self._page_staging: Optional[HostStaging] = None
        self._reserved_bytes = None
        # serve-side prefetch lookahead (rounds assembled ahead of the
        # consumer); the pipeline exposes it as an autotuner knob
        self.prefetch_depth = 2
        # optional-key schema (qid/field), observed locally and OR-agreed
        # across processes so every rank pads exhausted parts to the SAME
        # key set
        self._has_qid = False
        self._has_field = False
        # a qid/field column that first appears MID-file flips the batch
        # key set at the discovery round: warn ONCE, the moment the flip
        # happens after round 0
        self._schema_rounds = 0
        self._schema_warned = False
        self._rounds_per_epoch: Optional[int] = None
        # per-part block counts from epoch 1: later epochs assert the
        # replay produced exactly these (file-mutation detector)
        self._part_rounds: Optional[List[int]] = None
        self._my_parts = mesh.local_parts(axis)
        check(len(self._my_parts) > 0, "process owns no mesh parts")
        self._uri = uri
        self._total_parts = mesh.parts(axis)
        self._parsers = [
            Parser.create(uri, p, self._total_parts, format=format,
                          index_dtype=index_dtype, **parser_kwargs)
            for p in self._my_parts]
        # (path, size) at construction: steady epochs stat-check these
        # BEFORE touching any reader — a shrunk file under the native
        # engine's mmap views is SIGBUS (uncatchable), so the shrink
        # must be detected by stat, not by reading
        try:
            self._ctor_sizes = list_split_files(uri)
        except (OSError, DMLCError):  # non-stat-able backing
            self._ctor_sizes = None
        # per-iterator obs collector (weakly held): replay tier +
        # epoch counters land in one metrics snapshot per LIVE
        # iterator, next to the queue/engine surfaces
        from dmlc_tpu_torch.obs.metrics import REGISTRY as _registry
        self._obs_key = _registry.register(
            f"shard/{os.path.basename(uri.split('?', 1)[0])}",
            self, ShardedRowBlockIter._metrics)

    # -- the collectives

    def _all_gather(self, row: np.ndarray) -> np.ndarray:
        """``row`` (int64 [k]) of every process, [world, k], in rank
        order: one ``all_gather`` over the mesh's group."""
        import torch.distributed as dist
        dev = collective_device(self.mesh)
        t = torch.from_numpy(row.astype(np.int64)).to(dev)
        out = [torch.empty_like(t) for _ in range(self.mesh.world)]
        dist.all_gather(out, t, group=self.mesh.group)
        return torch.stack(out).cpu().numpy()

    def _agree_first_epoch(self, cached_ok: bool, local_rounds: int):
        """ONE collective for epoch 1: gathers (did this process cache
        its shard?, its local round count, its observed qid/field
        schema). Returns (all processes cached, global rounds = max of
        counts — exhausted processes pad with empty batches up to it)
        and ORs the schema bits so every rank pads to one key set."""
        if self.mesh.world == 1:
            return cached_ok, max(local_rounds, 0)
        data = self._all_gather(np.array(
            [1 if cached_ok else 0, local_rounds, int(self._has_qid),
             int(self._has_field)], np.int64))
        # collective OR bypasses _note_schema's flip warning: a peer
        # rank's keys arriving via agreement BEFORE this rank yields a
        # batch is the protocol working, not a mid-file flip
        self._has_qid |= bool(np.any(data[:, 2]))
        self._has_field |= bool(np.any(data[:, 3]))
        return bool(np.all(data[:, 0] == 1)), int(np.max(data[:, 1]))

    def _all_processes_done(self, local_done: bool) -> bool:
        """Collective agreement on stream end: with skewed shards, some
        processes exhaust early and must keep yielding empty batches
        until ALL are done (batch count is a collective contract). The
        same per-round collective ORs the observed qid/field schema."""
        if self.mesh.world == 1:
            return local_done
        flags = self._all_gather(np.array(
            [int(local_done), int(self._has_qid), int(self._has_field)],
            np.int64))
        self._has_qid |= bool(np.any(flags[:, 1]))
        self._has_field |= bool(np.any(flags[:, 2]))
        return bool(np.all(flags[:, 0]))

    # -- epochs

    def _first_epoch_batches(self) -> Iterator[DeviceBatch]:
        """Epoch 1: agree on rounds-per-epoch across processes.

        Fast path (one collective): parse the local parts into an
        in-memory cache of raw blocks, all-gather the per-process round
        counts ONCE, then assemble batches from the cache padding
        exhausted parts. Falls back to the per-round done-flag agreement
        when the local shard exceeds ``agreement_cache_bytes``."""
        want_cache = (self.first_epoch_cache == "always" or
                      (self.first_epoch_cache == "auto" and
                       self.mesh.world > 1))
        # fingerprint BEFORE the caching parse reads any byte: a file
        # mutated DURING the pass then mismatches at the next epoch's
        # replay check and the stale rounds are dropped
        fp = self._fingerprint_now() if want_cache else None
        cached = self._try_cache_epoch() if want_cache else None
        local_rounds = (max((len(c) for c in cached), default=0)
                        if cached is not None else -1)
        # ONE all-gather carries the protocol vote, the round count, AND
        # the optional-key schema: the fast path runs only if EVERY
        # process cached, decided by the same collective that agrees the
        # rounds
        all_cached, rounds = self._agree_first_epoch(
            cached is not None, local_rounds)
        if all_cached:
            assert cached is not None
            self._part_rounds = [len(c) for c in cached]
            self._rounds_per_epoch = rounds
            empty = empty_block(self.index_dtype)
            # the tee takes ownership of the cached blocks (no second
            # copy)
            tee = self._make_tee(fp, owned_rows=True)

            def next_round(r: int) -> List[RowBlock]:
                # pad/stack happens at serve time (on the prefetch
                # producer thread): the counting pass stays pure parse
                # and the retained rounds stay RAW
                row = [c[r] if r < len(c) else empty for c in cached]
                for c in cached:
                    if r < len(c):
                        c[r] = None  # the tee owns the blocks now
                tee.add_row(row)
                return row

            # pad+stack+copy of round r+1 runs on a background thread
            # while the consumer works on round r
            rr = iter(range(rounds))
            try:
                yield from self._prefetch_serve(
                    lambda: (next_round(r)
                             if (r := next(rr, None)) is not None
                             else None))
                # commit the replay rounds only on a COMPLETE
                # un-abandoned epoch whose files re-stat unchanged
                tee.commit(self, rounds)
            finally:
                tee.close()
            return
        # some process exceeded its budget: EVERYONE runs the per-round
        # agreement (skewed shards make a process exhaust early; it must
        # keep yielding empty batches until ALL are done), counting rounds
        # so every later epoch skips the collective entirely. A local
        # cache is dropped rather than used for assembly so both sides of
        # the protocol stay identical; the epoch is still teed locally
        # when this process wanted to cache (the tee is not part of the
        # protocol), and an over-budget shard spills its rounds to pages
        # here. force_spill when THIS rank's cache pass just measured
        # the shard over budget: accumulating up to the budget in memory
        # a second time only to flush it to the writer would be
        # redundant copying. A rank that cached fine but lost the vote
        # keeps the memory tier.
        over_budget = want_cache and cached is None
        cached = None
        tee = (self._make_tee(fp, force_spill=over_budget) if want_cache
               else self._ReplayTee(0, None, None))
        its, done, counts = self._restart_streams()
        rounds = 0
        try:
            while True:
                row = self._next_row(its, done, counts)
                if self._all_processes_done(all(done)):
                    self._part_rounds = counts
                    self._rounds_per_epoch = rounds
                    tee.commit(self, rounds)
                    return
                rounds += 1
                tee.add_row(row)
                yield self._assemble(row)
        finally:
            tee.close()

    def _replay_store(self, store: "ShardedRowBlockIter._RoundStore"
                      ) -> Iterator[DeviceBatch]:
        """Serve an epoch from retained raw rounds (memory or pages):
        zero parsing — the serve-prefetch thread pads and stacks a
        memory round, or reads a page round's bytes and unpacks them on
        the device (the raw route), and enqueues its copy one round
        ahead of the consumer. One producer on purpose: its work is
        memcpy-bound, and the reference measured a second serve thread
        35% slower. No collectives (the replay path and the re-parse
        path produce the same batch call sequence, so ranks may mix
        paths when only SOME see a local mutation — or sit in different
        tiers)."""
        if store.tier == "pages":
            # the raw route: each round's bytes to the card, unpacked
            # there by round_unpack
            self.raw_page_epochs += 1
            try:
                yield from self._prefetch_serve(pages=store.file)
            finally:
                # the serve thread has been joined by now
                store.file.close()
            return
        rows = store.iter_rows()
        yield from self._prefetch_serve(lambda: next(rows, None))

    def _fingerprint_now(self):
        """(path, size, mtime_ns, ctime_ns, inode) per backing file, or
        None when a file cannot be stat-ed (then replay never engages —
        the re-parse path simply keeps running every epoch). Inode
        catches replace-by-rename; ctime catches in-place rewrites whose
        mtime was then backdated."""
        from dmlc_tpu_torch.io.input_split import list_split_files
        from dmlc_tpu_torch.io.pagestore import stat_uri
        try:
            out = []
            for path, _size in list_split_files(self._uri):
                size, mtime_ns, ctime_ns, ino = stat_uri(path)
                out.append((path, size, mtime_ns, ctime_ns, ino))
            return tuple(out)
        except (OSError, DMLCError):
            return None

    class _RoundStore:
        """Retained epoch-1 rounds, served on steady epochs: RAW
        (unpadded) per-part blocks in memory, or a page file's rounds;
        padding happens at serve time on the prefetch thread."""

        tier = "?"

        def drop(self) -> None:
            pass

    class _MemoryRounds(_RoundStore):
        tier = "memory"

        def __init__(self, rows: List[List[RowBlock]], nbytes: int):
            self.rows: Optional[List[List[RowBlock]]] = rows
            self.nbytes = nbytes  # raw block bytes

        def iter_rows(self) -> Iterator[List[RowBlock]]:
            return iter(self.rows or [])

        def drop(self) -> None:
            self.rows = None

    class _PageRounds(_RoundStore):
        tier = "pages"

        def __init__(self, spill_file):
            self.file = spill_file  # data.row_iter.RoundSpillFile

        def drop(self) -> None:
            self.file.delete()

    class _ReplayTee:
        """Accumulate raw rounds within the byte budget, SPILLING to a
        binary page file when they exceed it; commit only a COMPLETE
        epoch whose backing files re-stat to the fingerprint captured
        before the epoch's parse began (a file mutated DURING the pass
        must not arm replay with half-old half-new rounds). Shared by
        the epoch-1 fast path, the epoch-1 per-round path, and the
        re-parse tee so the budget/spill/commit invariant lives in one
        place. ``owned_rows`` marks rows whose blocks the caller hands
        over (the epoch-1 cache pass); otherwise blocks may be
        ephemeral arena views and the memory tier copies them (the
        spill writer serializes immediately, so it never copies).
        ``start_spilled`` skips the doomed memory accumulation when a
        size pre-check already proved the shard over budget. A failed
        spill degrades to "no replay"; it never kills the epoch."""

        def __init__(self, budget: int, fp, spill_path: Optional[str],
                     owned_rows: bool = False,
                     start_spilled: bool = False):
            self.budget = budget
            self.fp = fp
            self.active = fp is not None and budget > 0
            self.spill_path = spill_path
            self.owned_rows = owned_rows
            self.rows: List[List[RowBlock]] = []
            self.used = 0
            self._writer = None
            self._committed = False
            # opened lazily at the first row (its width = nparts)
            self._spill_on_first_row = start_spilled
            if self.active and start_spilled and spill_path is None:
                self.active = False

        def _writer_for(self, nparts: int):
            from dmlc_tpu_torch.data.row_iter import RoundSpillWriter
            meta = {"fingerprint": [list(e) for e in self.fp]
                    if self.fp else None}
            return RoundSpillWriter(self.spill_path, nparts, meta)

        def add_row(self, blocks: List[RowBlock]) -> None:
            if not self.active:
                return
            try:
                self._add_row(blocks)
            except (OSError, DMLCError) as e:  # a full/unwritable disk
                # must degrade to "no replay", never kill the epoch
                log_warning(f"ShardedRowBlockIter: replay spill failed "
                            f"({e}); steady epochs will re-parse")
                self._abandon()

        def _add_row(self, blocks: List[RowBlock]) -> None:
            if self._writer is None and self._spill_on_first_row:
                self._writer = self._writer_for(len(blocks))
                self._spill_on_first_row = False
            if self._writer is not None:
                self._writer.add_row(blocks)
                return
            row = (list(blocks) if self.owned_rows
                   else [b.copy() for b in blocks])
            self.used += sum(b.memory_cost_bytes() for b in row)
            if self.used <= self.budget:
                self.rows.append(row)
                return
            # over budget: move to the page tier (or abandon when
            # spilling is off)
            if self.spill_path is None:
                self._abandon()
                return
            self._writer = self._writer_for(len(blocks))
            for r in self.rows:
                self._writer.add_row(r)
            self._writer.add_row(row)
            self.rows = []

        def _abandon(self) -> None:
            self.active = False
            self.rows = []
            if self._writer is not None:
                self._writer.abort()
                self._writer = None

        def commit(self, it: "ShardedRowBlockIter",
                   expected_rounds: int) -> None:
            if not self.active:
                return
            got = (self._writer.rounds if self._writer is not None
                   else len(self.rows))
            if got != expected_rounds or it._fingerprint_now() != self.fp:
                self._abandon()
                return
            if self._writer is not None:
                try:
                    spill_file = self._writer.commit()
                except OSError as e:  # same degrade-to-no-replay
                    # contract as add_row: a commit-time ENOSPC/unlink
                    # must not kill a COMPLETE epoch
                    log_warning(f"ShardedRowBlockIter: replay spill "
                                f"commit failed ({e}); steady epochs "
                                "will re-parse")
                    self._abandon()
                    return
                it._round_store = ShardedRowBlockIter._PageRounds(
                    spill_file)
                self._writer = None
            else:
                it._round_store = ShardedRowBlockIter._MemoryRounds(
                    self.rows, self.used)
                self.rows = []
            it._fingerprint = self.fp
            self._committed = True

        def close(self) -> None:
            """Abort an un-committed spill (abandoned epoch): the .tmp
            must not linger as if it were a cache."""
            if not self._committed:
                self._abandon()

    def _make_tee(self, fp, owned_rows: bool = False,
                  force_spill: bool = False) -> "_ReplayTee":
        """A two-tier tee for this iterator: memory within the budget,
        page spill above it (when enabled), starting directly in spill
        mode when the size pre-check — or the caller's stronger
        evidence (``force_spill``: a cache pass that just measured the
        shard over budget) — proves memory accumulation doomed."""
        if not self.steady_replay:
            return self._ReplayTee(0, None, None)
        return self._ReplayTee(
            self.agreement_cache_bytes, fp, self._spill_path(),
            owned_rows=owned_rows,
            start_spilled=(self.page_spill
                           and (force_spill
                                or not self._cache_precheck_ok())))

    # itertools.count: next() is atomic in CPython, so concurrent tees
    # from different threads can never derive the same spill path
    _SPILL_SEQ = itertools.count(1)

    def _spill_path(self) -> Optional[str]:
        """Unique per-instance spill file under spill_dir, keyed by the
        shard identity (uri/parts/buckets) so the name is self-
        describing; the fingerprint rides in the file header for
        sweep_stale_spill. None disables the page tier."""
        if not self.page_spill:
            return None
        from dmlc_tpu_torch.data.row_iter import default_spill_dir
        key = hashlib.sha256(repr(
            (self._uri, self._total_parts, self._my_parts,
             self.row_bucket, self.nnz_bucket,
             str(self.index_dtype))).encode()).hexdigest()[:16]
        return os.path.join(
            self._spill_dir or default_spill_dir(),
            f"rounds-{key}-p{os.getpid()}-{next(self._SPILL_SEQ)}.pages")

    def _prefetch_serve(self, next_row=None,
                        pages=None) -> Iterator[DeviceBatch]:
        """Serve batches from a background producer, one round ahead:
        ``next_row()`` gives the next round's raw blocks (None at the
        end), and the producer thread pads and stacks them straight into
        a pinned HostStaging slot (``stage_round``) and copies the slot
        to the device on the iterator's copy stream (``_copy_stream``,
        every epoch's), so the copy of round r+1 overlaps the
        consumer's work on round r; the consumer waits on
        each batch's copy event. With ``pages`` (a committed spill file)
        the producer serves its rounds in order by the raw route
        (:class:`RawRoundStager`) instead. The live queue is exposed as
        ``_serve_queue`` while an epoch runs (pipeline probes sample its
        occupancy — that is what lets the autotuner drive the
        shard.prefetch knob) and its producer stats land in
        ``_serve_stats`` at epoch end, with the thread's work (the round,
        its staging and the copy's enqueue) in wall seconds
        (``work_s``) and in the thread's CPU seconds (``work_cpu_s``):
        the gap is time the thread was ready but not running (the GIL,
        the page read's I/O)."""
        from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
        device = self.mesh.device
        on_cuda = device.type == "cuda"
        if on_cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        copy_stream = self._copy_stream
        work = [0.0, 0.0]  # wall, thread CPU
        stager = None
        if pages is not None:
            # the raw route's outputs never alias its slots: a slot is
            # reused on the CPU too, and from one page epoch to the next
            # (the pool is taken here and handed back once the epoch's
            # stager is closed; an epoch that finds it out, an
            # abandoned one's, makes its own). It holds a slot for each
            # read ahead besides those in copy
            staging, self._page_staging = self._page_staging, None
            if staging is None:
                staging = HostStaging(pin=on_cuda)
            staging.slots = self.prefetch_depth + 1 + PAGE_READERS
            stager = RawRoundStager(
                pages, device, self.row_bucket, self.nnz_bucket, staging,
                copy_stream, (self._has_qid, self._has_field))
            if self._reserved_bytes != stager._group_bytes:
                # a spill file's first page epoch: room for the most
                # group buffers a page epoch holds at once (the serve
                # queue's batches, the one staged, the consumer's, and
                # the last one it kept from the epoch before)
                stager.reserve(self.prefetch_depth + 3)
                self._reserved_bytes = stager._group_bytes
            rounds = iter(range(pages.rounds))

            def stage():
                r = next(rounds, None)
                if r is None:
                    return None
                # sticky keys, as _assemble_stacked notes them
                self._note_schema(*stager.schema(r))
                return stager(r, self._has_qid, self._has_field)
        else:
            pool = HostStaging(self.prefetch_depth + 1, pin=on_cuda,
                               alias_unsafe=not on_cuda)

            def stage():
                row = next_row()
                if row is None:
                    return None
                slot = self._assemble_stacked(row, staging=pool)
                return make_global_batch(slot, self.mesh, self.axis,
                                         staging=pool,
                                         copy_stream=copy_stream,
                                         staged=True)

        primed = []

        def produce():
            w0, c0 = time.perf_counter(), time.thread_time()
            if on_cuda and not primed:
                # this thread serves the epoch alone: its card, and its
                # copy stream as its current stream, once
                torch.cuda.set_device(device)
                torch.cuda.set_stream(copy_stream)
                primed.append(True)
            batch = stage()
            work[0] += time.perf_counter() - w0
            work[1] += time.thread_time() - c0
            return batch

        ti = ThreadedIter(max_capacity=self.prefetch_depth,
                          name="shard.serve")
        ti.init(produce)
        self._serve_queue = ti
        try:
            while (batch := ti.next()) is not None:
                yield wait_copy(batch, device)
        finally:
            self._serve_queue = None
            self._serve_stats = dict(ti.stats(),
                                     work_s=round(work[0], 6),
                                     work_cpu_s=round(work[1], 6))
            ti.destroy()
            if stager is not None:
                stager.close()
                self._page_staging = stager.staging

    def _steady_stream(self) -> Iterator[List[RowBlock]]:
        """Epochs 2+: replay the agreed round count with ZERO
        collectives, then assert the replay matched epoch 1 — if the
        underlying file changed between epochs, streams would silently
        yield short or long and desynchronize the collective batch
        contract; turn that into a loud error instead."""
        part_rounds = self._part_rounds
        assert part_rounds is not None  # set with _rounds_per_epoch
        its, done, counts = self._restart_streams()
        for _ in range(self._rounds_per_epoch):
            try:
                row = self._next_row(its, done, counts)
            except DMLCError as e:
                raise self._mutation_error(cause=e) from e
            # fail FAST on a shrunk part: a stream that exhausted short
            # of its epoch-1 count is conclusive evidence the moment it
            # happens
            for i in range(len(its)):
                if done[i] and counts[i] < part_rounds[i]:
                    raise self._mutation_error(
                        part=self._my_parts[i], got=counts[i],
                        want=part_rounds[i])
            yield row
        for i, it in enumerate(its):
            grew = False
            if not done[i]:
                try:
                    next(it)
                    grew = True
                except StopIteration:
                    pass
                except DMLCError as e:
                    # the probe read bytes past the last replayed block
                    # that failed to parse: same hazard, same context
                    raise self._mutation_error(cause=e) from e
            if grew or counts[i] != part_rounds[i]:
                raise self._mutation_error(
                    part=self._my_parts[i], got=counts[i],
                    want=part_rounds[i], grew=grew)

    @staticmethod
    def _mutation_error(part=None, got=None, want=None, grew=False,
                        cause=None) -> DMLCError:
        detail = (f"part {part} replayed {got} blocks"
                  f"{' and kept going' if grew else ''} where epoch 1 "
                  f"produced {want}"
                  if cause is None
                  else f"error replaying data that parsed cleanly in "
                       f"epoch 1: {cause}")
        return DMLCError(
            f"ShardedRowBlockIter: {detail} — the underlying file "
            "changed between epochs of one iterator (deterministic "
            "replay is the contract; recreate the iterator after "
            "mutating inputs)")

    def _note_schema(self, has_qid: bool, has_field: bool) -> None:
        """OR newly observed optional keys into the schema, warning ONCE
        if a key first appears after the first assembled round: from
        that round on the per-batch key set differs from the earlier
        rounds' (and from replay/re-parse epochs, which carry the keys
        from round 0). The fix is uniform columns: tag every row (qid) /
        every feature (field), or none."""
        if self._schema_rounds > 0 and not self._schema_warned:
            flipped = [name for name, seen, new in (
                ("qid", self._has_qid, has_qid),
                ("field", self._has_field, has_field)) if new and not seen]
            if flipped:
                self._schema_warned = True
            if flipped and self.mesh.rank == 0:
                # rank 0 only: every rank detects the same flip
                log_warning(
                    f"ShardedRowBlockIter: optional column(s) "
                    f"{'/'.join(flipped)} first appeared after "
                    f"{self._schema_rounds} assembled round(s) — the "
                    "batch key set changes at this round and will differ "
                    "from earlier rounds and from replay/re-parse epochs. "
                    "Supply uniform columns: tag every row (qid) / every "
                    "feature (field), or none.")
        self._has_qid |= has_qid
        self._has_field |= has_field

    def _check_not_shrunk(self) -> None:
        """Raise the mutation error if any backing file SHRANK since
        construction. Shrinkage is conclusive mutation evidence, and it
        must be caught by stat BEFORE a re-parse: the native engine
        reads files through mmap views, and touching pages past a new
        EOF is SIGBUS — a crash, not a catchable error."""
        if self._ctor_sizes is None:
            return
        from dmlc_tpu_torch.io.pagestore import stat_uri
        for path, size in self._ctor_sizes:
            try:
                now = stat_uri(path)[0]
            except (OSError, DMLCError):
                continue  # deleted/unstatable: the read path reports it
            if now < size:
                raise DMLCError(
                    f"ShardedRowBlockIter: backing file {path} shrank "
                    f"from {size} to {now} bytes — the underlying file "
                    "changed between epochs of one iterator "
                    "(deterministic replay is the contract; recreate "
                    "the iterator after mutating inputs)")

    def _restart_streams(self):
        its = []
        for p in self._parsers:
            p.before_first()
            its.append(self._rechunk(p))
        return its, [False] * len(its), [0] * len(its)

    def _next_row(self, its, done, counts) -> List[RowBlock]:
        row = []
        for i, it in enumerate(its):
            if done[i]:
                row.append(empty_block(self.index_dtype))
                continue
            try:
                blk = next(it)
                counts[i] += 1
                self._note_schema(blk.qid is not None,
                                  blk.field is not None)
                row.append(blk)
            except StopIteration:
                done[i] = True
                row.append(empty_block(self.index_dtype))
        self._schema_rounds += 1
        return row

    def _try_cache_epoch(self) -> Optional[List[List[RowBlock]]]:
        """Parse all local parts into cached RAW owned blocks, or None
        if the budget is exceeded (the fallback rewinds the parsers and
        runs the per-round protocol). The copy() detaches each block
        from any zero-copy engine lease (recycled on the parser's
        next())."""
        budget = self.agreement_cache_bytes
        if not self._cache_precheck_ok():
            return None
        used = 0
        cached: List[List[RowBlock]] = []
        for p in self._parsers:
            p.before_first()
            part: List[RowBlock] = []
            for blk in self._rechunk(p):
                self._note_schema(blk.qid is not None,
                                  blk.field is not None)
                blk = blk.copy()
                used += blk.memory_cost_bytes()
                if used > budget:
                    return None
                part.append(blk)
            cached.append(part)
        return cached

    def _cache_precheck_ok(self) -> bool:
        """Cheap size pre-check: when the backing store is a plain local
        file whose local share already exceeds the budget (raw CSR
        blocks are rarely smaller than their text), skip the doomed
        in-memory caching attempt instead of parsing up to the budget
        only to throw it away."""
        from dmlc_tpu_torch.io.filesys import URI
        try:
            u = URI(self._uri)
            if u.protocol == "file://" and os.path.isfile(u.name):
                total = os.path.getsize(u.name)
                share = (total * len(self._my_parts)
                         // max(self._total_parts, 1))
                if share > self.agreement_cache_bytes:
                    return False
        except (OSError, DMLCError):
            pass
        return True

    def _rechunk(self, parser) -> Iterator[RowBlock]:
        """Clip parser blocks to the (row_bucket, nnz_bucket) budget."""
        while parser.next():
            block = parser.value()
            start = 0
            while start < block.size:
                end = min(block.size, start + self.row_bucket)
                base = int(block.offset[start])
                while int(block.offset[end]) - base > self.nnz_bucket:
                    end -= 1
                check(end > start, "nnz_bucket smaller than one row")
                yield block.slice(start, end)
                start = end

    def _assemble_stacked(self, blocks: List[RowBlock],
                          staging: Optional[HostStaging] = None
                          ) -> Dict[str, Any]:
        """The fused pad+stack of one round: into fresh arrays, or with
        ``staging`` straight into a slot of it (``stage_round``)."""
        # locally observed keys are sticky too: a round where every part
        # is an empty pad must still carry the keys earlier rounds did
        self._note_schema(any(b.qid is not None for b in blocks),
                          any(b.field is not None for b in blocks))
        if staging is not None:
            return stage_round(blocks, self.row_bucket, self.nnz_bucket,
                               self._has_qid, self._has_field, staging)
        return stack_padded_rows(blocks, self.row_bucket,
                                 self.nnz_bucket, self._has_qid,
                                 self._has_field)

    def _assemble(self, blocks: List[RowBlock]) -> DeviceBatch:
        return make_global_batch(self._assemble_stacked(blocks),
                                 self.mesh, self.axis)

    def _metrics(self) -> Dict[str, Any]:
        """obs.metrics collector shape (registered weakly at
        construction, pruned with the iterator)."""
        return {"replay_tier": self.replay_tier,
                "replay_epochs": self.replay_epochs,
                "page_replay_epochs": self.page_replay_epochs,
                "raw_page_epochs": self.raw_page_epochs,
                "prefetch_depth": self.prefetch_depth}

    def __iter__(self) -> Iterator[DeviceBatch]:
        if self._rounds_per_epoch is None:
            self.replay_tier = "parse"
            yield from self._first_epoch_batches()
            return
        self._check_not_shrunk()
        store_file = getattr(self._round_store, "file", None)
        if store_file is not None and not os.path.exists(store_file.path):
            # spill file vanished (external cleanup raced us): not a
            # data hazard — degrade to the re-parse path below and let
            # the tee re-earn a fresh store
            self._round_store = None
            self._fingerprint = None
        if self._round_store is not None:
            if (self._fingerprint is not None
                    and self._fingerprint == self._fingerprint_now()):
                self.replay_epochs += 1
                self.replay_tier = self._round_store.tier
                if self.replay_tier == "pages":
                    self.page_replay_epochs += 1
                yield from self._replay_store(self._round_store)
                return
            # backing files changed (or stopped stat-ing) since the
            # rounds were captured: the store is stale. Drop it (a page
            # tier deletes its spill file) and re-parse —
            # _steady_stream's count assertions then decide whether the
            # change was a hazard (truncation/rewrite raises) or benign
            # (appends are invisible by byte-range)
            store, self._round_store, self._fingerprint = \
                self._round_store, None, None
            self._was_pages = store.tier == "pages"
            store.drop()
        # re-parse epoch; tee the raw rounds into a fresh replay store
        # (memory within budget, pages above it) so single-process
        # "auto" jobs (no epoch-1 cache) replay from epoch 3 on and a
        # mutated-then-stable file re-earns replay after one clean
        # re-parse epoch. A shard whose previous store was pages is
        # known over budget — skip the doomed memory accumulation.
        self.replay_tier = "parse"
        tee = self._make_tee(self._fingerprint_now(),
                             force_spill=self._was_pages)
        try:
            for blocks in self._steady_stream():
                tee.add_row(blocks)
                yield self._assemble(blocks)
            tee.commit(self, self._rounds_per_epoch)
        finally:
            tee.close()

    def close(self) -> None:
        """Release the replay store (a page-tier store deletes its
        spill file) and destroy the parsers. Safe to call twice; also
        invoked from __del__ so an abandoned iterator cannot leak spill
        files past process exit by accident."""
        if getattr(self, "_obs_key", None):
            from dmlc_tpu_torch.obs.metrics import REGISTRY as _registry
            _registry.unregister(self._obs_key)
            self._obs_key = None
        store, self._round_store = self._round_store, None
        if store is not None:
            store.drop()
        for p in self._parsers:
            if hasattr(p, "destroy"):
                try:
                    p.destroy()
                except Exception:  # noqa: BLE001 — teardown
                    pass
        self._parsers = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
