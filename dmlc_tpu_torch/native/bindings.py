"""ctypes bindings for the native engine: the libsvm, csv, libfm,
dense-record, image-record and Parquet Parser adapters, the sharded
single-input parser, the RecordIO record reader and the indexed-RecordIO
reader.

The native parser implements the same Parser protocol as the Python
golden (data/parser.py) with byte-identical output. File listing and URI
handling stay in Python (the VFS is the source of truth for shard
layout; ``cuda://`` paths map to their backing files); the native side
owns reading, splitting, parsing and padded batch assembly.

The engine's span ring (chunk reads, tokenize, batch assembly) drains
into the port's trace recorder (``drain_trace``); its on/off flag
follows ``dmlc_tpu_torch.obs.trace``.

Each parser and record-reader handle registers its engine counters with
the obs metrics registry (``native/<format>``, ``native/recordio``)
until ``destroy()``, as the reference's do. The engine's phase beacons
(``prof_read``, ``dtp_parser_set_shard`` on a sharded parser's subs)
feed the sampling profiler's ``native:*`` leaves (``obs/profile.py``).
``native_parse_float32`` and ``native_parse_float64`` are the engine's
float parse as a probe against the Python golden; a text parser's
``set_test_delay_ms`` and ``set_test_touch_rounds`` are the reference's
test hooks for the pipeline-scaling proof.
"""

from __future__ import annotations

import ctypes as C
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from dmlc_tpu_torch.data.padding import PaddedBatch
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.io.input_split import list_split_files
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["load", "BlockLease", "NativeTextParser", "NativeLibSVMParser",
           "NativeCSVParser", "NativeLibFMParser", "NativeDenseRecordParser",
           "NativeImageRecordParser", "NativeParquetParser",
           "NativeShardedTextParser", "NativeRecordIOReader",
           "NativeIndexedRecordIOReader", "native_parse_float32",
           "native_parse_float64", "columns_interleave", "prof_read"]

_lib = None

# Must equal dtp_version() in engine.cc (bumped on every C ABI signature
# change; 5 added native padded batch assembly, 8 is the current engine).
ABI_VERSION = 8


def load(path: str):
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(path)
    lib.dtp_last_error.restype = C.c_char_p
    lib.dtp_version.restype = C.c_int
    got = lib.dtp_version()
    if got != ABI_VERSION:
        raise OSError(f"{path} speaks ABI {got}, expected {ABI_VERSION}")
    lib.dtp_parser_create.restype = C.c_void_p
    lib.dtp_parser_create.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int64, C.c_int64,
        C.c_int64, C.c_char_p, C.c_int, C.c_int64, C.c_int, C.c_int64,
        C.c_int64, C.c_char, C.c_int,
        C.c_char_p, C.c_char_p,  # ABI 8: parquet label/weight names
    ]
    lib.dtp_parser_next.restype = C.c_int64
    lib.dtp_parser_next.argtypes = [
        C.c_void_p,
        C.POINTER(C.c_void_p),              # block lease handle
        C.POINTER(C.POINTER(C.c_int64)),    # offset
        C.POINTER(C.POINTER(C.c_float)),    # label
        C.POINTER(C.POINTER(C.c_float)),    # weight
        C.POINTER(C.POINTER(C.c_int64)),    # qid
        C.POINTER(C.POINTER(C.c_uint32)),   # index32
        C.POINTER(C.POINTER(C.c_uint64)),   # index64
        C.POINTER(C.POINTER(C.c_float)),    # value
        C.POINTER(C.POINTER(C.c_int64)),    # field
        C.POINTER(C.c_int64),               # nnz
        C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int),
    ]
    lib.dtp_parser_next_padded.restype = C.c_int64
    lib.dtp_parser_next_padded.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, C.c_int64, C.c_int, C.c_int,
        C.POINTER(C.c_void_p),              # padded-block lease handle
        C.POINTER(C.POINTER(C.c_int64)),    # offset  [row_bucket+1]
        C.POINTER(C.POINTER(C.c_float)),    # label   [row_bucket]
        C.POINTER(C.POINTER(C.c_float)),    # weight  [row_bucket]
        C.POINTER(C.POINTER(C.c_float)),    # value   [nnz_bucket]
        C.POINTER(C.POINTER(C.c_uint32)),   # index32 [nnz_bucket]
        C.POINTER(C.POINTER(C.c_uint64)),   # index64 [nnz_bucket]
        C.POINTER(C.POINTER(C.c_int64)),    # qid     [row_bucket]
        C.POINTER(C.POINTER(C.c_int64)),    # field   [nnz_bucket]
        C.POINTER(C.c_int64),               # num_nnz
        C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int),
    ]
    lib.dtp_padded_release.argtypes = [C.c_void_p, C.c_void_p]
    # ABI-6 gang assembly: padded batches cut ACROSS sharded
    # sub-parsers (same out-param layout as dtp_parser_next_padded)
    lib.dtp_gang_create.restype = C.c_void_p
    lib.dtp_gang_create.argtypes = [C.POINTER(C.c_void_p), C.c_int64]
    lib.dtp_gang_next_padded.restype = C.c_int64
    lib.dtp_gang_next_padded.argtypes = \
        list(lib.dtp_parser_next_padded.argtypes)
    lib.dtp_gang_padded_release.argtypes = [C.c_void_p, C.c_void_p]
    lib.dtp_gang_outstanding.restype = C.c_int64
    lib.dtp_gang_outstanding.argtypes = [C.c_void_p]
    lib.dtp_gang_assemble_ns.restype = C.c_int64
    lib.dtp_gang_assemble_ns.argtypes = [C.c_void_p]
    lib.dtp_gang_before_first.argtypes = [C.c_void_p]
    lib.dtp_gang_destroy.argtypes = [C.c_void_p]
    lib.dtp_parser_start.argtypes = [C.c_void_p]
    lib.dtp_parser_outstanding.restype = C.c_int64
    lib.dtp_parser_outstanding.argtypes = [C.c_void_p]
    lib.dtp_parser_before_first.argtypes = [C.c_void_p]
    lib.dtp_block_release.argtypes = [C.c_void_p, C.c_void_p]
    lib.dtp_block_index_range.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint64)]
    lib.dtp_columns_interleave.argtypes = [
        C.POINTER(C.c_void_p), C.POINTER(C.c_int32), C.c_int64, C.c_int64,
        C.POINTER(C.c_float)]
    lib.dtp_parser_stats.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
    lib.dtp_parser_set_test_delay_ms.argtypes = [C.c_void_p, C.c_int]
    lib.dtp_parser_set_test_touch_rounds.argtypes = [C.c_void_p, C.c_int]
    lib.dtp_parser_bytes_read.restype = C.c_int64
    lib.dtp_parser_bytes_read.argtypes = [C.c_void_p]
    lib.dtp_parser_destroy.argtypes = [C.c_void_p]
    lib.dtp_recio_create.restype = C.c_void_p
    lib.dtp_recio_create.argtypes = [
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64), C.c_int64, C.c_int64,
        C.c_int64, C.c_int64,
    ]
    lib.dtp_recio_next_batch.restype = C.c_int64
    lib.dtp_recio_next_batch.argtypes = [
        C.c_void_p, C.POINTER(C.c_void_p),
        C.POINTER(C.POINTER(C.c_uint8)), C.POINTER(C.POINTER(C.c_int64)),
        C.POINTER(C.POINTER(C.c_int64)),
    ]
    lib.dtp_recio_block_release.argtypes = [C.c_void_p, C.c_void_p]
    lib.dtp_recio_before_first.argtypes = [C.c_void_p]
    lib.dtp_recio_bytes_read.restype = C.c_int64
    lib.dtp_recio_bytes_read.argtypes = [C.c_void_p]
    lib.dtp_recio_total_size.restype = C.c_int64
    lib.dtp_recio_total_size.argtypes = [C.c_void_p]
    lib.dtp_recio_stats.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
    lib.dtp_recio_destroy.argtypes = [C.c_void_p]
    lib.dtp_recidx_create.restype = C.c_void_p
    lib.dtp_recidx_create.argtypes = [
        C.c_char_p, C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.c_int64]
    lib.dtp_recidx_read_batch.restype = C.c_int64
    lib.dtp_recidx_read_batch.argtypes = [
        C.c_void_p, C.POINTER(C.c_int64), C.c_int64,
        C.POINTER(C.c_void_p), C.POINTER(C.POINTER(C.c_uint8)),
        C.POINTER(C.POINTER(C.c_int64)), C.POINTER(C.POINTER(C.c_int64)),
    ]
    lib.dtp_recidx_release.argtypes = [C.c_void_p, C.c_void_p]
    lib.dtp_recidx_bytes_read.restype = C.c_int64
    lib.dtp_recidx_bytes_read.argtypes = [C.c_void_p]
    lib.dtp_recidx_destroy.argtypes = [C.c_void_p]
    lib.dtp_parse_float32.restype = C.c_int
    lib.dtp_parse_float32.argtypes = [C.c_char_p, C.c_int64,
                                      C.POINTER(C.c_float)]
    lib.dtp_parse_float64.restype = C.c_int
    lib.dtp_parse_float64.argtypes = [C.c_char_p, C.c_int64,
                                      C.POINTER(C.c_double)]
    lib.dtp_trace_set_enabled.argtypes = [C.c_int]
    lib.dtp_trace_enabled.restype = C.c_int
    lib.dtp_now_ns.restype = C.c_int64
    lib.dtp_parser_trace_drain.restype = C.c_int64
    lib.dtp_parser_trace_drain.argtypes = [
        C.c_void_p, C.POINTER(C.c_int64), C.c_int64]
    lib.dtp_prof_read.restype = C.c_int64
    lib.dtp_prof_read.argtypes = [C.POINTER(C.c_int64), C.c_int64]
    lib.dtp_parser_set_shard.restype = None
    lib.dtp_parser_set_shard.argtypes = [C.c_void_p, C.c_int32]
    _lib = lib
    # the tracing global may already be on when the engine loads late
    # (obs.trace only mirrors into an ALREADY-loaded lib)
    from dmlc_tpu_torch.obs import trace as _obs_trace
    lib.dtp_trace_set_enabled(1 if _obs_trace.active() is not None else 0)
    return lib


def _get_lib():
    from dmlc_tpu_torch.native import get_lib
    return get_lib()


_PROF_MAX_SLOTS = 256  # engine.cc kProfSlots


def prof_read(max_slots: int = _PROF_MAX_SLOTS):
    """Snapshot the engine's phase beacons: one ``(kind, index, phase,
    shard)`` tuple per live engine pipeline thread (kind 1 = shard
    reader, 2 = parse worker, 3 = padded consumer; phase per engine.cc
    ProfPhase, 0 = idle; shard -1 when the parser is not a sharded sub).
    Returns ``[]`` when the engine library is not loaded — callers
    (obs/profile.py's sampler) must never trigger a native build/load
    just to profile."""
    if _lib is None:
        return []
    n_slots = max(1, min(int(max_slots), _PROF_MAX_SLOTS))
    buf = (C.c_int64 * (4 * n_slots))()
    n = int(_lib.dtp_prof_read(buf, n_slots))
    return [(buf[4 * i], buf[4 * i + 1], buf[4 * i + 2],
             buf[4 * i + 3]) for i in range(n)]


def _local_split_files(uri: str):
    """[(local_path, size)] for a split URI. The engine reads raw local
    bytes, so cuda:// VFS paths map to their backing files (device
    staging happens at the consumer edge); anything else must exist
    locally."""
    from dmlc_tpu_torch.io.cuda_fs import local_path
    files = [(local_path(p), s) for p, s in list_split_files(uri)]
    for p, _ in files:
        check(os.path.exists(p),
              f"native engine requires local files, got {p!r}")
    return files


def columns_interleave(cols) -> np.ndarray:
    """Interleave contiguous float32/float64 column arrays into one
    row-major float32 array of shape [nrow * ncol] via the native
    cache-blocked transpose (the hot half of Parquet/Arrow ingest).
    Caller guarantees equal lengths, float dtypes, C-contiguity."""
    lib = _get_lib()
    ncol = len(cols)
    nrow = len(cols[0]) if ncol else 0
    out = np.empty(nrow * ncol, np.float32)
    ptrs = (C.c_void_p * ncol)(
        *[c.ctypes.data_as(C.c_void_p).value for c in cols])
    dts = (C.c_int32 * ncol)(
        *[0 if c.dtype == np.float32 else 1 for c in cols])
    lib.dtp_columns_interleave(ptrs, dts, ncol, nrow,
                               out.ctypes.data_as(C.POINTER(C.c_float)))
    return out


def native_parse_float32(token: bytes) -> np.float32:
    """Engine-side float parse (parity probe against the Python golden)."""
    lib = _get_lib()
    out = C.c_float()
    if not lib.dtp_parse_float32(token, len(token), C.byref(out)):
        raise ValueError(f"native: invalid float literal {token!r}")
    return np.float32(out.value)


def native_parse_float64(token: bytes) -> np.float64:
    """The float64 twin of :func:`native_parse_float32`."""
    lib = _get_lib()
    out = C.c_double()
    if not lib.dtp_parse_float64(token, len(token), C.byref(out)):
        raise ValueError(f"native: invalid float literal {token!r}")
    return np.float64(out.value)


class BlockLease:
    """Keeps one native engine block (CSR arena or record batch) alive.
    The arrays handed out by the producing reader are ZERO-COPY views
    into it; ``release()`` returns it to the engine's pool (after which
    the views must not be touched). Producers auto-release the previous
    block on each next() — the reference's RowBlock lifetime contract
    (include/dmlc/data.h: valid until the next Next()) — unless the
    consumer takes the lease over with ``detach()`` to overlap e.g. an
    async host-to-device copy with further parsing."""

    __slots__ = ("_owner", "_ptr")

    _release_fn = "dtp_block_release"  # C release entry point

    def __init__(self, owner, ptr: int):
        self._owner = owner
        self._ptr = ptr

    def release(self) -> None:
        ptr, self._ptr = self._ptr, None
        owner = self._owner
        if ptr and owner is not None and getattr(owner, "_handle", None):
            getattr(owner._lib, self._release_fn)(owner._handle, ptr)
        self._owner = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class _PaddedLease(BlockLease):
    """Lease over one ABI-5 padded device-layout block (the buffers
    return to the handle's padded pool on release)."""

    __slots__ = ()

    _release_fn = "dtp_padded_release"


class _GangPaddedLease(BlockLease):
    """Lease over one gang-assembled padded block (ABI 6): the buffers
    return to the GANG's padded pool on release (the owner's _handle
    is the gang handle, not a parser handle)."""

    __slots__ = ()

    _release_fn = "dtp_gang_padded_release"


class _RecioLease(BlockLease):
    """BlockLease for record batches (different C release entry)."""

    __slots__ = ()

    _release_fn = "dtp_recio_block_release"


class _RecidxLease(BlockLease):
    """Lease over an indexed-recordio batch."""

    __slots__ = ()

    _release_fn = "dtp_recidx_release"


def _padded_outparams():
    """The out-params of dtp_parser_next_padded and dtp_gang_next_padded
    (ABI 5/6), allocated once a parser: the C call overwrites them."""
    return (C.c_void_p(),             # padded-block lease
            C.POINTER(C.c_int64)(),   # offset
            C.POINTER(C.c_float)(),   # label
            C.POINTER(C.c_float)(),   # weight
            C.POINTER(C.c_float)(),   # value
            C.POINTER(C.c_uint32)(),  # index32
            C.POINTER(C.c_uint64)(),  # index64
            C.POINTER(C.c_int64)(),   # qid
            C.POINTER(C.c_int64)(),   # field
            C.c_int64(),              # num_nnz
            C.c_int(), C.c_int(), C.c_int())


def _padded_views(outs, n: int, rb: int, nnz_bucket: int,
                  index_dtype) -> PaddedBatch:
    """The batch of ``n`` rows the engine just cut into ``outs``
    (_padded_outparams), as ZERO-COPY views into its leased padded block,
    padded to (rb, nnz_bucket). A PaddedBatch (not a plain dict): it has
    the ``lease`` slot a consumer that detaches the lease can attach to
    the item."""
    (_, offset, label, weight, value, index32, index64, qid, field,
     num_nnz, wide, has_qid, has_field) = outs

    def arr(ptr, count, dtype):
        if count == 0:
            return np.empty(0, dtype)
        return np.ctypeslib.as_array(ptr, shape=(count,))

    nb = int(nnz_bucket)
    if wide.value:
        index = arr(index64, nb, np.uint64)
    else:
        index = arr(index32, nb, np.uint32)
    if index_dtype != index.dtype:
        index = index.astype(index_dtype)
    out = PaddedBatch(
        {"offset": arr(offset, rb + 1, np.int64),
         "label": arr(label, rb, np.float32),
         "weight": arr(weight, rb, np.float32),
         "index": index,
         "value": arr(value, nb, np.float32),
         "num_rows": np.int32(n), "num_nnz": np.int32(int(num_nnz.value))})
    if has_qid.value:
        out["qid"] = arr(qid, rb, np.int64)
    if has_field.value:
        out["field"] = arr(field, nb, np.int64)
    return out


# native span ring (engine.cc SpanRing): event kind -> (ph, timeline
# name); "X" = complete span, "i" = instant. The engine's small thread
# ids are offset into their own track range so they can never collide
# with Python pthread idents (which are pointer-sized).
_TRACE_KINDS = {
    1: ("X", "native/chunk_read"),
    2: ("X", "native/tokenize"),
    3: ("X", "native/batch_assemble"),
    4: ("i", "native/cache.hit"),
    5: ("i", "native/cache.miss"),
}
_NATIVE_TID_BASE = 0x6E000000  # 'n' << 24: the native track range
_NATIVE_RING_CAP = 4096        # engine.cc SpanRing::kCap


def _native_thread_name(tid: int) -> str:
    if tid == 0:
        return "native/consumer"
    if tid == 1:
        return "native/reader"
    if tid == 100:
        return "native/arena-pool"
    return f"native/worker-{tid - 2}"


class NativeTextParser(Parser):
    """Parser over the native pipeline (reader + parse-pool threads in
    C++). Blocks are zero-copy views into engine arenas (see BlockLease).
    """

    _format = "libsvm"

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 index_dtype=np.uint32, nthreads: Optional[int] = None,
                 chunk_size: int = 8 << 20, **kwargs: Any):
        lib = _get_lib()
        self.uri = uri
        self.index_dtype = np.dtype(index_dtype)
        spec = URISpec(uri)
        if spec.cache_file:
            raise DMLCError(
                "'#cache' URIs are not ported to the native engine (the "
                "reference's engine refuses them too); use "
                "engine='python' for cached splits")
        files = _local_split_files(uri)
        paths = (C.c_char_p * len(files))(
            *[p.encode() for p, _ in files])
        sizes = (C.c_int64 * len(files))(*[s for _, s in files])
        if nthreads is None:
            nthreads = max(1, (os.cpu_count() or 1) - 1)
        cfgerr = self._configure(kwargs)
        if cfgerr:
            raise DMLCError(cfgerr)
        self._lib = lib
        self._handle = lib.dtp_parser_create(
            paths, sizes, len(files), part_index, num_parts,
            self._format.encode(), int(nthreads), int(chunk_size),
            int(self._indexing_mode), int(self._label_column),
            int(self._weight_column), self._delimiter.encode()[:1],
            int(self._sparse),
            self._label_name.encode() if self._label_name else None,
            self._weight_name.encode() if self._weight_name else None)
        if not self._handle:
            raise DMLCError(
                f"native parser create failed: "
                f"{lib.dtp_last_error().decode()}")
        self._block: Optional[RowBlock] = None
        self._lease: Optional[BlockLease] = None
        self._init_outparams()
        # engine counters join the process metrics registry: one
        # obs.metrics snapshot sees reader/parse busy-ns next to the
        # Python-side queue stats (weakly held; destroy() unregisters)
        self._metrics_key = _METRICS.register(
            f"native/{self._format}", self, type(self)._metrics_stats)

    def _metrics_stats(self) -> Optional[Dict[str, int]]:
        return self.stats() if getattr(self, "_handle", None) else None

    def _init_outparams(self) -> None:
        # out-params allocated once; the C call overwrites them per block
        self._o = (C.c_void_p(),             # block lease
                   C.POINTER(C.c_int64)(),   # offset
                   C.POINTER(C.c_float)(),   # label
                   C.POINTER(C.c_float)(),   # weight
                   C.POINTER(C.c_int64)(),   # qid
                   C.POINTER(C.c_uint32)(),  # index32
                   C.POINTER(C.c_uint64)(),  # index64
                   C.POINTER(C.c_float)(),   # value
                   C.POINTER(C.c_int64)(),   # field
                   C.c_int64(),              # nnz
                   C.c_int(), C.c_int(), C.c_int())
        self._refs = tuple(C.byref(x) for x in self._o)
        self._p = _padded_outparams()
        self._prefs = tuple(C.byref(x) for x in self._p)
        self._mode: Optional[str] = None  # "blocks" | "padded" per epoch

    # format knobs; subclasses override
    _indexing_mode = 0
    _label_column = -1
    _weight_column = -1
    _delimiter = ","
    _sparse = False
    _label_name = None   # parquet: columns are addressed by NAME
    _weight_name = None

    def _configure(self, kwargs: Dict[str, Any]) -> Optional[str]:
        self._indexing_mode = int(kwargs.pop("indexing_mode", 0))
        self._label_column = int(kwargs.pop("label_column", -1))
        self._weight_column = int(kwargs.pop("weight_column", -1))
        self._delimiter = str(kwargs.pop("delimiter", ","))
        self._sparse = bool(kwargs.pop("sparse", False))
        kwargs.pop("engine", None)
        kwargs.pop("prefetch", None)
        kwargs.pop("format", None)
        if kwargs:
            return f"native parser: unknown parameter(s) {sorted(kwargs)}"
        return None

    def before_first(self) -> None:
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        self._lib.dtp_parser_before_first(self._handle)
        self._block = None
        self._mode = None

    def next(self) -> bool:
        if self._mode == "padded":
            raise DMLCError(
                "native parser: next() after next_padded() within one "
                "epoch — rows already cut into the padded carry would "
                "be skipped; call before_first() first")
        self._mode = "blocks"
        if self._lease is not None:  # standard RowBlock lifetime contract
            self._lease.release()
            self._lease = None
        rows = self._lib.dtp_parser_next(self._handle, *self._refs)
        (block, offset, label, weight, qid, index32, index64, value,
         field, nnz, hw, hq, hf) = self._o
        if rows < 0:
            self._block = None  # stale views must not outlive the error
            raise DMLCError(
                f"{self._format}: {self._lib.dtp_last_error().decode()}")
        if rows == 0:
            self._block = None
            return False
        n, z = int(rows), int(nnz.value)
        lease = BlockLease(self, block.value)

        def arr(ptr, count, dtype):
            # zero-copy view into the leased arena (no astype round-trip)
            if count == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,))

        if index32:
            index = arr(index32, z, np.uint32)
        else:
            index = arr(index64, z, np.uint64)
        if self.index_dtype != index.dtype:
            index = index.astype(self.index_dtype)  # widen requested u64
        # engine-computed feature-index range: saves consumers an O(nnz)
        # idx.max() rescan (mn > mx is the "no features" sentinel)
        mn = C.c_uint64()
        mx = C.c_uint64()
        self._lib.dtp_block_index_range(block, C.byref(mn), C.byref(mx))
        self._block = RowBlock(
            offset=arr(offset, n + 1, np.int64),
            label=arr(label, n, np.float32),
            index=index,
            value=arr(value, z, np.float32),
            weight=arr(weight, n, np.float32) if hw.value else None,
            qid=arr(qid, n, np.int64) if hq.value else None,
            field=arr(field, z, np.int64) if hf.value else None,
            max_index=int(mx.value) if mn.value <= mx.value else None)
        self._block.lease = lease
        self._lease = lease
        return True

    def value(self) -> RowBlock:
        check(self._block is not None, "value() before successful next()")
        return self._block

    def next_padded(self, rows: int, row_bucket: Optional[int] = None,
                    nnz_bucket: int = 0, want_qid: bool = False,
                    want_field: bool = False
                    ) -> Optional[Dict[str, np.ndarray]]:
        """One bucket-padded, device-layout batch assembled IN THE
        ENGINE (ABI 5): up to ``rows`` rows cut from the arena stream,
        padded to (row_bucket, nnz_bucket) with the Python fused
        golden's exact field set, dtypes, neutral pad values and offset
        rebasing (data/padding.py pad_single — byte parity pinned by
        tests/test_torch_parse.py). Returns a dict of ZERO-COPY views into
        the leased padded block — valid until the next
        next_padded()/before_first() (or hold via ``detach()``) — or
        None at end of stream (the last batch may be short:
        num_rows < rows). The source arenas are recycled the moment a
        batch is cut, so Python never holds row bytes on this path.
        The pad+stack memcpy runs with the GIL released (ctypes)."""
        if self._mode == "blocks":
            raise DMLCError(
                "native parser: next_padded() after next() within one "
                "epoch — the padded carry would skip the leased block's "
                "rows; call before_first() first")
        self._mode = "padded"
        if self._lease is not None:  # same lifetime contract as next()
            self._lease.release()
            self._lease = None
        rb = rows if row_bucket is None else row_bucket
        n = self._lib.dtp_parser_next_padded(
            self._handle, rows, rb, nnz_bucket,
            1 if want_qid else 0, 1 if want_field else 0, *self._prefs)
        if n < 0:
            self._block = None
            raise DMLCError(
                f"{self._format}: {self._lib.dtp_last_error().decode()}")
        if n == 0:
            return None
        self._lease = _PaddedLease(self, self._p[0].value)
        self._block = None
        return _padded_views(self._p, n, rb, nnz_bucket, self.index_dtype)

    def start(self) -> None:
        """Kick the parse pipeline without consuming a block (reader +
        workers run ahead immediately). Used by NativeShardedTextParser
        so every byte-range sub-parser fills its bounded window while
        the consumer drains them in order. No-op while running."""
        self._lib.dtp_parser_start(self._handle)

    def set_test_delay_ms(self, ms: int) -> None:
        """Test hook: add a per-chunk parse delay (pipeline-scaling proof
        on single-core hosts)."""
        self._lib.dtp_parser_set_test_delay_ms(self._handle, int(ms))

    def set_test_touch_rounds(self, rounds: int) -> None:
        """Test hook: FNV-checksum every chunk byte ``rounds`` times per
        chunk before parsing: real byte-touching work for the scaling
        proof."""
        self._lib.dtp_parser_set_test_touch_rounds(self._handle,
                                                   int(rounds))

    def outstanding(self) -> int:
        """Leases currently held by consumers (CSR arenas + padded
        blocks) — the leak probe: after padded emission the source
        arenas must be back in the free list even while padded leases
        are still held."""
        return int(self._lib.dtp_parser_outstanding(self._handle))

    def detach(self) -> Optional[BlockLease]:
        """Take ownership of the current block's lease: the parser will
        NOT release it on the next next()/before_first(). The caller must
        call ``lease.release()`` (e.g. once a copy of the block's views
        into a staging slot has landed)."""
        lease, self._lease = self._lease, None
        return lease

    def stats(self) -> Dict[str, int]:
        """Pipeline stage timings of the current/last run (ns): reader
        busy, parse busy (wall, summed over workers), wall, chunk count,
        queue depths, parse CPU (thread CPU time, summed — the honest
        per-core kernel rate: wall inflates when workers are preempted,
        e.g. by the consumer on a 1-core host), and padded-batch
        assemble time (ABI 5: consumer-side pad+stack memcpy, queue
        waits excluded). reader+parse > wall proves stage overlap."""
        out = (C.c_int64 * 8)()
        self._lib.dtp_parser_stats(self._handle, out)
        return {"reader_busy_ns": int(out[0]), "parse_busy_ns": int(out[1]),
                "wall_ns": int(out[2]), "chunks": int(out[3]),
                "max_chunk_queue_depth": int(out[4]),
                "max_reorder_depth": int(out[5]),
                "parse_cpu_ns": int(out[6]),
                "assemble_ns": int(out[7])}

    def drain_trace(self, rec) -> int:
        """Drain this parser's native span ring into a
        :class:`~dmlc_tpu_torch.obs.trace.TraceRecorder`, converting
        engine steady-clock timestamps onto the recorder's perf_counter
        timebase (offset calibrated per drain — exact when both are
        CLOCK_MONOTONIC, which glibc guarantees, and bounded by one
        syscall's jitter otherwise). Returns the event count. The ring
        records only while tracing is on (dtp_trace_set_enabled), so
        with tracing off this returns 0 at the cost of one C call."""
        if not getattr(self, "_handle", None):
            return 0
        buf = (C.c_int64 * (5 * _NATIVE_RING_CAP))()
        n = int(self._lib.dtp_parser_trace_drain(
            self._handle, buf, _NATIVE_RING_CAP))
        if n == 0:
            return 0
        off_s = time.perf_counter() - self._lib.dtp_now_ns() / 1e9
        named = set()
        for k in range(n):
            kind, tid, t0_ns, dur_ns, arg = buf[5 * k:5 * k + 5]
            ph_name = _TRACE_KINDS.get(kind)
            if ph_name is None:
                continue
            ph, name = ph_name
            rtid = _NATIVE_TID_BASE + tid
            if rtid not in named:
                rec.name_thread(rtid, _native_thread_name(tid))
                named.add(rtid)
            t0_s = t0_ns / 1e9 + off_s
            if ph == "X":
                rec.complete_at(name, t0_s, dur_ns / 1e9, rtid,
                                "native", {"seq": int(arg)})
            else:
                rec.instant_at(name, t0_s, rtid, "native")
        return n

    def bytes_read(self) -> int:
        return int(self._lib.dtp_parser_bytes_read(self._handle))

    def destroy(self) -> None:
        if getattr(self, "_metrics_key", None):
            _METRICS.unregister(self._metrics_key)
            self._metrics_key = None
        if getattr(self, "_handle", None):
            if self._lease is not None:
                self._lease.release()
                self._lease = None
            self._lib.dtp_parser_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


class NativeLibSVMParser(NativeTextParser):
    _format = "libsvm"


class NativeCSVParser(NativeTextParser):
    """The csv format in the engine: label and weight columns by
    ordinal, a one-byte delimiter, and ``sparse=True`` dropping zero
    cells (indices keep the column ordinal), byte-identical to
    data/csv_parser.py's CSVParser."""

    _format = "csv"


class NativeLibFMParser(NativeTextParser):
    _format = "libfm"


class NativeDenseRecordParser(NativeTextParser):
    """Dense RecordIO decode over the native pipeline (ABI 6): the
    engine's RecordIOShardReader realigns the shard by magic scan and
    the parse pool decodes each record's frozen dense payload
    (``u32 n_values | f32 label | f32[n] values`` — io/recordio.py)
    straight into CSR arenas: indices are the column ordinals, values a
    memcpy of the payload's f32 bits. Byte-identical to the Python
    golden (data/dense_record_parser.py); ``next_padded`` feeds the
    same ABI-5 device-layout lease path as the text formats, so
    ``batch(pad=True)`` runs pad+stack in C with the GIL released."""

    _format = "recordio_dense"

    def _configure(self, kwargs):
        # the recordio framing is the format; only the standard engine
        # knobs apply (no delimiter/label_column/sparse semantics)
        split_type = kwargs.pop("split_type", "recordio")
        if split_type != "recordio":
            return (f"recordio_dense: split_type must be 'recordio', "
                    f"got {split_type!r}")
        return super()._configure(kwargs)


class NativeImageRecordParser(NativeTextParser):
    """Dense image-payload decode over the native pipeline (ABI 8):
    the MXNet-style ``.rec`` scenario's decoded lane. The engine's
    RecordIOShardReader realigns the shard by magic scan and the parse
    pool decodes each record's frozen image payload
    (``u32 h | u32 w | u32 c | f32 label | u8[h*w*c]`` HWC pixels —
    io/recordio.py) straight into CSR rows: indices are the pixel
    ordinals, values the pixels widened u8 -> f32 (exact). Byte parity
    with the Python golden (data/image_record_parser.py) is by
    construction; ``next_padded`` feeds the same ABI-5/6 device-layout
    lease path, so ``batch(pad=True)`` emits decoded fixed-shape
    batches with zero Python row-byte touches."""

    _format = "recordio_image"

    def _configure(self, kwargs):
        split_type = kwargs.pop("split_type", "recordio")
        if split_type != "recordio":
            return (f"recordio_image: split_type must be 'recordio', "
                    f"got {split_type!r}")
        return super()._configure(kwargs)


class NativeParquetParser(NativeTextParser):
    """Parquet columnar-page decode over the native pipeline (ABI 8):
    one chunk is one ROW GROUP's contiguous byte span, decoded on a
    pool worker — V1 PLAIN/RLE-dictionary data pages, physical types
    i32/i64/f32/f64, def-level nulls (NaN), UNCOMPRESSED + GZIP pages.
    Emission matches the pyarrow golden's dense path byte for byte
    (data/parquet_parser.py): feature columns in schema order, label/
    weight by name. Anything outside that matrix — nested or byte-array
    columns, zstd pages, V2 data pages, ``sparse=True`` —
    fails create with a NAMED error, so ``engine="auto"`` falls back to
    the pyarrow golden at build, never wrongly at decode. Row-group-
    aligned ``shards=N`` byte-range partition means sharded parses
    concatenate byte-identical to the 1-parser stream (the text/
    recordio contract), through the same ABI-6 gang padded assembly.
    The engine reads the file itself: this lane never imports pyarrow."""

    _format = "parquet"
    decode_path = "native-page"

    def _configure(self, kwargs):
        self._label_name = str(kwargs.pop("label_column", "") or "")
        self._weight_name = str(kwargs.pop("weight_column", "") or "")
        kwargs.pop("split_type", None)
        if kwargs.pop("sparse", False):
            return ("parquet: sparse (zero-dropping) decode is not "
                    "native; engine='auto' falls back to the pyarrow "
                    "golden")
        kwargs.pop("engine", None)
        kwargs.pop("prefetch", None)
        kwargs.pop("format", None)
        if kwargs:
            return f"native parquet: unknown parameter(s) {sorted(kwargs)}"
        return None


_SHARDED_FORMATS = {"libsvm": NativeLibSVMParser, "csv": NativeCSVParser,
                    "libfm": NativeLibFMParser,
                    "recordio_dense": NativeDenseRecordParser,
                    "recordio_image": NativeImageRecordParser,
                    "parquet": NativeParquetParser}


class NativeShardedTextParser(Parser):
    """Single-file parse sharded across N native parsers on byte ranges.

    One large file bounds the steady path by ONE reader thread and ONE
    consumer-side ordered queue however many parse workers run. This
    parser splits the WHOLE input across ``shards`` independent native
    parsers using the standard InputSplit partition rule (sub-parser j
    is part j of ``shards``, so the aligned byte ranges concatenate to
    exactly the whole input — the same realignment contract the Python
    golden and the engine already share), kicks every sub-pipeline at
    epoch start (``dtp_parser_start``), and reassembles blocks by
    draining the sub-parsers in shard order. Each sub-parser's bounded
    reorder window holds its early blocks, so all shards read and parse
    concurrently while the emitted stream stays BYTE-IDENTICAL to the
    1-parser stream (pinned by tests/test_torch_recordio.py).

    ``next_padded`` (ABI 6) assembles device-layout batches ACROSS the
    shards in C (``dtp_gang_next_padded``): the gang handle drains the
    sub-parsers' arena streams in shard order through the same padded
    emission a single parser uses, so batches are cut across shard
    boundaries exactly as the 1-parser stream cuts them — byte
    parity pinned — and the sharded steady path keeps Python off the
    row bytes (pre-6, sharded parses paid the Python fused pad, which
    BOUND memcpy-cheap formats like recordio_dense below the unsharded
    native path).

    Serves the whole input only (part 0 of 1): nesting an outer
    part/num_parts split and the inner shard split would apply the
    byte-range alignment rule twice with different step sizes, yielding
    ranges that no longer concatenate to the outer part.
    """

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 shards: int = 2, format: str = "libsvm",
                 index_dtype=np.uint32, nthreads: Optional[int] = None,
                 chunk_size: int = 8 << 20, **kwargs: Any):
        check(part_index == 0 and num_parts == 1,
              "NativeShardedTextParser serves the whole input "
              "(part 0 of 1); shard the file via `shards=` only")
        cls = _SHARDED_FORMATS.get(format)
        check(cls is not None,
              f"NativeShardedTextParser: unsupported format {format!r}")
        self.uri = uri
        self.index_dtype = np.dtype(index_dtype)
        self.shards = max(1, int(shards))
        if nthreads is None:
            nthreads = max(1, (os.cpu_count() or 1) - 1)
        per = max(1, int(nthreads) // self.shards)
        self._subs: List[NativeTextParser] = [
            cls(uri, j, self.shards, index_dtype=index_dtype,
                nthreads=per, chunk_size=chunk_size, **dict(kwargs))
            for j in range(self.shards)]
        for j, p in enumerate(self._subs):
            # tag each sub's phase beacons with its shard, so the
            # sampling profiler's native labels carry which shard a
            # worker belongs to (set BEFORE any pipeline start —
            # StartPipeline stamps the slots)
            p._lib.dtp_parser_set_shard(p._handle, j)
        self._cur = 0
        self._started = False
        self._block: Optional[RowBlock] = None
        self._block_sub: Optional[NativeTextParser] = None
        # ABI-6 gang handle: padded assembly across the sub-parsers
        # (borrows their handles — destroyed BEFORE the subs)
        self._lib = self._subs[0]._lib
        ptrs = (C.c_void_p * self.shards)(
            *[p._handle for p in self._subs])
        self._handle = self._lib.dtp_gang_create(ptrs, self.shards)
        if not self._handle:
            raise DMLCError(
                f"gang create failed: {self._lib.dtp_last_error().decode()}")
        self._please: Optional[_GangPaddedLease] = None
        self._mode: Optional[str] = None  # "blocks" | "padded" per epoch
        self._p = _padded_outparams()
        self._prefs = tuple(C.byref(x) for x in self._p)

    def _start_all(self) -> None:
        for p in self._subs:
            p.start()
        self._started = True

    def before_first(self) -> None:
        if self._please is not None:
            self._please.release()
            self._please = None
        # after destroy() the gang handle is gone: stay the safe no-op
        # the pre-gang code was (subs are empty too)
        if getattr(self, "_handle", None):
            self._lib.dtp_gang_before_first(self._handle)
        for p in self._subs:
            p.before_first()
        self._cur = 0
        self._mode = None
        self._block = None
        self._block_sub = None
        # restart every sub-pipeline NOW: shard j's reader/workers fill
        # its bounded window while the consumer is still draining j-1
        self._start_all()

    def next(self) -> bool:
        if self._mode == "padded":
            raise DMLCError(
                "sharded parser: next() after next_padded() within one "
                "epoch — rows already cut into the gang's padded carry "
                "would be skipped; call before_first() first")
        self._mode = "blocks"
        if not self._started:
            self._start_all()
        while self._cur < len(self._subs):
            p = self._subs[self._cur]
            if p.next():
                self._block = p.value()
                self._block_sub = p
                return True
            self._cur += 1
        self._block = None
        self._block_sub = None
        return False

    def value(self) -> RowBlock:
        check(self._block is not None, "value() before successful next()")
        return self._block

    def next_padded(self, rows: int, row_bucket: Optional[int] = None,
                    nnz_bucket: int = 0, want_qid: bool = False,
                    want_field: bool = False
                    ) -> Optional[Dict[str, np.ndarray]]:
        """One bucket-padded batch assembled across the shards in the
        ENGINE (ABI 6, dtp_gang_next_padded): same layout contract,
        lease discipline, and Python-golden byte parity as
        NativeTextParser.next_padded — the gang cuts batches over the
        shard-ordered arena stream, so output is identical to the
        1-parser padded stream."""
        if self._mode == "blocks":
            raise DMLCError(
                "sharded parser: next_padded() after next() within one "
                "epoch — the gang's padded carry would skip the leased "
                "block's rows; call before_first() first")
        self._mode = "padded"
        if not self._started:
            self._start_all()
        if self._please is not None:
            self._please.release()
            self._please = None
        rb = rows if row_bucket is None else row_bucket
        n = self._lib.dtp_gang_next_padded(
            self._handle, rows, rb, nnz_bucket,
            1 if want_qid else 0, 1 if want_field else 0, *self._prefs)
        if n < 0:
            raise DMLCError(
                f"sharded: {self._lib.dtp_last_error().decode()}")
        if n == 0:
            return None
        self._please = _GangPaddedLease(self, self._p[0].value)
        return _padded_views(self._p, n, rb, nnz_bucket, self.index_dtype)

    def detach(self) -> Optional[BlockLease]:
        if self._please is not None:
            lease, self._please = self._please, None
            return lease
        return (self._block_sub.detach()
                if self._block_sub is not None else None)

    def stats(self) -> Dict[str, int]:
        """Summed busy/cpu/chunk/assemble counters over the sub-parsers
        (they run concurrently, so summed busy vs the max wall proves
        the cross-shard overlap); depths are maxima. The gang's own
        padded-assembly copy time joins assemble_ns (sub-parsers report
        0 there on the gang path — their planes never run)."""
        outs = [p.stats() for p in self._subs]
        agg = {k: sum(o[k] for o in outs)
               for k in ("reader_busy_ns", "parse_busy_ns", "chunks",
                         "parse_cpu_ns", "assemble_ns")}
        if getattr(self, "_handle", None):
            agg["assemble_ns"] += int(
                self._lib.dtp_gang_assemble_ns(self._handle))
        agg["wall_ns"] = max(o["wall_ns"] for o in outs)
        agg["max_chunk_queue_depth"] = max(
            o["max_chunk_queue_depth"] for o in outs)
        agg["max_reorder_depth"] = max(
            o["max_reorder_depth"] for o in outs)
        agg["shards"] = self.shards
        return agg

    def drain_trace(self, rec) -> int:
        # sub-parser span rings share one engine tid range, so their
        # events land on the same named native tracks — one timeline,
        # shard attribution via the per-span seq args
        return sum(p.drain_trace(rec) for p in self._subs)

    def outstanding(self) -> int:
        gang = (int(self._lib.dtp_gang_outstanding(self._handle))
                if getattr(self, "_handle", None) else 0)
        return gang + sum(p.outstanding() for p in self._subs)

    def bytes_read(self) -> int:
        return sum(p.bytes_read() for p in self._subs)

    def destroy(self) -> None:
        if getattr(self, "_handle", None):
            if self._please is not None:
                self._please.release()
                self._please = None
            # the gang borrows the sub handles: destroy it FIRST
            self._lib.dtp_gang_destroy(self._handle)
            self._handle = None
        for p in self._subs:
            p.destroy()
        self._subs = []
        self._block = None
        self._block_sub = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


class NativeRecordIOReader:
    """Sharded RecordIO record reader over the native pipeline.

    Native counterpart of InputSplit.create(uri, k, n, "recordio")
    (reference: src/io/recordio_split.cc + src/recordio.cc): the engine's
    reader thread realigns the shard to a record-starting frame head,
    reads whole-frame chunks, and the decode stitches multi-frame
    records IN PLACE inside the chunk buffer (single-frame records never
    move — decode cost is the header walk). ``next_batch()`` yields one
    chunk's records zero-copy as (payload_u8, starts_i64, ends_i64)
    numpy views — record i is ``payload[starts[i]:ends[i]]`` — valid
    until the next next_batch()/before_first() (or hold via
    ``detach()``). Record stream is byte-identical to the Python split
    (parity test: tests/test_torch_recordio.py)."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 chunk_size: int = 8 << 20):
        lib = _get_lib()
        self.uri = uri
        files = _local_split_files(uri)
        paths = (C.c_char_p * len(files))(*[p.encode() for p, _ in files])
        sizes = (C.c_int64 * len(files))(*[s for _, s in files])
        self._lib = lib
        self._handle = lib.dtp_recio_create(
            paths, sizes, len(files), part_index, num_parts,
            int(chunk_size))
        if not self._handle:
            raise DMLCError(f"native recordio create failed: "
                            f"{lib.dtp_last_error().decode()}")
        self._lease: Optional[_RecioLease] = None
        self._metrics_key = _METRICS.register(
            "native/recordio", self, NativeRecordIOReader._metrics_stats)

    def _metrics_stats(self) -> Optional[Dict[str, int]]:
        return self.stats() if getattr(self, "_handle", None) else None

    def next_batch(self):
        """(payload, starts, ends) numpy views for one chunk's records,
        or None at end of shard."""
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        block = C.c_void_p()
        payload = C.POINTER(C.c_uint8)()
        starts = C.POINTER(C.c_int64)()
        ends = C.POINTER(C.c_int64)()
        nrec = self._lib.dtp_recio_next_batch(
            self._handle, C.byref(block), C.byref(payload), C.byref(starts),
            C.byref(ends))
        if nrec < 0:
            raise DMLCError(
                f"recordio: {self._lib.dtp_last_error().decode()}")
        if nrec == 0:
            return None
        self._lease = _RecioLease(self, block.value)
        n = int(nrec)
        s = np.ctypeslib.as_array(starts, shape=(n,))
        e = np.ctypeslib.as_array(ends, shape=(n,))
        data = np.ctypeslib.as_array(payload, shape=(int(e[-1]),))
        return data, s, e

    def detach(self) -> Optional[_RecioLease]:
        lease, self._lease = self._lease, None
        return lease

    def records(self):
        """Iterate records as bytes (convenience; copies)."""
        self.before_first()
        while True:
            batch = self.next_batch()
            if batch is None:
                return
            data, starts, ends = batch
            buf = data.tobytes()
            for i in range(len(starts)):
                yield buf[int(starts[i]):int(ends[i])]

    def before_first(self) -> None:
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        self._lib.dtp_recio_before_first(self._handle)

    def bytes_read(self) -> int:
        return int(self._lib.dtp_recio_bytes_read(self._handle))

    def get_total_size(self) -> int:
        return int(self._lib.dtp_recio_total_size(self._handle))

    def stats(self) -> Dict[str, int]:
        out = (C.c_int64 * 7)()
        self._lib.dtp_recio_stats(self._handle, out)
        return {"reader_busy_ns": int(out[0]), "decode_busy_ns": int(out[1]),
                "wall_ns": int(out[2]), "chunks": int(out[3]),
                "decode_cpu_ns": int(out[6])}

    def destroy(self) -> None:
        if getattr(self, "_metrics_key", None):
            _METRICS.unregister(self._metrics_key)
            self._metrics_key = None
        if getattr(self, "_handle", None):
            if self._lease is not None:
                self._lease.release()
                self._lease = None
            self._lib.dtp_recio_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


class NativeIndexedRecordIOReader:
    """Shuffled random-access record reader over the native data plane
    (reference: src/io/indexed_recordio_split.cc).

    The Python split (io.indexed_recordio_split.IndexedRecordIOSplit)
    owns index parsing, byte-range partitioning, and the seeded per-epoch
    batch shuffle — so ordering semantics are IDENTICAL by construction.
    The native handle maps the data file once; ``next_batch()`` returns
    one shuffled batch's payloads as zero-copy spans into the mapping
    (single-frame records; multi-frame batches stitch into a pooled
    buffer). Same lease contract as NativeRecordIOReader."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 index_uri: Optional[str] = None, shuffle: bool = False,
                 seed: int = 0, batch_size: int = 256):
        from dmlc_tpu_torch.io.cuda_fs import local_path
        from dmlc_tpu_torch.io.indexed_recordio_split import (
            IndexedRecordIOSplit)
        lib = _get_lib()
        self._split = IndexedRecordIOSplit(
            uri, part_index, num_parts, index_uri=index_uri,
            shuffle=shuffle, seed=seed, batch_size=batch_size)
        offs, sizes = self._split.record_windows()
        self._lib = lib
        self._handle = lib.dtp_recidx_create(
            local_path(self._split._data_uri).encode(),
            offs.ctypes.data_as(C.POINTER(C.c_int64)),
            sizes.ctypes.data_as(C.POINTER(C.c_int64)), len(offs))
        if not self._handle:
            raise DMLCError(f"native indexed recordio create failed: "
                            f"{lib.dtp_last_error().decode()}")
        self._lease: Optional[_RecidxLease] = None

    def keys(self):
        return self._split.keys()

    def next_batch(self):
        """(payload, starts, ends) numpy views for the next shuffled
        batch's records, or None at end of epoch. Spans are in batch
        order (record i = payload[starts[i]:ends[i]])."""
        order = self._split.next_order_batch()
        if order is None:
            return None
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        block = C.c_void_p()
        payload = C.POINTER(C.c_uint8)()
        starts = C.POINTER(C.c_int64)()
        ends = C.POINTER(C.c_int64)()
        nrec = self._lib.dtp_recidx_read_batch(
            self._handle, order.ctypes.data_as(C.POINTER(C.c_int64)),
            len(order), C.byref(block), C.byref(payload), C.byref(starts),
            C.byref(ends))
        if nrec < 0:
            # engine messages already carry the "indexed recordio:" prefix
            raise DMLCError(self._lib.dtp_last_error().decode())
        if nrec == 0:
            return None
        self._lease = _RecidxLease(self, block.value)
        n = int(nrec)
        s = np.ctypeslib.as_array(starts, shape=(n,))
        e = np.ctypeslib.as_array(ends, shape=(n,))
        # shuffled spans are not ascending: the view must cover max(ends)
        data = np.ctypeslib.as_array(payload, shape=(int(e.max()),))
        return data, s, e

    def detach(self) -> Optional[_RecidxLease]:
        lease, self._lease = self._lease, None
        return lease

    def records(self):
        """Iterate the CURRENT epoch's remaining records as bytes
        (copies). Does NOT rewind: with shuffle=True, before_first()
        advances to the next epoch's permutation (the split's
        semantics — construction leaves epoch 0 ready), so rewinding
        here would silently skip an epoch."""
        while True:
            batch = self.next_batch()
            if batch is None:
                return
            data, starts, ends = batch
            view = memoryview(data)
            for i in range(len(starts)):
                yield bytes(view[int(starts[i]):int(ends[i])])

    def before_first(self) -> None:
        """Rewind; with shuffle=True this advances to the next epoch's
        permutation (the split's reshuffle-per-epoch semantics)."""
        if self._lease is not None:
            self._lease.release()
            self._lease = None
        self._split.before_first()

    def bytes_read(self) -> int:
        return int(self._lib.dtp_recidx_bytes_read(self._handle))

    def get_total_size(self) -> int:
        return self._split.get_total_size()

    def destroy(self) -> None:
        if getattr(self, "_handle", None):
            if self._lease is not None:
                self._lease.release()
                self._lease = None
            self._lib.dtp_recidx_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
