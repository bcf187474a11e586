"""ctypes bindings for the native engine + the libsvm Parser adapter.

The native parser implements the same Parser protocol as the Python
golden (data/parser.py) with byte-identical output. File listing and URI
handling stay in Python (the VFS is the source of truth for shard
layout); the native side owns reading, splitting, parsing and padded
batch assembly.
"""

from __future__ import annotations

import ctypes as C
import os
from typing import Any, Dict, Optional

import numpy as np

from dmlc_tpu_torch.data.padding import PaddedBatch
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.io.input_split import list_split_files
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["load", "BlockLease", "NativeTextParser", "NativeLibSVMParser"]

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
    lib.dtp_parser_before_first.argtypes = [C.c_void_p]
    lib.dtp_block_release.argtypes = [C.c_void_p, C.c_void_p]
    lib.dtp_block_index_range.argtypes = [
        C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_uint64)]
    lib.dtp_parser_stats.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
    lib.dtp_parser_bytes_read.restype = C.c_int64
    lib.dtp_parser_bytes_read.argtypes = [C.c_void_p]
    lib.dtp_parser_destroy.argtypes = [C.c_void_p]
    _lib = lib
    return lib


def _get_lib():
    from dmlc_tpu_torch.native import get_lib
    return get_lib()


def _local_split_files(uri: str):
    """[(local_path, size)] for a split URI: the engine reads raw local
    bytes, so every path must exist locally."""
    files = list_split_files(uri)
    for p, _ in files:
        check(os.path.exists(p),
              f"native engine requires local files, got {p!r}")
    return files


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
            raise DMLCError("'#cache' URIs are not ported to "
                            "dmlc_tpu_torch yet")
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
        # label/weight column, delimiter, sparse flag and column names
        # configure the csv/parquet formats, not ported yet: neutral here
        self._handle = lib.dtp_parser_create(
            paths, sizes, len(files), part_index, num_parts,
            self._format.encode(), int(nthreads), int(chunk_size),
            int(self._indexing_mode), -1, -1, b",", 0, None, None)
        if not self._handle:
            raise DMLCError(
                f"native parser create failed: "
                f"{lib.dtp_last_error().decode()}")
        self._block: Optional[RowBlock] = None
        self._lease: Optional[BlockLease] = None
        self._init_outparams()

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
        # padded-batch out-params (ABI 5), same allocate-once discipline
        self._p = (C.c_void_p(),             # padded-block lease
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
        self._prefs = tuple(C.byref(x) for x in self._p)
        self._mode: Optional[str] = None  # "blocks" | "padded" per epoch

    def _configure(self, kwargs: Dict[str, Any]) -> Optional[str]:
        self._indexing_mode = int(kwargs.pop("indexing_mode", 0))
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
        (block, offset, label, weight, value, index32, index64, qid,
         field, num_nnz, wide, has_qid, has_field) = self._p
        if n < 0:
            self._block = None
            raise DMLCError(
                f"{self._format}: {self._lib.dtp_last_error().decode()}")
        if n == 0:
            return None
        z = int(num_nnz.value)
        lease = _PaddedLease(self, block.value)

        def arr(ptr, count, dtype):
            if count == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,))

        nb = int(nnz_bucket)
        if wide.value:
            index = arr(index64, nb, np.uint64)
        else:
            index = arr(index32, nb, np.uint32)
        if self.index_dtype != index.dtype:
            index = index.astype(self.index_dtype)
        # a PaddedBatch (not a plain dict): it has the ``lease`` slot a
        # consumer that detaches the lease can attach to the item
        out = PaddedBatch(
            {"offset": arr(offset, rb + 1, np.int64),
             "label": arr(label, rb, np.float32),
             "weight": arr(weight, rb, np.float32),
             "index": index,
             "value": arr(value, nb, np.float32),
             "num_rows": np.int32(n), "num_nnz": np.int32(z)})
        if has_qid.value:
            out["qid"] = arr(qid, rb, np.int64)
        if has_field.value:
            out["field"] = arr(field, nb, np.int64)
        self._lease = lease
        self._block = None
        return out

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

    def bytes_read(self) -> int:
        return int(self._lib.dtp_parser_bytes_read(self._handle))

    def destroy(self) -> None:
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
