"""The port's CUDA kernel library, shared by the ops modules.

One shared library is built from every source under ``csrc/``
(``native/build.py``, nvcc for ``sm_90a``, at first use) and loaded with
ctypes. Each C entry point is declared here once, and :func:`launch`
calls one on a stream (the current stream of a tensor's device unless
it is given one) and raises on the CUDA error it returns. Every entry
only enqueues work on a stream and returns. A call releases the GIL, so
the threads that feed a training step run while it launches, except an
entry of ``_KEEP_GIL``: one called on the thread whose progress paces a
page epoch (the page tier's serve thread), which keeps the GIL for its
microseconds instead of handing it to a reader thread and waiting for
it to come back. :func:`count` adds one to a wrapper's launch count
under a lock, since wrappers launch from more than one thread (two
tenants training in one process).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from dmlc_tpu_torch.utils.logging import DMLCError

__all__ = ["INDEX_BYTES", "library", "launch", "count", "max_shared_bytes"]

# The index dtypes the kernels read, by width: the layout's u32/u64, and
# int32 (csr_to_padded_rows). Under the index rule (csrc/index.cuh) u32 and
# int32 read alike: only the low 32 bits count.
INDEX_BYTES = {torch.uint32: 4, torch.int32: 4, torch.uint64: 8}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
# Every entry returns a cudaError_t; the trailing pointer is the stream.
_SIGNATURES = {
    # offset, index, index_bytes, value, w, rows, nnz, features, y, lanes
    # (16: the half route, 32: the warp route)
    "dmlc_csr_spmv": [_P, _P, _I, _P, _P, _I64, _I64, _I64, _P, _I, _P],
    # offset [parts, rows+1], index, index_bytes, value [parts, nnz], g
    # [parts, rows], parts, rows, nnz (a part's), features, grad_w, lanes
    # (the global route's, 16 or 32), blocks (0: global route)
    "dmlc_csr_spmv_t": [_P, _P, _I, _P, _P, _I64, _I64, _I64, _I64, _P, _I,
                        _I64, _P],
    # offset, index, index_bytes, value, V, rows, nnz, features, K, pair, s,
    # vector (1: vector route)
    "dmlc_fm_pair_fwd": [_P, _P, _I, _P, _P, _I64, _I64, _I64, _I64, _P, _P,
                         _I, _P],
    # offset, index, index_bytes, value, V, s, g, rows, nnz, features, K,
    # gV, vector (1: vector route)
    "dmlc_fm_pair_bwd": [_P, _P, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                         _P, _I, _P],
    # offset, index, index_bytes, value, field, V, rows, nnz, features, nf,
    # K, pair, workspace (null: shared route), blocks
    "dmlc_ffm_pair_fwd": [_P, _P, _I, _P, _P, _P, _I64, _I64, _I64, _I64,
                          _I64, _P, _P, _I64, _P],
    # offset, index, index_bytes, value, field, V, g, rows, nnz, features,
    # nf, K, gV, workspace, blocks
    "dmlc_ffm_pair_bwd": [_P, _P, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                          _I64, _P, _P, _I64, _P],
    # out: int64 (no stream)
    "dmlc_max_shared_bytes": [_P],
    # index [n, k], index_bytes, value [n, k], w, rows, k, features, y
    "dmlc_sdot_rows": [_P, _I, _P, _P, _I64, _I64, _I64, _P, _P],
    # offset, index, index_bytes, value, rows, nnz, cols, dense, rows a
    # block (0: global route)
    "dmlc_csr_to_dense": [_P, _P, _I, _P, _I64, _I64, _I64, _P, _I64, _P],
    # margins, label, qid, weight, n, row sums [2n] (scratch), tile table,
    # lsum, wsum
    "dmlc_pair_sums_fwd": [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
    # margins, label, qid, weight, s (device scalar), n, the forward's tile
    # table, g [n]
    "dmlc_pair_sums_bwd": [_P, _P, _P, _P, _P, _I64, _P, _P, _P],
    # t0, t1 (or null), bias (or null), label, weight, n, partial
    # [2 blocks], counter, loss, g, gb, blocks
    "dmlc_logistic_step": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                           _I64, _P],
    # t0, t1, bias, label, weight, n, partial [2 blocks], counter, total [2],
    # blocks
    "dmlc_logistic_sums": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _I64, _P],
    # t0, t1, bias, label, weight, n, total [2] (read), loss, g,
    # partial [blocks], counter, gb, blocks
    "dmlc_logistic_grad": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                           _P, _I64, _P],
    # host arrays: params, grads, numel (int64), decay (int); count, lr,
    # l2, partial [blocks], counter (both null: no l2 term, or the narrow
    # route), loss (null: no l2 term), blocks (0: the narrow route)
    "dmlc_sgd_update": [_P, _P, _P, _P, _I, _F, _F, _P, _P, _P, _I64,
                        _P],
    # raw round, table [parts, 12], parts, row_bucket, nnz_bucket, the
    # output index's bytes; offset, label, weight, index, value, qid and
    # field (each null where not asked for), num_rows, num_nnz
    "dmlc_round_unpack": [_P, _P, _I64, _I64, _I64, _I, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P],
    # pinned host round, card byte buffer, the round's bytes; then
    # dmlc_round_unpack's arguments after its raw round
    "dmlc_round_stage": [_P, _P, _I64, _P, _I64, _I64, _I64, _I, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P],
}

# entries whose call keeps the GIL (``ctypes.PyDLL``'s convention)
_KEEP_GIL = frozenset({"dmlc_round_stage"})

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def library():
    """The CUDA kernel library, built from csrc/ at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from dmlc_tpu_torch.native.build import build_kernels
            lib = ctypes.CDLL(build_kernels())
            held = ctypes.PyDLL(lib._name, handle=lib._handle)
            for name, args in _SIGNATURES.items():
                fn = getattr(held if name in _KEEP_GIL else lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                setattr(lib, name, fn)
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args, stream=None) -> None:
    """Call the entry ``name`` with ``args`` and ``stream`` (a
    ``torch.cuda.Stream``; the current stream of ``device`` when None)
    on ``device``; raise a DMLCError on the CUDA error it returns."""
    with torch.cuda.device(device):
        if stream is None:
            stream = torch.cuda.current_stream(device)
        err = getattr(library(), name)(*args, stream.cuda_stream)
    if err != 0:
        raise DMLCError(f"{name} launch failed: CUDA error {err}")


def count(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel: ``wrapper.launches += 1``
    under a lock, so launches from two threads are each counted."""
    with _count_lock:
        wrapper.launches += 1


@functools.lru_cache(maxsize=None)
def max_shared_bytes(device: torch.device) -> int:
    """The most shared memory, static and dynamic together, that a block
    may opt in to on ``device`` (``csrc/device.cuh``); the routes of K2,
    K4 and K6 are chosen against it."""
    out = ctypes.c_int64()
    with torch.cuda.device(device):
        err = library().dmlc_max_shared_bytes(ctypes.addressof(out))
    if err != 0:
        raise DMLCError(f"dmlc_max_shared_bytes failed: CUDA error {err}")
    return out.value
