"""The page tier's round unpack: one spilled round's raw bytes → the
padded ``[L, ...]`` batch, a CUDA kernel and its plain version.

A round of a spill file (``data/row_iter.py`` ``RoundSpillWriter``) is
``L`` RowBlock pages back to back, each array behind a header. Its
:class:`~dmlc_tpu_torch.data.row_iter.RoundTable` row (int64 ``[L,
len(ROUND_TABLE_COLUMNS)]``) says where each part's arrays lie, and
:func:`round_unpack` writes from those bytes the batch that
``data.padding.stack_padded_rows`` makes from the round's decoded blocks,
byte for byte: every key of ``stack_spec``, with ``qid`` and ``field``
where asked for (``want_qid``/``want_field``; a round whose blocks carry
one must ask for it).

``round_unpack`` launches ``csrc/pages.cu`` for CUDA tensors and counts
the launch in ``round_unpack.launches``; for CPU tensors it runs
:func:`round_unpack_plain`, the same function in numpy over the same
bytes. It replaces no TPU kernel: the reference pads a replayed round on
the host (``stack_padded_rows``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.data.row_iter import ROUND_TABLE_COLUMNS
from dmlc_tpu_torch.ops.kernels import count, launch
from dmlc_tpu_torch.utils.logging import check

__all__ = ["round_unpack", "round_unpack_plain", "unpack_spec",
           "INDEX_DTYPES"]

_C = {name: i for i, name in enumerate(ROUND_TABLE_COLUMNS)}
# the output index's dtype by its width in bytes
INDEX_DTYPES = {4: torch.uint32, 8: torch.uint64}
_NP_INDEX = {4: "<u4", 8: "<u8"}


def unpack_spec(parts: int, row_bucket: int, nnz_bucket: int,
                index_dtype: torch.dtype, want_qid: bool, want_field: bool
                ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{key: (shape, dtype)}`` of the batch ``round_unpack`` writes
    (``data.padding.stack_spec``'s, in torch dtypes)."""
    L, rb, nb = parts, row_bucket, nnz_bucket
    spec = {"offset": ((L, rb + 1), torch.int64),
            "label": ((L, rb), torch.float32),
            "weight": ((L, rb), torch.float32),
            "index": ((L, nb), index_dtype),
            "value": ((L, nb), torch.float32),
            "num_rows": ((L,), torch.int32),
            "num_nnz": ((L,), torch.int32)}
    if want_qid:
        spec["qid"] = ((L, rb), torch.int64)
    if want_field:
        spec["field"] = ((L, nb), torch.int64)
    return spec


def _check_inputs(raw, table, index_dtype):
    check(raw.dtype == torch.uint8 and raw.dim() == 1
          and raw.is_contiguous(),
          f"round_unpack: raw must be contiguous 1-D uint8, got "
          f"{tuple(raw.shape)} {raw.dtype}")
    check(table.dtype == torch.int64 and table.dim() == 2
          and table.shape[1] == len(ROUND_TABLE_COLUMNS)
          and table.is_contiguous(),
          f"round_unpack: table must be contiguous int64 [parts, "
          f"{len(ROUND_TABLE_COLUMNS)}], got {tuple(table.shape)} "
          f"{table.dtype}")
    check(table.device == raw.device, "round_unpack: raw and table must "
          f"share one device, got {raw.device} and {table.device}")
    check(index_dtype in INDEX_DTYPES.values(),
          f"round_unpack: index dtype must be uint32 or uint64, got "
          f"{index_dtype}")


def _outputs(spec, device, out):
    """Fresh tensors of ``spec`` on ``device``, or ``out`` once it is
    checked to hold them."""
    if out is None:
        return {k: torch.empty(shape, dtype=dtype, device=device)
                for k, (shape, dtype) in spec.items()}
    check(out.keys() == spec.keys()
          and all(tuple(out[k].shape) == shape and out[k].dtype == dtype
                  and out[k].device == device and out[k].is_contiguous()
                  for k, (shape, dtype) in spec.items()),
          f"round_unpack: out= does not hold the round's unpack_spec on "
          f"{device}")
    return out


def round_unpack(raw: torch.Tensor, table: torch.Tensor, row_bucket: int,
                 nnz_bucket: int, index_dtype: torch.dtype,
                 want_qid: bool = False, want_field: bool = False,
                 out: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The padded batch of the round whose bytes are ``raw`` (uint8, at
    least the round's size) and whose table rows are ``table``, into
    fresh tensors on ``raw``'s device or into ``out`` (tensors of
    :func:`unpack_spec`'s shapes and dtypes there). For CUDA tensors the
    caller has checked each part's n and nnz against the buckets (it
    holds the table on the host); the plain version checks them."""
    _check_inputs(raw, table, index_dtype)
    if raw.device.type == "cpu":
        return round_unpack_plain(raw, table, row_bucket, nnz_bucket,
                                  index_dtype, want_qid, want_field, out)
    check(raw.is_cuda, f"round_unpack runs on cuda or cpu, got {raw.device}")
    out = _outputs(unpack_spec(table.shape[0], row_bucket, nnz_bucket,
                               index_dtype, want_qid, want_field),
                   raw.device, out)
    ptr = lambda k: out[k].data_ptr() if k in out else None  # noqa: E731
    launch("dmlc_round_unpack", raw.device, raw.data_ptr(), table.data_ptr(),
           table.shape[0], row_bucket, nnz_bucket, index_dtype.itemsize,
           ptr("offset"), ptr("label"), ptr("weight"), ptr("index"),
           ptr("value"), ptr("qid"), ptr("field"), ptr("num_rows"),
           ptr("num_nnz"))
    count(round_unpack)
    return out


def round_unpack_plain(raw: torch.Tensor, table: torch.Tensor,
                       row_bucket: int, nnz_bucket: int,
                       index_dtype: torch.dtype, want_qid: bool = False,
                       want_field: bool = False,
                       out: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """:func:`round_unpack` in numpy over CPU tensors: each array read
    where the table places it (``np.frombuffer`` reads at any byte),
    written into its part's row, then the neutral tail, as
    ``stack_padded_rows`` writes them. The outputs own their memory:
    none aliases ``raw``."""
    rb, nb = row_bucket, nnz_bucket
    _check_inputs(raw, table, index_dtype)
    out = _outputs(unpack_spec(table.shape[0], rb, nb, index_dtype,
                               want_qid, want_field), raw.device, out)
    buf = raw.numpy()
    o = {k: v.numpy() for k, v in out.items()}
    for i, t in enumerate(table.numpy()):
        n, nnz = int(t[_C["n"]]), int(t[_C["nnz"]])
        check(n <= rb, "row bucket too small")
        check(nnz <= nb, "nnz bucket too small")
        check((want_qid or t[_C["qid"]] < 0)
              and (want_field or t[_C["field"]] < 0),
              "round_unpack: a block carries qid or field the call did not "
              "ask for")

        def arr(name, dtype, count):
            return np.frombuffer(buf, dtype, count, int(t[_C[name]]))

        def opt(name, dtype, count, absent):
            return arr(name, dtype, count) if t[_C[name]] >= 0 else absent

        o["offset"][i, :n + 1] = arr("offset", "<i8", n + 1)
        o["offset"][i, n + 1:] = nnz
        o["label"][i, :n] = arr("label", "<f4", n)
        o["label"][i, n:] = 0.0
        o["weight"][i, :n] = opt("weight", "<f4", n, 1.0)
        o["weight"][i, n:] = 0.0
        o["index"][i, :nnz] = arr("index", _NP_INDEX[int(
            t[_C["index_bytes"]])], nnz)
        o["index"][i, nnz:] = 0
        o["value"][i, :nnz] = opt("value", "<f4", nnz, 1.0)
        o["value"][i, nnz:] = 0.0
        o["num_rows"][i] = n
        o["num_nnz"][i] = nnz
        if want_qid:
            o["qid"][i, :n] = opt("qid", "<i8", n, -1)
            o["qid"][i, n:] = -1
        if want_field:
            o["field"][i, :nnz] = opt("field", "<i8", nnz, 0)
            o["field"][i, nnz:] = 0
    return out


round_unpack.launches = 0
