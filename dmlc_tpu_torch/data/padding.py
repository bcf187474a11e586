"""Bucket padding: CSR RowBlocks → fixed-shape, device-layout batches.

The one home of the padded-batch layout contract, shared by the
producers that must agree byte for byte (tests pin it):

- ``pad_single`` / ``pad_to_bucket``: the Python golden — one block →
  one padded dict (``pad_single`` is the fused one-pass form).
- the native engine's ABI-5 ``dtp_parser_next_padded``
  (``native/src/engine.cc`` NextPadded), which emits the same layout
  directly from the parse arena so Python never touches row bytes.

Layout (row_bucket = rb, nnz_bucket = nb):
  offset  [rb+1] int64 — rebased to the batch, pad tail repeats num_nnz
  label   [rb]   f32   — pad 0
  weight  [rb]   f32   — absent weights fill 1, pad 0
  index   [nb]   u32/u64 (block dtype) — pad 0
  value   [nb]   f32   — absent values fill 1, pad 0
  qid     [rb]   int64 — fill/pad -1; present iff some row's qid != -1
                         (RowBlockContainer's value-based rule) or the
                         caller forces it (``want_qid``)
  field   [nb]   int64 — fill/pad 0; present iff a constituent block
                         carried fields or ``want_field``
  num_rows/num_nnz     — true sizes under the padding (int32)

Padded rows are compute-neutral: weight 0, empty (offset repeats);
padded nnz carry index 0, value 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.utils.logging import check_le

__all__ = ["pad_to_bucket", "pad_single", "PaddedBatch"]


class PaddedBatch(dict):
    """A padded-batch dict that can carry a native-engine lease.

    The ABI-5 padded path yields ZERO-COPY views into a leased padded
    block; downstream stages apply the exact RowBlock lease discipline,
    so the dict needs the same ``lease`` attribute slot. ``copy()`` materializes owned arrays (the dict
    ``copy()`` would alias the leased views)."""

    __slots__ = ("lease",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lease = None

    def copy(self) -> "PaddedBatch":
        out = PaddedBatch({k: np.array(v, copy=True)
                           for k, v in self.items()})
        return out


def pad_to_bucket(block: RowBlock, row_bucket: int,
                  nnz_bucket: int) -> Dict[str, np.ndarray]:
    """CSR RowBlock → fixed-shape numpy dict (padded, compute-neutral).

    Keys: offset[row_bucket+1] int64, label/weight[row_bucket] f32,
    index[nnz_bucket] (block dtype), value[nnz_bucket] f32,
    num_rows/num_nnz scalars int32. Padded rows are empty (offset
    repeats) with weight 0; padded nnz carry index 0, value 0.
    """
    n, nnz = block.size, block.nnz
    check_le(n, row_bucket, "row bucket too small")
    check_le(nnz, nnz_bucket, "nnz bucket too small")
    offset = np.full(row_bucket + 1, nnz, np.int64)
    offset[:n + 1] = block.offset
    label = np.zeros(row_bucket, np.float32)
    label[:n] = block.label
    weight = np.zeros(row_bucket, np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    index = np.zeros(nnz_bucket, block.index.dtype)
    index[:nnz] = block.index
    value = np.zeros(nnz_bucket, np.float32)
    if block.value is not None:
        value[:nnz] = block.value
    else:
        value[:nnz] = 1.0
    out = {"offset": offset, "label": label, "weight": weight,
           "index": index, "value": value,
           "num_rows": np.int32(n), "num_nnz": np.int32(nnz)}
    if block.qid is not None:
        qid = np.full(row_bucket, -1, np.int64)
        qid[:n] = block.qid
        out["qid"] = qid
    if block.field is not None:
        field = np.zeros(nnz_bucket, np.int64)
        field[:nnz] = block.field
        out["field"] = field
    return out


def pad_single(block: RowBlock, row_bucket: int, nnz_bucket: int,
               want_qid: bool = False,
               want_field: bool = False) -> PaddedBatch:
    """pad_to_bucket, with the optional qid/field keys forced on by
    ``want_qid``/``want_field``, fused into one pass — the Python golden
    for the native engine's ABI-5 padded block. Writes each element once
    (data prefix + neutral-pad tail) instead of fill-then-overwrite."""
    n, nnz = block.size, block.nnz
    check_le(n, row_bucket, "row bucket too small")
    check_le(nnz, nnz_bucket, "nnz bucket too small")
    rb, nb = row_bucket, nnz_bucket
    offset = np.empty(rb + 1, np.int64)
    offset[:n + 1] = block.offset
    offset[n + 1:] = nnz
    label = np.empty(rb, np.float32)
    label[:n] = block.label
    label[n:] = 0.0
    weight = np.empty(rb, np.float32)
    weight[:n] = block.weight if block.weight is not None else 1.0
    weight[n:] = 0.0
    index = np.empty(nb, block.index.dtype)
    index[:nnz] = block.index
    index[nnz:] = 0
    value = np.empty(nb, np.float32)
    value[:nnz] = block.value if block.value is not None else 1.0
    value[nnz:] = 0.0
    out = PaddedBatch({"offset": offset, "label": label,
                       "weight": weight, "index": index, "value": value,
                       "num_rows": np.int32(n), "num_nnz": np.int32(nnz)})
    if block.qid is not None or want_qid:
        qid = np.empty(rb, np.int64)
        qid[:n] = block.qid if block.qid is not None else -1
        qid[n:] = -1
        out["qid"] = qid
    if block.field is not None or want_field:
        field = np.empty(nb, np.int64)
        field[:nnz] = block.field if block.field is not None else 0
        field[nnz:] = 0
        out["field"] = field
    return out
