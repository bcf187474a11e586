"""Dense-record RecordIO parser — the Python golden of the engine's
ABI-6 ``recordio_dense`` fast path.

Copy of ``dmlc_tpu/data/dense_record_parser.py`` with its imports
rewritten to ``dmlc_tpu_torch``. The format is the frozen dense payload encoding of
``io/recordio.py`` (``u32 n_values | f32 label | f32[n]
values``, little-endian) inside standard RecordIO framing — the binary
dense/image scenario class dmlc-core's RecordIO serves (PAPER.md §1).
Each record becomes one CSR row whose indices are the column ordinals
``0..n_values-1`` and whose values are the payload's exact f32 bits, so
the native decoder (engine.cc ``ParseRecIODenseSlice``) is
byte-identical by construction — pinned by
tests/test_torch_recordio.py, incl. escaped-magic multi-frame records
and 2/4/8-way sharded parses.

Rows may carry DIFFERENT n_values (a ragged dense corpus still decodes;
``num_col`` is the max). ``pipeline.from_uri("x.rec")
.parse(format="recordio_dense").batch(rows, pad=True, nnz_bucket=...)``
lowers onto the engine's ABI-5/6 ``NextPadded`` lease path when the
native engine is built, and onto this golden otherwise.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, TextParserBase
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.io.recordio import decode_dense_record
from dmlc_tpu_torch.utils.logging import check

__all__ = ["DenseRecordParser"]


class DenseRecordParser(TextParserBase):
    """Chunked dense-record parser over the RecordIO InputSplit (the
    split realigns shard boundaries by magic scan and stitches
    multi-frame records — identical boundary contract to the engine's
    RecordIOShardReader)."""

    def __init__(self, **kwargs):
        split_type = kwargs.pop("split_type", "recordio")
        check(split_type == "recordio",
              f"recordio_dense: split_type must be 'recordio', "
              f"got {split_type!r}")
        kwargs.pop("format", None)
        super().__init__(split_type="recordio", **kwargs)

    def parse_block(self, records: List[bytes],
                    container: RowBlockContainer) -> None:
        dt = self.index_dtype
        for payload in records:
            label, values = decode_dense_record(payload)
            container.push(label, np.arange(len(values), dtype=dt),
                           values)


@PARSER_REGISTRY.register(
    "recordio_dense",
    description="RecordIO-framed dense f32 records "
                "(u32 n | f32 label | f32[n] values)")
def _make_recordio_dense(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeDenseRecordParser", DenseRecordParser, kwargs)
