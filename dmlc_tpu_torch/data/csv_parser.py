"""CSV text parser → dense-as-CSR RowBlock (or zero-dropping sparse
CSR with ``sparse=True``; indices keep the column ordinal).

Reference: src/data/csv_parser.h — CSVParser<I>::ParseBlock,
CSVParserParam{label_column, delimiter, ...}. Uniform column count is
enforced across rows (reference behavior). The label column is removed
from the features; remaining columns become indices 0..ncol-2 in order.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, TextParserBase
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.data.strtonum import parse_float32
from dmlc_tpu_torch.utils.logging import check_eq
from dmlc_tpu_torch.utils.parameter import Parameter, field

__all__ = ["CSVParser", "CSVParserParam"]


class CSVParserParam(Parameter):
    label_column = field(-1, desc="column holding the label; -1: no label "
                                  "(labels default to 0)")
    weight_column = field(-1, desc="column holding row weight; -1: none")
    delimiter = field(",", desc="field delimiter")
    sparse = field(False, desc="drop zero-valued cells (indices keep the "
                               "column ordinal) — BASELINE config 2's "
                               "sparse RowBlock mode")


class CSVParser(TextParserBase):
    def __init__(self, **kwargs):
        self.param = CSVParserParam()
        rest = self.param.update_allow_unknown(kwargs)
        super().__init__(**rest)
        self._ncol = None

    def parse_block(self, records: List[bytes],
                    container: RowBlockContainer) -> None:
        delim = self.param.delimiter.encode()
        lcol, wcol = self.param.label_column, self.param.weight_column
        sparse = self.param.sparse
        for line in records:
            line = line.strip(b"\r")
            if not line:
                continue
            toks = line.split(delim)
            if self._ncol is None:
                self._ncol = len(toks)
            check_eq(len(toks), self._ncol,
                     "csv: non-uniform number of columns")
            label = np.float32(0.0)
            weight = 1.0
            idxs: List[int] = []
            vals: List[np.float32] = []
            fidx = 0
            for c, tok in enumerate(toks):
                if c == lcol:
                    label = parse_float32(tok)
                    continue
                if c == wcol:
                    weight = float(parse_float32(tok))
                    continue
                v = parse_float32(tok)
                if not sparse or v != 0:
                    vals.append(v)
                    idxs.append(fidx)
                fidx += 1
            container.push(label,
                           np.asarray(idxs, self.index_dtype),
                           np.asarray(vals, np.float32),
                           weight=weight)


@PARSER_REGISTRY.register("csv", description="dense csv text")
def _make_csv(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeCSVParser", CSVParser, kwargs)
