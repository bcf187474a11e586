"""LibFM text parser: ``label field:idx:val ...`` → CSR with field[].

Reference: src/data/libfm_parser.h — LibFMParser<I>::ParseBlock.

indexing_mode: 0 = indices used as-is (default), 1 = input is 1-based,
subtract one; -1 = auto-detect per parser instance from the first parsed
block (0-based iff a zero index is seen). Field ids are taken as they
are in every mode.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, TextParserBase
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.data.strtonum import (parse_float32, parse_index,
                                          parse_uint64)
from dmlc_tpu_torch.utils.logging import DMLCError
from dmlc_tpu_torch.utils.parameter import Parameter, field

__all__ = ["LibFMParser", "LibFMParserParam"]


class LibFMParserParam(Parameter):
    indexing_mode = field(0, enum=[-1, 0, 1],
                          desc="0: as-is; 1: one-based input; -1: auto")


class LibFMParser(TextParserBase):
    def __init__(self, **kwargs):
        self.param = LibFMParserParam()
        rest = self.param.update_allow_unknown(kwargs)
        super().__init__(**rest)
        self._resolved_mode = (self.param.indexing_mode
                               if self.param.indexing_mode != -1 else None)

    def parse_block(self, records: List[bytes],
                    container: RowBlockContainer) -> None:
        rows = []
        block_min = None
        for line in records:
            toks = line.split()
            if not toks:
                continue
            label = parse_float32(toks[0])
            n = len(toks) - 1
            fields = np.empty(n, np.int64)
            idxs = np.empty(n, np.uint64)
            vals = np.empty(n, np.float32)
            for j, t in enumerate(toks[1:]):
                parts = t.split(b":")
                if len(parts) != 3:
                    raise DMLCError(f"libfm: bad token {t!r} "
                                    "(want field:idx:val)")
                fields[j] = parse_index(parts[0])
                idxs[j] = parse_uint64(parts[1])
                vals[j] = parse_float32(parts[2])
            if n:
                m = int(idxs.min())
                block_min = m if block_min is None else min(block_min, m)
            rows.append((label, fields, idxs, vals))
        if self._resolved_mode is None:
            self._resolved_mode = 0 if (block_min == 0 or block_min is None) else 1
        shift = self._resolved_mode
        for label, fields, idxs, vals in rows:
            if shift:
                if len(idxs) and int(idxs.min()) == 0:
                    raise DMLCError("libfm: index 0 with indexing_mode=1")
                idxs = idxs - np.uint64(shift)
            container.push(label, idxs.astype(self.index_dtype), vals,
                           fields=fields)


@PARSER_REGISTRY.register("libfm", description="label field:idx:val text")
def _make_libfm(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeLibFMParser", LibFMParser, kwargs)
