"""LibSVM text parser: ``label [qid:N] idx:val idx:val ...`` → CSR.

Reference: src/data/libsvm_parser.h — LibSVMParser<I>::ParseBlock,
LibSVMParserParam{indexing_mode}.

indexing_mode: 0 = indices used as-is (default), 1 = input is 1-based,
subtract one; -1 = auto-detect per parser instance from the first parsed
block (0-based iff a zero index is seen — reference semantics; note
auto-detection is per-shard, as in the reference).
"""

from __future__ import annotations

from typing import List

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, TextParserBase
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.data.strtonum import parse_float32, parse_index, parse_uint64
from dmlc_tpu_torch.utils.logging import DMLCError
from dmlc_tpu_torch.utils.parameter import Parameter, field

__all__ = ["LibSVMParser", "LibSVMParserParam"]


class LibSVMParserParam(Parameter):
    indexing_mode = field(0, enum=[-1, 0, 1],
                          desc="0: as-is; 1: one-based input; -1: auto-detect")


class LibSVMParser(TextParserBase):
    def __init__(self, **kwargs):
        self.param = LibSVMParserParam()
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
            try:
                label = parse_float32(toks[0])
            except ValueError as e:
                # engine parity: the native engine reports a bad label
                # as DMLCError
                raise DMLCError(f"libsvm: bad label {toks[0]!r}") from e
            qid = -1
            feats = toks[1:]
            if feats and feats[0].startswith(b"qid:"):
                try:
                    qid = parse_index(feats[0][4:])
                except ValueError as e:
                    raise DMLCError(
                        f"libsvm: bad qid token {feats[0]!r}") from e
                feats = feats[1:]
            idxs = np.empty(len(feats), np.uint64)
            vals = np.empty(len(feats), np.float32)
            for j, t in enumerate(feats):
                i, sep, v = t.rpartition(b":")
                if not sep:
                    raise DMLCError(f"libsvm: bad feature token {t!r}")
                try:
                    idxs[j] = parse_uint64(i)
                    vals[j] = parse_float32(v)
                except ValueError as e:
                    raise DMLCError(
                        f"libsvm: bad feature token {t!r}") from e
            if len(idxs):
                m = int(idxs.min())
                block_min = m if block_min is None else min(block_min, m)
            rows.append((label, idxs, vals, qid))
        if self._resolved_mode is None:
            # auto-detect: 0-based iff a zero index was observed
            self._resolved_mode = 0 if (block_min == 0 or block_min is None) else 1
        shift = self._resolved_mode
        for label, idxs, vals, qid in rows:
            if shift:
                # uint64 arrays: reject zero BEFORE subtracting (no
                # negative sentinel exists in unsigned space)
                if len(idxs) and int(idxs.min()) == 0:
                    raise DMLCError(
                        "libsvm: index 0 found with indexing_mode=1")
                idxs = idxs - np.uint64(shift)
            container.push(label, idxs.astype(self.index_dtype), vals, qid=qid)


@PARSER_REGISTRY.register("libsvm", description="label idx:val sparse text")
def _make_libsvm(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeLibSVMParser", LibSVMParser, kwargs)
