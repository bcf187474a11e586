"""Parquet/Arrow columnar parser → RowBlock.

A copy of ``dmlc_tpu/data/parquet_parser.py`` (the reference has no
Parquet parser; this is the registry-plugin seam the survey
prescribes). ``format="parquet"`` is the pyarrow golden; pyarrow is
imported when this module is, guarded: where it is absent the scheme
stays registered and raises a DMLCError naming it, and
``format="parquet_native"`` with ``engine="native"`` decodes pages in
the native engine, which never touches pyarrow.

Row-group granularity maps to InputSplit semantics: row groups are
distributed across (part_index, num_parts) as CONTIGUOUS row-group
ranges by the standard InputSplit byte rule applied at group
granularity — nstep = ceil(total_bytes/num_parts), and a group belongs
to part j iff its global byte start lands in [j*nstep, (j+1)*nstep).
This preserves the coverage/no-overlap invariant AND makes the parts
concatenate in file order, so the native engine's row-group-aligned
sharded parse (``shards=N``, ABI 8) is byte-identical to the 1-parser
stream — the SAME rule (``_partition_groups``).

Parquet rides the same Stream/VFS seam as every text parser: a local
path (and ``cuda://``, through its backing file) goes to pyarrow
directly, by its mmap fast path; any other registered scheme
(``obj://``, ``s3://``, one added with ``FileSystem.register_scheme``)
reaches pyarrow as a buffered ``Stream.as_file`` over its SeekStream.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from dmlc_tpu_torch.data.parser import PARSER_REGISTRY, Parser
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.utils.logging import DMLCError, check
from dmlc_tpu_torch.utils.parameter import Parameter, field

__all__ = ["ParquetParser", "ParquetParserParam"]

try:
    import pyarrow  # noqa: F401
    import pyarrow.parquet as _pq
    _HAVE_ARROW = True
except Exception:  # pragma: no cover - environment-dependent
    _pq = None
    _HAVE_ARROW = False


class ParquetParserParam(Parameter):
    label_column = field("", desc="column name holding the label; '' = none")
    weight_column = field("", desc="column name holding row weights")
    sparse = field(False, desc="drop zero cells (sparse CSR output) "
                               "instead of dense row-major fill")


class ParquetParser(Parser):
    # which decode path this parser IS — the obs/analyze decode
    # evidence (stage extra "decode_path") names it so a config-5-
    # shaped DECODE-bound epoch says pyarrow-golden vs native-page
    decode_path = "pyarrow"

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 index_dtype=np.uint32, prefetch: bool = True,
                 **kwargs: Any):
        if not _HAVE_ARROW:
            raise DMLCError(
                "parquet parser requires pyarrow, which is not installed "
                "in this environment")
        self.param = ParquetParserParam()
        self.param.update_allow_unknown(kwargs)
        self.index_dtype = np.dtype(index_dtype)
        # same URI expansion as InputSplit (';'-joined and/or
        # directories of part files — the Hadoop-style dataset layout;
        # reference: InputSplitBase::Init's ListDirectory expansion)
        from dmlc_tpu_torch.io.input_split import list_split_files
        entries = list_split_files(uri)
        check(len(entries) >= 1, "parquet: no input path")
        self._sources = [self._open_source(p, size) for p, size in entries]
        self._files = [_pq.ParquetFile(s) for s in self._sources]
        self._groups = self._partition_groups(self._files, entries,
                                              part_index, num_parts)
        self._pos = 0
        self._block: Optional[RowBlock] = None
        # bytes_read reports COMPRESSED on-disk bytes (what GB/s is
        # measured against), not inflated in-RAM table bytes
        self._bytes = 0
        self._prefetch = None
        # prefetch starts LAZILY on the first next(): consumers call
        # before_first() first, which would discard (and re-read) any
        # eagerly prefetched row groups
        self._want_prefetch = prefetch and len(self._groups) > 1

    @staticmethod
    def _partition_groups(files, entries, part_index: int,
                          num_parts: int):
        """Contiguous row-group ranges by the InputSplit byte rule at
        group granularity — THE shared partition contract with the
        native engine's ParquetShardReader (engine.cc), so sharded and
        part-split parses agree across engines: group g belongs to
        part j iff its global byte start (file base + the group's
        first page offset) lands in [j*nstep, (j+1)*nstep) with
        nstep = ceil(total/num_parts). Empty groups are skipped on
        both sides."""
        groups = []
        base = 0
        for fi, (f, (_p, size)) in enumerate(zip(files, entries)):
            md = f.metadata
            for gi in range(md.num_row_groups):
                rg = md.row_group(gi)
                if rg.num_rows == 0:
                    continue
                span_lo = None
                for c in range(rg.num_columns):
                    col = rg.column(c)
                    dpo = col.dictionary_page_offset
                    start = (dpo if dpo and 0 < dpo < col.data_page_offset
                             else col.data_page_offset)
                    span_lo = start if span_lo is None \
                        else min(span_lo, start)
                if span_lo is None:
                    span_lo = 4  # no columns: the native sentinel
                groups.append((fi, gi, base + span_lo))
            base += size
        nstep = -(-base // num_parts) if base else 1
        lo, hi = nstep * part_index, nstep * (part_index + 1)
        return [(fi, gi) for fi, gi, g in groups if lo <= g < hi]

    @staticmethod
    def _open_source(path: str, size: int):
        """Local path, or a buffered seekable file-like over the VFS
        stream for registered schemes. Non-seekable streams fail with
        the adapter's UnsupportedOperation naming the fix (pyarrow
        needs random access to read the footer)."""
        import io as _io
        import os
        from dmlc_tpu_torch.io.cuda_fs import local_path
        from dmlc_tpu_torch.io.stream import SeekStream, create_stream
        lp = local_path(path)
        if os.path.isfile(lp):
            return lp
        # the adapter is handed off to pyarrow and nothing else holds
        # the stream: transfer ownership so closing the file closes it
        stream = create_stream(path, "r")
        raw = stream.as_file(size=size if isinstance(stream, SeekStream)
                             else None, own_stream=True)
        return _io.BufferedReader(raw, buffer_size=1 << 20)

    # -- producer hooks (run on the prefetch thread)

    def _rewind(self) -> None:
        self._pos = 0

    def _produce(self) -> Optional[RowBlock]:
        if self._pos >= len(self._groups):
            return None
        fi, gi = self._groups[self._pos]
        self._pos += 1
        meta = self._files[fi].metadata.row_group(gi)
        # decode relies on pyarrow's default use_threads=True: Arrow's
        # C++ pool decompresses columns in parallel with the GIL
        # released, so the decode wall (~0.7 GB/s compressed for snappy
        # on one core — the measured single-core ceiling of this config)
        # scales with cores on real hosts
        table = self._files[fi].read_row_group(gi)
        self._bytes += sum(meta.column(c).total_compressed_size
                           for c in range(meta.num_columns))
        return self._table_to_block(table)

    def before_first(self) -> None:
        if self._prefetch is not None:
            self._prefetch.before_first()
        else:
            self._rewind()
        self._block = None

    def next(self) -> bool:
        if self._prefetch is None and self._want_prefetch:
            from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
            self._prefetch = ThreadedIter(max_capacity=2,
                                          name="parquet.prefetch")
            self._prefetch.init(self._produce, self._rewind)
        self._block = (self._prefetch.next() if self._prefetch is not None
                       else self._produce())
        return self._block is not None

    def destroy(self) -> None:
        if self._prefetch is not None:
            self._prefetch.destroy()
            self._prefetch = None
        # close VFS-backed sources deterministically (a registered
        # scheme's stream may hold an fd or remote connection; GC is
        # too late for many-part many-epoch jobs)
        for s in getattr(self, "_sources", []):
            if hasattr(s, "close"):
                try:
                    s.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
        self._sources = []
        self._files = []

    @staticmethod
    def _zero_copy_columns(table, names) -> Optional[List[np.ndarray]]:
        """Arrow columns → contiguous float numpy views without a
        conversion copy (combine_chunks still concatenates when a column
        arrives multi-chunk — single-chunk row-group reads don't), or
        None when any column needs real conversion (nulls, non-float
        dtypes, non-contiguous) — callers then take the general path."""
        cols: List[np.ndarray] = []
        for n in names:
            col = table.column(n)
            if col.null_count:
                return None
            if hasattr(col, "combine_chunks"):
                col = col.combine_chunks()
            try:
                arr = col.to_numpy(zero_copy_only=True)
            except Exception:  # noqa: BLE001 - pyarrow raises ArrowInvalid
                return None
            if (arr.dtype not in (np.float32, np.float64)
                    or not arr.flags["C_CONTIGUOUS"]):
                return None
            cols.append(arr)
        return cols

    def _dense_values(self, table, names) -> np.ndarray:
        """Row-major [nrow*ncol] f32 cell values. Hot path: zero-copy
        Arrow buffers → native cache-blocked interleave (ctypes releases
        the GIL, so this overlaps with the prefetch thread's next
        read_row_group). Fallback: numpy stack."""
        nrow = table.num_rows
        if not names:
            return np.zeros(0, np.float32)
        from dmlc_tpu_torch.native import native_available
        if native_available():
            cols = self._zero_copy_columns(table, names)
            if cols is not None:
                from dmlc_tpu_torch.native.bindings import columns_interleave
                return columns_interleave(cols)
        cols = [table.column(n).to_numpy(zero_copy_only=False)
                .astype(np.float32, copy=False) for n in names]
        return np.stack(cols, axis=1).reshape(-1)

    def _dense_skeleton(self, nrow: int, ncol: int):
        """offset/index for a dense block are fully determined by the
        shape — cache them across row groups (all groups but the last
        share a shape). Consecutive blocks then SHARE these arrays by
        reference; that is safe because RowBlock arrays are immutable by
        contract and the container only ever concatenates them into new
        arrays — never mutates in place."""
        key = (nrow, ncol)
        if getattr(self, "_skel_key", None) != key:
            self._skel_key = key
            self._skel = (np.arange(nrow + 1, dtype=np.int64) * ncol,
                          np.tile(np.arange(ncol, dtype=self.index_dtype),
                                  nrow))
        return self._skel

    def _table_to_block(self, table) -> RowBlock:
        lcol, wcol = self.param.label_column, self.param.weight_column
        names = [n for n in table.column_names if n not in (lcol, wcol)]
        nrow = table.num_rows
        ncol = len(names)
        label = (table.column(lcol).to_numpy(zero_copy_only=False)
                 .astype(np.float32, copy=False) if lcol
                 else np.zeros(nrow, np.float32))
        weight = (table.column(wcol).to_numpy(zero_copy_only=False)
                  .astype(np.float32, copy=False) if wcol else None)
        if self.param.sparse:
            # sparse column path: keep only non-zero cells, vectorized
            cols = [table.column(n).to_numpy(zero_copy_only=False)
                    .astype(np.float32, copy=False) for n in names]
            dense = np.stack(cols, axis=1) if ncol else np.zeros(
                (nrow, 0), np.float32)
            mask = dense != 0
            offset = np.zeros(nrow + 1, np.int64)
            np.cumsum(mask.sum(axis=1), out=offset[1:])
            rows_idx, cols_idx = np.nonzero(mask)
            del rows_idx  # CSR order == row-major nonzero order
            return RowBlock(offset=offset, label=label,
                            index=cols_idx.astype(self.index_dtype),
                            value=dense[mask], weight=weight)
        value = self._dense_values(table, names)
        offset, index = self._dense_skeleton(nrow, ncol)
        return RowBlock(offset=offset, label=label, index=index,
                        value=value, weight=weight,
                        max_index=ncol - 1 if ncol else None)

    def value(self) -> RowBlock:
        check(self._block is not None, "value() before successful next()")
        return self._block

    def bytes_read(self) -> int:
        """COMPRESSED on-disk bytes consumed so far — the GB/s
        denominator, not the decompressed table bytes (progress measured
        against uncompressed sizes undershoots)."""
        return self._bytes


@PARSER_REGISTRY.register("parquet", description="parquet/arrow columnar")
def _make_parquet(**kwargs):
    kwargs.pop("engine", None)
    return ParquetParser(**kwargs)


def _parquet_golden(**kwargs):
    """The pyarrow golden as a ``native_or`` fallback target: strip
    the engine-only construction kwargs the text-parser fallbacks
    absorb via TextParserBase."""
    for k in ("nthreads", "chunk_size", "split_type", "prefetch_depth",
              "split_factory", "engine"):
        kwargs.pop(k, None)
    return ParquetParser(**kwargs)


@PARSER_REGISTRY.register(
    "parquet_native",
    description="parquet columnar — native page decoder (ABI 8: V1 "
                "PLAIN/RLE-dictionary pages, i32/i64/f32/f64, "
                "def-level nulls, UNCOMPRESSED/GZIP), pyarrow golden "
                "fallback")
def _make_parquet_native(**kwargs):
    from dmlc_tpu_torch.data.parser import native_or
    return native_or("NativeParquetParser", _parquet_golden, kwargs)
