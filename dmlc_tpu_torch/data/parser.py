"""Parser framework: format dispatch + chunked text parsing base.

Reference: src/data.cc + src/data/parser.h (ParserFactoryReg — entries
"libsvm"/"csv"/"libfm"; ParserImpl<I>), src/data/text_parser.h
(TextParserBase<I>: pull InputSplit chunks, parallel ParseBlock, stitch,
BytesRead) and include/dmlc/data.h (Parser<I>::Create, DataIter<T>).

A Parser IS a DataIter over RowBlocks (one block per input chunk). Format
implementations subclass TextParserBase and provide ``parse_block(records,
container)``. The native C++ engine (dmlc_tpu_torch.native) slots in at
Parser.create via engine="native"; engine="auto" prefers native when it
builds, and both engines share the frozen parse semantics (see
data/strtonum.py), so blocks are byte-identical. ``import dmlc_tpu_torch``
registers the reference's formats: ``libsvm``, ``csv``, ``libfm``,
``recordio_dense``, ``recordio_image``, ``parquet`` and ``parquet_native``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check
from dmlc_tpu_torch.utils.registry import Registry

__all__ = ["DataIter", "Parser", "TextParserBase", "PARSER_REGISTRY",
           "native_or"]

PARSER_REGISTRY = Registry.get("ParserFactory")


def native_or(native_cls_name: str, python_cls, kwargs):
    """Shared engine dispatch for text-format factories.

    engine="auto": prefer the native engine (built at first use), fall
    back to the Python golden when it cannot be built or cannot serve
    the URI. engine="native": require it, re-raising any failure.
    engine="python": golden only.

    ``shards=N`` (N > 1, whole-input reads only) splits one input
    across N independent native parsers on byte ranges with
    deterministic in-order block reassembly
    (bindings.NativeShardedTextParser), byte-identical to the 1-parser
    stream. The python golden (and a part of a wider split) runs
    unsharded: shards is a pure performance knob, never a semantics
    change.
    """
    engine = kwargs.get("engine", "auto")
    shards = int(kwargs.pop("shards", 1) or 1)
    whole = (kwargs.get("part_index", 0) == 0
             and kwargs.get("num_parts", 1) == 1)
    if shards > 1 and not whole:
        # an outer part/num_parts split already subdivides the input;
        # nesting the shard split would apply the byte-range alignment
        # rule twice with different steps
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            "parser-shards-nested",
            f"shards={shards} ignored under a part/num_parts split "
            "(sharded parse serves whole inputs only); running the "
            "part unsharded", min_interval_s=60.0)
        shards = 1
    # python-only construction kwargs (pipeline seam): the native engine
    # runs its own reader/queue pipeline, so a custom split forces the
    # python golden and the chunk-prefetch depth simply does not apply
    has_custom_split = kwargs.get("split_factory") is not None
    if engine in ("auto", "native") and not has_custom_split:
        from dmlc_tpu_torch.native import native_available
        if native_available():
            try:
                from dmlc_tpu_torch.native import bindings
                nat_kwargs = {k: v for k, v in kwargs.items()
                              if k not in ("prefetch_depth",
                                           "split_factory")}
                cls = getattr(bindings, native_cls_name)
                if shards > 1:
                    return bindings.NativeShardedTextParser(
                        **nat_kwargs, shards=shards, format=cls._format)
                return cls(**nat_kwargs)
            except (DMLCError, FileNotFoundError, OSError):
                if engine == "native":
                    raise
        elif engine == "native":
            from dmlc_tpu_torch.native import get_lib
            get_lib()  # raises with the build failure
    elif engine == "native" and has_custom_split:
        raise DMLCError("native engine does not accept split_factory; "
                        "use engine='python' for injected splits")
    if shards > 1:
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            "parser-shards-ignored",
            f"shards={shards} ignored: the sharded single-input parse "
            "needs the native engine over the whole input "
            "(part 0 of 1); running unsharded", min_interval_s=60.0)
    return python_cls(**kwargs)


class DataIter:
    """Pull iterator protocol (reference: DataIter<T> in data.h)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self):
        raise NotImplementedError

    def __iter__(self) -> Iterator:
        self.before_first()
        while self.next():
            yield self.value()


class Parser(DataIter):
    """DataIter over parsed RowBlocks (reference: Parser<IndexType>)."""

    @staticmethod
    def create(uri: str, part_index: int = 0, num_parts: int = 1,
               format: Optional[str] = None, index_dtype=np.uint32,
               engine: str = "auto", prefetch: bool = True,
               **kwargs: Any) -> "Parser":
        """Reference: Parser<I>::Create (src/data.cc).

        format defaults from the URI's ``?format=`` arg, else "libsvm".
        kwargs go to the format's parameter struct (e.g. label_column).
        engine: "auto" | "python" | "native".
        """
        spec = URISpec(uri)
        args: Dict[str, Any] = dict(spec.args)
        args.update(kwargs)
        fmt = format or args.pop("format", None) or "libsvm"
        args.pop("engine", None)
        entry = PARSER_REGISTRY.lookup(fmt)
        return entry.body(uri=uri, part_index=part_index,
                          num_parts=num_parts, index_dtype=index_dtype,
                          engine=engine, prefetch=prefetch, **args)

    def bytes_read(self) -> int:
        """Bytes consumed so far (reference: Parser::BytesRead)."""
        raise NotImplementedError


class TextParserBase(Parser):
    """Chunked text parsing engine (reference: src/data/text_parser.h).

    Pulls whole-record chunks from InputSplit and parses chunk → RowBlock.
    With ``prefetch=True`` the chunk reads run on a background thread
    (reference: ThreadedInputSplit wrapping + the parser's own thread pool;
    in Python the parse itself is serial — the C++ engine parallelizes).
    """

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 index_dtype=np.uint32, split_type: str = "text",
                 chunk_size: int = 8 << 20, prefetch: bool = True,
                 prefetch_depth: int = 4, split_factory=None,
                 engine: str = "auto", **_ignored: Any):
        self.uri = uri
        self.index_dtype = np.dtype(index_dtype)
        # split_factory (dmlc_tpu_torch.pipeline): inject a custom
        # InputSplit (e.g. InputSplitShuffle) in place of the default
        # byte-range split — python engine only (native builds its own
        # reader)
        self._split = (split_factory() if split_factory is not None
                       else InputSplit.create(uri, part_index, num_parts,
                                              split_type,
                                              chunk_size=chunk_size))
        self._block: Optional[RowBlock] = None
        self._prefetch: Optional[ThreadedIter] = None
        if prefetch and getattr(self._split, "rewindable", True):
            self._prefetch = ThreadedIter(max_capacity=prefetch_depth,
                                          name="parse.chunk_prefetch")
            self._prefetch.init(self._split.next_chunk,
                                self._split.before_first)

    # -- DataIter

    def before_first(self) -> None:
        if self._prefetch is not None:
            self._prefetch.before_first()
        else:
            self._split.before_first()
        self._block = None

    def next(self) -> bool:
        chunk = (self._prefetch.next() if self._prefetch is not None
                 else self._split.next_chunk())
        while chunk is not None:
            container = RowBlockContainer(self.index_dtype)
            self.parse_block(list(self._split.extract_records(chunk)),
                             container)
            if container.size > 0:
                self._block = container.get_block()
                return True
            chunk = (self._prefetch.next() if self._prefetch is not None
                     else self._split.next_chunk())
        self._block = None
        return False

    def value(self) -> RowBlock:
        check(self._block is not None, "value() before successful next()")
        return self._block

    def bytes_read(self) -> int:
        return self._split.bytes_read

    def destroy(self) -> None:
        if self._prefetch is not None:
            self._prefetch.destroy()
            self._prefetch = None

    # -- format hook

    def parse_block(self, records: List[bytes],
                    container: RowBlockContainer) -> None:
        raise NotImplementedError
