"""Declarative stage specs for the dataset-pipeline graph.

Counterpart of ``dmlc_tpu/pipeline/stages.py``, copied whole: the port
keeps the reference's stage grammar, so a chain that the reference
refuses is refused here with the same message. A
:class:`~dmlc_tpu_torch.pipeline.Pipeline` is an immutable tuple of
``StageSpec`` values; chaining (``.parse().batch(...)``) appends specs
without executing anything. ``Pipeline.build()`` validates the chain
against ``ALLOWED_AFTER`` (the legal stage grammar) and lowers each spec
onto the port's machinery (see ``dmlc_tpu_torch.pipeline.graph``).

Stage catalog (the reference's docs/pipeline.md has the narrative
version):

  source    — from_uri(uri, part_index, num_parts): the sharded byte span;
              from_stream(uri, ...): an EOF-less windowed growing file
  parse     — text bytes → CSR RowBlock stream (Parser.create)
  cache     — parse once, replay later epochs; the tier is picked by
              memory_budget_bytes: raw blocks in RAM when they fit,
              a DiskRowIter binary page cache when they don't
              (an explicit path forces pages)
  batch     — re-chunk the block stream to fixed row counts, or (pad=True)
              assemble fixed-shape padded batches
  map       — user fn over each item
  prefetch  — bounded background queue (ThreadedIter); depth "auto" is
              an autotuner knob
  to_device — async host→device copies with a bounded in-flight
              window; window "auto" is an autotuner knob
  shard     — part-granular multi-process ingest (ShardedRowBlockIter):
              [L, ...] batches on the mesh's device
  shuffle   — shuffled read order, python engine: chunk-level
              (InputSplitShuffle, reference: input_split_shuffle.h), or
              with global_seed the gang-wide sample-level permutation
              (GlobalShuffleSplit)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["StageSpec", "ALLOWED_AFTER", "validate_chain"]


class StageSpec:
    """One immutable node of the declarative graph."""

    __slots__ = ("kind", "params")

    def __init__(self, kind: str, **params: Any):
        self.kind = kind
        self.params: Dict[str, Any] = params

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self.params.items()
                          if v is not None)
        return f"{self.kind}({inner})"


# stage grammar: which stage kinds may follow which. "item" marks the
# transforming stages legal over any materialized item stream.
_ITEM_STAGES = ("batch", "map", "prefetch", "to_device")

ALLOWED_AFTER: Dict[str, Tuple[str, ...]] = {
    "source": ("shuffle", "parse", "shard"),
    "shuffle": ("parse",),
    "parse": ("cache", "shard") + _ITEM_STAGES,
    "cache": _ITEM_STAGES,
    "batch": _ITEM_STAGES,
    "map": _ITEM_STAGES,
    "prefetch": _ITEM_STAGES,
    "shard": ("map", "prefetch"),
    "to_device": (),  # terminal
}


def validate_chain(stages: Tuple[StageSpec, ...]) -> None:
    """Raise DMLCError on an illegal chain, naming the violation."""
    check(len(stages) > 0, "empty pipeline")
    check(stages[0].kind == "source",
          f"pipeline must start at from_uri(), got {stages[0].kind!r}")
    for prev, cur in zip(stages, stages[1:]):
        allowed = ALLOWED_AFTER[prev.kind]
        if cur.kind not in allowed:
            raise DMLCError(
                f"pipeline: {cur.kind!r} cannot follow {prev.kind!r} "
                f"(allowed after {prev.kind}: {sorted(allowed)})")
    kinds = [s.kind for s in stages]
    for unique in ("parse", "shard", "cache", "to_device"):
        if kinds.count(unique) > 1:
            raise DMLCError(f"pipeline: {unique!r} may appear only once")
    if "shard" in kinds:
        # shard lowers source+parse into ShardedRowBlockIter itself:
        # nothing may transform the block stream before it
        pre = kinds[:kinds.index("shard")]
        for k in pre:
            if k not in ("source", "parse"):
                raise DMLCError(
                    f"pipeline: {k!r} before shard is not lowerable — "
                    "shard compiles source+parse directly into "
                    "ShardedRowBlockIter")
    if stages[0].params.get("stream") is not None:
        # a streaming source has no frozen byte range: nothing that
        # needs one (re-read shuffle order, replay caches, byte-range
        # shards) can sit on it
        for k in ("shuffle", "cache", "shard"):
            if k in kinds:
                raise DMLCError(
                    f"pipeline: {k!r} is not lowerable over a "
                    "streaming source (from_stream) — a growing file "
                    "has no frozen byte range to "
                    + ("reshuffle" if k == "shuffle" else
                       "replay" if k == "cache" else "shard"))
    if "shuffle" in kinds:
        i = kinds.index("shuffle")
        if i + 1 < len(kinds) and kinds[i + 1] == "parse":
            eng = stages[i + 1].params.get("engine", "auto")
            if eng == "native":
                raise DMLCError(
                    "pipeline: shuffle requires the python parse engine "
                    "(the native reader owns its own split); drop "
                    "engine='native'")
