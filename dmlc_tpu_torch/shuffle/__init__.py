"""Gang-wide sample-level shuffle: a seeded global permutation served
through the index plane, page store, and peer ``/pages`` tier.

Counterpart of ``dmlc_tpu/shuffle``, every module a copy with its
imports rewritten; SURVEY §2.2 (IndexedRecordIOSplitter's index plane)
and §4 (unittest_inputsplit's exact-coverage invariant).

The subsystem in one breath: :mod:`~dmlc_tpu_torch.shuffle.index` turns any
supported format into an offset/size record table (committed once as
a fingerprint-stamped page-store sidecar);
:mod:`~dmlc_tpu_torch.shuffle.permutation` turns a seed + epoch into a
window-shuffled global order — a pure function, identical on every
rank at any world size; :mod:`~dmlc_tpu_torch.shuffle.exchange` walks one
rank's slice of that order, materializing window pages local → peer
``/pages`` → wire with byte accounting on ``/metrics`` and a
``/shuffle`` row surface; :mod:`~dmlc_tpu_torch.shuffle.split` wraps it all
as an InputSplit so ``Pipeline.from_uri(...).shuffle(global_seed=…)``
lowers straight onto it.

This package is also the ONE home for seeded-permutation construction
in io/ + data/: shuffling code draws epoch randomness from
:func:`epoch_rng`.
"""

from dmlc_tpu_torch.shuffle.exchange import (
    DEFAULT_WINDOW_BYTES, ShuffleReader, attach_rendezvous,
    install_view, view,
)
from dmlc_tpu_torch.shuffle.index import (
    RecordIndex, SPLIT_TYPES, build_record_index,
)
from dmlc_tpu_torch.shuffle.permutation import (
    GlobalShuffle, displacement_stats, epoch_rng,
)
from dmlc_tpu_torch.shuffle.split import GlobalShuffleSplit

__all__ = [
    "DEFAULT_WINDOW_BYTES", "ShuffleReader", "attach_rendezvous",
    "install_view", "view", "RecordIndex", "SPLIT_TYPES",
    "build_record_index", "GlobalShuffle", "displacement_stats",
    "epoch_rng", "GlobalShuffleSplit",
]
