"""dmlc_tpu_torch.shuffle — the seed law of the shuffled splits.

Counterpart of ``dmlc_tpu/shuffle``; only :func:`epoch_rng` is ported
(``shuffle/permutation.py``). The gang-wide sample-level shuffle
(``GlobalShuffle``, the record index, the window exchange) waits for the
port of the shuffle plane.
"""

from dmlc_tpu_torch.shuffle.permutation import epoch_rng

__all__ = ["epoch_rng"]
