"""The per-epoch random stream of every seeded shuffle.

Counterpart of ``dmlc_tpu/shuffle/permutation.py``, holding only
:func:`epoch_rng`: the seed law that makes the port's shuffled order
the reference's. Randomness is a ``numpy RandomState`` seeded with
``seed + epoch``; RandomState's bit stream is frozen by numpy's
compatibility policy (unlike ``Generator``), which is what makes "same
seed ⇒ same order" a durable cross-version promise. ``GlobalShuffle``
waits for the port of the shuffle plane.
"""

from __future__ import annotations

import numpy as np

__all__ = ["epoch_rng"]


def epoch_rng(seed: int, epoch: int) -> "np.random.RandomState":
    """The per-epoch random stream: ``RandomState(seed + epoch)``.

    Every seeded shuffle (the chunk-level InputSplitShuffle now; the
    global permutation when it is ported) draws from here so one seed
    law covers them all.
    """
    return np.random.RandomState((int(seed) + int(epoch)) & 0x7FFFFFFF)
