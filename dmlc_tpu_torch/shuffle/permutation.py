"""Seeded epoch-deterministic global permutation with a bounded window.

Copy of ``dmlc_tpu/shuffle/permutation.py``: the same draws from the
same seed, so the port's global order is the reference's, element for
element. The permutation contract (tested in tests/test_torch_shuffle.py
against the reference):

- ``GlobalShuffle(sizes, seed, window_bytes)`` is a **pure function** of
  its arguments: ``order(epoch)`` returns the same permutation of
  ``range(n)`` on every process, at any world size, forever.  Nothing
  about the gang (rank, world, membership epoch) enters the stream.
- Coverage is exact: ``sorted(order(e)) == range(n)`` for every epoch.
- The working set is bounded: records are grouped into contiguous
  **windows** whose summed record bytes stay under ``window_bytes``
  (always at least one record per window, so a single over-budget
  record still flows).  ``order(epoch)`` shuffles the window order and
  the records within each window — a consumer walking the order needs
  only one window's bytes resident at a time, yet every record can
  land anywhere in the epoch because the window ORDER is shuffled too.

Randomness is drawn from :func:`epoch_rng` — a ``numpy RandomState``
seeded with ``seed + epoch``.  RandomState's bit stream is frozen by
numpy's compatibility policy (unlike ``Generator``), which is what
makes "same seed ⇒ same order" a durable cross-version promise. The
port's shuffled splits (``InputSplitShuffle``, the indexed-RecordIO
batch shuffle) draw from it too.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["epoch_rng", "GlobalShuffle", "displacement_stats"]


def epoch_rng(seed: int, epoch: int) -> "np.random.RandomState":
    """The per-epoch random stream: ``RandomState(seed + epoch)``.

    Every seeded shuffle of the port (chunk-level InputSplitShuffle,
    indexed-recordio batch shuffle, the global permutation) draws from
    here so one seed law covers them all.
    """
    return np.random.RandomState((int(seed) + int(epoch)) & 0x7FFFFFFF)


class GlobalShuffle:
    """Window-shuffled global permutation over ``n = len(sizes)`` records.

    ``sizes[k]`` is record ``k``'s byte footprint in the source (used
    only to cut windows; the permutation itself is size-agnostic).
    """

    def __init__(self, sizes: Sequence[int], seed: int = 0,
                 window_bytes: int = 32 << 20):
        self._sizes = np.asarray(sizes, dtype=np.int64)
        if self._sizes.ndim != 1:
            raise ValueError("GlobalShuffle: sizes must be 1-D")
        self.seed = int(seed)
        self.window_bytes = int(window_bytes)
        if self.window_bytes <= 0:
            raise ValueError("GlobalShuffle: window_bytes must be > 0")
        self._windows = self._cut_windows()

    # -- window plan (epoch-invariant)

    def _cut_windows(self) -> List[Tuple[int, int]]:
        """Greedy contiguous [start, end) index spans under the byte
        budget; a record larger than the budget gets a window alone."""
        spans: List[Tuple[int, int]] = []
        start, acc = 0, 0
        for k, sz in enumerate(self._sizes):
            if k > start and acc + int(sz) > self.window_bytes:
                spans.append((start, k))
                start, acc = k, 0
            acc += int(sz)
        if start < len(self._sizes):
            spans.append((start, len(self._sizes)))
        return spans

    @property
    def n(self) -> int:
        return int(len(self._sizes))

    @property
    def num_windows(self) -> int:
        return len(self._windows)

    def windows(self) -> List[Tuple[int, int]]:
        """The [start, end) record-index span of each window, in
        canonical (source) order — window ids index this list."""
        return list(self._windows)

    def window_of(self, record: int) -> int:
        """The window id holding canonical record index ``record``."""
        starts = [s for s, _ in self._windows]
        wid = int(np.searchsorted(starts, record, side="right")) - 1
        s, e = self._windows[wid]
        if not (s <= record < e):
            raise IndexError(f"record {record} outside all windows")
        return wid

    # -- the permutation (pure in (seed, epoch))

    def order(self, epoch: int = 0) -> np.ndarray:
        """The epoch's global order: a permutation of ``range(n)``.

        Window order is shuffled, then each window's records are
        shuffled, with all draws taken from one :func:`epoch_rng`
        stream in a fixed sequence — deterministic by construction.
        """
        rng = epoch_rng(self.seed, epoch)
        worder = rng.permutation(len(self._windows))
        parts = []
        for wid in worder:
            s, e = self._windows[int(wid)]
            parts.append(s + rng.permutation(e - s))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts).astype(np.int64)

    def epoch_window_order(self, epoch: int = 0) -> np.ndarray:
        """Window ids in the order the epoch visits them (prefix of
        the same rng stream as :meth:`order`)."""
        rng = epoch_rng(self.seed, epoch)
        return rng.permutation(len(self._windows))


def displacement_stats(order: Sequence[int]) -> Dict[str, float]:
    """Position-displacement summary of a permutation: for each record
    ``k`` at output position ``p``, displacement is ``|p - k|``.  A
    uniform permutation of n has mean displacement ≈ n/3; the identity
    has 0.  Used by the statistical shuffle-quality tests."""
    arr = np.asarray(order, dtype=np.int64)
    n = len(arr)
    if n == 0:
        return {"n": 0, "mean": 0.0, "max": 0.0, "normalized_mean": 0.0}
    disp = np.abs(np.arange(n, dtype=np.int64) - arr)
    return {
        "n": float(n),
        "mean": float(disp.mean()),
        "max": float(disp.max()),
        # uniform expectation is (n**2 - 1) / (3 * n) ≈ n/3; report the
        # ratio so tests can assert a band around 1.0
        "normalized_mean": float(disp.mean() / ((n * n - 1) / (3.0 * n)))
        if n > 1 else 0.0,
    }
