"""Cross-rank sample exchange: the permutation's read plane.

Copy of ``dmlc_tpu/shuffle/exchange.py`` with its imports rewritten to
``dmlc_tpu_torch``: the same position ownership, window pages, tiers and
counters, so a port rank and a reference rank deliver the same records
and name the same pages.

A :class:`ShuffleReader` walks one gang rank's slice of the epoch's
global order.  Ownership of a *position* is modular — position ``p``
belongs to rank ``p % world`` — so same-seed streams merge back into
the identical global order at ANY world size (round-robin by rank),
which is the determinism contract's cross-world half.

Bytes move in **window pages**: the raw global byte span of one
:class:`~dmlc_tpu_torch.shuffle.permutation.GlobalShuffle` window, committed
to the page store under ``shuffle.win.<digest>.<wid>`` with the source
fingerprint.  Window entry names carry no seed and no epoch — the
page is canonical source bytes — so pages hydrate once and stay warm
across epochs, restarts, and reshards.  Materialization tries three
tiers in order and accounts each on ``/metrics``:

- **local** — a fresh committed page in this rank's store
  (``shuffle.bytes.local``);
- **peer** — another rank already hydrated it: fetched through the
  existing peer ``/pages`` tier with exact-length + fingerprint
  validation, then committed locally so this rank can serve it onward
  (``shuffle.bytes.peer``);
- **wire** — read from the source through the io seam and committed
  (``shuffle.bytes.wire``).

Window ownership for the peer probe rides
:meth:`PeerTier.owner_index` — the same modular owner map the
objstore block tier uses, refreshed by rendezvous membership epochs —
so an N→M world change reroutes both position ownership (via
:func:`attach_rendezvous` → :meth:`ShuffleReader.reshard`) and page
ownership with no new protocol.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np

from dmlc_tpu_torch.io.codec import decode_page, encode_page
from dmlc_tpu_torch.io.pagestore import PageStore
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
from dmlc_tpu_torch.obs.metrics import REGISTRY
from dmlc_tpu_torch.shuffle.index import RecordIndex
from dmlc_tpu_torch.shuffle.permutation import GlobalShuffle
from dmlc_tpu_torch.utils.logging import check, check_lt

__all__ = ["ShuffleReader", "install_view", "view", "attach_rendezvous",
           "DEFAULT_WINDOW_BYTES"]

DEFAULT_WINDOW_BYTES = 32 << 20

_TIERS = ("local", "peer", "wire")


def _counter(name: str):
    return REGISTRY.counter(name)


class ShuffleReader:
    """One rank's cursor over the seeded global order.

    ``next_record_span()`` yields raw source spans (framed records for
    the RecordIO family, terminator-free line bytes for text) in this
    rank's sub-sequence of the global order; ``None`` ends the epoch.
    ``start_position`` resumes mid-epoch: the reader delivers exactly
    the positions ``p >= start_position`` with ``p % world == rank``,
    which is the restart-identity contract.
    """

    def __init__(self, index: RecordIndex, seed: int = 0,
                 window_bytes: int = DEFAULT_WINDOW_BYTES, *,
                 rank: int = 0, world: int = 1, epoch: int = 0,
                 start_position: int = 0,
                 store: Optional[PageStore] = None):
        check_lt(rank, world, "shuffle: rank must be < world")
        self._index = index
        self._shuffle = GlobalShuffle(index.sizes, seed,
                                      window_bytes=window_bytes)
        self._store = store or PageStore.default()
        self._rank, self._world = int(rank), int(world)
        self._epoch = int(epoch)
        self._order = self._shuffle.order(self._epoch)
        self._lock = threading.Lock()
        self._pos = int(start_position)  # next global position cursor
        self._delivered = 0
        # current window page (the bounded working set: exactly one)
        self._win_id: Optional[int] = None
        self._win_bytes: bytes = b""
        self._win_base = 0
        self._win_tier = "local"
        # per-reader tallies (the /shuffle view; global counters on
        # REGISTRY aggregate across readers for /metrics)
        self.records = {t: 0 for t in _TIERS}
        self.bytes = {t: 0 for t in _TIERS}

    # -- identity

    @property
    def seed(self) -> int:
        return self._shuffle.seed

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world(self) -> int:
        return self._world

    @property
    def position(self) -> int:
        """Next global position this reader will consider — the
        coverage watermark to checkpoint for mid-epoch resume."""
        return self._pos

    @property
    def n(self) -> int:
        return self._index.n

    @property
    def window_bytes(self) -> int:
        return self._shuffle.window_bytes

    @property
    def num_windows(self) -> int:
        return self._shuffle.num_windows

    @property
    def delivered(self) -> int:
        """Records this rank delivered in the current epoch."""
        return self._delivered

    # -- the cursor

    def next_record_span(self) -> Optional[bytes]:
        with self._lock:
            n = len(self._order)
            if self._world <= 0:
                return None
            p = self._pos + ((self._rank - self._pos) % self._world)
            if p >= n:
                self._pos = n
                return None
            rec = int(self._order[p])
            span = self._record_bytes_locked(rec)
            self._pos = p + 1
            self._delivered += 1
            self.records[self._win_tier] += 1
            _counter(f"shuffle.records.{self._win_tier}").inc()
            return span

    def next_epoch(self) -> int:
        """Advance to the next epoch's order and rewind the cursor.
        Window pages stay warm (entry names are epoch-invariant)."""
        with self._lock:
            self._epoch += 1
            self._order = self._shuffle.order(self._epoch)
            self._pos = 0
            self._delivered = 0
            return self._epoch

    def reshard(self, rank: int, world: int,
                position: Optional[int] = None) -> None:
        """Re-derive position ownership after a membership change.
        The cursor is kept (or pinned to an agreed ``position``
        watermark) so a gang resuming from the same watermark under a
        new world still tiles the remaining order exactly once."""
        check_lt(rank, world, "shuffle: rank must be < world")
        with self._lock:
            self._rank, self._world = int(rank), int(world)
            if position is not None:
                self._pos = int(position)

    # -- window materialization

    def _record_bytes_locked(self, rec: int) -> bytes:
        wid = self._shuffle.window_of(rec)
        if wid != self._win_id:
            self._materialize_locked(wid)
        off = int(self._index.offsets[rec]) - self._win_base
        size = int(self._index.sizes[rec])
        check(0 <= off and off + size <= len(self._win_bytes),
              f"shuffle: record {rec} outside window {wid} page")
        return self._win_bytes[off:off + size]

    def _window_span(self, wid: int):
        s, e = self._shuffle.windows()[wid]
        a = int(self._index.offsets[s])
        b = int(self._index.offsets[e - 1]) + int(self._index.sizes[e - 1])
        return a, b

    def _entry_name(self, wid: int) -> str:
        return f"shuffle.win.{self._index.digest}.{wid}"

    def _materialize_locked(self, wid: int) -> None:
        a, b = self._window_span(wid)
        name = self._entry_name(wid)
        fp = self._index.fingerprint
        data: Optional[bytes] = None
        tier_used = "wire"
        if self._store.lookup(name, fp) is not None:
            rs = self._store.open_read(name)
            if rs is not None:
                with rs:
                    data = decode_page(rs.read_all())
                tier_used = "local"
                if len(data) != b - a:
                    data = None  # torn page: fall through and rebuild
        if data is None:
            data = self._fetch_peer(wid, name, fp, b - a)
            if data is not None:
                tier_used = "peer"
                _counter("shuffle.windows.fetched").inc()
        if data is None:
            data = self._read_source(a, b)
            tier_used = "wire"
            _counter("shuffle.windows.built").inc()
        if tier_used != "local":
            # commit so restarts hit local and peers can pull from us
            self._store.commit_bytes(
                name, encode_page(data, 0), fingerprint=fp,
                meta={"codec": "raw", "kind": "shuffle.window",
                      "window": wid, "uri": self._index.uri})
        self._win_id = wid
        self._win_bytes = data
        self._win_base = a
        self._win_tier = tier_used
        self.bytes[tier_used] += len(data)
        _counter(f"shuffle.bytes.{tier_used}").inc(len(data))

    def _fetch_peer(self, wid: int, name: str, fp,
                    expected_len: int) -> Optional[bytes]:
        from dmlc_tpu_torch.io.objstore import peer as peer_mod
        tier = peer_mod.tier()
        if tier is None:
            return None
        owner = tier.owner_index(wid)
        if owner is None:  # self-owned: hydrate from source
            return None
        return tier.fetch_entry(owner, name, fp,
                                expected_len=expected_len)

    def _read_source(self, a: int, b: int) -> bytes:
        parts = []
        for path, off, length in self._index.segments(a, b):
            with create_seek_stream_for_read(path) as s:
                s.seek(off)
                parts.append(s.read_exact(length))
        return b"".join(parts)

    # -- the /shuffle view

    def view_dict(self) -> Dict[str, Any]:
        with self._lock:
            n = self._index.n
            return {
                "seed": self._shuffle.seed,
                "epoch": self._epoch,
                "window_bytes": self._shuffle.window_bytes,
                "windows": self._shuffle.num_windows,
                "records": n,
                "total_bytes": self._index.total_bytes,
                "uri": self._index.uri,
                "split_type": self._index.split_type,
                "rank": self._rank,
                "world": self._world,
                "position": self._pos,
                "delivered": self._delivered,
                "coverage": round(self._pos / n, 6) if n else 1.0,
                "records_by_tier": dict(self.records),
                "bytes_by_tier": dict(self.bytes),
            }


# -- module view registry (what GET /shuffle serves)

_VIEW_REF: Optional["weakref.ReferenceType[ShuffleReader]"] = None


def install_view(reader: ShuffleReader) -> None:
    """Make ``reader`` the process's ``/shuffle`` surface (held
    weakly — a collected reader drops the endpoint back to 404)."""
    global _VIEW_REF
    _VIEW_REF = weakref.ref(reader)


def view() -> Optional[Dict[str, Any]]:
    """The installed reader's row dict, or None when no global
    shuffle is active in this process."""
    r = _VIEW_REF() if _VIEW_REF is not None else None
    return r.view_dict() if r is not None else None


def attach_rendezvous(reader: ShuffleReader,
                      client) -> Callable[[Dict[str, Any]], None]:
    """Wire membership epochs to permutation ownership: every roster
    change reshards ``reader`` to the delivered (rank, world).  The
    registered callback is returned (tests poke it directly)."""

    def _on_change(v: Dict[str, Any]) -> None:
        rank, world = v.get("rank"), v.get("world")
        if rank is None or not world:
            return
        try:
            reader.reshard(int(rank), int(world))
        except Exception:
            pass  # a torn view must never kill the heartbeat thread

    client.on_change(_on_change)
    return _on_change
