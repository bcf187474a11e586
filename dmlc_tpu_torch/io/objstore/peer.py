"""Peer hydration tier: gang peers as a ranged-GET backend AHEAD of
the wire.

Copy of ``dmlc_tpu/io/objstore/peer.py`` with its imports rewritten to
``dmlc_tpu_torch``; ownership, the fetch, its validation and the
breaker are the reference's, so a port rank and a reference rank read
each other's ``/pages``. Outside a gang every rank hydrates ``obj://``
pages over its own wire, so an N-rank gang re-fetches the same bytes N
times. This module is the fix's client half — each rank's
:class:`~dmlc_tpu_torch.obs.serve.StatusServer` serves its
fingerprint-fresh committed page-store entries at ``GET
/pages/<entry>``, and
:class:`~dmlc_tpu_torch.io.objstore.fs.ObjectSeekStream` consults the
gang through a :class:`PeerTier` before falling back to the object
store:

- **ownership**: hydration blocks group into contiguous runs of
  ``coalesce`` blocks (the span-coalescing unit, so wire fetches stay
  coalesced), and group ``g`` is OWNED by rank ``g % world``. The
  owner fetches its groups from the wire exactly as before; every
  other rank asks the owner's ``/pages`` endpoint first — so a cold
  gang epoch moves ~1/N of the single-rank wire bytes, each byte
  GET'd once and peer-served N-1 times;
- **the seam**: every peer fetch runs under ``resilience.guarded()``
  at the NEW ``io.objstore.peer`` site — an owner that has not
  hydrated the block yet answers 404, which retries under the site's
  policy (the non-owner paces itself behind the owner) and then
  degrades to the wire. Chaos (``ioerror``/``truncate`` FaultPlans at
  ``io.objstore.peer``) rides the same path: degrade to the wire,
  never corruption, never a hang;
- **validation**: the peer's response carries the entry's stamped
  fingerprint and codec tag; the client decodes the codec frame,
  compares the fingerprint against its OWN ``[uri, size, mtime_ns]``
  expectation, and length-checks the block — a peer serving a
  STALE-fingerprint page is rejected (an IOError inside the seam) and
  the block is refetched from the wire;
- **breaker**: ``breaker_failures`` consecutive degraded fetches from
  one peer snooze it for ``breaker_snooze_s`` — a dead rank costs a
  bounded number of probes, after which its groups fetch as full
  coalesced wire spans again;
- **telemetry**: ``objstore.peer.get`` / ``objstore.peer.bytes`` /
  ``objstore.peer.miss`` (rendered ``dmlc_objstore_peer_*_total``)
  make the dedup auditable next to the serving side's
  ``objstore.peer.served`` / ``objstore.peer.served_bytes``.

Configuration is the gang's existing live-telemetry env contract —
``DMLC_TPU_SERVE_PORTS`` (the gang list, one port per rank in task-id
order) and ``DMLC_TPU_SERVE_PORT`` (this rank's own port), both set by
``launch_local(serve_ports=...)`` — so a gang that serves /metrics is
already a peer data plane. :func:`configure` overrides for tests and
embeddings; :func:`tier` returns the process tier (None when the
process is not in a gang).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional
from urllib.parse import quote
from urllib.request import Request, urlopen

from dmlc_tpu_torch.obs import rpc as _rpc
from dmlc_tpu_torch.resilience import inject as _inject
from dmlc_tpu_torch.resilience.policy import guarded

__all__ = ["PeerTier", "tier", "configure", "FINGERPRINT_HEADER",
           "CODEC_HEADER"]

# response headers the /pages endpoint stamps (obs/serve.py writes
# them, this module validates them — keep in lockstep)
FINGERPRINT_HEADER = "X-Dmlc-Fingerprint"
CODEC_HEADER = "X-Dmlc-Codec"

_lock = threading.Lock()
_tier: Optional["PeerTier"] = None
_tier_built = False


def _count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"objstore.peer.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


class PeerTier:
    """The gang's page servers as a read tier. One instance per
    process (see :func:`tier`); thread-safe."""

    def __init__(self, ports: List[int], self_port: Optional[int] = None,
                 host: str = "127.0.0.1", timeout_s: float = 2.0,
                 breaker_failures: int = 3,
                 breaker_snooze_s: float = 5.0):
        self.ports = [int(p) for p in ports]
        self.host = host
        self.timeout_s = float(timeout_s)
        self.self_index: Optional[int] = None
        if self_port is not None and int(self_port) in self.ports:
            self.self_index = self.ports.index(int(self_port))
        self.breaker_failures = int(breaker_failures)
        self.breaker_snooze_s = float(breaker_snooze_s)
        self._lock = threading.Lock()
        self._fails = [0] * len(self.ports)
        self._snoozed_until = [0.0] * len(self.ports)
        self._dead: set = set()

    # -- topology

    @property
    def world(self) -> int:
        return len(self.ports)

    @property
    def remote_count(self) -> int:
        """Peers other than this process — the tier is inert at 0."""
        return self.world - (1 if self.self_index is not None else 0)

    def owner_index(self, group_ix: int) -> Optional[int]:
        """The rank owning hydration group ``group_ix`` (fetches it
        from the wire; everyone else asks its /pages first). None when
        this process IS the owner — including when a DEAD base
        owner's group round-robins onto this process: a rank the
        rendezvous declared dead (:meth:`mark_dead`) costs zero
        probes, its groups reassign deterministically over the
        survivors instead of degrading to full-span wire fetches for
        the rest of the run."""
        if not self.ports:
            return None
        owner = group_ix % self.world
        dead = self._dead
        if owner in dead:
            survivors = [i for i in range(self.world)
                         if i not in dead]
            if not survivors:
                return None
            owner = survivors[group_ix % len(survivors)]
        if owner == self.self_index:
            return None
        return owner

    def mark_dead(self, index: int) -> None:
        """Declare a rank permanently dead (rendezvous roster says
        so, or the supervisor reported it): its page groups reassign
        onto survivors immediately and :meth:`available` answers
        False without burning breaker probes."""
        with self._lock:
            if 0 <= int(index) < self.world:
                self._dead.add(int(index))

    def refresh(self, ports: List[int],
                self_port: Optional[int] = None) -> None:
        """Adopt a new roster IN PLACE (live ObjectSeekStreams hold
        this instance): new port list in rank order, recomputed self
        index, dead set cleared, and the breaker fully reset — the
        3-strike/5s breaker exists for FLAKY peers, and a roster
        change means the flaky/dead topology it learned is stale."""
        with self._lock:
            self.ports = [int(p) for p in ports]
            self.self_index = None
            if self_port is not None and int(self_port) in self.ports:
                self.self_index = self.ports.index(int(self_port))
            self._fails = [0] * len(self.ports)
            self._snoozed_until = [0.0] * len(self.ports)
            self._dead = set()

    # -- breaker

    def available(self, index: int) -> bool:
        """Whether the peer is currently worth asking (breaker not
        open, not declared dead). A snoozed peer's groups fetch as
        full wire spans; a DEAD peer's groups have already been
        reassigned by :meth:`owner_index`."""
        with self._lock:
            if index in self._dead or index >= len(self._fails):
                return False
            if self._fails[index] < self.breaker_failures:
                return True
            return time.monotonic() >= self._snoozed_until[index]

    def _note_failure(self, index: int) -> None:
        with self._lock:
            if index >= len(self._fails):  # refresh() shrank the gang
                return                     # under an in-flight fetch
            self._fails[index] += 1
            if self._fails[index] >= self.breaker_failures:
                self._snoozed_until[index] = (time.monotonic()
                                              + self.breaker_snooze_s)

    def _note_success(self, index: int) -> None:
        with self._lock:
            if index < len(self._fails):
                self._fails[index] = 0

    # -- the fetch

    def fetch_entry(self, index: int, entry: str, fingerprint,
                    expected_len: int) -> Optional[bytes]:
        """One peer-tier block fetch under the ``io.objstore.peer``
        seam. Returns the decoded block bytes, or None — the tier's
        "degrade to the wire" answer (peer missing/behind/unreachable,
        chaos exhausted the site policy, stale fingerprint, torn
        payload). Never raises, never hangs: attempts are bounded by
        the site's retry policy and each carries ``timeout_s``."""
        if index >= len(self.ports) or not self.available(index):
            _count("miss")
            return None
        url = (f"http://{self.host}:{self.ports[index]}"
               f"/pages/{quote(entry, safe='')}")
        peer_label = f"{self.host}:{self.ports[index]}"
        want_fp = [list(e) for e in fingerprint] if fingerprint else None

        def attempt() -> bytes:
            from dmlc_tpu_torch.io.codec import decode_page
            from dmlc_tpu_torch.utils.logging import DMLCError
            with _rpc.client_span("pages", peer_label) as call:
                hdrs = {}
                if call is not None:
                    _rpc.inject(call.ctx, hdrs)
                with urlopen(Request(url, headers=hdrs),
                             timeout=self.timeout_s) as resp:
                    raw = resp.read()
                    got_fp = resp.headers.get(FINGERPRINT_HEADER)
                    if call is not None:
                        call.note_server(
                            resp.headers.get(_rpc.HANDLE_HEADER))
            # chaos: a truncate clause at io.objstore.peer tears the
            # peer payload INSIDE the retried attempt, like the wire
            raw = _inject.corrupt("io.objstore.peer", raw)
            if want_fp is not None:
                try:
                    peer_fp = json.loads(got_fp) if got_fp else None
                except ValueError:
                    peer_fp = None
                if peer_fp != want_fp:
                    # stale or unstamped page: never serve it — the
                    # wire (or a retried fresh peer commit) owns truth
                    raise IOError(
                        f"objstore.peer: stale fingerprint on {entry} "
                        f"(peer {peer_fp!r} != expected {want_fp!r})")
            try:
                data = decode_page(raw)
            except DMLCError as e:
                raise IOError(
                    f"objstore.peer: torn page payload for {entry}: "
                    f"{e}") from e
            if len(data) != expected_len:
                raise IOError(
                    f"objstore.peer: short page {entry}: got "
                    f"{len(data)}/{expected_len} bytes")
            return data

        try:
            with _rpc.operation("io.objstore.peer", peer=peer_label):
                data = guarded("io.objstore.peer", attempt)
        except Exception:  # noqa: BLE001 — ANY failure degrades to wire
            self._note_failure(index)
            _count("miss")
            return None
        self._note_success(index)
        _count("get")
        _count("bytes", len(data))
        return data


def configure(ports: Optional[List[int]] = None,
              self_port: Optional[int] = None,
              host: str = "127.0.0.1",
              timeout_s: float = 2.0,
              breaker_failures: int = 3,
              breaker_snooze_s: float = 5.0,
              enabled: bool = True) -> Optional["PeerTier"]:
    """Install the process peer tier explicitly (tests, embeddings;
    gangs get it free from the env contract). ``enabled=False`` (or
    ``ports=None``) uninstalls — the next :func:`tier` call re-reads
    the env."""
    global _tier, _tier_built
    with _lock:
        if not enabled or ports is None:
            _tier, _tier_built = None, not enabled
            return None
        _tier = PeerTier(ports, self_port=self_port, host=host,
                         timeout_s=timeout_s,
                         breaker_failures=breaker_failures,
                         breaker_snooze_s=breaker_snooze_s)
        _tier_built = True
        return _tier


def reset() -> None:
    """Forget the installed/declined tier (tests); the env is re-read
    on the next :func:`tier` call."""
    global _tier, _tier_built
    with _lock:
        _tier, _tier_built = None, False


def tier() -> Optional["PeerTier"]:
    """The process peer tier: the configured one, else built once from
    the gang env contract (``DMLC_TPU_SERVE_PORTS`` +
    ``DMLC_TPU_SERVE_PORT``); None outside a gang (or when the gang
    has no other member to ask)."""
    global _tier, _tier_built
    with _lock:
        if _tier_built:
            return _tier
        _tier_built = True
        from dmlc_tpu_torch.obs.serve import ENV_SERVE_PORT, ENV_SERVE_PORTS
        raw = os.environ.get(ENV_SERVE_PORTS, "")
        try:
            ports = [int(p) for p in raw.split(",") if p.strip()]
        except ValueError:
            # a mangled gang list must not crash the first obj://
            # read and then silently differ on later ones — warn once,
            # run tierless consistently
            try:
                from dmlc_tpu_torch.obs.log import warn_once
                warn_once("peer-ports-malformed",
                          f"objstore.peer: malformed {ENV_SERVE_PORTS}"
                          f"={raw!r}; peer tier disabled",
                          all_ranks=True)
            except Exception:  # noqa: BLE001
                pass
            return None
        if len(ports) < 2:
            return None
        self_raw = os.environ.get(ENV_SERVE_PORT)
        try:
            self_port = int(self_raw) if self_raw else None
        except ValueError:
            self_port = None
        _tier = PeerTier(ports, self_port=self_port)
        return _tier
