"""Gang rendezvous + elastic membership (reference: dmlc-core's
``tracker/dmlc_tracker/tracker.py``, gone elastic).

Copy of ``dmlc_tpu/rendezvous/__init__.py`` with its imports rewritten
to ``dmlc_tpu_torch``; an epoch bump does what the reference's does,
the membership record on the control ledger (``obs.control``) included.
Unlike the
reference's, a client's first view (its join) also sets the peer tier's
topology from the roster, so a member that joins a gang of two or more
agrees with the members already in it on who owns each hydration group;
and each call (join, heartbeat, commit) and the delivery of its answer
are one ordered step, so the background heartbeat's answer cannot land
after a commit's newer one and step the member's epoch back (the
reference's client delivers whichever answer lands last).

Three planes in one package:

- :mod:`dmlc_tpu_torch.rendezvous.service` — the launcher-side TCP service:
  rank assignment, the roster, the monotonically increasing
  membership epoch, heartbeat-grace death detection, merged progress;
- :mod:`dmlc_tpu_torch.rendezvous.elastic` — the pure resharding math:
  ``assign_parts(num_parts, world, rank)`` and the mid-epoch
  ``reshard_plan`` built from exchanged progress;
- this module — the worker-side :class:`RendezvousClient`: join at
  startup, heartbeat on a daemon thread (each beat rides the
  ``rendezvous.heartbeat`` retry seam — a flaky connection is a
  counted retry, not a membership flap), and on every epoch bump
  refresh the process's reactive surfaces: the
  :class:`~dmlc_tpu_torch.io.objstore.peer.PeerTier` topology (breaker
  reset, dead ranks dropped), a ``gang/member/reshard`` instant on
  the trace, ``rendezvous.*`` metrics, the RPC edge table's
  departed rows, and any registered ``on_change`` callbacks.

Env contract (set by ``launch_local(rendezvous=True)``):

- ``DMLC_TPU_RNDV_URI`` / ``DMLC_TPU_RNDV_PORT`` — where the service
  listens (the reference's ``DMLC_TRACKER_URI/PORT`` shape);
- ``DMLC_TPU_RNDV_GANG`` — gang name (default ``"local"``);
- ``DMLC_TPU_RNDV_HB_S`` — heartbeat period (default 0.5s).

Workers opt in with one :func:`install_if_env` line, like every other
plane (serve_if_env, trace_if_env, ...). Member identity is the
supervisor's member name (``worker-<task_id>``), so supervisor death
reports and client joins speak about the same slot.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from dmlc_tpu_torch.rendezvous import elastic, service
from dmlc_tpu_torch.rendezvous.service import RendezvousService
from dmlc_tpu_torch.utils.logging import check

__all__ = ["RendezvousClient", "RendezvousService", "elastic",
           "service", "active", "install", "uninstall",
           "install_if_env", "ENV_RNDV_URI", "ENV_RNDV_PORT",
           "ENV_RNDV_GANG", "ENV_RNDV_HB_S", "MEMBERSHIP_SCHEMA"]

ENV_RNDV_URI = "DMLC_TPU_RNDV_URI"
ENV_RNDV_PORT = "DMLC_TPU_RNDV_PORT"
ENV_RNDV_GANG = "DMLC_TPU_RNDV_GANG"
ENV_RNDV_HB_S = "DMLC_TPU_RNDV_HB_S"

# bump when view()'s top-level shape changes incompatibly
MEMBERSHIP_SCHEMA = 1

_lock = threading.Lock()
_client: Optional["RendezvousClient"] = None


class RendezvousClient:
    """One process's membership in one gang (module docstring)."""

    def __init__(self, host: str, port: int, gang: str = "default",
                 member: str = "worker-0",
                 self_host: str = "127.0.0.1",
                 serve_port: Optional[int] = None,
                 attempt: int = 0, heartbeat_s: float = 0.5,
                 timeout_s: float = 2.0):
        check(bool(member), "RendezvousClient needs a member name")
        self.host = host
        self.port = int(port)
        self.gang = gang
        self.member = member
        self.self_host = self_host
        self.serve_port = (int(serve_port) if serve_port is not None
                           else None)
        self.attempt = int(attempt)
        self.heartbeat_s = float(heartbeat_s)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        # one call and the delivery of its answer are one step: the
        # answer delivered last is the one the service gave last, so a
        # heartbeat answered late cannot step the view back past a
        # commit's. Re-entrant: a refused beat or commit rejoins inside
        # its own step.
        self._order = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._callbacks: List[Callable[[Dict[str, Any]], None]] = []
        self._pending_progress: Dict[str, int] = {}
        self.epoch: Optional[int] = None
        self.world: int = 0
        self.rank: Optional[int] = None
        self.roster: List[Dict[str, Any]] = []
        self.progress: Dict[str, int] = {}

    # -- transport (each op rides the rendezvous.* retry seam)

    def _call(self, payload: Dict[str, Any],
              site: str) -> Dict[str, Any]:
        from dmlc_tpu_torch.obs import rpc as _rpc
        from dmlc_tpu_torch.resilience.policy import guarded
        verb = site.rsplit(".", 1)[-1]
        peer = f"{self.host}:{self.port}"

        def attempt() -> Dict[str, Any]:
            # the trace context rides the line-JSON payload itself (a
            # "trace" field the service echoes with its handle time) —
            # one client span per attempt under the shared trace_id
            with _rpc.client_span(verb, peer) as call:
                if call is not None:
                    _rpc.inject(call.ctx, payload,
                                key=_rpc.TRACE_FIELD)
                resp = service.call(self.host, self.port, payload,
                                    timeout_s=self.timeout_s)
                if call is not None:
                    call.note_server(resp.get(_rpc.HANDLE_FIELD))
                return resp

        with _rpc.operation(site, peer=peer):
            return guarded(site, attempt)

    # -- membership ops

    def join(self) -> int:
        """Join (or rejoin) the gang; returns the assigned rank."""
        with self._order:
            resp = self._call({"op": "join", "gang": self.gang,
                               "member": self.member,
                               "host": self.self_host,
                               "port": self.serve_port,
                               "attempt": self.attempt},
                              "rendezvous.join")
            check(bool(resp.get("ok")),
                  f"rendezvous join refused: {resp.get('error')!r}")
            self._deliver(resp)
            return int(self.rank if self.rank is not None else -1)

    def heartbeat(self,
                  progress: Optional[Dict[Any, int]] = None) -> bool:
        """One heartbeat: reports liveness (+ optional ``{part:
        records_consumed}`` progress), learns the current epoch and
        roster. Returns False — without flapping anything — when the
        beat could not be delivered inside the retry seam; True when
        the service answered (including "rejoin", which is handled
        here by rejoining)."""
        payload: Dict[str, Any] = {"op": "heartbeat",
                                   "gang": self.gang,
                                   "member": self.member}
        with self._lock:
            merged = dict(self._pending_progress)
            self._pending_progress.clear()
        if progress:
            for part, n in progress.items():
                k = str(part)
                merged[k] = max(merged.get(k, 0), int(n))
        if merged:
            payload["progress"] = merged
        with self._order:
            try:
                resp = self._call(payload, "rendezvous.heartbeat")
            except Exception:  # noqa: BLE001 — a beat lost past the
                # seam is NOT a flap from our side; the grace window
                # decides
                with self._lock:
                    for k, n in merged.items():
                        self._pending_progress[k] = max(
                            self._pending_progress.get(k, 0), n)
                self._count("heartbeat.lost")
                return False
            if not resp.get("ok"):
                # the service declared us dead (grace or a supervisor
                # report) while we are demonstrably alive: rejoin — the
                # epoch bumps and we get a (possibly new) rank back
                try:
                    self.join()
                    return True
                except Exception:  # noqa: BLE001
                    return False
            self._deliver(resp)
            return True

    def commit(self, part: Any, records: int,
               epoch: Optional[int] = None) -> bool:
        """Epoch-fenced progress commit: one beat carrying ``{part:
        records}`` plus the membership epoch the ownership decision
        was DERIVED under — pass the ``epoch`` from the same
        :meth:`view` snapshot that produced the part and the resume
        offset (default: the current view, only safe when no
        background heartbeat runs). The service merges the progress
        ONLY when that epoch is current — within one epoch a part
        has exactly one owner, so a fenced commit can never overlap
        the range a post-reshard owner resumes from. Returns True
        iff the commit landed; False means the batch must NOT be
        counted as consumed (the roster moved — re-derive ownership
        from the view this very call just delivered, then retry)."""
        with self._order:
            fence = self.epoch if epoch is None else int(epoch)
            check(fence is not None, "commit() before join()")
            payload = {"op": "heartbeat", "gang": self.gang,
                       "member": self.member, "epoch": fence,
                       "progress": {str(part): int(records)}}
            try:
                resp = self._call(payload, "rendezvous.commit")
            except Exception:  # noqa: BLE001 — undeliverable ==
                self._count("heartbeat.lost")  # uncommitted
                return False
            if not resp.get("ok"):
                try:
                    self.join()
                except Exception:  # noqa: BLE001
                    pass
                return False
            self._deliver(resp)
            return not resp.get("progress_rejected", False)

    def report_progress(self, part: Any, records: int) -> None:
        """Queue a part's consumed-prefix length for the next beat."""
        with self._lock:
            k = str(part)
            self._pending_progress[k] = max(
                self._pending_progress.get(k, 0), int(records))

    def leave(self) -> None:
        try:
            self._call({"op": "leave", "gang": self.gang,
                        "member": self.member}, "rendezvous.leave")
        except Exception:  # noqa: BLE001 — leaving is best-effort;
            pass           # the grace window reaps us anyway
        self.stop()

    # -- the heartbeat thread

    def start(self) -> "RendezvousClient":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._beat_loop,
                name=f"dmlc-tpu-rndv-{self.member}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _beat_loop(self) -> None:
        # the wait holds no lock: heartbeat() takes the step's lock for
        # its call and delivery only
        while not self._stop.wait(self.heartbeat_s):
            self.heartbeat()

    # -- epoch delivery

    def on_change(self,
                  fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register a roster-change callback (called with the new
        :meth:`view` after every epoch bump — reshard hooks live
        here)."""
        self._callbacks.append(fn)

    def parts(self, num_parts: int) -> List[int]:
        """This member's current shard ownership (pure function of
        the delivered epoch's (world, rank))."""
        check(self.rank is not None and self.world >= 1,
              "parts() before join()")
        return elastic.assign_parts(num_parts, self.world, self.rank)

    def view(self) -> Dict[str, Any]:
        """The membership view served on ``/gang`` and rendered by
        ``obsctl gang``."""
        with self._lock:
            return {"schema": MEMBERSHIP_SCHEMA, "gang": self.gang,
                    "member": self.member, "rank": self.rank,
                    "epoch": self.epoch, "world": self.world,
                    "roster": list(self.roster),
                    "progress": dict(self.progress)}

    def _deliver(self, resp: Dict[str, Any]) -> None:
        with self._lock:
            old_epoch, old_world = self.epoch, self.world
            self.epoch = int(resp.get("epoch") or 0)
            self.world = int(resp.get("world") or 0)
            self.roster = list(resp.get("roster") or [])
            self.progress = dict(resp.get("progress") or {})
            rank = resp.get("rank")
            if rank is None:
                rank = next((e["rank"] for e in self.roster
                             if e.get("member") == self.member), None)
            self.rank = int(rank) if rank is not None else None
        if old_epoch is None:
            # the first view this member holds: its peer tier follows
            # the roster from now on, as every member's does after an
            # epoch bump. (The reference's client leaves a member that
            # joins a gang of two or more on the env's port order until
            # the next bump, while the members already in it reorder by
            # rank at theirs: the two then disagree on who owns a
            # hydration group and each waits out the other's 404s.)
            self._refresh_peer_tier()
        elif self.epoch != old_epoch:
            self._on_membership_change(old_epoch, old_world)

    def _on_membership_change(self, old_epoch: int,
                              old_world: int) -> None:
        self._refresh_peer_tier()
        self._count("reshard")
        try:
            from dmlc_tpu_torch.obs import trace
            trace.instant("gang/member/reshard", "rendezvous",
                          {"gang": self.gang, "member": self.member,
                           "epoch": self.epoch, "rank": self.rank,
                           "old_world": old_world,
                           "new_world": self.world})
        except Exception:  # noqa: BLE001
            pass
        try:
            from dmlc_tpu_torch.obs import control as _control
            _control.membership_record(
                "reshard", gang=self.gang, epoch=self.epoch,
                old_world=old_world, new_world=self.world,
                member=self.member, rank=self.rank)
        except Exception:  # noqa: BLE001
            pass
        view = self.view()
        try:
            # retire RPC edge rows for departed members — a dead
            # rank's latency attribution must not haunt /rpc forever
            from dmlc_tpu_torch.obs import rpc as _rpc_mod
            _rpc_mod.membership_changed(view)
        except Exception:  # noqa: BLE001
            pass
        for fn in list(self._callbacks):
            try:
                fn(view)
            except Exception:  # noqa: BLE001 — one consumer's hook
                pass           # must not starve the others

    def _refresh_peer_tier(self) -> None:
        """Roster -> PeerTier topology: dead ranks are gone from the
        port list entirely (their page groups reassign onto survivors
        by the same modular contract) and the dead-peer breaker state
        resets — the satellite fix for the breaker that never
        re-closed on a permanently dead peer."""
        try:
            from dmlc_tpu_torch.io.objstore import peer as _peer
            with self._lock:
                entries = sorted(self.roster,
                                 key=lambda e: e.get("rank", 0))
                ports = [e.get("port") for e in entries]
            if len(ports) < 2 or any(p is None for p in ports):
                return
            ports = [int(p) for p in ports]
            t = _peer.tier()
            if t is not None:
                # in place: live ObjectSeekStreams hold the instance
                t.refresh(ports, self_port=self.serve_port)
            else:
                _peer.configure(ports=ports,
                                self_port=self.serve_port)
        except Exception:  # noqa: BLE001 — topology refresh is an
            pass           # optimization; the wire still works

    def _count(self, which: str) -> None:
        try:
            from dmlc_tpu_torch.obs.metrics import REGISTRY
            REGISTRY.counter(f"rendezvous.{which}").inc()
            if self.epoch is not None:
                REGISTRY.gauge("rendezvous.epoch").set(self.epoch)
                REGISTRY.gauge("rendezvous.world").set(self.world)
        except Exception:  # noqa: BLE001
            pass


# ------------------------------------------------------------ module plane

def active() -> Optional[RendezvousClient]:
    return _client


def install(client: Optional[RendezvousClient] = None,
            **kwargs: Any) -> RendezvousClient:
    """Install the process rendezvous client (idempotent: a second
    call returns the running one). With kwargs, builds a client,
    joins, and starts heartbeats."""
    global _client
    with _lock:
        if _client is not None:
            return _client
        if client is None:
            client = RendezvousClient(**kwargs)
            client.join()
            client.start()
        _client = client
        return _client


def uninstall() -> Optional[RendezvousClient]:
    """Stop heartbeats and forget the process client (tests)."""
    global _client
    with _lock:
        cli, _client = _client, None
    if cli is not None:
        cli.stop()
    return cli


def install_if_env() -> Optional[RendezvousClient]:
    """Gang-worker hook (one line, like serve_if_env): join the
    rendezvous and start heartbeats when ``DMLC_TPU_RNDV_URI`` /
    ``DMLC_TPU_RNDV_PORT`` are set — ``launch_local(rendezvous=True)``
    sets them per worker — else no-op."""
    host = os.environ.get(ENV_RNDV_URI)
    port = os.environ.get(ENV_RNDV_PORT)
    if not host or not port:
        return None
    task_id = os.environ.get("DMLC_TPU_TASK_ID",
                             os.environ.get("DMLC_TASK_ID", "0"))
    attempt = os.environ.get("DMLC_TPU_ATTEMPT",
                             os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    serve_port = os.environ.get("DMLC_TPU_SERVE_PORT")
    return install(
        host=host, port=int(port),
        gang=os.environ.get(ENV_RNDV_GANG, "local"),
        member=f"worker-{int(task_id)}",
        serve_port=int(serve_port) if serve_port else None,
        attempt=int(attempt or 0),
        heartbeat_s=float(os.environ.get(ENV_RNDV_HB_S, "0.5")))
