"""The rendezvous service: a threaded TCP accept loop owning gang
membership (reference: tracker/dmlc_tracker/tracker.py RabitTracker).

Copy of ``dmlc_tpu/rendezvous/service.py`` with its imports rewritten
to ``dmlc_tpu_torch``: the line protocol, the roster and the epoch
rules are the reference's, so a client of either package joins a
service of the other.

The reference tracker's job — workers connect, get a rank, learn the
roster — plus the one thing it never did: a **membership epoch**. The
service keeps, per gang, an ordered roster of alive members; rank IS
the roster index, so ranks are always dense ``0..world-1``. Any
membership change — a join, a clean leave, a supervisor-reported
death, a member silent past the heartbeat grace — bumps the gang's
monotonically increasing epoch, and every member learns the new
roster (and possibly a NEW rank) from its next heartbeat. Shard
ownership is then re-derived deterministically from ``(num_parts,
world, rank)`` by :mod:`dmlc_tpu_torch.rendezvous.elastic` — no state
migrates, only the pure function's inputs change.

Wire protocol: one line-delimited JSON request
per TCP connection, one JSON line back. Ops: ``join``, ``heartbeat``,
``leave``, ``report_death``, ``roster``. The transport is bounded —
requests above ``MAX_LINE`` bytes are rejected, every socket carries
a timeout — and the accept loop reuses the ``obs/serve.py``
ThreadingHTTPServer discipline (daemon handler threads, never block
process exit).

The client transport (:func:`call`) and the free-port probe
(:func:`probe_free_ports`) live here beside the service.

Progress exchange: heartbeats may carry a ``{part: records_consumed}``
map. The service folds each gang's maps together (max per part), and
hands the merged view back — so after a reshard the NEW owner of a
part knows the committed prefix length and resumes mid-epoch
(prefix-skip over the deterministic stream, bytes re-read from the
committed page/peer tier, never the wire) instead of replaying from
record zero. Exactly-once coverage follows from the determinism
contract: a dead member's progress is a PREFIX of the part's stream.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dmlc_tpu_torch.utils.logging import check

__all__ = ["RendezvousService", "call", "probe_free_ports",
           "MAX_LINE", "DEFAULT_GRACE_S"]

# one request line must fit here — join/heartbeat payloads are tiny;
# a progress map over even 10^4 parts stays well under this
MAX_LINE = 1 << 20

# a member silent past this many seconds is declared dead (epoch
# bump); heartbeats ride the rendezvous.* retry seam, so a flaky
# connection costs counted retries well inside the grace window —
# a retry is never a membership flap
DEFAULT_GRACE_S = 3.0


def probe_free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` distinct free ports, chosen while ALL probe sockets are
    held open: closing a probe before the next bind lets
    the OS hand the same port out twice. Only guaranteed distinct from
    each other; as with any probe-then-bind scheme another process can
    still grab one before the real bind."""
    check(n >= 1, "probe_free_ports needs n >= 1")
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def call(host: str, port: int, payload: Dict[str, Any],
         timeout_s: float = 2.0) -> Dict[str, Any]:
    """One client request: connect, send one JSON line, read one JSON
    line back. Raises OSError/ValueError on transport or protocol
    failure — callers wrap it in ``resilience.guarded()`` at a
    ``rendezvous.*`` site so flakes are counted retries."""
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        s.sendall(json.dumps(payload).encode("utf-8") + b"\n")
        buf = bytearray()
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            if len(buf) > MAX_LINE:
                raise IOError("rendezvous: oversized response line")
    if not buf:
        raise IOError("rendezvous: empty response (service gone?)")
    resp = json.loads(buf.decode("utf-8"))
    if not isinstance(resp, dict):
        raise IOError(f"rendezvous: non-object response {resp!r}")
    return resp


class _Member:
    __slots__ = ("name", "host", "port", "attempt", "last_seen",
                 "joined_epoch")

    def __init__(self, name: str, host: str, port: Optional[int],
                 attempt: int, now: float, epoch: int):
        self.name = name
        self.host = host
        self.port = port
        self.attempt = attempt
        self.last_seen = now
        self.joined_epoch = epoch


class _Gang:
    """One gang's membership state (under the service lock)."""

    def __init__(self, grace_s: float):
        self.grace_s = grace_s
        self.epoch = 0
        self.members: Dict[str, _Member] = {}
        self.order: List[str] = []         # roster order; rank = index
        self.progress: Dict[str, int] = {}  # part -> consumed prefix
        self.events: List[Dict[str, Any]] = []  # bounded history


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True          # the obs/serve.py discipline:
    allow_reuse_address = True     # handlers never block process exit
    rendezvous: "RendezvousService"


class _Handler(socketserver.StreamRequestHandler):
    timeout = 10.0

    def handle(self) -> None:  # noqa: D102 — socketserver contract
        from dmlc_tpu_torch.obs import rpc as _rpc
        try:
            line = self.rfile.readline(MAX_LINE + 1)
            if not line or len(line) > MAX_LINE:
                return
            ctx = None
            op = "?"
            t0 = time.perf_counter()
            try:
                req = json.loads(line.decode("utf-8"))
                check(isinstance(req, dict), "request must be an object")
                # an inbound trace context (obs.rpc) rides as an extra
                # field the op dispatch below simply ignores
                ctx = _rpc.extract(req, key=_rpc.TRACE_FIELD)
                op = str(req.get("op", "?"))
                resp = self.server.rendezvous.handle(req)
            except Exception as e:  # noqa: BLE001 — one bad request
                # must not take the accept loop down; the client sees
                # a typed error line instead of a dropped connection
                resp = {"ok": False, "error": repr(e)}
            if ctx is not None:
                dur_s = time.perf_counter() - t0
                _rpc.inject(ctx, resp, key=_rpc.TRACE_FIELD)
                resp[_rpc.HANDLE_FIELD] = round(dur_s * 1e6, 1)
                _rpc.record_server_span(
                    op, _rpc.serialize(ctx), t0, dur_s,
                    args={"peer": str(self.client_address[0]),
                          "handle_us": round(dur_s * 1e6, 1)})
            self.wfile.write(json.dumps(resp).encode("utf-8") + b"\n")
        except OSError:
            pass  # client went away mid-exchange; nothing to answer


class RendezvousService:
    """The gang membership service (module docstring). Threaded accept
    loop on a daemon thread; :meth:`handle` is also callable directly
    for in-process tests (same dispatch, no socket)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_grace_s: float = DEFAULT_GRACE_S,
                 max_events: int = 256):
        self.host = host
        self.heartbeat_grace_s = float(heartbeat_grace_s)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._gangs: Dict[str, _Gang] = {}
        self._srv = _Server((host, port), _Handler)
        self._srv.rendezvous = self
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="dmlc-tpu-rendezvous", daemon=True)
        self._thread.start()

    # -- lifecycle

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "RendezvousService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- dispatch

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        gang = str(req.get("gang") or "default")
        with self._lock:
            g = self._gangs.setdefault(gang,
                                       _Gang(self.heartbeat_grace_s))
            now = time.monotonic()
            if op == "join":
                return self._join(gang, g, req, now)
            if op == "heartbeat":
                return self._heartbeat(gang, g, req, now)
            if op == "leave":
                return self._remove(gang, g, str(req.get("member")),
                                    "leave", now)
            if op == "report_death":
                return self._remove(gang, g, str(req.get("member")),
                                    "death", now)
            if op == "roster":
                self._sweep(gang, g, now)
                return self._view(gang, g)
            return {"ok": False, "error": f"unknown op {op!r}"}

    # -- state transitions (under the lock)

    def _roster(self, g: _Gang) -> List[Dict[str, Any]]:
        return [{"member": n, "rank": i,
                 "host": g.members[n].host, "port": g.members[n].port,
                 "attempt": g.members[n].attempt}
                for i, n in enumerate(g.order)]

    def _view(self, gang: str, g: _Gang,
              member: Optional[str] = None) -> Dict[str, Any]:
        out = {"ok": True, "gang": gang, "epoch": g.epoch,
               "world": len(g.order), "roster": self._roster(g),
               "progress": dict(g.progress)}
        if member is not None and member in g.order:
            out["rank"] = g.order.index(member)
        return out

    def _bump(self, gang: str, g: _Gang, kind: str, member: str,
              old_world: int) -> None:
        g.epoch += 1
        event = {"kind": kind, "member": member, "epoch": g.epoch,
                 "old_world": old_world, "new_world": len(g.order)}
        g.events.append(event)
        del g.events[:-self.max_events]
        self._emit(gang, g, event)

    def _join(self, gang: str, g: _Gang, req: Dict[str, Any],
              now: float) -> Dict[str, Any]:
        self._sweep(gang, g, now)
        member = str(req.get("member"))
        check(bool(member) and member != "None",
              "join needs a member name")
        host = str(req.get("host") or "127.0.0.1")
        port = req.get("port")
        port = int(port) if port is not None else None
        attempt = int(req.get("attempt") or 0)
        old_world = len(g.order)
        m = g.members.get(member)
        if m is not None and member in g.order:
            # a supervisor RESTART at the same coordinates: the slot
            # is still alive on the roster, so membership (and the
            # epoch) does not change — the reference's recover
            # handshake (DMLC_NUM_ATTEMPT bumped, same rank)
            m.host, m.port, m.attempt = host, port, attempt
            m.last_seen = now
            return self._view(gang, g, member)
        g.members[member] = _Member(member, host, port, attempt, now,
                                    g.epoch + 1)
        g.order.append(member)
        self._bump(gang, g, "join", member, old_world)
        return self._view(gang, g, member)

    def _heartbeat(self, gang: str, g: _Gang, req: Dict[str, Any],
                   now: float) -> Dict[str, Any]:
        member = str(req.get("member"))
        m = g.members.get(member)
        if m is None or member not in g.order:
            # declared dead (grace or a supervisor report) — the
            # member must re-join; until then it is not in the gang
            self._sweep(gang, g, now)
            out = self._view(gang, g)
            out["ok"] = False
            out["error"] = f"member {member!r} not in gang (rejoin)"
            return out
        m.last_seen = now
        prog = req.get("progress")
        rejected = False
        if isinstance(prog, dict):
            # epoch-fenced commit: progress is merged ONLY when the
            # sender's view of the membership epoch is current —
            # ownership of a part is unique within one epoch, so a
            # fenced commit can never overlap a post-reshard owner's
            # resume (the exactly-once half of the elastic contract);
            # a stale sender learns the new roster from this very
            # response and re-derives what it owns
            fence = req.get("epoch")
            if fence is not None and int(fence) != g.epoch:
                rejected = True
            else:
                for part, consumed in prog.items():
                    if isinstance(consumed, (int, float)):
                        k = str(part)
                        g.progress[k] = max(g.progress.get(k, 0),
                                            int(consumed))
        self._sweep(gang, g, now)
        out = self._view(gang, g, member)
        if rejected:
            out["progress_rejected"] = True
        return out

    def _remove(self, gang: str, g: _Gang, member: str, kind: str,
                now: float) -> Dict[str, Any]:
        self._sweep(gang, g, now)
        if member in g.order:
            old_world = len(g.order)
            g.order.remove(member)
            self._bump(gang, g, kind, member, old_world)
        return self._view(gang, g)

    def _sweep(self, gang: str, g: _Gang, now: float) -> None:
        """Lazy grace check: any member silent past the gang's grace
        window is declared dead (one epoch bump each — the events
        list says exactly who fell when)."""
        for name in list(g.order):
            if now - g.members[name].last_seen > g.grace_s:
                old_world = len(g.order)
                g.order.remove(name)
                self._bump(gang, g, "grace_death", name, old_world)

    # -- telemetry (launcher-side; members emit their own on epoch
    #    delivery — both sides of the story land on the merged trace)

    def _emit(self, gang: str, g: _Gang,
              event: Dict[str, Any]) -> None:
        try:
            from dmlc_tpu_torch.obs import trace
            from dmlc_tpu_torch.obs.metrics import REGISTRY
            trace.instant(f"gang/member/{event['kind']}", "rendezvous",
                          {"gang": gang, **event})
            REGISTRY.counter(
                f"rendezvous.{event['kind']}".replace("grace_death",
                                                      "death")).inc()
            REGISTRY.gauge("rendezvous.epoch").set(g.epoch)
            REGISTRY.gauge("rendezvous.world").set(len(g.order))
        except Exception:  # noqa: BLE001 — telemetry must not break
            pass           # membership bookkeeping
