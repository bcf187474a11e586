"""Cross-process trace-context plane: Dapper-shaped causality for
every RPC edge the port owns, in pure stdlib.

Copy of ``dmlc_tpu/obs/rpc.py`` with its imports rewritten to
``dmlc_tpu_torch``; the context format, the header names and the edge
table are the reference's, so a trace either package writes reads the
same. The port's edges are the object-store wire calls
(``io/objstore/fs.py``, ``io/objstore/emulator.py``): every ranged GET,
HEAD, LIST and PUT runs as one :func:`client_span` inside one
:func:`operation`.

- :class:`TraceContext` ``(trace_id, span_id)`` — minted at the client
  call site, serialized through ONE wire format (``trace_id-span_id``)
  into the ``X-Dmlc-Trace`` HTTP header (or the ``trace`` field of a
  line-JSON message). :func:`inject`/:func:`extract` are the single
  helper pair every edge uses;
- **client spans** (cat ``rpc.client``) and **server spans** (cat
  ``rpc.server``) carrying the peer identity and the context string.
  ``obs.export`` turns each matched pair into Perfetto flow events
  (``ph "s"``/``"f"`` bound by the context id);
- **operations vs attempts**: :func:`operation` pins one ``trace_id``
  for a whole retried operation (the ``resilience.guarded`` scope)
  while every attempt inside opens its own :func:`client_span` with a
  fresh ``span_id`` — a FaultPlan-injected retry shows as N countable
  client spans sharing a trace_id;
- a bounded per-process **RPC edge table**: per ``(peer, verb)``
  count/errors and p50/p99 of client-observed latency, server-reported
  handle time (``X-Dmlc-Handle-Us`` echo), and their difference — the
  network+queue residual that tells "slow server" from "slow wire". It
  is the ``rpc`` collector of the metrics registry (:func:`view` gives
  the whole table); the reference's ``GET /rpc`` endpoint waits for the
  port's status server (``obs/serve.py``).

Off cost: every entry point reads the ONE trace-recorder global and
branches; with tracing off no context is minted, no header injected,
no table row touched.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

from dmlc_tpu_torch.obs import trace as _trace
from dmlc_tpu_torch.obs.metrics import REGISTRY

__all__ = [
    "TraceContext", "new_context", "serialize", "parse",
    "inject", "extract",
    "TRACE_HEADER", "HANDLE_HEADER", "TRACE_FIELD", "HANDLE_FIELD",
    "operation", "client_span", "active_call", "emulated_server",
    "record_server_span", "note_injected_failure",
    "RpcEdgeTable", "EDGES", "view", "membership_changed",
    "RPC_SCHEMA",
]

# bump when the /rpc (and rpc.json) shape changes incompatibly
RPC_SCHEMA = 1

# the ONE spelling of the wire carriers. Every other module imports
# these names; scripts/lint.py rejects the literals anywhere else.
TRACE_HEADER = "X-Dmlc-Trace"
HANDLE_HEADER = "X-Dmlc-Handle-Us"
TRACE_FIELD = "trace"
HANDLE_FIELD = "handle_us"


class TraceContext(NamedTuple):
    """One hop's identity: ``trace_id`` names the logical operation
    (stable across retries), ``span_id`` names this attempt."""
    trace_id: str
    span_id: str


def new_context(trace_id: Optional[str] = None) -> TraceContext:
    """Mint a context: fresh 16-hex trace_id (unless continuing an
    operation) and fresh 8-hex span_id."""
    return TraceContext(trace_id or os.urandom(8).hex(),
                        os.urandom(4).hex())


def serialize(ctx: TraceContext) -> str:
    """The single wire form: ``<trace_id>-<span_id>``."""
    return f"{ctx.trace_id}-{ctx.span_id}"


def parse(value: Any) -> Optional[TraceContext]:
    """Tolerant inverse of :func:`serialize` — anything malformed
    (wrong type, no dash, empty halves) is None, never an exception:
    a garbled header must not take down a handler."""
    if not isinstance(value, str):
        return None
    trace_id, dash, span_id = value.partition("-")
    if not dash or not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id)


def inject(ctx: TraceContext, carrier: Dict[str, Any],
           key: str = TRACE_HEADER) -> None:
    """Write ``ctx`` into a carrier mapping — HTTP header dict by
    default, ``key=TRACE_FIELD`` for line-JSON payloads."""
    carrier[key] = serialize(ctx)


def extract(carrier: Any, key: str = TRACE_HEADER
            ) -> Optional[TraceContext]:
    """Read a context back out of a carrier (``dict``, ``Message`` —
    anything with ``.get``); None when absent or malformed."""
    try:
        return parse(carrier.get(key))
    except AttributeError:
        return None


# ------------------------------------------------------------ thread state
# One thread-local pair: the operation's pinned trace_id (shared by
# every attempt under one guarded() call) and the innermost active
# client call (how transports find the context to inject and where a
# server's handle-time echo lands).

_tls = threading.local()


class _ClientCall:
    """The live client-side half of one RPC attempt."""

    __slots__ = ("ctx", "verb", "peer", "server_us")

    def __init__(self, ctx: TraceContext, verb: str, peer: str):
        self.ctx = ctx
        self.verb = verb
        self.peer = peer
        self.server_us: Optional[float] = None

    def note_server(self, handle_us: Any) -> None:
        """Record the server-reported handle time (header/field echo);
        junk values are dropped, not raised."""
        try:
            self.server_us = float(handle_us)
        except (TypeError, ValueError):
            pass


def active_call() -> Optional[_ClientCall]:
    """The innermost open client span on this thread (transports call
    this to inject the header), or None."""
    return getattr(_tls, "call", None)


@contextlib.contextmanager
def operation(site: str, peer: Optional[str] = None
              ) -> Iterator[Optional[str]]:
    """Pin one trace_id for a whole (possibly retried) client
    operation. Wrap this OUTSIDE ``resilience.guarded`` so each
    attempt's :func:`client_span` inherits the id — retries become
    countable same-trace spans. ``peer`` (when known) labels attempts
    that die before reaching the wire (see
    :func:`note_injected_failure`). No-op (yields None) when tracing
    is off."""
    if _trace.active() is None:
        yield None
        return
    prev = getattr(_tls, "trace_id", None)
    prev_peer = getattr(_tls, "op_peer", None)
    _tls.trace_id = trace_id = os.urandom(8).hex()
    _tls.op_peer = peer
    try:
        yield trace_id
    finally:
        _tls.trace_id = prev
        _tls.op_peer = prev_peer


def note_injected_failure(site: str) -> None:
    """Resilience hook: ``policy.guarded`` calls this when an armed
    FaultPlan fires BEFORE the attempt body runs — the attempt never
    reaches its transport, so no :func:`client_span` opened. Record
    the aborted attempt as a zero-length failed client span on the
    pinned trace (plus an edge-table error), so an injected retry is
    still one countable span per attempt. No-op when tracing is off
    or no :func:`operation` is pinned."""
    rec = _trace.active()
    if rec is None:
        return
    trace_id = getattr(_tls, "trace_id", None)
    if trace_id is None:
        return
    verb = site.rsplit(".", 1)[-1]
    peer = getattr(_tls, "op_peer", None) or "injected"
    ctx = new_context(trace_id)
    rec.complete(f"rpc/{verb}", time.perf_counter(), 0.0,
                 cat=_trace.CAT_RPC_CLIENT,
                 args={TRACE_FIELD: serialize(ctx), "peer": peer,
                       "verb": verb, "ok": False, "injected": True})
    EDGES.observe(peer, verb, 0.0, None, ok=False)


@contextlib.contextmanager
def client_span(verb: str, peer: str) -> Iterator[Optional[_ClientCall]]:
    """Record the block as one client-side RPC attempt: a span (cat
    ``rpc.client``) carrying the serialized context plus an edge-table
    observation. Yields the :class:`_ClientCall` (transports read its
    ``.ctx``; the server echo lands in ``.server_us``) or None with
    tracing off — in which case nothing is minted or injected."""
    rec = _trace.active()
    if rec is None:
        yield None
        return
    ctx = new_context(getattr(_tls, "trace_id", None))
    call = _ClientCall(ctx, verb, peer)
    prev = getattr(_tls, "call", None)
    _tls.call = call
    t0 = time.perf_counter()
    ok = True
    try:
        yield call
    except BaseException:
        ok = False
        raise
    finally:
        dur_s = time.perf_counter() - t0
        _tls.call = prev
        args: Dict[str, Any] = {TRACE_FIELD: serialize(ctx),
                                "peer": peer, "verb": verb, "ok": ok}
        if call.server_us is not None:
            args["server_us"] = round(call.server_us, 1)
        rec.complete(f"rpc/{verb}", t0, dur_s,
                     cat=_trace.CAT_RPC_CLIENT, args=args)
        EDGES.observe(peer, verb, dur_s * 1e6, call.server_us, ok)


@contextlib.contextmanager
def emulated_server(verb: str, peer: str = "emulator") -> Iterator[None]:
    """The objstore emulator's server half: models the same context a
    real endpoint would echo, so a single-process bench traces exactly
    like a wire run. Records a server span bound to the in-process
    client context and reports the handle time back to it."""
    call = active_call()
    if call is None:  # tracing off, or no client span: stay silent
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur_s = time.perf_counter() - t0
        call.note_server(dur_s * 1e6)
        record_server_span(verb, serialize(call.ctx), t0, dur_s,
                           args={"peer": peer,
                                 "handle_us": round(dur_s * 1e6, 1)})


def record_server_span(verb: str, trace: str, t0_s: float, dur_s: float,
                       args: Optional[Dict[str, Any]] = None) -> None:
    """Record one server-side handler span (cat ``rpc.server``) bound
    to an inbound context string. No-op when tracing is off."""
    rec = _trace.active()
    if rec is None:
        return
    a: Dict[str, Any] = {TRACE_FIELD: trace, "verb": verb}
    if args:
        a.update(args)
    rec.complete(f"rpc/{verb}", t0_s, dur_s,
                 cat=_trace.CAT_RPC_SERVER, args=a)


# ------------------------------------------------------------- edge table

def _pctl(sorted_us: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    return sorted_us[min(len(sorted_us) - 1,
                         int(q * len(sorted_us)))]


class _Edge:
    __slots__ = ("count", "errors", "client_total_us", "server_total_us",
                 "residual_total_us", "attributed", "client_us",
                 "server_us", "residual_us")

    def __init__(self, samples: int):
        self.count = 0
        self.errors = 0
        self.client_total_us = 0.0
        self.server_total_us = 0.0
        self.residual_total_us = 0.0
        self.attributed = 0  # observations with a server-handle echo
        self.client_us: deque = deque(maxlen=samples)
        self.server_us: deque = deque(maxlen=samples)
        self.residual_us: deque = deque(maxlen=samples)


class RpcEdgeTable:
    """Bounded per-process ``(peer, verb)`` latency attribution.

    Client-observed latency minus the server-reported handle time is
    the network+queue residual; keeping recent samples per edge gives
    p50/p99 of all three without unbounded growth. At most
    ``max_edges`` distinct keys are tracked — overflow folds into the
    ``("other", verb)`` bucket so a port-per-rank gang cannot blow up
    the table."""

    def __init__(self, max_edges: int = 64, samples: int = 512):
        self._lock = threading.Lock()
        self._max_edges = int(max_edges)
        self._samples = int(samples)
        self._edges: Dict[tuple, _Edge] = {}

    def observe(self, peer: str, verb: str, client_us: float,
                server_us: Optional[float] = None,
                ok: bool = True) -> None:
        key = (str(peer), str(verb))
        with self._lock:
            e = self._edges.get(key)
            if e is None:
                if len(self._edges) >= self._max_edges:
                    key = ("other", str(verb))
                    e = self._edges.get(key)
                if e is None:
                    e = self._edges[key] = _Edge(self._samples)
            e.count += 1
            if not ok:
                e.errors += 1
            e.client_total_us += client_us
            e.client_us.append(client_us)
            if server_us is not None:
                residual = max(0.0, client_us - server_us)
                e.attributed += 1
                e.server_total_us += server_us
                e.residual_total_us += residual
                e.server_us.append(server_us)
                e.residual_us.append(residual)

    @staticmethod
    def _summ(samples: deque) -> Optional[Dict[str, float]]:
        s = sorted(samples)
        if not s:
            return None
        return {"p50": round(_pctl(s, 0.50), 1),
                "p99": round(_pctl(s, 0.99), 1)}

    def view(self) -> Dict[str, Any]:
        """The ``GET /rpc`` document: every edge with percentiles."""
        with self._lock:
            items = sorted(self._edges.items())
            rows = []
            for (peer, verb), e in items:
                rows.append({
                    "peer": peer, "verb": verb,
                    "count": e.count, "errors": e.errors,
                    "attributed": e.attributed,
                    "client_total_us": round(e.client_total_us, 1),
                    "server_total_us": round(e.server_total_us, 1),
                    "residual_total_us": round(e.residual_total_us, 1),
                    "client_us": self._summ(e.client_us),
                    "server_us": self._summ(e.server_us),
                    "residual_us": self._summ(e.residual_us),
                })
        return {"schema": RPC_SCHEMA, "edges": rows}

    def stats(self) -> Dict[str, Any]:
        """Compact numeric totals for the metrics collector (rides
        /metrics.json into gang rollups and analyzer evidence)."""
        with self._lock:
            edges = len(self._edges)
            count = sum(e.count for e in self._edges.values())
            errors = sum(e.errors for e in self._edges.values())
            attributed = sum(e.attributed
                             for e in self._edges.values())
            client = sum(e.client_total_us
                         for e in self._edges.values())
            server = sum(e.server_total_us
                         for e in self._edges.values())
            residual = sum(e.residual_total_us
                           for e in self._edges.values())
        return {"edges": edges, "count": count, "errors": errors,
                "attributed": attributed,
                "client_us": round(client, 1),
                "server_us": round(server, 1),
                "residual_us": round(residual, 1)}

    def retire(self, peers) -> int:
        """Drop every row for the given peers (each edge key is
        ``(peer, verb)``; all verbs go). Called when rendezvous
        membership advances past a member — a departed rank's edges
        would otherwise sit in the bounded table forever, crowding out
        live peers and haunting ``obsctl rpc`` and the ``/gang``
        rollup. Returns the number of rows dropped."""
        peers = {str(p) for p in peers}
        if not peers:
            return 0
        with self._lock:
            dead = [k for k in self._edges if k[0] in peers]
            for k in dead:
                del self._edges[k]
        return len(dead)

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()


EDGES = RpcEdgeTable()  # the process-global edge table

REGISTRY.register("rpc", EDGES, RpcEdgeTable.stats)


def view() -> Dict[str, Any]:
    """The process edge table as the ``/rpc`` document."""
    return EDGES.view()


# peers seen in the last rendezvous roster — retirement only ever
# touches addresses that WERE gang members, so the rendezvous service
# endpoint, the "other" overflow bucket, and emulator rows survive
# every membership change
_roster_peers: set = set()


def membership_changed(view: Dict[str, Any]) -> int:
    """Rendezvous hook (called from ``_on_membership_change``): diff
    the new roster against the last one and retire edges for departed
    members. Counts retired rows on ``rpc.edges_retired``."""
    global _roster_peers
    live = set()
    for entry in (view.get("roster") or []):
        host = entry.get("host")
        port = entry.get("port")
        if host is not None and port is not None:
            live.add(f"{host}:{port}")
    departed = _roster_peers - live
    _roster_peers = live
    n = EDGES.retire(departed) if departed else 0
    if n:
        REGISTRY.counter("rpc.edges_retired").inc(n)
    return n
