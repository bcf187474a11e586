"""Gang-wide metrics aggregation: one timeline across every rank.

Copy of ``dmlc_tpu/obs/aggregate.py`` with its imports rewritten to
``dmlc_tpu_torch``; it polls through the port's ``obs.serve.scrape``.

``scrape_gang()`` merges the gang's CURRENT snapshots once. The
analysis plane needs the gang OVER TIME: a rank-0 (or launcher-side)
:class:`GangAggregator` polls every rank's ``/metrics.json`` — through
the existing ``obs.scrape`` resilience seam, so one dropped connection
does not mark a live rank unreachable — and merges the polls onto one
wall-anchored timeline:

- **per-rank series**: each member feeds its own
  :class:`~dmlc_tpu_torch.obs.timeseries.TimeSeriesRing` (same coarsening
  mechanics, same byte budget each), so a 2-hour gang run fits the
  same memory as a 10-second one;
- **rollups**: at every poll, sum/min/max across the REACHABLE ranks
  per numeric series, plus ``gang.reachable``/``gang.expected`` so a
  reader can see membership shrink on the same timeline;
- **explicit gaps**: an unreachable rank gets a gap marker (poll time
  + error) instead of an interpolated value — the rank you cannot
  scrape is exactly the one you are diagnosing, and inventing numbers
  for it would hide the outage the timeline exists to show.

Installed on rank 0 via ``launch_local(gang_poll_s=...)`` →
``DMLC_TPU_GANG_POLL_S`` (+ the ``DMLC_TPU_SERVE_PORTS`` gang
list); workers opt in with one :func:`install_if_env` call. The live
view serves as ``GET /gang`` on the member's StatusServer.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from dmlc_tpu_torch.obs.timeseries import TimeSeriesRing, numeric_leaves

__all__ = ["GangAggregator", "install", "uninstall", "active",
           "install_if_env", "ENV_GANG_POLL_S", "GANG_SCHEMA"]

# bump when view()'s top-level shape changes incompatibly
GANG_SCHEMA = 1

ENV_GANG_POLL_S = "DMLC_TPU_GANG_POLL_S"

# bounded per-member gap log: a rank that stays dead for hours must
# not grow the view without bound — the FIRST gap after each outage
# transition plus the most recent ones tell the whole story
MAX_GAPS = 64

# knob VALUES are identities, not quantities — summing rank 0's queue
# depth with rank 1's reads as nonsense on the rollup timeline (the
# per-rank series still carry them; obsctl gang reads those).
# Control collectors may be name-suffixed ("control#2" when two
# controllers coexist), so their knob leaves are matched by the pair
# below, not a plain prefix. SLO rows are ratios/specs — summing
# attainments across ranks is meaningless; the dedicated merged
# ``slo`` section on view() carries the count-level merge instead.
_ROLLUP_SKIP_SECTIONS = ("collectors.pipeline.knobs",
                         "collectors.slo")
_ROLLUP_SKIP_PAIRS = (("collectors.control", ".knobs."),)


class _Member:
    """One gang member's aggregation state (keyed by serve port)."""

    __slots__ = ("port", "rank", "ring", "gaps", "unreachable",
                 "last_error", "last_poll_t", "polls_ok", "polls_failed",
                 "last_rpc", "last_slo")

    def __init__(self, port: int, budget_bytes: int, period_s: float):
        self.port = port
        self.rank: Optional[int] = None
        self.ring = TimeSeriesRing(period_s=period_s,
                                   budget_bytes=budget_bytes)
        self.gaps: List[Dict[str, Any]] = []
        self.unreachable = False
        self.last_error: Optional[str] = None
        self.last_poll_t: Optional[float] = None
        self.polls_ok = 0
        self.polls_failed = 0
        # the rank's last-scraped RPC edge totals (obs.rpc collector):
        # /gang carries the gang-wide wire-attribution picture
        self.last_rpc: Optional[Dict[str, Any]] = None
        # the rank's last-scraped SLO objective rows (obs.slo
        # collector): rank 0 judges gang objectives on merged counts
        self.last_slo: Optional[Dict[str, Any]] = None

    def label(self) -> str:
        return (f"rank{self.rank}" if self.rank is not None
                else f"port{self.port}")


class GangAggregator:
    """Poll the gang; keep per-rank history, rollups, explicit gaps."""

    def __init__(self, ports: Optional[List[int]] = None,
                 host: str = "127.0.0.1",
                 period_s: float = 2.0,
                 timeout_s: float = 2.0,
                 budget_bytes: int = 128 << 10):
        if ports is None:
            from dmlc_tpu_torch.obs.serve import ENV_SERVE_PORTS
            raw = os.environ.get(ENV_SERVE_PORTS, "")
            ports = [int(p) for p in raw.split(",") if p.strip()]
        self.ports = list(ports)
        self.host = host
        self.period_s = max(0.05, float(period_s))
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._members = {p: _Member(p, budget_bytes, self.period_s)
                         for p in self.ports}
        self._rollup = TimeSeriesRing(period_s=self.period_s,
                                      budget_bytes=budget_bytes)
        self._polls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- polling

    def poll_once(self, t: Optional[float] = None) -> Dict[str, Any]:
        """One poll pass over every port; returns {label: ok_bool}.
        Wall-anchored: every member's sample from this pass shares one
        timestamp, so cross-rank reads line up by construction."""
        from dmlc_tpu_torch.obs.serve import scrape
        t = time.time() if t is None else t
        reachable: List[Dict[str, float]] = []
        status: Dict[str, bool] = {}
        for port in self.ports:
            m = self._members[port]
            try:
                snap = scrape(port, host=self.host,
                              timeout_s=self.timeout_s)
                leaves = numeric_leaves(snap)
            except Exception as e:  # noqa: BLE001 — dead rank: a GAP,
                with self._lock:    # never an invented sample
                    m.polls_failed += 1
                    m.last_error = repr(e)
                    m.last_poll_t = t
                    # log the transition INTO the outage and a bounded
                    # tail of the outage's polls; the earliest gap (when
                    # the outage began) always survives the pruning
                    m.gaps.append({"t": t, "error": repr(e),
                                   "first": not m.unreachable})
                    if len(m.gaps) > MAX_GAPS:
                        m.gaps = m.gaps[:1] + m.gaps[-(MAX_GAPS - 1):]
                    m.unreachable = True
                status[m.label()] = False
                continue
            with self._lock:
                if snap.get("rank") is not None:
                    m.rank = snap["rank"]
                m.polls_ok += 1
                m.unreachable = False
                m.last_error = None
                m.last_poll_t = t
                rpc = (snap.get("collectors") or {}).get("rpc")
                if isinstance(rpc, dict):
                    m.last_rpc = rpc
                slo = (snap.get("collectors") or {}).get("slo")
                if isinstance(slo, dict):
                    m.last_slo = slo
            m.ring.append(t, leaves)
            reachable.append(leaves)
            status[m.label()] = True
        self._rollup.append(t, self._rollup_leaves(reachable))
        with self._lock:
            self._polls += 1
        return status

    def _rollup_leaves(self, per_rank: List[Dict[str, float]]
                       ) -> Dict[str, float]:
        """sum/min/max across the reachable ranks per series — NOT
        across time (the rings own time)."""
        out: Dict[str, float] = {
            "gang.expected": float(len(self.ports)),
            "gang.reachable": float(len(per_rank)),
        }
        keys: set = set()
        for leaves in per_rank:
            keys.update(leaves)
        for key in keys:
            if key.startswith(_ROLLUP_SKIP_SECTIONS):
                continue
            if any(key.startswith(p) and mid in key
                   for p, mid in _ROLLUP_SKIP_PAIRS):
                continue
            vals = [lv[key] for lv in per_rank if key in lv]
            if not vals:
                continue
            out[f"sum.{key}"] = sum(vals)
            out[f"min.{key}"] = min(vals)
            out[f"max.{key}"] = max(vals)
        return out

    # -- reads

    def view(self, last_s: Optional[float] = None) -> Dict[str, Any]:
        """The /gang payload: per-member series + gaps + reachability,
        and the gang rollup timeline."""
        with self._lock:
            members = list(self._members.values())
            polls = self._polls
        ranks: Dict[str, Any] = {}
        for m in members:
            ranks[m.label()] = {
                "port": m.port,
                "rank": m.rank,
                "unreachable": m.unreachable,
                "last_error": m.last_error,
                "last_poll_t": m.last_poll_t,
                "polls_ok": m.polls_ok,
                "polls_failed": m.polls_failed,
                "gaps": list(m.gaps),
                "rpc": m.last_rpc,
                "slo": m.last_slo,
                "series": m.ring.to_dict(last_s=last_s),
            }
        out = {
            "schema": GANG_SCHEMA,
            "period_s": self.period_s,
            "host": self.host,
            "ports": list(self.ports),
            "polls": polls,
            "ranks": ranks,
            "rollup": self._rollup.to_dict(last_s=last_s),
        }
        slo_views = [m.last_slo for m in members
                     if isinstance(m.last_slo, dict)]
        if slo_views:
            # gang-level objectives judged on MERGED window counts;
            # unreachable ranks flag the section incomplete rather
            # than silently skewing the attainment
            try:
                from dmlc_tpu_torch.obs import slo as _slo
                out["slo"] = _slo.merge_views(
                    slo_views,
                    unreachable=[m.label() for m in members
                                 if m.unreachable])
            except Exception:  # noqa: BLE001 — rollup must not kill
                pass           # the /gang read
        return out

    # -- lifecycle

    def start(self) -> "GangAggregator":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="dmlc_tpu_torch.obs.GangAggregator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poll loop survives
                pass


_aggregator: Optional[GangAggregator] = None


def active() -> Optional[GangAggregator]:
    return _aggregator


def install(ports: Optional[List[int]] = None,
            **kwargs: Any) -> GangAggregator:
    """Install + start the process gang aggregator (idempotent)."""
    global _aggregator
    if _aggregator is not None:
        return _aggregator
    _aggregator = GangAggregator(ports=ports, **kwargs).start()
    return _aggregator


def uninstall() -> None:
    global _aggregator
    agg, _aggregator = _aggregator, None
    if agg is not None:
        agg.stop()


def install_if_env() -> Optional[GangAggregator]:
    """Gang-worker hook (one line, like serve_if_env): start the gang
    aggregator when ``DMLC_TPU_GANG_POLL_S`` is set —
    ``launch_local(gang_poll_s=...)`` sets it on RANK 0 only — with the
    gang's ports from ``DMLC_TPU_SERVE_PORTS``; else no-op."""
    raw = os.environ.get(ENV_GANG_POLL_S)
    if not raw:
        return None
    try:
        period = float(raw)
    except ValueError as e:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("gang-poll-env-failed",
                  f"obs.aggregate: bad {ENV_GANG_POLL_S}={raw!r}: {e}",
                  all_ranks=True)
        return None
    agg = install(period_s=period)
    if not agg.ports:
        from dmlc_tpu_torch.obs.log import warn_once
        warn_once("gang-poll-no-ports",
                  "obs.aggregate: DMLC_TPU_GANG_POLL_S set but no "
                  "DMLC_TPU_SERVE_PORTS gang list to poll",
                  all_ranks=True)
    return agg
