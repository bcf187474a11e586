"""Declared SLOs, error budgets, and multi-rate burn alerting.

Copy of ``dmlc_tpu/obs/slo.py`` with its imports rewritten to
``dmlc_tpu_torch``.

Every latency number the plane records so far is DESCRIPTIVE — a p99
with no opinion attached. The scheduler is to act on
"tenant declares a p99 latency target", and acting needs a contract
first: WHO declared WHAT, how attainment is judged, and when a miss
becomes an alert. This module owns that contract:

- **objectives**: a tenant (or a pipeline, or a gang edge) registers
  ``{metric, target, window_s, budget}`` — "observations of histogram
  ``metric`` stay <= ``target`` seconds over ``window_s``, with a
  ``budget`` fraction allowed to miss" (e.g. p99 batch latency <=
  150ms over 5min, 1% error budget). Attainment is judged from the
  EXISTING histogram bucket counts (good = observations at or under
  the target, walked cumulatively), so declaring an objective adds no
  second measurement path — and with SLO-aware explicit bucket bounds
  (:func:`latency_bounds`) the target sits ON a bucket edge and the
  bucket-boundary judgment error at the target is zero;
- **sliding windows**: the engine keeps a small deque of cumulative
  ``(t, good, total)`` samples per objective and differences them, so
  window attainment needs no per-observation bookkeeping;
- **multi-rate burn alerts** (the SRE-workbook shape): burn rate =
  (1 - attainment) / budget. The FAST pair of windows (``window_s/6``
  long, ``/72`` short — the 1h/5m geometry scaled to the objective)
  fires at :data:`FAST_BURN_RATE`; the SLOW pair (``window_s`` long,
  ``/12`` short — the 6h/30m geometry) fires at
  :data:`SLOW_BURN_RATE`. An alert needs BOTH its windows over the
  rate, so a recovered tenant's short window clears the alert without
  waiting for the long window to drain. A window with no samples
  judges nothing (burn ``None``) — silence is not attainment;
- **gang rollup**: per-objective window counts ride the ``slo``
  registry collector into ``/metrics.json``, so rank 0 can
  :func:`merge_views` them and judge a gang-level objective on the
  MERGED samples; unreachable ranks mark the rollup ``incomplete``
  instead of silently skewing it (the dmlc-core tracker rule: rank 0
  owns the gang view, but never invents the missing rank).

Surfaces: ``GET /slo`` (obs.serve), ``obsctl slo``, per-objective
``slo.*`` gauges on ``/metrics`` (the lint gate confines the family —
and the burn-rate threshold literals — to this module), a merged
``slo`` section on ``/gang`` (obs.aggregate), ``slo.json`` in flight
bundles, and an ``slo``-bound verdict (:func:`analyze.slo_verdict`)
attached to ``/analyze`` while an alert fires — this module ships the
verdict, not the knob moves.

Wiring mirrors the obs planes: :func:`install` / :func:`install_if_env`
under ``DMLC_TPU_SLO`` (``launch_local(slo=...)`` exports it), one
engine per process. Declarations arrive three ways: the env grammar
(``name=victim,metric=tenant.victim.batch_s,target=0.15[,window=300]
[,budget=0.01][;...]``), ``PipelineScheduler.add_tenant(slo=...)``
(which also gives the tenant's latency histogram SLO-aware bounds),
or :meth:`SloEngine.register` directly.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.utils.logging import check

__all__ = ["SloEngine", "latency_bounds", "parse_objectives",
           "merge_views", "gang_view", "active", "install", "uninstall",
           "install_if_env", "ENV_SLO", "SLO_SCHEMA",
           "FAST_BURN_RATE", "SLOW_BURN_RATE"]

# env contract (parallel.launch.launch_local(slo=...) sets it): "1"
# installs an empty engine; otherwise parse_objectives() grammar
ENV_SLO = "DMLC_TPU_SLO"

# bump when view()'s top-level shape changes incompatibly
SLO_SCHEMA = 1

# the SRE-workbook multi-window burn-rate thresholds: fast-burn is the
# "2% of a 30d budget in 1h" rate, slow-burn the "5% in 6h" rate.
# scripts/lint.py confines these literals to THIS module — one home
# for the alert math, every surface imports the names.
FAST_BURN_RATE = 14.4
SLOW_BURN_RATE = 6.0

DEFAULT_WINDOW_S = 300.0
DEFAULT_BUDGET = 0.01

# window geometry, scaled to the objective's window W: the slow pair
# is (W, W/12) — the workbook's 6h/30m shape — and the fast pair
# (W/6, W/72) — the 1h/5m shape. Short windows gate alert RESET: a
# recovered tenant's short burn drops immediately, so the alert
# clears without draining the long window.
_WINDOW_FRACS = (("long", 1.0), ("short", 1.0 / 12.0),
                 ("fast_long", 1.0 / 6.0), ("fast_short", 1.0 / 72.0))

_NAME_RE = re.compile(r"^[a-z0-9_.\-]+$")


def latency_bounds(target_s: float) -> List[float]:
    """SLO-aware explicit histogram bounds for a latency objective:
    fine resolution around the target with the target itself ON a
    bucket edge, so the cumulative bucket walk judges "observation <=
    target" exactly (the bucket-boundary error at the target is zero;
    everywhere else it is bounded by one bucket width). Pass to
    ``registry.histogram(name, bounds=...)`` BEFORE observations."""
    t = float(target_s)
    check(t > 0, f"slo: latency target must be > 0, got {target_s!r}")
    return [round(t * f, 9)
            for f in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                      1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 8.0)]


class _Objective:
    """One declared objective's ledger (engine-lock protected)."""

    __slots__ = ("name", "metric", "target_s", "window_s", "budget",
                 "tenant", "samples")

    def __init__(self, name: str, metric: str, target_s: float,
                 window_s: float, budget: float,
                 tenant: Optional[str]):
        self.name = name
        self.metric = metric
        self.target_s = target_s
        self.window_s = window_s
        self.budget = budget
        self.tenant = tenant
        # cumulative (monotonic t, good, total) samples; window
        # attainment is a difference of two samples, so no
        # per-observation bookkeeping ever happens
        self.samples: deque = deque()


class SloEngine:
    """Objectives, windowed attainment, budget burn (module docstring).

    A daemon sampler thread differences the histograms every
    ``period_s``; with no objectives registered a tick is a no-op
    (the <2% off-cost smoke gate, tests/test_slo.py)."""

    def __init__(self, registry=None, period_s: float = 1.0):
        check(period_s > 0, "slo: period_s must be > 0")
        self._registry = registry if registry is not None else _METRICS
        self.period_s = float(period_s)
        self._lock = threading.Lock()
        self._objectives: Dict[str, _Objective] = {}
        # rows computed at the last sample(): the collector and
        # verdicts() read this cache so a /metrics scrape never pays
        # for a fresh histogram walk
        self._last_rows: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics_key = self._registry.register(
            "slo", self, SloEngine._collect)

    # ------------------------------------------------- declarations

    def register(self, name: str, *, metric: str, target_s: float,
                 window_s: float = DEFAULT_WINDOW_S,
                 budget: float = DEFAULT_BUDGET,
                 tenant: Optional[str] = None) -> str:
        """Declare (or re-declare) an objective: observations of
        histogram ``metric`` stay <= ``target_s`` seconds over
        ``window_s``, with a ``budget`` fraction allowed to miss.
        Registration snapshots the metric's CURRENT cumulative counts
        as the baseline — traffic before the declaration is never
        judged against it."""
        check(bool(_NAME_RE.match(name or "")),
              f"slo: objective name {name!r} must match "
              f"{_NAME_RE.pattern}")
        check(float(target_s) > 0,
              f"slo objective {name!r}: target_s must be > 0")
        check(float(window_s) > 0,
              f"slo objective {name!r}: window_s must be > 0")
        check(0 < float(budget) < 1,
              f"slo objective {name!r}: budget must be in (0, 1)")
        o = _Objective(name, str(metric), float(target_s),
                       float(window_s), float(budget), tenant)
        now = time.monotonic()
        o.samples.append((now,) + self._counts(o))
        with self._lock:
            self._objectives[name] = o
            self._last_rows[name] = self._row_locked(o, now)
        return name

    def unregister(self, name: str) -> None:
        with self._lock:
            self._objectives.pop(name, None)
            self._last_rows.pop(name, None)

    def objectives(self) -> List[str]:
        with self._lock:
            return sorted(self._objectives)

    # --------------------------------------------------- judgment

    def _counts(self, o: _Objective) -> tuple:
        """Cumulative (good, total) of the objective's histogram right
        now: good = observations at or under the target, from the
        cumulative bucket walk. A bucket straddling the target counts
        as bad — judgment error is bounded by one bucket width, zero
        when the target sits on a bound (latency_bounds). peek, never
        get-or-create: an objective must not materialize its metric."""
        h = self._registry.peek_histogram(o.metric)
        if h is None:
            return 0, 0
        s = h.summary()
        good = 0
        lim = o.target_s * (1.0 + 1e-9)
        for ub, n in (s.get("buckets") or {}).items():
            try:
                if float(ub) <= lim:
                    good += int(n)
            except (TypeError, ValueError):
                continue
        return good, int(s.get("count") or 0)

    def sample(self, now: Optional[float] = None) -> float:
        """One sampling pass: append a cumulative sample per objective,
        prune past the long window, refresh the cached rows and the
        per-objective ``slo.*`` gauges. Returns the pass timestamp
        (monotonic; pass ``now`` explicitly for deterministic tests)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            objectives = list(self._objectives.values())
        for o in objectives:
            counts = self._counts(o)
            with self._lock:
                o.samples.append((now,) + counts)
                # keep one sample OLDER than the long window as its
                # baseline; everything older than that is dead weight
                while (len(o.samples) > 2
                       and o.samples[1][0] <= now - o.window_s):
                    o.samples.popleft()
                row = self._row_locked(o, now)
                self._last_rows[o.name] = row
            self._export_gauges(o.name, row)
        return now

    def _window_counts_locked(self, o: _Objective, now: float,
                              window_s: float) -> tuple:
        """(good, total) inside the trailing window: newest cumulative
        sample minus the newest sample at or before the window start
        (falling back to the oldest sample — a not-yet-full window
        judges what it has, from the registration baseline)."""
        if not o.samples:
            return 0, 0
        cur = o.samples[-1]
        base = None
        start = now - window_s
        for s in o.samples:
            if s[0] <= start:
                base = s
            else:
                break
        if base is None:
            base = o.samples[0]
        return max(0, cur[1] - base[1]), max(0, cur[2] - base[2])

    def _row_locked(self, o: _Objective, now: float) -> Dict[str, Any]:
        windows: Dict[str, Any] = {}
        for label, frac in _WINDOW_FRACS:
            w = o.window_s * frac
            good, total = self._window_counts_locked(o, now, w)
            sli = (good / total) if total else None
            burn = ((1.0 - sli) / o.budget) if sli is not None else None
            windows[label] = {
                "window_s": round(w, 3),
                "good": good,
                "total": total,
                "attainment": (round(sli, 6) if sli is not None
                               else None),
                "burn": round(burn, 4) if burn is not None else None,
            }
        return self._judge(o.name, o.metric, o.target_s, o.window_s,
                           o.budget, o.tenant, windows)

    @staticmethod
    def _judge(name: str, metric: str, target_s: float,
               window_s: float, budget: float, tenant: Optional[str],
               windows: Dict[str, Any]) -> Dict[str, Any]:
        """Alert + budget arithmetic over computed window counts (the
        ONE implementation — merge_views re-judges merged gang counts
        through here, so a gang objective obeys the same rules)."""

        def _pair_fires(long_label: str, short_label: str,
                        rate: float) -> bool:
            bl = (windows.get(long_label) or {}).get("burn")
            bs = (windows.get(short_label) or {}).get("burn")
            return (bl is not None and bs is not None
                    and bl >= rate and bs >= rate)

        fast = _pair_fires("fast_long", "fast_short", FAST_BURN_RATE)
        slow = _pair_fires("long", "short", SLOW_BURN_RATE)
        att = (windows.get("long") or {}).get("attainment")
        remaining = (round(1.0 - (1.0 - att) / budget, 6)
                     if att is not None else None)
        return {
            "metric": metric,
            "target_s": target_s,
            "window_s": window_s,
            "budget": budget,
            "tenant": tenant,
            "attainment": att,
            "budget_remaining": remaining,
            "windows": windows,
            "alerts": {"fast": fast, "slow": slow,
                       "firing": fast or slow},
        }

    def _export_gauges(self, name: str, row: Dict[str, Any]) -> None:
        g = self._registry.gauge
        g(f"slo.{name}.attainment").set(row["attainment"])
        g(f"slo.{name}.budget_remaining").set(row["budget_remaining"])
        g(f"slo.{name}.burn").set(row["windows"]["long"]["burn"])
        g(f"slo.{name}.fast_burn").set(row["alerts"]["fast"])
        g(f"slo.{name}.slow_burn").set(row["alerts"]["slow"])

    # ------------------------------------------------------- reads

    def view(self, sample: bool = True) -> Dict[str, Any]:
        """The ``GET /slo`` payload (and ``slo.json`` in flight
        bundles). ``sample=True`` takes a fresh pass first so a reader
        never judges stale counts."""
        if sample:
            self.sample()
        with self._lock:
            return {"schema": SLO_SCHEMA,
                    "fast_burn_rate": FAST_BURN_RATE,
                    "slow_burn_rate": SLOW_BURN_RATE,
                    "objectives": {n: dict(r) for n, r in
                                   sorted(self._last_rows.items())}}

    def _collect(self) -> Dict[str, Any]:
        """Registry-collector shape: the cached rows (numeric leaves
        flatten onto /metrics; the full rows ride /metrics.json so
        rank 0 can merge_views the gang)."""
        with self._lock:
            rows = {n: dict(r) for n, r in self._last_rows.items()}
        return {"schema": SLO_SCHEMA, "count": len(rows),
                "firing": sum(1 for r in rows.values()
                              if r["alerts"]["firing"]),
                "objectives": rows}

    def verdicts(self, epoch: Optional[int] = None
                 ) -> List[Dict[str, Any]]:
        """``slo``-bound verdicts (obs.analyze VERDICT_KEYS shape) for
        every objective with a FIRING alert — what /analyze attaches
        and the controller will consume. Empty when healthy."""
        from dmlc_tpu_torch.obs import analyze as _an
        with self._lock:
            rows = {n: dict(r) for n, r in self._last_rows.items()}
        return [_an.slo_verdict(name, row, epoch=epoch)
                for name, row in sorted(rows.items())
                if row["alerts"]["firing"]]

    # --------------------------------------------------- lifecycle

    def start(self) -> "SloEngine":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="dmlc_tpu_torch.obs.SloEngine")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                if self._objectives:
                    self.sample()
            except Exception:  # noqa: BLE001 — the sampler survives
                pass

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        if self._metrics_key is not None:
            self._registry.unregister(self._metrics_key)
            self._metrics_key = None


# ------------------------------------------------------- gang rollup

def merge_views(views: List[Dict[str, Any]],
                unreachable: Iterable[Any] = ()) -> Dict[str, Any]:
    """Rank-0 rollup: judge each objective on the gang's MERGED window
    counts (good/total summed across the ranks that reported it), then
    re-run the same alert arithmetic — a gang-level objective is
    judged on merged samples, not on a vote of per-rank verdicts.
    ``unreachable`` ranks mark the rollup (and every objective row)
    ``incomplete``: the merged numbers still render, flagged as a
    subset, never dressed up as the gang."""
    unreachable = [str(u) for u in unreachable]
    incomplete = bool(unreachable)
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for v in views:
        if not isinstance(v, dict):
            continue
        for name, row in (v.get("objectives") or {}).items():
            if isinstance(row, dict):
                by_name.setdefault(str(name), []).append(row)
    objectives: Dict[str, Any] = {}
    for name, rows in sorted(by_name.items()):
        spec = rows[0]
        windows: Dict[str, Any] = {}
        budget = float(spec.get("budget") or DEFAULT_BUDGET)
        for label, _frac in _WINDOW_FRACS:
            good = total = 0
            w = None
            for r in rows:
                win = (r.get("windows") or {}).get(label) or {}
                good += int(win.get("good") or 0)
                total += int(win.get("total") or 0)
                if w is None and win.get("window_s") is not None:
                    w = win["window_s"]
            sli = (good / total) if total else None
            burn = ((1.0 - sli) / budget) if sli is not None else None
            windows[label] = {
                "window_s": w,
                "good": good,
                "total": total,
                "attainment": (round(sli, 6) if sli is not None
                               else None),
                "burn": round(burn, 4) if burn is not None else None,
            }
        row = SloEngine._judge(
            name, spec.get("metric"), spec.get("target_s"),
            spec.get("window_s"), budget, spec.get("tenant"), windows)
        row["ranks"] = len(rows)
        row["incomplete"] = incomplete
        objectives[name] = row
    return {"schema": SLO_SCHEMA, "incomplete": incomplete,
            "unreachable": unreachable, "ranks": len(views),
            "objectives": objectives}


def gang_view(merged_snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The gang SLO rollup from a ``scrape_gang()`` merged snapshot:
    pull every reachable rank's ``slo`` collector payload and
    :func:`merge_views` them, with the scrape's unreachable ports
    marking the rollup incomplete. None when no rank carries an SLO
    section and nothing was unreachable."""
    views = []
    for w in (merged_snap.get("workers") or {}).values():
        v = (w.get("collectors") or {}).get("slo")
        if isinstance(v, dict) and v.get("objectives"):
            views.append(v)
    unreachable = sorted(merged_snap.get("unreachable") or {})
    if not views and not unreachable:
        return None
    return merge_views(views, unreachable=unreachable)


# ------------------------------------------------- process wiring
# (the serve/flight/history/control install contract)

_active: Optional[SloEngine] = None
_lock = threading.Lock()


def active() -> Optional[SloEngine]:
    return _active


def install(engine: Optional[SloEngine] = None,
            **opts: Any) -> SloEngine:
    """Install the process SLO engine (idempotent: a second call
    returns the running one, like obs.serve.serve)."""
    global _active
    with _lock:
        if _active is not None:
            return _active
        _active = (engine if engine is not None
                   else SloEngine(**opts)).start()
        return _active


def uninstall() -> None:
    global _active
    with _lock:
        eng, _active = _active, None
    if eng is not None:
        eng.close()


def parse_objectives(raw: str) -> List[Dict[str, Any]]:
    """Parse the declaration grammar: ``;``-separated objectives, each
    a ``,``-separated k=v list with keys ``name``/``metric``/``target``
    (required) and ``window``/``budget``/``tenant`` (optional) —
    ``name=victim,metric=tenant.victim.batch_s,target=0.15,window=300,
    budget=0.01``. Raises ValueError on anything malformed."""
    out: List[Dict[str, Any]] = []
    for decl in raw.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        spec: Dict[str, Any] = {}
        for part in decl.split(","):
            k, eq, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if not eq or not v:
                raise ValueError(part)
            if k in ("name", "metric", "tenant"):
                spec[k] = v
            elif k == "target":
                spec["target_s"] = float(v)
            elif k == "window":
                spec["window_s"] = float(v)
            elif k == "budget":
                spec["budget"] = float(v)
            else:
                raise ValueError(k)
        if not {"name", "metric", "target_s"} <= set(spec):
            raise ValueError(decl)
        out.append(spec)
    return out


def install_if_env() -> Optional[SloEngine]:
    """Gang-worker hook: install under ``DMLC_TPU_SLO`` — "1"/"true"
    for an empty engine (declarations arrive at runtime), or the
    :func:`parse_objectives` grammar — else no-op
    (``launch_local(slo=...)`` sets the var per worker). A malformed
    declaration degrades to a warning and an empty engine: the
    telemetry opt-in must never take down the job it watches."""
    raw = os.environ.get(ENV_SLO, "").strip()
    if not raw or raw in ("0", "false"):
        return None
    specs: List[Dict[str, Any]] = []
    if raw not in ("1", "true"):
        try:
            specs = parse_objectives(raw)
        except ValueError:
            from dmlc_tpu_torch.obs.log import warn_once
            warn_once("slo-env-malformed",
                      f"obs.slo: malformed {ENV_SLO}={raw!r} (want '1' "
                      "or 'name=...,metric=...,target=0.15[,window=300]"
                      "[,budget=0.01][;...]'); installing an empty "
                      "engine", all_ranks=True)
            specs = []
    eng = install()
    for spec in specs:
        eng.register(spec.pop("name"), **spec)
    return eng
