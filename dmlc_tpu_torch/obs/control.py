"""Verdict-driven control plane: the observe→act loop, closed.

Copy of ``dmlc_tpu/obs/control.py`` with its imports rewritten to
``dmlc_tpu_torch``; it moves the port's pipeline knobs on the port's
``pipeline/autotune.py`` rails.

The analysis planes give the system judgment — schema-pinned bound verdicts
(:mod:`dmlc_tpu_torch.obs.analyze`) with hot-frame evidence — but the
between-epoch :class:`~dmlc_tpu_torch.pipeline.autotune.Autotuner` still
hill-climbed queue depths blind: the pipeline could SAY "parse-bound"
or "credit-limited" and then ignore itself. This module makes the
verdict the policy input. After every completed epoch the
:class:`Controller` attributes the epoch, maps the bound to a knob
*family*, and moves at most ONE knob inside it under the autotuner's
safe-exploration rails (:class:`~dmlc_tpu_torch.pipeline.autotune
.ExplorationRail`: revert on regression, cooldown after a revert,
bounded ×2 steps — generalized here with per-family revert budgets):

- ``parse``-bound  → the parse family (native shard count / worker
  pool / chunk-prefetch depth): more parse-side parallelism;
- ``wire``-bound (a cold pagestore re-fetching) → the wire family:
  raise ``coalesce``, then ``parallel`` GETs, then flip the page
  codec on — automating exactly the per-verdict advice
  docs/remote_io.md documents as manual;
- ``assemble``-bound → the assemble family (staging/prefetch depths,
  bucket-geometry knobs when a caller exposes them);
- ``xfer``-bound → the transfer family (the in-flight device window);
- ``credit-limited`` → **FREEZE every knob** for a cooldown: wall
  rates reflect the credit scheduler, not the pipeline, and a tuner
  that keeps moving is chasing the climate (the exact failure the
  gauge-band machinery was built to name);
- ``consumer``-bound → an explicit no-op record (the pipeline is not
  the bottleneck; moving knobs would be noise).

The observability headline is the **decision ledger**: every decision
— including "freeze" and "no-op" — is an immutable record
``{epoch, verdict_id, tenant, bound, band, evidence, family, knob, old, new,
outcome, reverted}`` kept in a byte-budgeted ring on the
TimeSeriesRing coarsening discipline (old history halves its
resolution, the newest and oldest decisions always survive), so an
operator can always answer "why is this knob at this value" with the
measured evidence that moved it. The ledger is:

- served at ``GET /control`` on every rank's StatusServer,
- rendered by ``obsctl control``,
- emitted as ``control/<family>`` trace instants on the shared
  timeline,
- aggregated gang-wide through the registry collector ``control``
  (numeric leaves ride the GangAggregator rollups; ``obsctl
  gang`` prints the per-rank decision/freeze counts),
- attached to flight bundles as ``control.json``.

Wiring mirrors every other obs plane: ``install()`` directly, or
:func:`install_if_env` under ``DMLC_TPU_CONTROL`` (set per worker by
``launch_local(control=True)``). An installed controller ADOPTS every
:class:`~dmlc_tpu_torch.pipeline.graph.CompiledPipeline` that completes an
epoch — the pipeline's "auto" knobs join the controller's families
(stage kind → family) and the pipeline's own Autotuner stands down
(one mover per process; the controller subsumes it on the same
rails). ``scripts/lint.py``'s knob gate confines knob mutation to
``pipeline/autotune.py`` + this module, so no hand-tuned constant can
sneak back in behind the ledger's back.
"""

from __future__ import annotations

import json
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

from dmlc_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from dmlc_tpu_torch.utils.logging import check

__all__ = ["ControlKnob", "DecisionLedger", "Controller",
           "objstore_knobs", "install", "uninstall", "active",
           "install_if_env", "membership_record", "ENV_CONTROL",
           "CONTROL_SCHEMA", "RECORD_KEYS", "FAMILY_FOR_BOUND",
           "FAMILY_FOR_STAGE_KIND"]

ENV_CONTROL = "DMLC_TPU_CONTROL"

# bump when to_dict()'s top-level shape changes incompatibly
CONTROL_SCHEMA = 1

# every ledger record carries exactly these keys (tests/test_control.py
# pins it): the decision, the verdict that caused it, and the measured
# evidence — immutable once appended (a revert is a NEW record, never
# an edit)
RECORD_KEYS = ("epoch", "verdict_id", "tenant", "bound", "band",
               "evidence",
               "family", "knob", "old", "new", "outcome", "reverted")

# verdict bound -> the knob family allowed to move. credit-limited and
# consumer are deliberately absent: the first freezes, the second no-ops.
FAMILY_FOR_BOUND = {
    "parse": "parse",
    "wire": "wire",
    "assemble": "assemble",
    "xfer": "transfer",
}

# pipeline stage kind -> family, for adopted CompiledPipeline knobs
FAMILY_FOR_STAGE_KIND = {
    "parse": "parse",
    "prefetch": "assemble",
    "shard": "assemble",
    "to_device": "transfer",
}

# evidence lines kept per ledger record (the full verdict is served by
# /analyze; the ledger stores the measured lines that moved the knob,
# bounded so the byte budget buys decisions, not prose)
_EVIDENCE_PER_RECORD = 4


class ControlKnob:
    """One integer knob owned by the controller, tagged with its
    family. ``grow`` overrides the default bounded ×2 step (e.g. the
    page codec flips 0 → 6 once instead of ramping). ``owner`` is an
    optional weakref to the object whose lifetime the knob rides
    (an adopted pipeline): a dead owner retires the knob — its
    closures point at closed queues, and trialing it would judge a
    dead pipeline's knob by a live pipeline's throughput."""

    __slots__ = ("name", "family", "get", "set", "lo", "hi", "initial",
                 "_grow", "owner")

    def __init__(self, name: str, family: str, get: Callable[[], int],
                 set: Callable[[int], None], lo: int, hi: int,
                 grow: Optional[Callable[[int], int]] = None,
                 owner: Optional["weakref.ref"] = None):
        check(hi >= lo, f"knob {name}: bad bounds [{lo},{hi}]")
        self.name = name
        self.family = family
        self.get = get
        self.set = set
        self.lo = lo
        self.hi = hi
        self.initial = get()
        self._grow = grow
        self.owner = owner

    def retired(self) -> bool:
        return self.owner is not None and self.owner() is None

    def grow_value(self, cur: int) -> int:
        """The bounded exploration step: at most ×2 per move, clamped
        to [lo, hi]; returns ``cur`` when there is no headroom."""
        if self._grow is not None:
            new = self._grow(cur)
        else:
            new = min(max(cur * 2, self.lo, 1), self.hi)
        return min(max(new, self.lo), self.hi)


class DecisionLedger:
    """Byte-budgeted ring of immutable decision records, on the
    TimeSeriesRing coarsening discipline: when the budget fills, every
    other stored record is dropped across the history (the oldest —
    the run's "why is this knob here at all" anchor — and the NEWEST
    record always survive). Unlike the metrics ring, appends are never
    stride-skipped: every decision lands, old history coarsens."""

    def __init__(self, budget_bytes: int = 64 << 10):
        self.budget_bytes = max(2 << 10, int(budget_bytes))
        self._lock = threading.Lock()
        self._records: List[tuple] = []  # (record, est_bytes)
        self._bytes = 0
        self._offered = 0
        self._coarsenings = 0

    def append(self, record: Dict[str, Any]) -> None:
        est = len(json.dumps(record, default=repr)) + 16
        with self._lock:
            self._offered += 1
            self._records.append((record, est))
            self._bytes += est
            while self._bytes > self.budget_bytes and \
                    len(self._records) >= 8:
                # halve the OLDER history (even indices keep the run's
                # oldest anchor) and always retain the newest record
                kept = self._records[:-1][::2]
                kept.append(self._records[-1])
                self._records = kept
                self._bytes = sum(e for _, e in kept)
                self._coarsenings += 1

    def records(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = [r for r, _ in self._records]
        return recs[-last:] if last else recs

    def to_dict(self, last: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            recs = [r for r, _ in self._records]
            out = {
                "offered": self._offered,
                "kept": len(recs),
                "coarsenings": self._coarsenings,
                "approx_bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
            }
        out["records"] = recs[-last:] if last else recs
        return out


def objstore_knobs() -> List[ControlKnob]:
    """The wire family, bound to the live objstore read path
    (``objstore.configure`` — process-global, safely mutable between
    epochs). Ordered by the docs/remote_io.md escalation: coalesce
    more blocks per span, then more parallel GETs, then flip the page
    codec on (0 → level 6 once — compression is a switch, not a
    ramp). This automates the manual WHEN-per-verdict advice."""
    from dmlc_tpu_torch.io import objstore

    def opt(key: str, default: int) -> int:
        v = objstore.options().get(key)
        return int(v) if v is not None else default

    def codec_level() -> int:
        # the EFFECTIVE level: an unset option falls through to the
        # process default (DMLC_TPU_PAGE_CODEC_LEVEL). Reading the raw
        # None as 0 would let a revert write an explicit 0 that
        # silently disables a codec the operator enabled by env.
        v = objstore.options().get("codec_level")
        if v is not None:
            return int(v)
        from dmlc_tpu_torch.io.codec import default_level
        return default_level()

    return [
        ControlKnob("wire.coalesce", "wire",
                    lambda: opt("coalesce", 4),
                    lambda n: objstore.configure(coalesce=n),
                    lo=1, hi=16),
        ControlKnob("wire.parallel", "wire",
                    lambda: opt("parallel", 4),
                    lambda n: objstore.configure(parallel=n),
                    lo=1, hi=16),
        ControlKnob("wire.codec_level", "wire",
                    codec_level,
                    lambda n: objstore.configure(codec_level=n),
                    lo=0, hi=9,
                    grow=lambda cur: 6 if cur == 0 else cur),
    ]


class Controller:
    """The between-epoch controller; see the module docstring.

    Feed it epochs either through :meth:`observe` (a stats snapshot —
    the manual path benches and tests drive) or let an INSTALLED
    controller adopt pipelines automatically (CompiledPipeline calls
    :meth:`observe_pipeline` at each epoch end when one is active).
    """

    def __init__(self, knobs: Optional[List[ControlKnob]] = None, *,
                 revert_tolerance: float = 0.9, cooldown: int = 3,
                 revert_budget: int = 2,
                 ledger_bytes: int = 64 << 10,
                 registry: Optional[MetricsRegistry] = None):
        from dmlc_tpu_torch.pipeline.autotune import ExplorationRail
        self.rail = ExplorationRail(revert_tolerance=revert_tolerance,
                                    cooldown=cooldown,
                                    revert_budget=revert_budget)
        self.ledger = DecisionLedger(ledger_bytes)
        self.registry = registry if registry is not None else REGISTRY
        self._lock = threading.RLock()
        self._knobs: Dict[str, ControlKnob] = {}
        for k in (knobs or []):
            self._knobs[k.name] = k
        # pipelines already adopted (their "auto" knobs joined the
        # families); weak — a closed pipeline drops out on its own.
        # Each gets a MINTED source token (never id(): CPython reuses
        # addresses after GC, and a new pipeline inheriting a dead
        # one's throughput reference would be falsely reverted);
        # dead tokens are pruned with their knobs.
        self._adopted: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()  # token -> pipeline
        self._minted: set = set()          # every token ever minted
        self._source_seq = 0
        self._counts = {"decisions": 0, "trials": 0, "accepted": 0,
                        "reverted": 0, "freezes": 0, "noops": 0,
                        "exhausted": 0, "discarded": 0}
        # wire-side counters are process-cumulative: delta-scope them
        # per observed epoch AND per source (the serve.py /analyze
        # discipline) so a cold hydration configs ago — or ANOTHER
        # pipeline's traffic — cannot flip a local epoch's verdict to
        # wire-bound
        self._prev_counters: Dict[Any, Dict[str, Any]] = {}
        # recent host-credit gauges fed by the measurement loop
        # (bench.py's memcpy gauge): without them the credit-limited
        # freeze cannot fire — attribute() says so in the band
        self._gauges: List[float] = []
        self._observed = 0  # epochs observed, all sources
        self._metrics_key = self.registry.register(
            "control", self, Controller._collect)

    def note_gauge(self, gauge: float) -> None:
        """Feed one pre-epoch host-credit gauge reading (bench.py's
        memcpy gauge); the next :meth:`observe` without explicit
        ``epoch_gauges`` judges the climate from the recent readings."""
        with self._lock:
            self._gauges.append(float(gauge))
            del self._gauges[:-8]

    # -- knob management

    def add_knobs(self, knobs: List[ControlKnob],
                  prefix: Optional[str] = None) -> None:
        """Register knobs. A name collision (two live pipelines with
        the same stage kinds) is resolved with the stable ``prefix``
        (the adopting pipeline's source token) — "pipe-2.prefetch.
        depth" is attributable across the ledger/obsctl/gang labels,
        an apostrophe suffix would not be."""
        with self._lock:
            self._prune_locked()
            for k in knobs:
                name = k.name
                if name in self._knobs and prefix:
                    name = f"{prefix}.{k.name}"
                while name in self._knobs:
                    name += "'"
                k.name = name
                self._knobs[name] = k

    def _prune_locked(self) -> None:
        """Retire knobs whose owning pipeline is gone: their closures
        point at closed queues, and a pending trial on one would be
        judged by the NEXT pipeline's throughput (and could burn the
        family's revert budget on a ghost). Dead pipelines' source
        state (throughput reference, regime, counter baseline) is
        dropped with them — the maps stay bounded by LIVE pipelines."""
        dead = [name for name, k in self._knobs.items() if k.retired()]
        for name in dead:
            del self._knobs[name]
            self.rail.cancel(name)
        for token in self._minted - set(self._adopted.keys()):
            self._minted.discard(token)
            self.rail.drop_source(token)
            self._prev_counters.pop(token, None)

    def knob_values(self) -> Dict[str, int]:
        with self._lock:
            self._prune_locked()
            return {name: k.get() for name, k in self._knobs.items()}

    def _token_locked(self, pipe) -> tuple:
        """(token, known): the pipeline's minted source token, minting
        one when this is a first sight."""
        for token, p in self._adopted.items():
            if p is pipe:
                return token, True
        self._source_seq += 1
        token = f"pipe-{self._source_seq}"
        self._adopted[token] = pipe
        self._minted.add(token)
        return token, False

    def adopt_pipeline(self, pipe) -> str:
        """Fold a CompiledPipeline's "auto" knobs into the families
        (stage kind → family). Idempotent per pipeline; knobs ride
        the pipeline's lifetime (weak owner) and retire with it.
        Returns the pipeline's source token."""
        with self._lock:
            token, known = self._token_locked(pipe)
            if known:
                return token
            ref = weakref.ref(pipe)
            adopted = []
            # a tenant-admitted pipeline's queue-capacity knobs belong
            # to the multi-tenant scheduler's budget rebalancer — one
            # owner per knob (the same rule that stands the autotuner
            # down when this controller adopts)
            sched_owned = set(getattr(pipe, "scheduler_owned", ()))
            for knob in pipe.knobs():
                if knob.name in sched_owned:
                    continue
                family = FAMILY_FOR_STAGE_KIND.get(knob.stage)
                if family is None:
                    continue
                adopted.append(ControlKnob(
                    knob.name, family, knob.get, knob.set,
                    lo=knob.lo, hi=knob.hi, owner=ref))
            self.add_knobs(adopted, prefix=token)
            return token

    def abandon_pipeline(self, pipe) -> None:
        """Release a pipeline whose epoch hook failed (it fell back to
        its own autotuner, permanently): discard its pending trial
        (value restored), retire its adopted knobs, forget its source
        state. Without this, its unresolved trial would wedge the
        whole controller into no-ops (one pending at a time) and the
        autotuner + controller would both move its knobs."""
        with self._lock:
            token = None
            for t, p in list(self._adopted.items()):
                if p is pipe:
                    token = t
                    del self._adopted[t]
                    break
            if token is None:
                return
            self.rail.discard(source=token)  # restore, no charge
            for name in [n for n, k in self._knobs.items()
                         if k.owner is not None and k.owner() is pipe]:
                del self._knobs[name]
                self.rail.cancel(name)
            self._minted.discard(token)
            self.rail.drop_source(token)
            self._prev_counters.pop(token, None)

    # -- observation

    def observe_pipeline(self, pipe, snapshot: Dict[str, Any]) -> Dict:
        """The CompiledPipeline hook: adopt the pipeline's knobs, then
        decide from its epoch snapshot (source-keyed so two pipelines
        never judge each other's throughput)."""
        token = self.adopt_pipeline(pipe)
        return self.observe(snapshot, source=token)

    def observe(self, snapshot: Dict[str, Any],
                metrics: Optional[Dict[str, Any]] = None,
                epoch_gauges: Optional[List[float]] = None,
                run_band: Optional[str] = None,
                verdict: Optional[Dict[str, Any]] = None,
                source: Any = None) -> Dict[str, Any]:
        """Feed one completed epoch; returns the primary decision
        record appended to the ledger. ``verdict`` overrides the
        attribution (bench embeds the one it already computed);
        otherwise the epoch is attributed from ``metrics`` (default:
        the registry snapshot, wire counters delta-scoped)."""
        from dmlc_tpu_torch.obs import analyze as _analyze
        from dmlc_tpu_torch.pipeline.autotune import (
            epoch_throughput, tier_signature,
        )
        with self._lock:
            self._prune_locked()
            if verdict is None:
                if metrics is None:
                    metrics = self._delta_metrics(source)
                if epoch_gauges is None and run_band is None \
                        and self._gauges:
                    epoch_gauges = self._gauges[-3:]
                verdict = _analyze.attribute(
                    snapshot, metrics=metrics,
                    epoch_gauges=epoch_gauges, run_band=run_band)
            tp = epoch_throughput(snapshot)
            discarded = self.rail.note_regime(tier_signature(snapshot),
                                              source=source)
            if discarded is None and verdict.get("bound") == \
                    "credit-limited":
                # a drained epoch judges NOTHING: its wall throughput
                # is the credit scheduler's, so resolving the pending
                # trial by it would falsely revert a good knob and
                # charge the family's budget — the exact climate-
                # chasing the freeze exists to prevent. Discard like a
                # regime flip: restored, no freeze, no budget charge.
                discarded = self.rail.discard(source)
            if discarded is not None:
                # record orientation is always the TRIAL's (old = the
                # pre-trial value the knob is back at): the outcome
                # says the move was undone, the fields say what it was
                self._counts["discarded"] += 1
                self._append(verdict, family=discarded["group"],
                             knob=discarded["key"],
                             old=discarded["old"],
                             new=discarded["new"],
                             outcome="discarded")
            record = None
            if verdict.get("bound") != "credit-limited":
                resolved = self.rail.observe(tp, source=source)
                if resolved is not None:
                    outcome = resolved["outcome"]  # accepted|reverted
                    self._counts[outcome] += 1
                    rec = self._append(
                        verdict, family=resolved["group"],
                        knob=resolved["key"], old=resolved["old"],
                        new=resolved["new"], outcome=outcome,
                        reverted=outcome == "reverted")
                    if outcome == "reverted":
                        # the reverted epoch ran under the bad value:
                        # no new trial from its stats (the autotuner's
                        # double-count fix, same rail, same reason) —
                        # the revert record IS this epoch's decision
                        record = rec
            if record is None:
                record = self._decide(verdict, source=source)
            self._counts["decisions"] += 1
            self.rail.advance(source)
            self._observed += 1
        return record

    # -- the policy

    def _decide(self, verdict: Dict[str, Any],
                source: Any = None) -> Dict[str, Any]:
        bound = verdict.get("bound")
        if bound == "credit-limited":
            # freeze ALL knobs: the wall rates reflect the credit
            # scheduler; a tuner that keeps moving chases the climate
            self.rail.freeze_all(self._knobs, source=source)
            self._counts["freezes"] += 1
            return self._append(verdict, outcome="freeze")
        family = FAMILY_FOR_BOUND.get(bound)
        if family is None:  # consumer (or an unknown future bound)
            self._counts["noops"] += 1
            return self._append(verdict, outcome="no-op")
        if self.rail.exhausted(family, source=source):
            self._counts["exhausted"] += 1
            return self._append(verdict, family=family,
                                outcome="family-exhausted")
        if self.rail.pending is not None:
            # a trial from another source is mid-flight: one mover per
            # process — record the abstention rather than double-move
            self._counts["noops"] += 1
            return self._append(verdict, family=family, outcome="no-op")
        # eligible knobs: process-global ones (wire options, manual
        # knobs) plus the OBSERVED pipeline's own — another pipeline's
        # knob cannot affect this source's throughput, so trialing it
        # here would void the rail's revert guarantee (the move would
        # be judged by rates it cannot change)
        owner_pipe = self._adopted.get(source) \
            if isinstance(source, str) else None
        for knob in self._knobs.values():
            if knob.family != family or self.rail.frozen(knob.name):
                continue
            if knob.owner is not None and knob.owner() is not owner_pipe:
                continue
            cur = knob.get()
            new = knob.grow_value(cur)
            if new == cur:
                continue  # no headroom on this knob; try the next
            knob.set(new)
            self.rail.begin(knob.name, cur, new, knob.set,
                            group=family, source=source)
            self._counts["trials"] += 1
            return self._append(verdict, family=family, knob=knob.name,
                                old=cur, new=new, outcome="trial")
        self._counts["noops"] += 1
        return self._append(verdict, family=family, outcome="no-op")

    # -- the ledger + its emission surfaces

    def _append(self, verdict: Dict[str, Any],
                family: Optional[str] = None,
                knob: Optional[str] = None,
                old: Optional[int] = None, new: Optional[int] = None,
                outcome: str = "no-op",
                reverted: bool = False) -> Dict[str, Any]:
        record = {
            "epoch": verdict.get("epoch"),
            "verdict_id": verdict.get("verdict_id"),
            # schema-4 verdicts name the tenant whose epoch moved the
            # knob — the ledger answers "who caused this move", not
            # just "what evidence" (None for untenanted pipelines)
            "tenant": verdict.get("tenant"),
            "bound": verdict.get("bound"),
            "band": verdict.get("band"),
            "evidence": list(verdict.get("evidence")
                             or [])[:_EVIDENCE_PER_RECORD],
            "family": family,
            "knob": knob,
            "old": old,
            "new": new,
            "outcome": outcome,
            "reverted": reverted,
        }
        self.ledger.append(record)
        try:  # the decision rides the shared timeline next to the
            # stalls/retries/faults that explain it
            from dmlc_tpu_torch.obs import trace as _trace
            _trace.instant(f"control/{family or outcome}", "control",
                           {"outcome": outcome, "bound": record["bound"],
                            "knob": knob, "old": old, "new": new,
                            "verdict_id": record["verdict_id"]})
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass
        return record

    def _delta_metrics(self, source: Any = None) -> Dict[str, Any]:
        snap = self.registry.snapshot()
        counters = dict(snap.get("counters") or {})
        # baselines are keyed PER SOURCE: two interleaved pipelines'
        # epochs must each be scoped against their OWN previous epoch,
        # or pipeline A's verdict would carry B's wire bytes
        prev = self._prev_counters.get(source)
        self._prev_counters[source] = counters
        snap = dict(snap)
        if prev:
            snap["counters"] = {
                k: (v - prev[k] if isinstance(v, (int, float))
                    and isinstance(prev.get(k), (int, float)) else v)
                for k, v in counters.items()}
        else:
            # a source's FIRST epoch has no baseline: cumulative
            # counters would blame pre-pipeline traffic (corpus
            # hydration at startup) on this epoch and move a wire
            # knob for it — no wire evidence beats wrong evidence
            snap["counters"] = {}
        return snap

    def _collect(self) -> Dict[str, Any]:
        """The registry collector ("control"): numeric leaves the
        GangAggregator rolls up — every rank's decision cadence on one
        wall-anchored timeline."""
        with self._lock:
            self._prune_locked()
            out: Dict[str, Any] = {"epoch": self._observed}
            out.update(self._counts)
            out["knobs"] = {name: k.get()
                            for name, k in self._knobs.items()}
        return out

    def to_dict(self, last: Optional[int] = None) -> Dict[str, Any]:
        """The /control payload (and the flight bundle's
        control.json)."""
        with self._lock:
            self._prune_locked()
            families: Dict[str, Dict[str, Any]] = {}
            for name, k in self._knobs.items():
                fam = families.setdefault(k.family, {
                    "knobs": [],
                    "reverts": self.rail.reverts_total(k.family)})
                fam["knobs"].append(name)
            knobs = {name: {"family": k.family, "value": k.get(),
                            "initial": k.initial, "lo": k.lo, "hi": k.hi,
                            "frozen": self.rail.frozen(name)}
                     for name, k in self._knobs.items()}
            counts = dict(self._counts)
            epoch = self._observed
        return {
            "schema": CONTROL_SCHEMA,
            "epoch": epoch,
            "counts": counts,
            "families": families,
            "knobs": knobs,
            "ledger": self.ledger.to_dict(last=last),
        }

    def suspend_collector(self) -> None:
        """Unregister the "control" registry collector (detach():
        a suspended controller must not shadow the live one's gang/
        metrics surface — obsctl gang reads ``collectors.control.*``
        by name)."""
        if self._metrics_key is not None:
            self.registry.unregister(self._metrics_key)
            self._metrics_key = None

    def resume_collector(self) -> None:
        if self._metrics_key is None:
            self._metrics_key = self.registry.register(
                "control", self, Controller._collect)

    def close(self) -> None:
        self.suspend_collector()


# ------------------------------------------------------------ module plane

_controller: Optional[Controller] = None


def active() -> Optional[Controller]:
    return _controller


def install(controller: Optional[Controller] = None,
            **kwargs: Any) -> Controller:
    """Install the process controller (idempotent: a second call
    returns the running one). With no argument, a controller over the
    wire-family knobs is built — pipelines join by adoption when they
    complete epochs."""
    global _controller
    if _controller is not None:
        return _controller
    if controller is None:
        controller = Controller(objstore_knobs(), **kwargs)
    controller.resume_collector()  # no-op unless detach()ed before
    _controller = controller
    return _controller


def uninstall() -> None:
    global _controller
    ctl, _controller = _controller, None
    if ctl is not None:
        ctl.close()


def detach() -> Optional[Controller]:
    """Suspend the installed controller WITHOUT closing it — returns
    it so the caller can ``install()`` it back. For probes that must
    run a pipeline under their OWN controller (bench config 16): two
    movers on one pipeline would break the one-mover-per-process
    invariant and judge each other's trials. The suspended
    controller's registry collector is unregistered (so the caller's
    own controller owns the "control" name) and re-registered by
    ``install()``."""
    global _controller
    ctl, _controller = _controller, None
    if ctl is not None:
        ctl.suspend_collector()
    return ctl


def install_if_env() -> Optional[Controller]:
    """Gang-worker hook (one line, like serve_if_env): install the
    controller when ``DMLC_TPU_CONTROL`` is set non-zero —
    ``launch_local(control=True)`` sets it per worker — else no-op."""
    raw = os.environ.get(ENV_CONTROL)
    if not raw or raw.strip() in ("0", "false", "no"):
        return None
    return install()


def membership_record(event: str, gang: str, epoch: int,
                      old_world: int, new_world: int,
                      member: Optional[str] = None,
                      rank: Optional[int] = None,
                      ) -> Optional[Dict[str, Any]]:
    """Land a gang-membership change on the decision ledger
    (rendezvous plane: join/leave/death/reshard). Membership moves are
    DECISIONS about the run's shape — world size is the knob, the
    membership epoch is the evidence — so they share the pinned
    RECORD_KEYS schema and render in ``obsctl control`` next to the
    verdict-driven moves they often explain (a reshard is why the
    next epoch's wire bytes moved). ``verdict_id`` cites the
    membership epoch (``m<epoch>-<gang>``) the way knob records cite
    the verdict that caused them. No-op (returns None) without an
    installed controller — membership is observable on /gang and the
    trace regardless."""
    ctl = active()
    if ctl is None:
        return None
    record = {
        "epoch": int(epoch),
        "verdict_id": f"m{int(epoch)}-{gang}",
        "tenant": None,
        "bound": "membership",
        "band": None,
        "evidence": [f"membership epoch {int(epoch)}: {event}"
                     + (f" of {member}" if member else "")
                     + f", world {int(old_world)} -> "
                       f"{int(new_world)}"
                     + (f" (rank {rank})" if rank is not None
                        else "")],
        "family": "gang",
        "knob": "membership",
        "old": int(old_world),
        "new": int(new_world),
        "outcome": event,
        "reverted": False,
    }
    ctl.ledger.append(record)
    return record
