"""Between-epoch depth autotuning from stage telemetry.

Counterpart of ``dmlc_tpu/pipeline/autotune.py``, copied whole (it has no
JAX in it). The verdict-driven controller named below
(``dmlc_tpu.obs.control``) is not ported: here the Autotuner is the only
mover of a pipeline's knobs.

Replaces the hard-coded queue depths the hand-wired stacks carried
(``ThreadedIter(max_capacity=4)``, the bench loop's fixed ``> 4``
in-flight device window, ``depth(chunkq=3, reorder=2)`` in BENCH logs)
with measured decisions: after every completed epoch the tuner reads the
pipeline's stats snapshot (``dmlc_tpu_torch.pipeline.stats``) and adjusts at
most ONE knob, then watches the next epoch's throughput to keep or
revert the change.

Model (deliberately simple — one trial per epoch keeps every decision
attributable):

- A queue whose mean occupancy is near its capacity is *producer-ahead*:
  the producer fills it and blocks. Growing it lets the producer run
  further ahead and absorbs consumer bursts → trial ``depth *= 2``.
- A queue that is near-empty while its consumer still waits on it is
  *producer-bound*: depth cannot help; a near-empty queue with NO
  consumer wait is over-provisioned → trial ``depth //= 2`` (memory
  thrift).
- A windowed transfer stage (``to_device``) whose transfer-drain wait
  dominates grows its in-flight window.
- Any trial whose next-epoch throughput drops below
  ``revert_tolerance`` × the best accepted throughput is reverted and
  the knob is frozen for ``cooldown`` epochs. The reverted epoch's
  stats were measured under the BAD knob value, so they neither set
  the throughput reference nor seed the next trial — proposing from
  them double-counted the regression into the following decision.
- Stages that replay (cache/shard) stamp ``extra.replay_tier``
  ("parse" | "memory" | "pages") into their snapshot; when the tier
  serving an epoch CHANGES (e.g. a re-parse epoch after a mutation, or
  the first page-replay epoch — regimes ~5× apart in throughput), the
  pending trial is discarded (knob restored, no freeze) and the best-
  throughput reference resets, so a knob is never credited or blamed
  for a tier flip.

The accept/revert/cooldown machinery itself is :class:`ExplorationRail`
— the safe-exploration rails shared with the verdict-driven controller
(:mod:`dmlc_tpu.obs.control`), which generalizes them with per-family
revert budgets. The Autotuner keeps the local per-knob heuristics; the
controller owns the global "WHICH family" judgment (the bound verdict).

Convergence: knob values are clamped to [lo, hi] and every accept/revert
is recorded in ``report()`` — on a steady workload the tuner reaches a
fixed point (tests/test_pipeline.py pins this on a synthetic slow
stage).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from dmlc_tpu_torch.utils.logging import check

__all__ = ["Knob", "Autotuner", "ExplorationRail", "epoch_throughput",
           "tier_signature"]


def epoch_throughput(snapshot: Dict[str, Any]) -> float:
    """Epoch objective: sink-stage bytes/s (falls back to items/s
    ×1.0 when the sink reports no bytes — same ordering either
    way). The ONE throughput definition every exploration decision
    (Autotuner and controller alike) is judged by."""
    wall = snapshot.get("wall_s") or 0.0
    if wall <= 0:
        return 0.0
    stages = snapshot.get("stages") or []
    if not stages:
        return 0.0
    sink = stages[-1]
    vol = sink.get("bytes") or sink.get("items") or 0
    return vol / wall


def tier_signature(snapshot: Dict[str, Any]) -> tuple:
    """(stage, replay_tier) pairs for every tier-stamped stage —
    empty for pipelines without replaying stages, so the regime gate
    never fires for them."""
    return tuple(
        (s.get("name"), (s.get("extra") or {}).get("replay_tier"))
        for s in snapshot.get("stages") or []
        if (s.get("extra") or {}).get("replay_tier"))


class ExplorationRail:
    """Safe-exploration rails: one pending trial at a time, judged by
    the NEXT observation's throughput against the best accepted
    reference; revert + per-key cooldown on regression; optional
    per-group revert budgets (a group that keeps regressing is
    disabled); reference reset + trial discard on a regime change
    (replay-tier flip).

    Extracted from the Autotuner's revert/cooldown machinery so the
    verdict-driven controller (:mod:`dmlc_tpu.obs.control`) explores
    under the SAME guarantees. ``source`` keys the throughput
    reference (a controller watching two pipelines must not judge one
    by the other's rates); single-pipeline users leave it None.
    """

    def __init__(self, revert_tolerance: float = 0.9, cooldown: int = 3,
                 revert_budget: Optional[int] = None):
        check(0.0 < revert_tolerance <= 1.0,
              f"revert_tolerance must be in (0, 1], got {revert_tolerance}")
        check(cooldown >= 0, f"cooldown must be >= 0, got {cooldown}")
        self.revert_tolerance = revert_tolerance
        self.cooldown = cooldown
        self.revert_budget = revert_budget
        # epochs are PER SOURCE: with K pipelines observing one shared
        # rail, a global tick would expire every cooldown/freeze K×
        # faster than configured (each wall-epoch advances K times)
        self._epochs: Dict[Any, int] = {}
        self._best: Dict[Any, float] = {}      # source -> best accepted tp
        # key -> (source whose clock gates it, expiry epoch)
        self._frozen_until: Dict[str, tuple] = {}
        self._pending: Optional[Dict[str, Any]] = None
        # (group, source) -> revert count: budget charges ride the
        # charging source's lifetime (a dead pipeline's reverts must
        # not exhaust a family for every future pipeline)
        self._reverts: Dict[tuple, int] = {}
        self._regime: Dict[Any, tuple] = {}      # source -> last signature

    # -- state reads

    @property
    def epoch(self) -> int:
        return self._epochs.get(None, 0)

    def epoch_of(self, source: Any = None) -> int:
        return self._epochs.get(source, 0)

    @property
    def pending(self) -> Optional[Dict[str, Any]]:
        return self._pending

    def frozen(self, key: str) -> bool:
        gate = self._frozen_until.get(key)
        if gate is None:
            return False
        src, expiry = gate
        return self._epochs.get(src, 0) < expiry

    def exhausted(self, group: Optional[str],
                  source: Any = None) -> bool:
        """True when the group spent its revert budget for this source
        — its trials keep regressing, stop exploring it."""
        if group is None or self.revert_budget is None:
            return False
        return self._reverts.get((group, source), 0) >= \
            self.revert_budget

    def reverts(self, group: str, source: Any = None) -> int:
        return self._reverts.get((group, source), 0)

    def reverts_total(self, group: str) -> int:
        """Revert charges for the group summed across sources (the
        /control families view)."""
        return sum(v for (g, _), v in self._reverts.items()
                   if g == group)

    def best(self, source: Any = None) -> Optional[float]:
        return self._best.get(source)

    # -- trial lifecycle

    def begin(self, key: str, old: int, new: int,
              restore: Callable[[int], None], group: Optional[str] = None,
              source: Any = None, meta: Optional[Dict] = None) -> Dict:
        """Arm one trial (the caller already applied the new value).
        ``restore`` is called with ``old`` on revert/discard."""
        check(self._pending is None,
              "one trial at a time: resolve the pending trial first")
        self._pending = {"key": key, "group": group, "old": old,
                         "new": new, "restore": restore,
                         "source": source,
                         "epoch": self._epochs.get(source, 0),
                         "meta": meta or {}}
        return self._pending

    def note_regime(self, signature: tuple,
                    source: Any = None) -> Optional[Dict[str, Any]]:
        """Feed the epoch's regime signature (replay tiers). On a
        change: the throughput reference resets and any pending trial
        is DISCARDED (value restored, no freeze, no budget charge —
        the regime moved, not the knob). Returns the discarded trial
        or None."""
        prev = self._regime.get(source)
        self._regime[source] = signature
        if prev is None or signature == prev:
            return None
        self._best.pop(source, None)
        trial, self._pending = self._pending, None
        if trial is not None and trial["source"] == source:
            trial["restore"](trial["old"])
            trial["outcome"] = "discarded (replay tier changed)"
            return trial
        if trial is not None:
            self._pending = trial  # different source: keep it pending
        return None

    def observe(self, tp: float,
                source: Any = None) -> Optional[Dict[str, Any]]:
        """Feed one completed epoch's throughput. Resolves the pending
        trial for this source (accept, or revert + freeze + budget
        charge) and maintains the best-throughput reference. Returns
        the resolved trial dict (with ``outcome``/``throughput``) or
        None when no trial was pending."""
        trial = self._pending
        if trial is None or trial["source"] != source:
            best = self._best.get(source)
            if best is None or tp > best:
                self._best[source] = tp
            return None
        self._pending = None
        best = self._best.get(source)
        if best is not None and tp < self.revert_tolerance * best:
            trial["restore"](trial["old"])
            self.freeze(trial["key"], source=source)
            if trial["group"] is not None:
                k = (trial["group"], trial["source"])
                self._reverts[k] = self._reverts.get(k, 0) + 1
            trial["outcome"] = "reverted"
        else:
            trial["outcome"] = "accepted"
            if best is None or tp > best:
                self._best[source] = tp
        trial["throughput"] = round(tp, 2)
        return trial

    def cancel(self, key: str) -> Optional[Dict[str, Any]]:
        """Drop the pending trial for ``key`` without restore, freeze,
        or budget charge — the knob's owner is gone, there is nothing
        left to judge or restore. Returns the cancelled trial."""
        if self._pending is not None and self._pending["key"] == key:
            trial, self._pending = self._pending, None
            return trial
        return None

    def discard(self, source: Any = None) -> Optional[Dict[str, Any]]:
        """Discard this source's pending trial: value RESTORED, no
        freeze, no budget charge — the epoch that would have judged it
        measured something else (a drained credit bucket, a regime
        flip). Returns the discarded trial or None."""
        if self._pending is not None and self._pending["source"] == source:
            trial, self._pending = self._pending, None
            trial["restore"](trial["old"])
            trial["outcome"] = "discarded"
            return trial
        return None

    def drop_source(self, source: Any) -> None:
        """Forget a source entirely (its pipeline is gone): throughput
        reference, regime signature, revert charges, and any pending
        trial — a NEW pipeline that lands on a recycled source key
        must never be judged against a dead one's best, nor inherit a
        family exhausted by a ghost's reverts. The pending trial IS
        restored: a process-global knob trialed on the dead source's
        behalf (dead-owner knobs go through :meth:`cancel` first)
        would otherwise be left at its unjudged trial value forever."""
        self._best.pop(source, None)
        self._regime.pop(source, None)
        self._epochs.pop(source, None)
        for key in [k for k in self._reverts if k[1] == source]:
            del self._reverts[key]
        # freezes gated by the dead source's clock would never thaw
        # (its clock stops): release them
        for key in [k for k, (src, _) in self._frozen_until.items()
                    if src == source]:
            del self._frozen_until[key]
        if self._pending is not None and self._pending["source"] == source:
            trial, self._pending = self._pending, None
            trial["restore"](trial["old"])

    def freeze(self, key: str, epochs: Optional[int] = None,
               source: Any = None) -> None:
        """Freeze a knob for ``epochs`` (default cooldown) ticks of
        ``source``'s clock — the clock of whoever observed the
        condition, so another source's faster cadence cannot thaw it
        early."""
        self._frozen_until[key] = (source, self._epochs.get(source, 0)
                                   + (self.cooldown if epochs is None
                                      else epochs))

    def freeze_all(self, keys, epochs: Optional[int] = None,
                   source: Any = None) -> None:
        """The climate freeze: stop every knob for ``epochs`` (default
        cooldown) — a credit-limited verdict means wall rates reflect
        the scheduler, and chasing them would thrash."""
        for key in keys:
            self.freeze(key, epochs, source=source)

    def advance(self, source: Any = None) -> None:
        self._epochs[source] = self._epochs.get(source, 0) + 1


class Knob:
    """One tunable integer depth bound to a live pipeline object."""

    __slots__ = ("name", "stage", "get", "set", "lo", "hi", "initial")

    def __init__(self, name: str, stage: str, get: Callable[[], int],
                 set: Callable[[int], None], lo: int, hi: int):
        check(lo >= 1 and hi >= lo, f"knob {name}: bad bounds [{lo},{hi}]")
        self.name = name
        self.stage = stage  # probe name whose telemetry drives this knob
        self.get = get
        self.set = set
        self.lo = lo
        self.hi = hi
        self.initial = get()


class Autotuner:
    """One-trial-per-epoch hill climber over pipeline depth knobs,
    riding :class:`ExplorationRail` for accept/revert/cooldown."""

    def __init__(self, knobs: List[Knob], *,
                 grow_occupancy: float = 0.7,
                 shrink_occupancy: float = 0.15,
                 wait_frac_floor: float = 0.05,
                 revert_tolerance: float = 0.9,
                 cooldown: int = 3):
        self.knobs = list(knobs)
        self.grow_occupancy = grow_occupancy
        self.shrink_occupancy = shrink_occupancy
        self.wait_frac_floor = wait_frac_floor
        self.rail = ExplorationRail(revert_tolerance=revert_tolerance,
                                    cooldown=cooldown)
        self._log: List[Dict[str, Any]] = []

    # -- helpers

    @staticmethod
    def _stage(snapshot: Dict[str, Any], name: str) -> Optional[Dict]:
        for s in snapshot.get("stages", []):
            if s.get("name") == name:
                return s
        return None

    def _record(self, trial: Dict[str, Any]) -> None:
        self._log.append({k: trial[k] for k in
                          ("name", "epoch", "old", "new", "reason",
                           "outcome", "throughput") if k in trial})

    def _propose(self, snapshot: Dict[str, Any]) -> None:
        for knob in self.knobs:
            if self.rail.frozen(knob.name):
                continue
            stage = self._stage(snapshot, knob.stage)
            if stage is None:
                continue
            cur = knob.get()
            new = None
            reason = None
            occ = stage.get("queue_occupancy")
            if occ is not None:
                if occ >= self.grow_occupancy and cur < knob.hi:
                    new = min(cur * 2, knob.hi)
                    reason = f"occupancy {occ:.2f} ≥ {self.grow_occupancy}"
                elif (occ <= self.shrink_occupancy and cur > knob.lo
                      and (stage.get("wait_frac") or 0.0)
                      <= self.wait_frac_floor):
                    new = max(cur // 2, knob.lo)
                    reason = (f"occupancy {occ:.2f} ≤ "
                              f"{self.shrink_occupancy}, idle consumer")
            else:
                # windowed stage (to_device): grow while its drain wait
                # dominates the epoch
                extra = stage.get("extra") or {}
                xfer = extra.get("xfer_wait_s")
                wall = snapshot.get("wall_s") or 0.0
                if (xfer is not None and wall > 0
                        and xfer / wall > self.wait_frac_floor
                        and cur < knob.hi):
                    new = min(cur * 2, knob.hi)
                    reason = f"xfer wait {xfer / wall:.2f} of epoch"
            if new is not None and new != cur:
                knob.set(new)
                self.rail.begin(knob.name, cur, new, knob.set,
                                meta={"name": knob.name,
                                      "reason": reason})
                return  # one trial per epoch

    # -- public API

    def after_epoch(self, snapshot: Dict[str, Any]) -> None:
        """Feed one completed epoch's stats; may adjust one knob."""
        tp = epoch_throughput(snapshot)
        discarded = self.rail.note_regime(tier_signature(snapshot))
        if discarded is not None:
            # the serving tier flipped under this epoch: throughput is
            # a different regime (page replay vs parse differ ~5×) —
            # the rail restored the knob and reset the reference; the
            # discarded trial still proposes fresh from THIS epoch
            # (its stats describe the new regime honestly)
            discarded.update(name=discarded["key"],
                             epoch=discarded["epoch"],
                             reason=discarded["meta"].get("reason"),
                             throughput=round(tp, 2))
            self._record(discarded)
        resolved = self.rail.observe(tp)
        if resolved is not None:
            resolved.update(name=resolved["key"],
                            epoch=resolved["epoch"],
                            reason=resolved["meta"].get("reason"))
            self._record(resolved)
        if resolved is None or resolved["outcome"] != "reverted":
            self._propose(snapshot)
        # else: the reverted epoch ran under the BAD knob value — its
        # occupancies/waits must not seed the next trial (the latent
        # double-count); the next clean epoch proposes instead
        self.rail.advance()

    def values(self) -> Dict[str, int]:
        return {k.name: k.get() for k in self.knobs}

    def tuned(self) -> Dict[str, int]:
        """Knobs whose current value differs from their initial one —
        the 'set by the autotuner rather than a constant' evidence."""
        return {k.name: k.get() for k in self.knobs
                if k.get() != k.initial}

    def converged(self, last_n: int = 3) -> bool:
        """No accepted change in the last ``last_n`` decisions (or no
        decisions at all and no trial pending)."""
        if self.rail.pending is not None:
            return False
        recent = self._log[-last_n:]
        return all(d["outcome"] != "accepted" for d in recent) \
            if recent else self.rail.epoch >= last_n

    def report(self) -> Dict[str, Any]:
        best = self.rail.best()
        return {
            "epochs": self.rail.epoch,
            "values": self.values(),
            "initial": {k.name: k.initial for k in self.knobs},
            "tuned": self.tuned(),
            "decisions": list(self._log),
            "best_throughput": (round(best, 2)
                                if best is not None else None),
        }
