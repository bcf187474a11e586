"""Process-wide multi-tenant pipeline scheduler: many pipelines, one

Copy of ``dmlc_tpu/pipeline/scheduler.py`` with its imports rewritten
to ``dmlc_tpu_torch``.

process, shared budgets.

Every ``CompiledPipeline`` before this module owned its own constants —
reader threads, chunk-prefetch queues, prefetch depths — sized as if it
were alone on the machine. N concurrent pipelines on a small box then
oversubscribe each other into mutual starvation: every tenant's queues
grow, every tenant's p99 dies, and nobody can say who ate the budget.
The :class:`PipelineScheduler` makes the budgets PROCESS-wide and
time-slices them across registered *tenants*:

- **Pull credits, deficit-round-robin.** Every batch a tenant's
  pipeline delivers costs one credit. Each tenant holds a deficit
  counter replenished by ``quantum × weight`` per *round*; a round
  advances when no active tenant can pay, and at latest every
  ``round_period_s`` — so a lone tenant runs effectively unthrottled
  (work conservation), competing saturators interleave in weight
  proportion, and every tenant keeps a guaranteed FLOOR of
  ``quantum × weight`` credits per round period no matter how a peer
  dribbles its hoard. An idle tenant retains up to its burst
  allowance (``burst × quantum × weight``), so a provisioned
  latency-sensitive tenant's whole sparse burst clears without ever
  going broke mid-burst (the p99 story); a saturating tenant is
  throttled the moment a peer demands its share.
- **Backpressure, not buffering.** A credit-blocked tenant stops
  pulling; its bounded queues fill; its producer threads block; its
  readers go idle — the throttle propagates UP the pipeline instead of
  letting a hot tenant's queues eat the shared arena pool. The
  scheduler also owns the queue-capacity knobs of every admitted
  pipeline (``parse.chunk_prefetch`` / ``prefetch.depth`` /
  ``shard.prefetch``): ``queue_budget`` items are divided across
  tenants by weight and across each tenant's pipelines evenly, so
  admission of a new tenant SHRINKS everyone's slack instead of
  growing the process footprint.
- **Admission control.** ``register_tenant(max_pipelines=...)`` caps
  each tenant's live pipelines; past the cap :meth:`admit` rejects
  (:class:`AdmissionError`) or queues (``admission="queue"``) until a
  slot frees. ``pause()``/``resume()`` administratively suspend a
  tenant (its pulls block, watchdog-visible).
- **Yield points.** The DRR grant grain is the batch, and one batch of
  a Python-parsed tenant can be seconds of GIL-holding work that no
  credit can interrupt: a latency tenant sharing the process then
  waits a GIL switch interval for every hand-off of its own pull. So a
  pull runs under :meth:`PipelineScheduler.pulling`, which puts a
  yield point on the serving thread (``utils.concurrency``): the
  golden text parsers call it every few records. At a yield point, and
  in :meth:`~PipelineScheduler.acquire`, a tenant waits while it is
  paused (a pause now lands mid-batch, at a record boundary), and
  while a tenant of HIGHER weight has a pull in flight — for at most
  ``PREEMPT_S`` of that pull, so a heavier tenant whose pull waits on
  a wire or a writer holds nobody for long. Equal weights never
  preempt each other: among them DRR alone decides.
- **Per-tenant accounting.** Counters/histograms land in the metrics
  registry under ``tenant.<name>.*`` (pulls, rows, bytes, credit
  waits, a batch-latency histogram whose p50/p99 render in
  ``/metrics``), epoch snapshots are stamped with a ``tenant`` label
  so :mod:`dmlc_tpu_torch.obs.analyze` emits per-tenant bound verdicts, and
  ``GET /tenants`` (:mod:`dmlc_tpu_torch.obs.serve`) renders one row per
  tenant: budget, credits, queue share, p99, watermark, last verdict.
  A credit-blocked pull registers with the stall watchdog as
  ``tenant/<name>.credits`` — a stall report NAMES the starved tenant.

Wiring mirrors the obs planes: :func:`install` /
:func:`install_if_env` under ``DMLC_TPU_SCHED``
(``launch_local(scheduler=...)`` exports it), one scheduler per
process, ``Pipeline.build(tenant="...")`` admits the compiled
pipeline and routes every delivered batch through
:meth:`PipelineScheduler.acquire`.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional

from dmlc_tpu_torch.obs import watchdog as _watchdog
from dmlc_tpu_torch.obs.metrics import REGISTRY as _METRICS
from dmlc_tpu_torch.utils.concurrency import set_yield_hook
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["PipelineScheduler", "AdmissionError", "active", "install",
           "uninstall", "install_if_env", "ENV_SCHED", "MANAGED_KNOBS",
           "TENANTS_SCHEMA"]

# env contract (parallel.launch.launch_local(scheduler=...) sets it):
# "1" installs defaults; "quantum=4,queue=48,burst=2" overrides, plus
# per-tenant SLO declarations as "slo.<tenant>=<target>[:<window>
# [:<budget>]]" (e.g. "quantum=2,slo.victim=0.15:300:0.01")
ENV_SCHED = "DMLC_TPU_SCHED"

# bump when to_dict()'s top-level shape changes incompatibly
TENANTS_SCHEMA = 1

# the queue-capacity knobs the scheduler owns for admitted pipelines
# (Pipeline.build(tenant=...) withholds these from the autotuner —
# one owner per knob, the controller-adoption rule)
MANAGED_KNOBS = ("parse.chunk_prefetch", "prefetch.depth",
                 "shard.prefetch")

# how long one pull of a heavier tenant holds lighter tenants at their
# yield points: a latency tenant's pull (config 19's victim: 7-13 ms on
# the H100 host) is covered whole, and a heavier pull that waits on a
# wire or a writer costs each lighter tenant at most this much
PREEMPT_S = 0.05


class AdmissionError(DMLCError):
    """A tenant is past its pipeline budget (or the queue timed out)."""


class _Tenant:
    """Internal per-tenant ledger (scheduler-lock protected)."""

    __slots__ = ("name", "weight", "max_pipelines", "admission",
                 "deficit", "demand", "last_demand", "paused", "pulls",
                 "rows", "bytes", "credit_waits", "credit_wait_s",
                 "admitted", "rejected", "queued", "queue_share",
                 "last_snapshot", "last_verdict", "slo")

    def __init__(self, name: str, weight: float, max_pipelines: int,
                 admission: str):
        self.name = name
        # the tenant's declared latency objective spec (None until
        # register_tenant(slo=...) declares one)
        self.slo: Optional[Dict[str, Any]] = None
        self.weight = weight
        self.max_pipelines = max_pipelines
        self.admission = admission
        self.deficit = 0.0
        self.demand = 0          # threads currently inside acquire()
        self.last_demand = 0.0   # monotonic stamp of the last acquire
        self.paused = False
        self.pulls = 0
        self.rows = 0
        self.bytes = 0
        self.credit_waits = 0
        self.credit_wait_s = 0.0
        self.admitted = 0
        self.rejected = 0
        self.queued = 0
        self.queue_share = None
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self.last_verdict: Optional[Dict[str, Any]] = None


class PipelineScheduler:
    """Deficit-round-robin fair queueing over pull credits + shared
    queue budgets + per-tenant admission (see the module docstring)."""

    def __init__(self, *, quantum: float = 4.0, burst: float = 2.0,
                 queue_budget: int = 48,
                 active_horizon_s: float = 0.25,
                 round_period_s: float = 0.1, registry=None):
        check(quantum > 0, "scheduler: quantum must be > 0")
        check(burst >= 1.0, "scheduler: burst must be >= 1")
        check(queue_budget >= 1, "scheduler: queue_budget must be >= 1")
        check(active_horizon_s > 0,
              "scheduler: active_horizon_s must be > 0")
        self.quantum = float(quantum)
        self.burst = float(burst)
        self.queue_budget = int(queue_budget)
        # a tenant stays on the DRR active list for this long after
        # its last pull: between two pulls a tenant is OUTSIDE
        # acquire() (it is parsing the batch it just paid for), and a
        # round that advanced the moment nobody was mid-call would
        # hand a saturator unlimited credit the instant its peers
        # touched their own work. The horizon is also the bound on
        # how long a vanished tenant can hold the round back.
        self.active_horizon_s = float(active_horizon_s)
        # rounds also advance on a clock: a tenant holding unspent
        # credits but pulling slowly (a wire tenant mid-hydration, a
        # bursty interactive tenant trickling its hoard) must not
        # stall broke peers indefinitely — at latest every
        # round_period_s everyone active is replenished, so each
        # tenant's guaranteed FLOOR is quantum x weight credits per
        # round period (a rate), bursts ride the deficit cap, and
        # back-to-back rounds stay work-conserving when every
        # demander is broke.
        check(round_period_s > 0,
              "scheduler: round_period_s must be > 0")
        self.round_period_s = float(round_period_s)
        self.preempt_s = PREEMPT_S
        # the pulls in flight, as (weight, monotonic start) per token;
        # _inflight_view is the same, rebuilt under the lock so the
        # yield point's fast path reads it without taking the lock
        self._inflight: Dict[int, tuple] = {}
        self._inflight_view: tuple = ()
        self._last_round = time.monotonic()
        self._registry = registry if registry is not None else _METRICS
        self._cond = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        # id(pipe) -> (weakref(pipe), tenant name): weak so a pipeline
        # that forgets close() still frees its admission slot
        self._pipes: Dict[int, tuple] = {}
        self.rounds = 0
        self._closed = False
        # one compact numeric collector: per-tenant occupancy of the
        # shared plane next to queue/engine stats in one snapshot
        self._metrics_key = self._registry.register(
            "scheduler", self, PipelineScheduler._collect)

    # ------------------------------------------------------ tenants

    def register_tenant(self, name: str, *, weight: float = 1.0,
                        max_pipelines: int = 4,
                        admission: str = "reject",
                        slo: Any = None) -> str:
        """Create (or re-weight) a tenant. ``admission`` is the
        over-budget policy for :meth:`admit`: "reject" raises
        :class:`AdmissionError`, "queue" blocks until a slot frees.

        ``slo`` declares the tenant's batch-latency objective — a
        float target in seconds, or a dict with ``target_s`` (or
        ``target``) plus optional ``window_s``/``budget`` — judged
        live by :mod:`dmlc_tpu_torch.obs.slo` over the tenant's existing
        ``tenant.<name>.batch_s`` histogram ("declare a target instead
        of hand-tuning a weight"; the judgment only, no knob moves on
        it). Declaring
        also gives the histogram SLO-aware bucket bounds, so
        attainment at the target is judged exactly — declare BEFORE
        the tenant's first batch."""
        check(weight > 0, f"tenant {name!r}: weight must be > 0")
        check(max_pipelines >= 1,
              f"tenant {name!r}: max_pipelines must be >= 1")
        check(admission in ("reject", "queue"),
              f"tenant {name!r}: admission must be 'reject' or 'queue'")
        spec = self._slo_spec(name, slo) if slo is not None else None
        with self._cond:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = _Tenant(
                    name, weight, max_pipelines, admission)
            else:
                t.weight = weight
                t.max_pipelines = max_pipelines
                t.admission = admission
            if spec is not None:
                t.slo = spec
            self._rebalance_locked()
        if spec is not None:
            self._declare_slo(name, spec)
        return name

    # tenants DECLARE objectives at admission time
    add_tenant = register_tenant

    @staticmethod
    def _slo_spec(name: str, slo: Any) -> Dict[str, Any]:
        """Normalize the ``slo=`` shorthand (float target, or a dict
        with target/window/budget) into the obs.slo register() spec."""
        if isinstance(slo, (int, float)):
            slo = {"target_s": float(slo)}
        check(isinstance(slo, dict),
              f"tenant {name!r}: slo must be a target (seconds) or a "
              f"dict, got {type(slo).__name__}")
        spec: Dict[str, Any] = {}
        target = slo.get("target_s", slo.get("target"))
        check(target is not None and float(target) > 0,
              f"tenant {name!r}: slo needs a positive 'target_s'")
        spec["target_s"] = float(target)
        if slo.get("window_s") is not None:
            spec["window_s"] = float(slo["window_s"])
        if slo.get("budget") is not None:
            spec["budget"] = float(slo["budget"])
        unknown = set(slo) - {"target_s", "target", "window_s",
                              "budget"}
        check(not unknown,
              f"tenant {name!r}: unknown slo keys {sorted(unknown)}")
        return spec

    def _declare_slo(self, name: str, spec: Dict[str, Any]) -> None:
        """Register the tenant's objective with the SLO engine. Order
        matters: the SLO-aware bounded histogram is created FIRST so
        the engine's baseline sample sees the bucketing the judgment
        will use (bounds apply only at creation — an already-observed
        histogram keeps its buckets, and the judgment error is then
        bounded by one log2 bucket width instead of zero)."""
        from dmlc_tpu_torch.obs import slo as _slo
        self._registry.histogram(f"tenant.{name}.batch_s",
                                 bounds=_slo.latency_bounds(
                                     spec["target_s"]))
        eng = _slo.active()
        if eng is None:
            eng = _slo.install(registry=self._registry)
        objective = re.sub(r"[^a-z0-9_.\-]", "_",
                           f"tenant.{name}".lower())
        eng.register(objective, metric=f"tenant.{name}.batch_s",
                     tenant=name, **spec)

    def tenants(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise DMLCError(
                f"scheduler: unknown tenant {name!r} (register_tenant "
                "first; registered: " + ", ".join(sorted(self._tenants))
                + ")")
        return t

    def pause(self, name: str) -> None:
        """Administratively suspend a tenant: its pulls block (the
        wait is watchdog-registered as ``tenant/<name>.paused``)."""
        with self._cond:
            self._tenant(name).paused = True
            self._cond.notify_all()

    def resume(self, name: str) -> None:
        with self._cond:
            self._tenant(name).paused = False
            self._cond.notify_all()

    # ---------------------------------------------------- admission

    def _live_pipes_locked(self, name: str) -> int:
        n = 0
        for pid, (ref, tname) in list(self._pipes.items()):
            if ref() is None:
                del self._pipes[pid]       # GC'ed without close()
            elif tname == name:
                n += 1
        return n

    def admit(self, tenant: str, pipe: Any,
              timeout_s: Optional[float] = 30.0) -> None:
        """Admit one compiled pipeline under ``tenant``'s budget.
        Past ``max_pipelines``: reject (:class:`AdmissionError`) or —
        ``admission="queue"`` — block until a slot frees (bounded by
        ``timeout_s``)."""
        with self._cond:
            t = self._tenant(tenant)
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            queued = False
            while self._live_pipes_locked(tenant) >= t.max_pipelines:
                if t.admission != "queue":
                    t.rejected += 1
                    self._count(tenant, "rejected")
                    raise AdmissionError(
                        f"tenant {tenant!r} is at its pipeline budget "
                        f"({t.max_pipelines}); close one or raise "
                        "max_pipelines")
                if not queued:
                    queued = True
                    t.queued += 1
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    t.rejected += 1
                    self._count(tenant, "rejected")
                    raise AdmissionError(
                        f"tenant {tenant!r}: admission queue timed out "
                        f"after {timeout_s}s at budget "
                        f"{t.max_pipelines}")
                # the detail fn runs on the WATCHDOG thread without
                # this lock: it must only read (the mutating
                # _live_pipes_locked would race its dead-ref deletes
                # against lock-holding callers)
                token = _watchdog.begin_wait(
                    f"tenant/{tenant}.admission",
                    lambda: {"tenant": tenant,
                             "live": sum(
                                 1 for ref, tn in
                                 list(self._pipes.values())
                                 if tn == tenant
                                 and ref() is not None),
                             "budget": t.max_pipelines})
                try:
                    self._cond.wait(
                        timeout=min(0.25, remaining)
                        if remaining is not None else 0.25)
                finally:
                    _watchdog.end_wait(token)
            self._pipes[id(pipe)] = (weakref.ref(pipe), tenant)
            t.admitted += 1
            self._count(tenant, "admitted")
            self._rebalance_locked()

    def release(self, pipe: Any) -> None:
        """Free a pipeline's admission slot (CompiledPipeline.close)."""
        with self._cond:
            if self._pipes.pop(id(pipe), None) is not None:
                self._rebalance_locked()
                self._cond.notify_all()

    def _rebalance_locked(self) -> None:
        """Divide ``queue_budget`` across tenants (by weight) and each
        tenant's live pipelines (evenly), applying the shares through
        the pipelines' queue-capacity knobs. Runs on every admission-
        set change — a new tenant SHRINKS everyone's slack; the
        process's queued-item footprint stays bounded by the budget."""
        by_tenant: Dict[str, List[Any]] = {}
        for pid, (ref, tname) in list(self._pipes.items()):
            p = ref()
            if p is None:
                del self._pipes[pid]
                continue
            by_tenant.setdefault(tname, []).append(p)
        total_w = sum(self._tenants[n].weight for n in by_tenant)
        for name, pipes in by_tenant.items():
            t = self._tenants[name]
            share = max(1, int(self.queue_budget * t.weight
                               / max(total_w, 1e-9)))
            t.queue_share = share
            per_pipe = max(1, share // len(pipes))
            for p in pipes:
                for k in p.knobs():
                    if k.name in MANAGED_KNOBS:
                        k.set(max(k.lo, min(per_pipe, k.hi)))
        for name, t in self._tenants.items():
            if name not in by_tenant:
                t.queue_share = None

    # ------------------------------------------------- pull credits

    def acquire(self, tenant: str, cost: float = 1.0) -> None:
        """Charge one pull to the tenant, blocking under the DRR
        discipline when its deficit is spent and a competing tenant
        can still pay. The block registers with the stall watchdog as
        ``tenant/<name>.credits`` — a wedged tenant is NAMED in the
        stall report, not inferred. It also holds, uncharged, while a
        heavier tenant's pull is in flight (:meth:`yield_point`)."""
        t0: Optional[float] = None
        preempted = False
        with self._cond:
            t = self._tenant(tenant)
            # liveness: a cost past one burst allowance could never be
            # saved up (round replenishment caps at the burst)
            cost = min(float(cost), self.burst * self.quantum * t.weight)
            t.demand += 1
            t.last_demand = time.monotonic()
            try:
                while True:
                    if self._closed:
                        return
                    if t.paused:
                        t0 = t0 or time.perf_counter()
                        token = _watchdog.begin_wait(
                            f"tenant/{tenant}.paused",
                            lambda: {"tenant": tenant, "paused": True})
                        try:
                            self._cond.wait(timeout=0.25)
                        finally:
                            _watchdog.end_wait(token)
                        continue
                    held = self._preempt_left_locked(t)
                    if held > 0:
                        preempted = True
                        self._cond.wait(timeout=held)
                        continue
                    if t.deficit >= cost:
                        t.deficit -= cost
                        self._cond.notify_all()
                        break
                    # broke: advance the round only when NO other
                    # ACTIVE, unpaused tenant can still pay — else
                    # wait for them to spend their slice (fair
                    # queueing). "Active" spans the horizon, not just
                    # the instants a peer is inside acquire().
                    now = time.monotonic()
                    payable = any(
                        o is not t and not o.paused
                        and self._active_locked(o, now)
                        and o.deficit >= 1.0
                        for o in self._tenants.values())
                    if (not payable or now - self._last_round
                            >= self.round_period_s):
                        self._advance_round_locked()
                        continue
                    t0 = t0 or time.perf_counter()
                    t.credit_waits += 1
                    token = _watchdog.begin_wait(
                        f"tenant/{tenant}.credits",
                        lambda: {"tenant": tenant,
                                 "deficit": round(t.deficit, 2),
                                 "round": self.rounds})
                    try:
                        self._cond.wait(timeout=min(
                            0.25, max(0.005, self.round_period_s
                                      - (now - self._last_round))))
                    finally:
                        _watchdog.end_wait(token)
            finally:
                t.demand -= 1
                if t.demand == 0:
                    # classic DRR: an emptied queue leaves the active
                    # list; what an idle tenant can hoard is capped at
                    # its BURST allowance — enough that a provisioned
                    # latency tenant's whole sparse burst clears
                    # without ever going broke mid-burst, bounded so a
                    # long sleep is not an unbounded credit bank
                    t.deficit = min(t.deficit, self.burst
                                    * self.quantum * t.weight)
                self._cond.notify_all()
        if preempted:
            self._count(tenant, "preempt_waits")
        if t0 is not None:
            dt = time.perf_counter() - t0
            with self._cond:
                t.credit_wait_s += dt
            self._registry.histogram(
                f"tenant.{tenant}.credit_wait_s").observe(dt)

    # ------------------------------------------------ yield points

    @contextlib.contextmanager
    def pulling(self, tenant: str) -> Iterator[None]:
        """One pull of ``tenant`` in flight on this thread: lighter
        tenants hold at their yield points for its first ``preempt_s``,
        and this thread's own long Python loops reach
        :meth:`yield_point` (through ``utils.concurrency``'s hook)."""
        with self._cond:
            t = self._tenant(tenant)
            key = object()
            self._inflight[id(key)] = (t.weight, time.monotonic())
            self._inflight_view = tuple(self._inflight.values())
        prev = set_yield_hook(lambda: self.yield_point(tenant))
        try:
            yield
        finally:
            set_yield_hook(prev)
            with self._cond:
                del self._inflight[id(key)]
                self._inflight_view = tuple(self._inflight.values())
                self._cond.notify_all()

    def _preempt_left_locked(self, t: _Tenant) -> float:
        """Seconds ``t`` must still hold for a heavier tenant's pull in
        flight (0 when none holds it)."""
        now = time.monotonic()
        return max((self.preempt_s - (now - since)
                    for w, since in self._inflight.values()
                    if w > t.weight), default=0.0)

    def yield_point(self, tenant: str) -> None:
        """Hold ``tenant``'s running pull at a record boundary while it
        is paused, or while a heavier tenant's pull is in flight (at
        most ``preempt_s`` of that pull). Cheap when neither holds."""
        t = self._tenants.get(tenant)
        if t is None or (not t.paused and all(
                w <= t.weight for w, _ in self._inflight_view)):
            return
        waited = False
        with self._cond:
            while not self._closed:
                if t.paused:
                    token = _watchdog.begin_wait(
                        f"tenant/{tenant}.paused",
                        lambda: {"tenant": tenant, "paused": True})
                    try:
                        self._cond.wait(timeout=0.25)
                    finally:
                        _watchdog.end_wait(token)
                    continue
                held = self._preempt_left_locked(t)
                if held <= 0:
                    break
                waited = True
                self._cond.wait(timeout=held)
        if waited:
            self._count(tenant, "preempt_waits")

    def _active_locked(self, t: _Tenant, now: float) -> bool:
        return (t.demand > 0
                or now - t.last_demand < self.active_horizon_s)

    def _advance_round_locked(self) -> None:
        self.rounds += 1
        now = time.monotonic()
        self._last_round = now
        for t in self._tenants.values():
            if self._active_locked(t, now) and not t.paused:
                cap = self.burst * self.quantum * t.weight
                t.deficit = min(t.deficit + self.quantum * t.weight,
                                cap)
        self._cond.notify_all()

    # ----------------------------------------------- accounting

    def _count(self, tenant: str, what: str, n: int = 1) -> None:
        self._registry.counter(f"tenant.{tenant}.{what}").inc(n)

    def note_batch(self, tenant: str, wait_s: float,
                   rows: int = 0, nbytes: int = 0) -> None:
        """One delivered batch: per-tenant volume + latency. The
        latency histogram's p50/p99 are the ``/tenants`` row numbers
        (and render as ``dmlc_tenant_<name>_batch_s_p99`` gauges)."""
        with self._cond:
            t = self._tenant(tenant)
            t.pulls += 1
            t.rows += int(rows)
            t.bytes += int(nbytes)
        self._count(tenant, "pulls")
        self._registry.histogram(
            f"tenant.{tenant}.batch_s").observe(wait_s)

    def note_epoch(self, tenant: str,
                   snapshot: Optional[Dict[str, Any]]) -> None:
        """One completed epoch: store the tenant-stamped snapshot and
        derive its bound verdict (obs.analyze) so ``/tenants`` rows
        carry a last-verdict column per tenant."""
        if snapshot is None:
            return
        verdict = None
        try:
            from dmlc_tpu_torch.obs import analyze as _an
            verdict = _an.attribute(snapshot)
        except Exception:  # noqa: BLE001 — telemetry must not kill
            verdict = None
        with self._cond:
            t = self._tenant(tenant)
            t.last_snapshot = snapshot
            if verdict is not None:
                t.last_verdict = verdict

    # ----------------------------------------------- introspection

    def _tenant_row_locked(self, t: _Tenant) -> Dict[str, Any]:
        live = self._live_pipes_locked(t.name)
        row: Dict[str, Any] = {
            "weight": t.weight,
            "deficit": round(t.deficit, 2),
            "quantum": round(self.quantum * t.weight, 2),
            "paused": t.paused,
            "pipelines": live,
            "max_pipelines": t.max_pipelines,
            "admission": t.admission,
            "queue_share": t.queue_share,
            "pulls": t.pulls,
            "rows": t.rows,
            "bytes": t.bytes,
            "credit_waits": t.credit_waits,
            "credit_wait_s": round(t.credit_wait_s, 4),
            "admitted": t.admitted,
            "rejected": t.rejected,
            "queued": t.queued,
        }
        h = self._registry.histogram(f"tenant.{t.name}.batch_s")
        s = h.summary()
        row["batch_p50_s"] = s.get("p50")
        row["batch_p99_s"] = s.get("p99")
        row["batches"] = s.get("count")
        if t.slo is not None:
            # the declared objective (judged live on GET /slo)
            row["slo"] = dict(t.slo)
        # live queue occupancy + streaming watermark off the tenant's
        # admitted pipelines (weak reads; a dead ref just drops out)
        occ = []
        stream = None
        for pid, (ref, tname) in list(self._pipes.items()):
            p = ref()
            if p is None or tname != t.name:
                continue
            snap = getattr(p, "stats", lambda: None)()
            if snap:
                occ.extend(
                    st["queue_occupancy"]
                    for st in snap.get("stages") or []
                    if st.get("queue_occupancy") is not None)
            ss = getattr(p, "stream_stats", lambda: None)()
            if ss is not None:
                stream = ss
        row["queue_occupancy"] = (round(sum(occ) / len(occ), 3)
                                  if occ else None)
        if stream is not None:
            row["watermark"] = stream
        if t.last_verdict is not None:
            v = t.last_verdict
            row["last_verdict"] = {
                "verdict_id": v.get("verdict_id"),
                "bound": v.get("bound"),
                "band": v.get("band"),
                "confidence": v.get("confidence"),
            }
        return row

    def to_dict(self) -> Dict[str, Any]:
        """The ``/tenants`` payload: one row per tenant."""
        with self._cond:
            return {
                "schema": TENANTS_SCHEMA,
                "quantum": self.quantum,
                "burst": self.burst,
                "queue_budget": self.queue_budget,
                "rounds": self.rounds,
                "tenants": {name: self._tenant_row_locked(t)
                            for name, t in
                            sorted(self._tenants.items())},
            }

    def _collect(self) -> Dict[str, Any]:
        """Compact numeric collector shape for the metrics registry."""
        with self._cond:
            return {
                "rounds": self.rounds,
                "queue_budget": self.queue_budget,
                "tenants": {
                    name: {"deficit": round(t.deficit, 2),
                           "pipelines": self._live_pipes_locked(name),
                           "pulls": t.pulls,
                           "credit_waits": t.credit_waits,
                           "paused": t.paused}
                    for name, t in self._tenants.items()},
            }

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._metrics_key is not None:
            self._registry.unregister(self._metrics_key)
            self._metrics_key = None


# ------------------------------------------------- process wiring
# (the serve/flight/history/control install contract)

_active: Optional[PipelineScheduler] = None
_lock = threading.Lock()


def active() -> Optional[PipelineScheduler]:
    return _active


def install(scheduler: Optional[PipelineScheduler] = None,
            **opts: Any) -> PipelineScheduler:
    """Install the process scheduler (idempotent: a second call
    returns the running one, like obs.serve.serve)."""
    global _active
    with _lock:
        if _active is not None:
            return _active
        _active = (scheduler if scheduler is not None
                   else PipelineScheduler(**opts))
        return _active


def uninstall() -> None:
    global _active
    with _lock:
        sched, _active = _active, None
    if sched is not None:
        sched.close()


def install_if_env() -> Optional[PipelineScheduler]:
    """Gang-worker hook: install under ``DMLC_TPU_SCHED`` — "1"/"true"
    for defaults, or "quantum=4,queue=48,burst=2" overrides, plus
    ``slo.<tenant>=<target>[:<window>[:<budget>]]`` per-tenant SLO
    declarations — else no-op (launch_local(scheduler=...) sets the
    var per worker)."""
    raw = os.environ.get(ENV_SCHED, "").strip()
    if not raw or raw in ("0", "false"):
        return None
    opts: Dict[str, Any] = {}
    slos: Dict[str, Dict[str, Any]] = {}
    if raw not in ("1", "true"):
        try:
            for part in raw.split(","):
                k, _, v = part.partition("=")
                k = k.strip()
                if k == "quantum":
                    opts["quantum"] = float(v)
                elif k == "queue":
                    opts["queue_budget"] = int(v)
                elif k == "burst":
                    opts["burst"] = float(v)
                elif k.startswith("slo.") and k[len("slo."):]:
                    # slo.<tenant>=<target>[:<window>[:<budget>]]
                    fields = v.split(":")
                    if not 1 <= len(fields) <= 3:
                        raise ValueError(v)
                    spec: Dict[str, Any] = {
                        "target_s": float(fields[0])}
                    if len(fields) > 1:
                        spec["window_s"] = float(fields[1])
                    if len(fields) > 2:
                        spec["budget"] = float(fields[2])
                    slos[k[len("slo."):]] = spec
                else:
                    raise ValueError(k)
        except ValueError:
            from dmlc_tpu_torch.obs.log import warn_once
            warn_once("sched-env-malformed",
                      f"scheduler: malformed {ENV_SCHED}={raw!r} "
                      "(want '1' or 'quantum=4,queue=48,burst=2"
                      ",slo.victim=0.15:300:0.01'); "
                      "installing defaults", all_ranks=True)
            opts = {}
            slos = {}
    sched = install(**opts)
    for tenant, spec in slos.items():
        try:
            sched.register_tenant(tenant, slo=spec)
        except DMLCError as e:
            from dmlc_tpu_torch.obs.log import warn_once
            warn_once("sched-env-slo-rejected",
                      f"scheduler: {ENV_SCHED} slo.{tenant} rejected "
                      f"({e}); tenant registered without an objective",
                      all_ranks=True)
            sched.register_tenant(tenant)
    return sched
