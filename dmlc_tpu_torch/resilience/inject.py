"""Seeded, deterministic fault-injection plane.

Copy of ``dmlc_tpu/resilience/inject.py`` with its imports rewritten to
``dmlc_tpu_torch``: one spec and one seed fire the same sequence in both
packages (the per-clause ``random.Random`` seeding is the reference's).
The env contract is shared too (``DMLC_TPU_FAULTS``,
``DMLC_TPU_FAULT_SEED``), so a plan armed for a gang reaches workers of
either package.

Chaos that cannot be replayed cannot be debugged. A :class:`FaultPlan`
is a list of clauses — site pattern × fault type × trigger — armed
process-wide via :func:`install` (or :func:`install_if_env` under the
``DMLC_TPU_FAULTS`` env contract, which ``launch_local(faults=...)``
sets for every gang member, so a multi-process gang provokes IDENTICAL
failures on every run). The instrumented seams
(:func:`dmlc_tpu_torch.resilience.policy.guarded` call sites) fire the plan
inside every retried attempt, so a ``times=2`` clause exercises exactly
"fail twice, then succeed".

Clause grammar (``;``-separated clauses of ``,``-separated ``k=v``)::

    DMLC_TPU_FAULTS="site=io.stream.read,fault=ioerror,times=2;
                     site=bench.block,fault=crash,nth=3,rank=1,attempt=0"

- ``site=<glob>``   (required) — fnmatch pattern over seam site names;
- ``fault=<type>``  (required) — ``ioerror`` (raise IOError),
  ``truncate`` (corrupt returned read bytes: drop the tail half),
  ``delay`` (sleep ``delay_s``), ``crash`` (dump a flight bundle if a
  recorder is installed, then ``os._exit(CRASH_EXIT)`` — a hard,
  no-cleanup death);
- trigger (at most one) — ``times=N`` (first N armed matches),
  ``nth=K`` (exactly the K-th), ``p=F`` (each match with probability
  F from a seeded RNG: same seed ⇒ same fault sequence); no trigger =
  every match;
- scoping — ``rank=K`` (only the gang member with that
  ``DMLC_TPU_TASK_ID``), ``attempt=K`` (only that restart attempt,
  ``DMLC_TPU_ATTEMPT``; how "crash once, run clean after the
  supervisor restarts me" is expressed);
- ``delay_s=X`` (for ``fault=delay``), ``seed=S`` (per-clause RNG
  seed override; the plan seed ``DMLC_TPU_FAULT_SEED`` is the base).

Every injected fault is observable: ``resilience.fault.injected``
counter, a ``fault/<site>`` trace instant, and the plan's bounded
event log — which the crash flight recorder copies into its bundle
(``faults.json``), so a post-mortem states what chaos was armed.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "FaultClause", "FaultPlan", "install", "uninstall", "active",
    "install_if_env", "fire", "corrupt", "injected_count", "parse_kv",
    "ENV_FAULTS", "ENV_FAULT_SEED", "CRASH_EXIT",
]

ENV_FAULTS = "DMLC_TPU_FAULTS"
ENV_FAULT_SEED = "DMLC_TPU_FAULT_SEED"
# the env the gang supervisor bumps on every restart (reference:
# DMLC_NUM_ATTEMPT, accepted as an alias)
_ENV_ATTEMPT = "DMLC_TPU_ATTEMPT"
FAULT_TYPES = ("ioerror", "truncate", "delay", "crash")
CRASH_EXIT = 77  # distinctive nonzero exit of an injected crash

_EVENT_LOG_CAP = 512


@dataclass
class FaultClause:
    site: str
    fault: str
    times: Optional[int] = None
    nth: Optional[int] = None
    p: Optional[float] = None
    delay_s: float = 0.05
    rank: Optional[int] = None
    attempt: Optional[int] = None
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        check(self.fault in FAULT_TYPES,
              f"unknown fault type {self.fault!r} (known: {FAULT_TYPES})")
        check(sum(x is not None for x in (self.times, self.nth, self.p))
              <= 1, "at most one trigger of times=/nth=/p= per clause")

    def spec(self) -> str:
        parts = [f"site={self.site}", f"fault={self.fault}"]
        for key in ("times", "nth", "p", "rank", "attempt", "seed"):
            v = getattr(self, key)
            if v is not None:
                parts.append(f"{key}={v}")
        if self.fault == "delay":
            parts.append(f"delay_s={self.delay_s}")
        return ",".join(parts)


_CLAUSE_KEYS = {"times": int, "nth": int, "p": float, "rank": int,
                "attempt": int, "seed": int, "delay_s": float}


def parse_kv(text: str, label: str) -> Dict[str, str]:
    """One ``,``-separated ``k=v`` clause -> dict. The ONE parser for
    the resilience env grammars (DMLC_TPU_FAULTS and DMLC_TPU_RETRY
    share it, so the clause syntax cannot drift between them)."""
    out: Dict[str, str] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        check("=" in part, f"{label}: expected k=v, got {part!r}")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def _parse_clause(text: str) -> FaultClause:
    kv = parse_kv(text, ENV_FAULTS)
    check("site" in kv and "fault" in kv,
          f"{ENV_FAULTS}: clause needs site= and fault= ({text!r})")
    args: Dict[str, Any] = {"site": kv.pop("site"),
                            "fault": kv.pop("fault")}
    for key, val in kv.items():
        conv = _CLAUSE_KEYS.get(key)
        if conv is None:
            raise DMLCError(f"{ENV_FAULTS}: unknown key {key!r} "
                            f"(known: {sorted(_CLAUSE_KEYS)})")
        args[key] = conv(val)
    return FaultClause(**args)


class FaultPlan:
    """An armed set of clauses with deterministic per-clause state."""

    def __init__(self, clauses: List[FaultClause], seed: int = 0):
        check(len(clauses) >= 1, "FaultPlan needs at least one clause")
        self.clauses = list(clauses)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts = [0] * len(self.clauses)
        self._rngs = [random.Random(
            (c.seed if c.seed is not None else self.seed) * 1000003 + i)
            for i, c in enumerate(self.clauses)]
        self._events: List[Dict[str, Any]] = []
        self.injected = 0
        # rank/attempt are fixed for the process's lifetime: cache them
        self._rank = self._int_env("DMLC_TPU_TASK_ID", "DMLC_TASK_ID")
        self._attempt = self._int_env(_ENV_ATTEMPT,
                                      "DMLC_NUM_ATTEMPT") or 0

    @staticmethod
    def _int_env(*names: str) -> Optional[int]:
        for name in names:
            v = os.environ.get(name)
            if v is not None:
                try:
                    return int(v)
                except ValueError:
                    pass
        return None

    @classmethod
    def parse(cls, spec: str, seed: Optional[int] = None) -> "FaultPlan":
        clauses = [_parse_clause(c) for c in spec.split(";")
                   if c.strip()]
        if seed is None:
            seed = int(os.environ.get(ENV_FAULT_SEED, "0") or "0")
        return cls(clauses, seed=seed)

    def spec(self) -> str:
        return ";".join(c.spec() for c in self.clauses)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -- matching

    def _scoped(self, clause: FaultClause, site: str) -> bool:
        if not fnmatch.fnmatchcase(site, clause.site):
            return False
        if clause.rank is not None and (self._rank or 0) != clause.rank:
            return False
        if clause.attempt is not None and self._attempt != clause.attempt:
            return False
        return True

    def _triggered(self, i: int, clause: FaultClause) -> bool:
        """Per-clause trigger check; caller holds no lock."""
        with self._lock:
            self._counts[i] += 1
            n = self._counts[i]
            if clause.nth is not None:
                return n == clause.nth
            if clause.times is not None:
                return n <= clause.times
            if clause.p is not None:
                return self._rngs[i].random() < clause.p
            return True

    def _record(self, site: str, clause: FaultClause) -> None:
        ev = {"site": site, "fault": clause.fault,
              "clause": clause.spec(), "time": time.time()}
        with self._lock:
            self.injected += 1
            ev["seq"] = self.injected
            if len(self._events) < _EVENT_LOG_CAP:
                self._events.append(ev)
        try:
            from dmlc_tpu_torch.obs.metrics import REGISTRY
            REGISTRY.counter("resilience.fault.injected").inc()
            from dmlc_tpu_torch.obs import trace
            trace.instant(f"fault/{site}", "resilience",
                          {"fault": clause.fault,
                           "clause": clause.spec()})
        except Exception:  # noqa: BLE001 — telemetry must not mask chaos
            pass

    # -- firing

    def fire(self, site: str) -> None:
        """Apply raising/delaying/crashing clauses armed at ``site``
        (truncation acts in :meth:`corrupt` — it needs the data)."""
        for i, clause in enumerate(self.clauses):
            if clause.fault == "truncate" or not self._scoped(clause, site):
                continue
            if not self._triggered(i, clause):
                continue
            self._record(site, clause)
            if clause.fault == "delay":
                time.sleep(clause.delay_s)
            elif clause.fault == "ioerror":
                raise IOError(
                    f"injected fault at site {site!r} ({clause.spec()})")
            elif clause.fault == "crash":
                self._crash(site, clause)

    def _crash(self, site: str, clause: FaultClause) -> None:
        """Hard death: the flight recorder (if installed) gets one dump
        — os._exit runs no atexit hooks, by design (a crashed worker
        flushes nothing, exactly what supervision must survive)."""
        try:
            from dmlc_tpu_torch.obs import flight
            fl = flight.active()
            if fl is not None:
                fl.dump("injected_crash")
        except Exception:  # noqa: BLE001 — the crash must still happen
            pass
        os._exit(CRASH_EXIT)

    def has_truncate(self, site: str) -> bool:
        """Whether ANY truncate clause is scoped at ``site`` (no
        trigger counters consumed): lets byte-owning seams skip the
        payload materialization :meth:`corrupt` needs when no armed
        clause could ever shorten it."""
        return any(c.fault == "truncate" and self._scoped(c, site)
                   for c in self.clauses)

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Apply armed truncation clauses to returned read bytes: drop
        the tail half (>=1 byte for non-empty data), simulating a torn
        read/short object the downstream framing must detect. The
        byte-owning seam (io.stream.FileStream) also pins its stream
        at EOF when this shortens data — without that, the advanced
        file position would shift later bytes into the hole and
        fixed-size readers would load silently wrong payloads."""
        if not data:
            return data
        for i, clause in enumerate(self.clauses):
            if clause.fault != "truncate" or not self._scoped(clause, site):
                continue
            if not self._triggered(i, clause):
                continue
            self._record(site, clause)
            data = data[:len(data) // 2]
        return data


# ------------------------------------------------------------ module plane

# THE armed plan (None = chaos off). Seams read this one global via
# policy.guarded's fast path; keep it a plain module attribute.
_plan: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _plan


def install(plan: "FaultPlan | str",
            seed: Optional[int] = None) -> FaultPlan:
    """Arm ``plan`` (a FaultPlan or a spec string) process-wide,
    replacing any armed predecessor."""
    global _plan
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan, seed=seed)
    _plan = plan
    return plan


def uninstall() -> Optional[FaultPlan]:
    global _plan
    plan, _plan = _plan, None
    return plan


def install_if_env() -> Optional[FaultPlan]:
    """Gang-worker hook (one line, like trace_if_env): arm the fault
    plan when ``DMLC_TPU_FAULTS`` is set — ``launch_local(faults=...)``
    sets it for every member — else no-op."""
    spec = os.environ.get(ENV_FAULTS)
    if not spec:
        return None
    return install(spec)


def fire(site: str) -> None:
    """Public site arming for code outside the built-in seams (e.g. a
    worker loop arming its own per-block site). No-op when chaos is
    off; one global read."""
    plan = _plan
    if plan is not None:
        plan.fire(site)


def corrupt(site: str, data: bytes) -> bytes:
    plan = _plan
    if plan is not None:
        return plan.corrupt(site, data)
    return data


def injected_count() -> int:
    plan = _plan
    return plan.injected if plan is not None else 0
