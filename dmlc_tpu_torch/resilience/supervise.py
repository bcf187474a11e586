"""Elastic gang supervision: restart a dead worker, don't kill the gang.

Copy of ``dmlc_tpu/resilience/supervise.py`` with its imports rewritten
to ``dmlc_tpu_torch``. Reference: the production dmlc-core tracker keeps
a job alive through worker deaths via its ``recover`` handshake — a
replacement worker rejoins with the same rank and ``DMLC_NUM_ATTEMPT``
bumped (SURVEY §5.3). The determinism contract (a shard stream is a pure
function of (uri, part, num_parts, seed, epoch)) makes the data-plane
half of that trivial: a restarted worker with the SAME coordinates
replays the byte-identical stream. This module performs the restart.

:class:`GangSupervisor` owns the process gang ``launch_local`` spawns:

- polls every member, distinguishing **exited 0 early** (a finished
  worker — the gang keeps running) from **died** (nonzero exit or
  signal);
- with a :class:`RestartPolicy`, a dead WORKER is respawned with its
  same env/coordinates and ``DMLC_TPU_ATTEMPT`` (alias
  ``DMLC_NUM_ATTEMPT``) bumped, after an exponential backoff — up to a
  per-worker and gang-wide budget. Each restart increments the
  ``resilience.restart`` counter, sets the ``resilience.gang.restarts``
  gauge, warns through obs.log, and lands as a ``gang/restart/<member>``
  instant on the supervisor's trace track (merged into
  ``trace-gang.json``);
- budget exhausted (or a non-worker death, or no policy): the whole
  gang is killed promptly — never a hang — and, when restart
  supervision was active and a flight dir is known, a launcher-side
  flight bundle (reason ``gang_restart_budget_exhausted``) records the
  teardown;
- PS service roles (scheduler/servers) that outlive every worker by
  more than a grace window are terminated cleanly and report exit 0:
  service processes wait for work forever by design, and "all workers
  finished" IS their clean shutdown signal.

``torch.distributed`` caveat: a restarted process cannot rejoin a LIVE
gloo or NCCL group — the group's TCPStore still holds the dead rank's
slot, and the survivors' collectives wait on it. Restart supervision is
for data-plane gangs with no cross-worker group (each worker parses its
own shard and trains or writes on its own), or for whole-job retry
wrappers.

Trimmed from the reference: the rendezvous wiring (death reports to a
membership service and the elastic shrink of a gang whose member's
budget is gone), which waits for the rendezvous plane.
"""

from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["RestartPolicy", "GangMember", "GangSupervisor",
           "ENV_ATTEMPT", "ENV_ATTEMPT_ALIAS"]

# restart-attempt env contract (reference: DMLC_NUM_ATTEMPT, set as an
# alias too): 0 on first spawn, +1 per supervisor restart. Fault-plan
# clauses scope on it (attempt=0 = "only before the first restart").
ENV_ATTEMPT = "DMLC_TPU_ATTEMPT"
# the reference tracker's own name for the same counter (SURVEY §2.3):
# spawn() stamps BOTH on every (re)spawn so reference-style workers
# read the attempt without knowing this repo's prefix
ENV_ATTEMPT_ALIAS = "DMLC_NUM_ATTEMPT"


@dataclass
class RestartPolicy:
    """How a dead worker is brought back.

    ``max_restarts`` is per worker; ``max_total_restarts`` bounds the
    gang (default: ``max_restarts * num_workers``). Backoff between a
    death and its respawn is exponential in the member's restart
    count — a crash-looping worker must not busy-spin the host."""

    max_restarts: int = 2
    max_total_restarts: Optional[int] = None
    backoff_base_s: float = 0.1
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 5.0

    def backoff_for(self, restarts: int) -> float:
        return min(self.backoff_max_s,
                   self.backoff_base_s
                   * self.backoff_multiplier ** max(0, restarts - 1))


class GangMember:
    """One supervised process slot: role, coordinates, env — and the
    attempt counter that survives respawns."""

    def __init__(self, name: str, role: str, task_id: int,
                 command: Sequence[str], env: Dict[str, str]):
        self.name = name
        self.role = role
        self.task_id = task_id
        self.command = list(command)
        self.env = dict(env)
        self.proc: Optional[subprocess.Popen] = None
        self.attempt = 0
        self.restarts = 0
        self.code: Optional[int] = None
        self.restart_due: Optional[float] = None

    def spawn(self) -> None:
        env = dict(self.env)
        env[ENV_ATTEMPT] = str(self.attempt)
        env[ENV_ATTEMPT_ALIAS] = str(self.attempt)
        self.proc = subprocess.Popen(self.command, env=env)

    def running(self) -> bool:
        return (self.code is None and self.proc is not None
                and self.proc.poll() is None)


class GangSupervisor:
    """Poll-loop owner of a launch_local gang (see module docstring)."""

    def __init__(self, members: List[GangMember],
                 restart_policy: Optional[RestartPolicy] = None,
                 timeout: Optional[float] = None,
                 poll_interval_s: float = 0.05,
                 trace_dir: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 ps_grace_s: float = 10.0):
        check(len(members) >= 1, "GangSupervisor needs members")
        self.members = members
        self.restart_policy = restart_policy
        self.timeout = timeout
        self.poll_interval_s = poll_interval_s
        self.trace_dir = trace_dir
        self.flight_dir = flight_dir
        # how long PS service roles may linger after the last worker
        # finishes before the supervisor terminates them: roles that
        # exit on their own (role-generic test binaries) get to, while
        # a real scheduler blocked waiting for work forever cannot
        # hang the launch
        self.ps_grace_s = ps_grace_s
        self.total_restarts = 0
        self._rec = None
        if trace_dir is not None:
            from dmlc_tpu_torch.obs.trace import TraceRecorder
            self._rec = TraceRecorder(8192)

    # -- events / telemetry

    def _event(self, kind: str, m: GangMember,
               args: Optional[Dict[str, Any]] = None) -> None:
        payload = {"role": m.role, "task_id": m.task_id,
                   "attempt": m.attempt, **(args or {})}
        name = f"gang/{kind}/{m.name}"
        try:
            from dmlc_tpu_torch.obs import trace
            trace.instant(name, "resilience", payload)
            if self._rec is not None:
                self._rec.instant(name, "resilience", payload)
        except Exception:  # noqa: BLE001 — telemetry must not kill the gang
            pass

    def _note_restart(self, m: GangMember, rc: int, delay: float) -> None:
        self.total_restarts += 1
        try:
            from dmlc_tpu_torch.obs.metrics import REGISTRY
            REGISTRY.counter("resilience.restart").inc()
            REGISTRY.gauge("resilience.gang.restarts").set(
                self.total_restarts)
            from dmlc_tpu_torch.obs.log import warn_limited
            warn_limited(
                f"gang-restart-{m.name}",
                f"resilience: {m.name} died (exit {rc}); restarting with "
                f"same coordinates in {delay:.2f}s (attempt "
                f"{m.attempt} -> {m.attempt + 1}, restart {m.restarts}"
                f"/{self.restart_policy.max_restarts})",
                min_interval_s=1.0, all_ranks=True)
        except Exception:  # noqa: BLE001
            pass
        self._event("restart", m, {"exit_code": rc,
                                   "delay_s": round(delay, 3),
                                   "restart": m.restarts})

    def _export_trace(self) -> None:
        if self._rec is None or self.trace_dir is None:
            return
        try:
            from dmlc_tpu_torch.obs.export import write_chrome
            write_chrome(self._rec,
                         os.path.join(self.trace_dir,
                                      "trace-supervisor.json"),
                         process_name="dmlc_tpu_torch gang supervisor")
        except Exception:  # noqa: BLE001 — best-effort export
            pass

    def _flight_bundle(self, reason: str,
                       detail: Dict[str, Any]) -> None:
        """Launcher-side post-mortem on graceful-degrade teardown."""
        try:
            from dmlc_tpu_torch.obs import flight
            fl = flight.active()
            if fl is None:
                if self.flight_dir is None:
                    return
                fl = flight.FlightRecorder(out_dir=self.flight_dir)
            fl.dump(reason, stall_report=detail)
        except Exception:  # noqa: BLE001 — the raise below still happens
            pass

    # -- teardown

    def _kill_all(self) -> None:
        for m in self.members:
            if m.proc is not None and m.proc.poll() is None:
                m.proc.kill()
        for m in self.members:
            if m.proc is not None:
                m.proc.wait()

    def _codes(self) -> List[Optional[int]]:
        return [m.code if m.code is not None
                else (m.proc.returncode if m.proc is not None else None)
                for m in self.members]

    def _fail(self, m: GangMember, rc: int, budget_exhausted: bool) -> None:
        self._event("exit", m, {"code": rc, "fatal": True})
        self._kill_all()
        codes = self._codes()
        if budget_exhausted:
            self._flight_bundle(
                "gang_restart_budget_exhausted",
                {"member": m.name, "exit_code": rc,
                 "restarts": {x.name: x.restarts for x in self.members},
                 "total_restarts": self.total_restarts,
                 "exit_codes": codes})
            raise DMLCError(
                f"worker failure, exit codes {codes} (restart budget "
                f"exhausted after {self.total_restarts} restart(s); "
                "gang killed)")
        raise DMLCError(
            f"worker failure, exit codes {codes} (gang killed "
            "on first nonzero exit)")

    def _drain_ps_roles(self) -> None:
        """All workers finished cleanly and the grace window passed;
        scheduler/server processes wait for work forever by design —
        terminate them and report 0 (the pre-resilience poll loop hung
        on them instead)."""
        lingering = [m for m in self.members
                     if m.role != "worker" and m.code is None]
        for m in lingering:
            if m.proc is not None and m.proc.poll() is None:
                m.proc.terminate()
        deadline = time.monotonic() + 5.0
        for m in lingering:
            if m.proc is None:
                m.code = 0
                continue
            while m.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if m.proc.poll() is None:
                m.proc.kill()
                m.proc.wait()
            m.code = 0
            self._event("ps.terminate", m)

    # -- restart decision

    def _may_restart(self, m: GangMember) -> bool:
        pol = self.restart_policy
        if pol is None or m.role != "worker":
            return False
        if m.restarts >= pol.max_restarts:
            return False
        total_cap = (pol.max_total_restarts
                     if pol.max_total_restarts is not None
                     else pol.max_restarts
                     * sum(1 for x in self.members
                           if x.role == "worker"))
        return self.total_restarts < total_cap

    # -- the loop

    def run(self) -> List[int]:
        deadline = (time.monotonic() + self.timeout
                    if self.timeout else None)
        workers_done_at: Optional[float] = None
        try:
            for m in self.members:
                m.spawn()
                self._event("spawn", m)
            while True:
                now = time.monotonic()
                if deadline is not None and now > deadline:
                    self._kill_all()
                    raise DMLCError(
                        f"workers exceeded timeout {self.timeout}s; "
                        "all killed")
                for m in self.members:
                    if m.code is not None:
                        continue
                    if m.restart_due is not None:
                        if now >= m.restart_due:
                            m.restart_due = None
                            m.attempt += 1
                            m.spawn()
                            self._event("spawn", m,
                                        {"after_restart": True})
                        continue
                    if m.proc is None:
                        continue
                    rc = m.proc.poll()
                    if rc is None:
                        continue
                    if rc == 0:
                        # exited 0 early: a FINISHED member, not a dead
                        # one — the rest of the gang keeps running
                        m.code = 0
                        self._event("exit", m, {"code": 0})
                        continue
                    if self._may_restart(m):
                        m.restarts += 1
                        delay = self.restart_policy.backoff_for(
                            m.restarts)
                        m.restart_due = now + delay
                        self._note_restart(m, rc, delay)
                        continue
                    self._fail(m, rc,
                               budget_exhausted=(
                                   self.restart_policy is not None
                                   and m.role == "worker"))
                workers_done = all(m.code is not None
                                   for m in self.members
                                   if m.role == "worker")
                if workers_done and workers_done_at is None:
                    workers_done_at = time.monotonic()
                if workers_done_at is not None:
                    drain_at = workers_done_at + self.ps_grace_s
                    if deadline is not None:
                        # every worker succeeded: the grace must not
                        # push the drain past the launch timeout and
                        # turn a clean run into a misleading timeout
                        # failure (6s leaves the drain its own 5s
                        # terminate window)
                        drain_at = min(drain_at, deadline - 6.0)
                    if time.monotonic() >= drain_at:
                        self._drain_ps_roles()
                if all(m.code is not None for m in self.members):
                    break
                time.sleep(self.poll_interval_s)
            return [m.code for m in self.members]
        except BaseException:
            self._kill_all()
            raise
        finally:
            self._export_trace()
