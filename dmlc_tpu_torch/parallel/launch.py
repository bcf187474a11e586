"""Job launcher and rendezvous on ``torch.distributed``.

Counterpart of ``dmlc_tpu/parallel/launch.py`` (reference:
tracker/dmlc_tracker/{submit,tracker,local}.py): workers find a
coordinator, get a rank and learn the world size. Here that is
``torch.distributed.init_process_group`` over a TCP store at the
coordinator's address. This module keeps:

- the env contract (``DMLC_TPU_COORDINATOR_URI``/``NUM_WORKER``/
  ``TASK_ID``, with the reference's ``DMLC_*`` names read as aliases),
  the parameter-server half (``ps_envs``, ``get_role``) and the
  rendezvous half (``rendezvous_envs``);
- ``init_from_env()`` and ``finalize()``, worker side: NCCL when the
  device is ``cuda`` (the default), gloo only when the caller asks for
  the CPU. NCCL needs one card a rank: a rank takes the card of its
  task id, and a gang with fewer cards than ranks on one host raises
  :class:`NotEnoughCardsError`. There is no fallback from one backend to
  the other: if NCCL fails, the call raises;
- ``launch_local()``, N local worker processes owned by a
  :class:`~dmlc_tpu_torch.resilience.GangSupervisor`: with no
  ``restart_policy`` the gang is killed on the first nonzero exit and
  on timeout; with one, a dead worker is respawned with its same
  coordinates up to a budget. ``faults`` hands every worker the fault
  plan's env contract, ``flight_dir`` the flight recorder's, and
  ``trace_dir`` the obs tracing contract (``DMLC_TPU_TRACE_DIR``);
  :func:`merge_gang_traces` stitches the workers' and the
  supervisor's trace files into one; ``serve_ports`` hands every worker
  the live status server's env contract (``DMLC_TPU_SERVE_PORT`` and
  ``_PORTS``, which the objstore peer tier reads too) and
  ``rendezvous=True`` starts a membership service for an elastic gang
  (``DMLC_TPU_RNDV_*``); ``num_servers`` adds the parameter-server role
  set (one scheduler and N servers running the same command under
  ``ps_envs``; the command branches on ``get_role()``); ``history_s``,
  ``gang_poll_s``, ``profile_hz``, ``control``, ``scheduler`` and
  ``slo`` hand the workers the analytic obs planes' env contracts;
- ``launch_ssh()``, the command lines for bare-metal hosts, and the
  submit CLI ``main`` (the reference's dmlc-submit):
  ``python -m dmlc_tpu_torch.parallel.launch -n 2 [-s 1] -- cmd ...``;
- the ring/tree topology helpers (``get_ring``, ``get_tree``,
  ``get_link_map``), pure functions kept for API parity;
- ``find_free_port(s)``.
"""

from __future__ import annotations

import os
import shlex
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "worker_envs", "ps_envs", "get_role", "init_from_env", "finalize",
    "launch_local", "launch_ssh", "merge_gang_traces", "get_ring",
    "get_tree", "get_link_map", "find_free_port", "find_free_ports",
    "main", "rendezvous_envs", "ENV_COORD", "ENV_NWORKER", "ENV_TASK_ID",
    "ENV_TRACE_DIR", "NotEnoughCardsError",
]

# env contract (reference: slave_envs in tracker.py)
ENV_COORD = "DMLC_TPU_COORDINATOR_URI"
ENV_NWORKER = "DMLC_TPU_NUM_WORKER"
ENV_TASK_ID = "DMLC_TPU_TASK_ID"
# obs tracing contract: workers that wrap their run in
# obs.trace.trace_if_env() export a rank-tagged trace file here
ENV_TRACE_DIR = "DMLC_TPU_TRACE_DIR"
# reference-name aliases accepted on read
_ALIASES = {
    ENV_COORD: ["DMLC_TRACKER_URI"],
    ENV_NWORKER: ["DMLC_NUM_WORKER"],
    ENV_TASK_ID: ["DMLC_TASK_ID"],
}


def _getenv(name: str) -> Optional[str]:
    v = os.environ.get(name)
    if v:
        return v
    for alias in _ALIASES.get(name, []):
        v = os.environ.get(alias)
        if v:
            return v
    return None


def find_free_port(host: str = "127.0.0.1") -> int:
    return find_free_ports(1, host)[0]


def find_free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` distinct free ports, chosen while ALL probe sockets are
    held open: closing a probe before the next bind lets the OS hand the
    same port out twice. Only guaranteed distinct from each other; as
    with any probe-then-bind scheme another process can still grab one
    before the real bind."""
    check(n >= 1, "find_free_ports needs n >= 1")
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


def worker_envs(coordinator: str, num_workers: int,
                task_id: int) -> Dict[str, str]:
    """The env block handed to each worker (reference: slave_envs +
    per-worker DMLC_TASK_ID). Reference names are set too, for
    downstream code that reads them."""
    check(":" in coordinator,
          f"coordinator must be host:port, got {coordinator!r}")
    return {
        ENV_COORD: coordinator,
        ENV_NWORKER: str(num_workers),
        ENV_TASK_ID: str(task_id),
        "DMLC_TRACKER_URI": coordinator.rsplit(":", 1)[0],
        "DMLC_TRACKER_PORT": coordinator.rsplit(":", 1)[1],
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_TASK_ID": str(task_id),
        "DMLC_ROLE": "worker",
    }


def ps_envs(root_uri: str, root_port: int, num_workers: int,
            num_servers: int, role: str,
            task_id: Optional[int] = None) -> Dict[str, str]:
    """The parameter-server half of the reference env contract
    (reference: tracker.py PSTracker — DMLC_PS_ROOT_URI/PORT, DMLC_ROLE
    in scheduler|server|worker, DMLC_NUM_SERVER/WORKER), for PS-style
    downstream code that expects these names."""
    check(role in ("scheduler", "server", "worker"),
          f"unknown PS role {role!r}")
    out = {
        "DMLC_PS_ROOT_URI": root_uri,
        "DMLC_PS_ROOT_PORT": str(root_port),
        "DMLC_NUM_SERVER": str(num_servers),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_ROLE": role,
    }
    if task_id is not None:
        out["DMLC_TASK_ID"] = str(task_id)
    return out


def get_role() -> str:
    """This process's tracker role (reference: DMLC_ROLE). 'worker' when
    unset — only launch_local(num_servers>0) / PS-style launchers create
    the other roles. Branch on this BEFORE init_from_env: scheduler and
    server processes are not part of the torch.distributed worker
    gang."""
    return os.environ.get("DMLC_ROLE", "worker")


class NotEnoughCardsError(DMLCError):
    """A gang on the card needs one CUDA card a rank, and this host has
    fewer: NCCL refuses two ranks on one card, and the port never falls
    back to gloo or to sharing a card.

    ``init_from_env`` raises it only when the coordinator is a loopback
    address (``localhost``, ``127.*``, ``::1``), the form ``launch_local``
    gives by default: then every rank runs on this host. A one-host gang
    given another address (``launch_local(coordinator=...)``) is not
    checked, and ranks past the host's cards reach NCCL on a shared card
    and fail there."""


def _loopback(coord: str) -> bool:
    """Whether the coordinator ``host:port`` is this host's loopback
    address, which only ranks on this host can reach: then every rank of
    the gang runs here."""
    host = coord.rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def init_from_env(device=None, force: bool = False) -> Tuple[int, int]:
    """Worker-side rendezvous: ``torch.distributed.init_process_group``
    from the env contract. Returns (rank, world size).

    The backend follows ``device`` (``cuda`` by default): ``nccl`` on
    the card, ``gloo`` only when the caller asks for ``"cpu"``; the
    store is TCP at the coordinator's host:port. With no coordinator in
    the env this is single-process mode: it returns (0, 1) and creates
    no group, unless ``force`` is set, which raises as the reference's
    does. A process group that already exists is kept (its rank and
    size are returned).

    A card a rank: a ``cuda`` device without an index takes card
    ``DMLC_TPU_TASK_ID % torch.cuda.device_count()``, so a
    ``launch_local`` gang of N ranks on a host of N cards puts one rank
    on each. When the coordinator is this host's loopback address (a
    ``launch_local`` gang: every rank runs here) and the world is larger
    than the host's cards, two ranks would share a card, and this raises
    :class:`NotEnoughCardsError` before NCCL is asked. The task id is
    global: across hosts (``launch_ssh`` puts rank r on host
    ``r % len(hosts)``) the card is still the global task id modulo this
    host's cards, which can repeat on a host, so such a gang passes
    ``device=cuda:<i>`` itself."""
    import torch
    import torch.distributed as dist
    check(get_role() == "worker",
          f"init_from_env joins the WORKER gang; this process is a "
          f"{get_role()!r} (branch on get_role() first)")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = _getenv(ENV_COORD)
    if coord is None and not force:
        return 0, 1
    check(coord is not None, f"{ENV_COORD} not set")
    dev = torch.device("cuda" if device is None else device)
    check(dev.type in ("cuda", "cpu"),
          f"init_from_env runs on cuda or cpu, got {dev}")
    nworker = int(_getenv(ENV_NWORKER) or "1")
    task_id = int(_getenv(ENV_TASK_ID) or "0")
    if dev.type == "cuda":
        check(torch.cuda.is_available(),
              "init_from_env(device='cuda') needs a CUDA card for NCCL "
              "(pass device='cpu' for gloo)")
        if dev.index is None:
            cards = torch.cuda.device_count()
            if _loopback(coord) and nworker > cards:
                raise NotEnoughCardsError(
                    f"rank {task_id} of {nworker} on this host would "
                    f"share card {task_id % cards} with another rank: the "
                    f"host has {cards} card(s) for {nworker} NCCL ranks "
                    "(pass device='cpu' for gloo)")
            dev = torch.device("cuda", task_id % cards)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=nworker, rank=task_id,
                            device_id=dev if backend == "nccl" else None)
    return task_id, nworker


def finalize() -> None:
    """Synchronize all processes, then shut the group down (call at
    worker exit: without the barrier rank 0, which hosts the store, can
    exit while peers are still using it). No-op without a group."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def launch_local(num_workers: int, command: Sequence[str],
                 env: Optional[Dict[str, str]] = None,
                 coordinator: Optional[str] = None,
                 timeout: Optional[float] = None,
                 num_servers: int = 0,
                 trace_dir: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 restart_policy=None,
                 faults=None,
                 serve_ports=None,
                 rendezvous: bool = False,
                 heartbeat_grace_s: Optional[float] = None,
                 history_s: Optional[float] = None,
                 gang_poll_s: Optional[float] = None,
                 profile_hz: Optional[float] = None,
                 control: Optional[bool] = None,
                 scheduler=None,
                 slo=None) -> List[int]:
    """Run ``num_workers`` worker processes of ``command`` on this host
    (reference: local.py), each with the env contract of its rank on top
    of this process's environment and ``env``.

    The gang is owned by a :class:`dmlc_tpu_torch.resilience.GangSupervisor`:
    a worker that **exits 0 early** is a finished member (the gang keeps
    running), a worker that **dies** (nonzero exit or signal) kills the
    gang on first failure and the call raises — unless
    ``restart_policy`` (a :class:`dmlc_tpu_torch.resilience.RestartPolicy`,
    or an int = max restarts per worker) is given, in which case the
    dead worker is respawned with its SAME coordinates and a bumped
    ``DMLC_TPU_ATTEMPT`` (alias ``DMLC_NUM_ATTEMPT``) up to the budget.
    Budget exhausted = prompt gang teardown (plus a launcher-side flight
    bundle when ``flight_dir`` is set), never a hang. Past ``timeout``
    seconds every worker is killed and the call raises. Restarts count
    in the launcher's ``resilience.restart`` counter and land as
    ``gang/restart/<member>`` instants on the merged gang trace. A
    restarted worker cannot rejoin a live ``torch.distributed`` group
    (see :mod:`dmlc_tpu_torch.resilience.supervise`): restarts are for
    gangs whose workers form none.

    ``faults`` (a spec string or :class:`dmlc_tpu_torch.resilience.FaultPlan`)
    hands every member the ``DMLC_TPU_FAULTS`` chaos contract (and a
    plan's seed as ``DMLC_TPU_FAULT_SEED``) — members opt in with one
    ``resilience.inject.install_if_env()`` call, and the seeded plan
    makes every run provoke identical failures.

    ``flight_dir`` hands every worker the crash flight-recorder contract
    (``DMLC_TPU_FLIGHT_DIR``): workers that call
    ``obs.flight.install_if_env()`` leave a post-mortem bundle there
    when they die badly.

    ``trace_dir`` hands every worker the obs tracing contract
    (``DMLC_TPU_TRACE_DIR``): workers that wrap their run in
    ``dmlc_tpu_torch.obs.trace.trace_if_env()`` each export a
    rank-tagged Chrome trace there, the supervisor writes its own
    (``trace-supervisor.json``), and on a clean gang exit the files are
    merged into ``<trace_dir>/trace-gang.json`` — one Perfetto timeline,
    one process row per rank. Stale ``trace-*.json`` files in the
    directory are removed first.

    ``serve_ports`` (a list of one port per worker, or True for free
    ones) hands every worker its status-server port via
    ``DMLC_TPU_SERVE_PORT`` (workers opt in with one
    ``obs.serve.serve_if_env()`` call) and the whole gang list via
    ``DMLC_TPU_SERVE_PORTS`` — which is also the objstore peer tier's
    topology: a gang that serves ``/metrics`` is a peer data plane.

    ``rendezvous=True`` makes the gang ELASTIC: the launcher starts a
    :class:`dmlc_tpu_torch.rendezvous.RendezvousService` and exports
    ``DMLC_TPU_RNDV_URI/PORT`` (+ the gang name) — workers that call
    ``dmlc_tpu_torch.rendezvous.install_if_env()`` join, heartbeat, and
    learn roster changes through the membership epoch. The supervisor
    reports deaths to the service (the epoch bumps at once, not after
    the heartbeat grace), and a worker whose restart budget is
    exhausted SHRINKS the gang instead of killing it.
    ``heartbeat_grace_s`` tunes the service's silent-member death
    window.

    ``history_s`` hands every worker the time-series contract
    (``DMLC_TPU_HISTORY_S``): workers that call
    ``obs.timeseries.install_if_env()`` sample their metrics registry
    at that period into the shared bounded ring — served live at
    ``/history``, attached to stall reports and crash bundles.

    ``gang_poll_s`` sets ``DMLC_TPU_GANG_POLL_S`` on RANK 0 ONLY: with
    ``serve_ports`` also wired, a rank-0 ``obs.aggregate.install_if_env()``
    call polls every peer's ``/metrics.json`` at that period into one
    gang timeline (per-rank series + sum/min/max rollups + explicit
    unreachable gaps), served at rank 0's ``/gang``.

    ``profile_hz`` hands every worker the sampling-profiler contract
    (``DMLC_TPU_PROFILE_HZ``): workers that call
    ``obs.profile.install_if_env()`` run the continuous sampler at that
    rate — merged Python+native flamegraphs served at ``/profile``,
    attached to stall reports and crash bundles (``profile.txt``), and
    feeding ``hot_frames`` verdict evidence.

    ``control=True`` hands every worker the verdict-driven control plane
    (``DMLC_TPU_CONTROL``): workers that call
    ``obs.control.install_if_env()`` run the between-epoch controller,
    whose decision ledger is served at ``/control`` and attached to
    flight bundles as ``control.json``.

    ``scheduler=True`` (or a ``DMLC_TPU_SCHED`` option string such as
    ``"quantum=4,queue=48"``) hands every worker the multi-tenant
    pipeline scheduler contract: workers that call
    ``pipeline.scheduler.install_if_env()`` share their process's queue
    budgets across tenants (``Pipeline.build(tenant=...)``) with DRR pull
    credits, admission control, and per-tenant rows at ``/tenants``.

    ``slo=True`` (or a ``DMLC_TPU_SLO`` declaration string such as
    ``"name=ingest,metric=tenant.ingest.batch_s,target=0.15"``) hands
    every worker the SLO contract (:mod:`dmlc_tpu_torch.obs.slo`):
    workers that call ``obs.slo.install_if_env()`` judge declared
    objectives live at ``/slo``, rolled up gang-wide on rank 0's
    ``/gang`` and attached to flight bundles as ``slo.json``. Tenants can
    also declare objectives through the scheduler string
    (``scheduler="slo.victim=0.15:300:0.01"``).

    With ``num_servers > 0`` (reference: dmlc-submit --num-servers +
    PSTracker), the launch also spawns ONE scheduler and
    ``num_servers`` server processes running the same command under the
    PS env contract (``DMLC_PS_ROOT_URI/PORT``, ``DMLC_ROLE``,
    ``DMLC_NUM_SERVER/WORKER``): the command branches on ``get_role()``.
    Workers carry BOTH contracts; the ``torch.distributed`` gang is
    workers-only. Service roles that outlive every worker are
    terminated after the supervisor's grace (a scheduler waiting for
    work forever cannot hang the launch), and a dead worker kills them
    with the rest of the gang, with or without a ``timeout``.

    Returns the exit codes: workers first in rank order, then the
    scheduler, then the servers. All are 0, except that in an elastic
    rendezvous gang a shrink is NOT a failure and a dead member's
    nonzero code is returned instead of raised."""
    check(num_workers >= 1, "num_workers must be >= 1")
    check(num_servers >= 0, "num_servers must be >= 0")
    if serve_ports is True:
        serve_ports = find_free_ports(num_workers)
    if serve_ports is not None:
        serve_ports = [int(p) for p in serve_ports]
        check(len(serve_ports) == num_workers,
              f"serve_ports needs one port per worker "
              f"({len(serve_ports)} != {num_workers})")
    if flight_dir is not None:
        os.makedirs(flight_dir, exist_ok=True)
    if trace_dir is not None:
        import glob
        os.makedirs(trace_dir, exist_ok=True)
        # stale trace-*.json from a previous gang (e.g. a 4-worker run
        # reusing a 2-worker run's dir) would merge as ghost rank rows
        # on the new timeline — this launch owns the dir's trace files
        for stale in glob.glob(os.path.join(trace_dir, "trace-*.json")):
            try:
                os.remove(stale)
            except OSError:
                pass
    ps_root: Optional[Tuple[str, int]] = None
    if coordinator is None and num_servers > 0:
        # one probe pass holding both sockets: back-to-back single-port
        # probes could hand the coordinator and the PS root the SAME port
        coord_port, ps_port = find_free_ports(2)
        coordinator = f"127.0.0.1:{coord_port}"
        ps_root = ("127.0.0.1", ps_port)
    else:
        if coordinator is None:
            coordinator = f"127.0.0.1:{find_free_port()}"
        if num_servers > 0:
            ps_root = ("127.0.0.1", find_free_port())
    from dmlc_tpu_torch.obs.flight import ENV_FLIGHT_DIR
    from dmlc_tpu_torch.resilience import inject as _inject
    from dmlc_tpu_torch.resilience.supervise import (
        GangMember, GangSupervisor, RestartPolicy,
    )
    from dmlc_tpu_torch.obs.serve import ENV_SERVE_PORT, ENV_SERVE_PORTS
    from dmlc_tpu_torch.obs.aggregate import ENV_GANG_POLL_S
    from dmlc_tpu_torch.obs.control import ENV_CONTROL
    from dmlc_tpu_torch.obs.profile import ENV_PROFILE_HZ
    from dmlc_tpu_torch.obs.slo import ENV_SLO
    from dmlc_tpu_torch.obs.timeseries import ENV_HISTORY_S
    from dmlc_tpu_torch.pipeline.scheduler import ENV_SCHED
    if isinstance(restart_policy, int):
        restart_policy = RestartPolicy(max_restarts=restart_policy)
    rndv_service = None
    rndv_gang = os.environ.get("DMLC_TPU_RNDV_GANG", "local")
    if rendezvous:
        from dmlc_tpu_torch.rendezvous import RendezvousService
        kw = ({"heartbeat_grace_s": float(heartbeat_grace_s)}
              if heartbeat_grace_s is not None else {})
        rndv_service = RendezvousService(**kw)
    fault_spec = fault_seed = None
    if faults is not None:
        if isinstance(faults, str):
            fault_spec = faults
        else:
            # a FaultPlan's spec() carries clauses only — the plan
            # seed must ride DMLC_TPU_FAULT_SEED or every worker's
            # p= clauses would re-parse onto seed 0, not the armed one
            fault_spec = faults.spec()
            fault_seed = str(faults.seed)

    def _base_env() -> Dict[str, str]:
        e = dict(os.environ)
        if env:
            e.update(env)
        if fault_spec is not None:
            e[_inject.ENV_FAULTS] = fault_spec
        if fault_seed is not None:
            e[_inject.ENV_FAULT_SEED] = fault_seed
        return e

    members: List[GangMember] = []
    for task_id in range(num_workers):
        wenv = _base_env()
        wenv.update(worker_envs(coordinator, num_workers, task_id))
        if trace_dir is not None:
            wenv[ENV_TRACE_DIR] = trace_dir
        if serve_ports is not None:
            wenv[ENV_SERVE_PORT] = str(serve_ports[task_id])
            wenv[ENV_SERVE_PORTS] = ",".join(map(str, serve_ports))
        if flight_dir is not None:
            wenv[ENV_FLIGHT_DIR] = flight_dir
        if history_s is not None:
            wenv[ENV_HISTORY_S] = str(history_s)
        if gang_poll_s is not None and task_id == 0:
            wenv[ENV_GANG_POLL_S] = str(gang_poll_s)
        if profile_hz is not None:
            wenv[ENV_PROFILE_HZ] = str(profile_hz)
        if control:
            wenv[ENV_CONTROL] = "1"
        if scheduler:
            wenv[ENV_SCHED] = (scheduler if isinstance(scheduler, str)
                               else "1")
        if slo:
            wenv[ENV_SLO] = (slo if isinstance(slo, str) else "1")
        if rndv_service is not None:
            from dmlc_tpu_torch.rendezvous import (
                ENV_RNDV_GANG, ENV_RNDV_PORT, ENV_RNDV_URI,
            )
            wenv[ENV_RNDV_URI] = rndv_service.host
            wenv[ENV_RNDV_PORT] = str(rndv_service.port)
            wenv[ENV_RNDV_GANG] = rndv_gang
        if ps_root is not None:
            wenv.update(ps_envs(ps_root[0], ps_root[1], num_workers,
                                num_servers, "worker", task_id))
        members.append(GangMember(f"worker-{task_id}", "worker",
                                  task_id, command, wenv))
    if ps_root is not None:
        roles = [("scheduler", 0)] + [("server", i)
                                      for i in range(num_servers)]
        for role, task_id in roles:
            renv = _base_env()
            renv.update(ps_envs(ps_root[0], ps_root[1], num_workers,
                                num_servers, role, task_id))
            members.append(GangMember(f"{role}-{task_id}", role,
                                      task_id, command, renv))
    # the supervisor owns spawning (a Popen failure mid-loop must not
    # leak the running half of the gang), the gang poll, restarts, the
    # timeout, and the PS roles' drain once every worker finished
    try:
        codes = GangSupervisor(
            members, restart_policy=restart_policy,
            timeout=timeout, trace_dir=trace_dir,
            flight_dir=flight_dir,
            rendezvous_addr=(rndv_service.address
                             if rndv_service is not None else None),
            rendezvous_gang=rndv_gang,
            elastic=rndv_service is not None).run()
    finally:
        if rndv_service is not None:
            rndv_service.close()
    if trace_dir is not None:
        merge_gang_traces(trace_dir)
    return codes


def merge_gang_traces(trace_dir: str,
                      out_name: str = "trace-gang.json") -> Optional[str]:
    """Merge the per-worker ``trace-*.json`` files a traced gang left
    in ``trace_dir`` into one Perfetto-loadable timeline. Returns the
    merged path, or None when no worker exported a trace (workers opt
    in via obs.trace.trace_if_env())."""
    import glob
    out_path = os.path.join(trace_dir, out_name)
    paths = sorted(p for p in glob.glob(os.path.join(trace_dir,
                                                     "trace-*.json"))
                   if os.path.abspath(p) != os.path.abspath(out_path))
    if not paths:
        return None
    from dmlc_tpu_torch.obs.export import merge_chrome_files
    merge_chrome_files(paths, out_path)
    return out_path


def rendezvous_envs(rendezvous_addr: Optional[Tuple[str, int]] = None,
                    rendezvous_gang: Optional[str] = None
                    ) -> Dict[str, str]:
    """The rendezvous env contract (``DMLC_TPU_RNDV_URI/PORT/GANG``)
    as a dict ready to merge into worker envs. An explicit
    ``rendezvous_addr=(host, port)`` wins; otherwise the launcher's own
    environment is forwarded (a membership service bound on the submit
    host is reachable from scheduler-launched workers too); empty when
    neither names a service. Shared by launch_ssh and every
    parallel.backends generator so elastic membership is not a
    local/ssh-only feature."""
    from dmlc_tpu_torch.rendezvous import (
        ENV_RNDV_GANG, ENV_RNDV_PORT, ENV_RNDV_URI,
    )
    rndv: Dict[str, str] = {}
    if rendezvous_addr is not None:
        rndv[ENV_RNDV_URI] = str(rendezvous_addr[0])
        rndv[ENV_RNDV_PORT] = str(rendezvous_addr[1])
    elif os.environ.get(ENV_RNDV_URI) and os.environ.get(ENV_RNDV_PORT):
        rndv[ENV_RNDV_URI] = os.environ[ENV_RNDV_URI]
        rndv[ENV_RNDV_PORT] = os.environ[ENV_RNDV_PORT]
    if rndv:
        rndv[ENV_RNDV_GANG] = (rendezvous_gang
                               or os.environ.get(ENV_RNDV_GANG, "local"))
    return rndv


def launch_ssh(hosts: Sequence[str], command: Sequence[str],
               coordinator: str, num_workers: Optional[int] = None,
               dry_run: bool = False,
               rendezvous_addr: Optional[Tuple[str, int]] = None,
               rendezvous_gang: Optional[str] = None) -> List[str]:
    """Generate (and optionally run) per-host ssh commands
    (reference: ssh.py). Returns the command lines, the reference's for
    the same arguments.

    The rendezvous env contract rides the command lines: pass
    ``rendezvous_addr=(host, port)`` (and optionally
    ``rendezvous_gang``) to point every worker at an elastic
    membership service, or leave them None and the launcher's own
    ``DMLC_TPU_RNDV_URI/PORT/GANG`` environment (when set) is
    forwarded — a service bound on the submit host is reachable from
    every ssh worker, not just the local gang."""
    n = num_workers or len(hosts)
    rndv = rendezvous_envs(rendezvous_addr, rendezvous_gang)
    lines = []
    for task_id in range(n):
        host = hosts[task_id % len(hosts)]
        envs = dict(worker_envs(coordinator, n, task_id))
        envs.update(rndv)
        env_str = " ".join(f"{k}={shlex.quote(v)}" for k, v in envs.items())
        cmd_str = " ".join(shlex.quote(c) for c in command)
        lines.append(f"ssh -o StrictHostKeyChecking=no {host} "
                     f"'cd {shlex.quote(os.getcwd())} && "
                     f"env {env_str} {cmd_str}'")
    if not dry_run:
        procs = [subprocess.Popen(line, shell=True) for line in lines]
        codes = [p.wait() for p in procs]
        if any(codes):
            raise DMLCError(f"ssh worker failure, exit codes {codes}")
    return lines


# ---------------------------------------------------------------- topology
# Reference: tracker.py get_ring/get_tree/get_link_map (RabitTracker).

def get_ring(n: int) -> Dict[int, Tuple[int, int]]:
    """rank -> (prev, next) on a ring (reference: get_ring)."""
    check(n >= 1, "ring needs n >= 1")
    return {r: ((r - 1) % n, (r + 1) % n) for r in range(n)}


def get_tree(n: int) -> Dict[int, int]:
    """rank -> parent (-1 for root) on a binary tree (reference: get_tree)."""
    check(n >= 1, "tree needs n >= 1")
    return {r: ((r - 1) // 2 if r else -1) for r in range(n)}


def get_link_map(n: int) -> Dict[int, List[int]]:
    """rank -> neighbor list combining tree links (reference: get_link_map)."""
    parent = get_tree(n)
    links: Dict[int, List[int]] = {r: [] for r in range(n)}
    for r, p in parent.items():
        if p >= 0:
            links[r].append(p)
            links[p].append(r)
    return links


# ---------------------------------------------------------------- CLI
# Reference: tracker/dmlc-submit + submit.py/opts.py

def main(argv: Optional[Sequence[str]] = None) -> int:
    """The submit CLI: ``python -m dmlc_tpu_torch.parallel.launch -n N
    [-s S] [--cluster local|ssh] -- cmd ...`` (the reference's options
    and behaviour). Returns 0; a failed gang raises."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="dmlc-tpu-torch-submit",
        description="Launch distributed workers "
                    "(reference: dmlc-submit; torch.distributed rendezvous)")
    ap.add_argument("--cluster", choices=["local", "ssh"], default="local")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="PS server processes (reference: dmlc-submit "
                         "--num-servers; spawns scheduler+servers under "
                         "the DMLC_PS_* env contract, local cluster only)")
    ap.add_argument("--host-file", default=None,
                    help="one host per line (ssh cluster)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank-0 coordinator")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    check(len(args.command) > 0, "no worker command given")
    cmd = args.command[1:] if args.command[0] == "--" else args.command
    if args.cluster == "local":
        launch_local(args.num_workers, cmd, coordinator=args.coordinator,
                     num_servers=args.num_servers)
    else:
        check(args.num_servers == 0,
              "--num-servers is local-cluster only (ssh PS launch: set "
              "the DMLC_PS_* env per host with ps_envs())")
        check(args.host_file is not None, "--host-file required for ssh")
        with open(args.host_file) as f:
            hosts = [h.strip() for h in f if h.strip()]
        # port chosen by local probe; it must be free on hosts[0] too —
        # pass --coordinator to control it explicitly
        coord = args.coordinator or f"{hosts[0]}:{find_free_port()}"
        launch_ssh(hosts, cmd, coord, num_workers=args.num_workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
