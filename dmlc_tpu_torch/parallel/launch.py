"""Job launcher and rendezvous on ``torch.distributed``.

Counterpart of ``dmlc_tpu/parallel/launch.py`` (reference:
tracker/dmlc_tracker/{submit,tracker,local}.py): workers find a
coordinator, get a rank and learn the world size. Here that is
``torch.distributed.init_process_group`` over a TCP store at the
coordinator's address. This module keeps:

- the env contract (``DMLC_TPU_COORDINATOR_URI``/``NUM_WORKER``/
  ``TASK_ID``, with the reference's ``DMLC_*`` names read as aliases),
  and the parameter-server half (``ps_envs``, ``get_role``);
- ``init_from_env()`` and ``finalize()``, worker side: NCCL when the
  device is ``cuda`` (the default), gloo only when the caller asks for
  the CPU. NCCL needs one card a rank. There is no fallback from one
  backend to the other: if NCCL fails, the call raises;
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
  (``DMLC_TPU_RNDV_*``);
- the ring/tree topology helpers (``get_ring``, ``get_tree``,
  ``get_link_map``), pure functions kept for API parity;
- ``find_free_port(s)``.

Trimmed from the reference: ssh and the CLI, the PS role set in
``launch_local`` and every option of ``launch_local`` that waits for a
plane the port does not have yet (each raises a DMLCError that says
"not ported" and names the plane).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "worker_envs", "ps_envs", "get_role", "init_from_env", "finalize",
    "launch_local", "merge_gang_traces", "get_ring", "get_tree",
    "get_link_map", "find_free_port", "find_free_ports", "ENV_COORD",
    "ENV_NWORKER", "ENV_TASK_ID", "ENV_TRACE_DIR",
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

# launch_local options of the reference that wait for a plane the port
# does not have, each with the plane it waits for
_NOT_PORTED = {
    "num_servers": "the parameter-server role set",
    "history_s": "the obs time-series plane",
    "gang_poll_s": "the obs gang aggregation plane",
    "profile_hz": "the obs sampling profiler",
    "control": "the obs control plane",
    "scheduler": "the multi-tenant pipeline scheduler",
    "slo": "the obs SLO plane",
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
    """This process's tracker role (reference: DMLC_ROLE); 'worker' when
    unset."""
    return os.environ.get("DMLC_ROLE", "worker")


def init_from_env(device=None) -> Tuple[int, int]:
    """Worker-side rendezvous: ``torch.distributed.init_process_group``
    from the env contract. Returns (rank, world size).

    The backend follows ``device`` (``cuda`` by default): ``nccl`` on
    the card, ``gloo`` only when the caller asks for ``"cpu"``; the
    store is TCP at the coordinator's host:port. With no coordinator in
    the env this is single-process mode: it returns (0, 1) and creates
    no group. A process group that already exists is kept (its rank and
    size are returned)."""
    import torch
    import torch.distributed as dist
    check(get_role() == "worker",
          f"init_from_env joins the WORKER gang; this process is a "
          f"{get_role()!r} (branch on get_role() first)")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = _getenv(ENV_COORD)
    if coord is None:
        return 0, 1
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
            dev = torch.device("cuda", torch.cuda.current_device())
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
                 trace_dir: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 restart_policy=None,
                 faults=None,
                 serve_ports=None,
                 rendezvous: bool = False,
                 heartbeat_grace_s: Optional[float] = None,
                 **options) -> List[int]:
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

    Returns the exit codes in rank order: all 0, except that in an
    elastic rendezvous gang a shrink is NOT a failure and a dead
    member's nonzero code is returned instead of raised. The
    reference's other options (``num_servers``, ``history_s``,
    ``gang_poll_s``, ``profile_hz``, ``control``, ``scheduler``,
    ``slo``) raise a DMLCError naming the plane each waits for."""
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(
                f"launch_local() got an unexpected keyword argument {name!r}")
        if value not in (None, False, 0):
            raise DMLCError(
                f"launch_local({name}=...) is not ported to dmlc_tpu_torch "
                f"yet (it waits for {_NOT_PORTED[name]})")
    check(num_workers >= 1, "num_workers must be >= 1")
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
    if coordinator is None:
        coordinator = f"127.0.0.1:{find_free_port()}"
    from dmlc_tpu_torch.obs.flight import ENV_FLIGHT_DIR
    from dmlc_tpu_torch.resilience import inject as _inject
    from dmlc_tpu_torch.resilience.supervise import (
        GangMember, GangSupervisor, RestartPolicy,
    )
    from dmlc_tpu_torch.obs.serve import ENV_SERVE_PORT, ENV_SERVE_PORTS
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
    members: List[GangMember] = []
    for task_id in range(num_workers):
        wenv = dict(os.environ)
        if env:
            wenv.update(env)
        if fault_spec is not None:
            wenv[_inject.ENV_FAULTS] = fault_spec
        if fault_seed is not None:
            wenv[_inject.ENV_FAULT_SEED] = fault_seed
        wenv.update(worker_envs(coordinator, num_workers, task_id))
        if trace_dir is not None:
            wenv[ENV_TRACE_DIR] = trace_dir
        if serve_ports is not None:
            wenv[ENV_SERVE_PORT] = str(serve_ports[task_id])
            wenv[ENV_SERVE_PORTS] = ",".join(map(str, serve_ports))
        if flight_dir is not None:
            wenv[ENV_FLIGHT_DIR] = flight_dir
        if rndv_service is not None:
            from dmlc_tpu_torch.rendezvous import (
                ENV_RNDV_GANG, ENV_RNDV_PORT, ENV_RNDV_URI,
            )
            wenv[ENV_RNDV_URI] = rndv_service.host
            wenv[ENV_RNDV_PORT] = str(rndv_service.port)
            wenv[ENV_RNDV_GANG] = rndv_gang
        members.append(GangMember(f"worker-{task_id}", "worker",
                                  task_id, command, wenv))
    # the supervisor owns spawning (a Popen failure mid-loop must not
    # leak the running half of the gang), the poll, restarts and the
    # timeout
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
