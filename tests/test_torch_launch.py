"""The port's launcher (``dmlc_tpu_torch.parallel.launch``) against the
JAX package's: the topology helpers, the env contract, ``rendezvous_envs``
and ``launch_ssh``'s command lines equal the reference's exactly;
``launch_local`` runs real worker processes (ranks read from their env, a
failure propagated, a gang killed at its timeout) and, with
``num_servers``, the parameter-server role set with the env each role of
the reference's sees; the submit CLI ``main`` runs a gang; every option
that waits for an unported plane raises a named error, and the resilience plane's options (``flight_dir``,
``restart_policy``, ``faults``) and the gang plane's (``serve_ports``,
``rendezvous``, ``heartbeat_grace_s``) are accepted; ``init_from_env`` without a coordinator is single-process mode
and, with one, forms a gloo group in a subprocess (never in this
process).
"""

import json
import os
import subprocess
import sys
import time

import pytest

from dmlc_tpu.parallel import launch as ref_launch
from dmlc_tpu_torch.parallel import launch
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 16, 33])
def test_topology_equals_reference(n):
    assert launch.get_ring(n) == ref_launch.get_ring(n)
    assert launch.get_tree(n) == ref_launch.get_tree(n)
    assert launch.get_link_map(n) == ref_launch.get_link_map(n)


def test_topology_rejects_empty():
    with pytest.raises(DMLCError):
        launch.get_ring(0)
    with pytest.raises(DMLCError):
        launch.get_tree(0)


@pytest.mark.parametrize("coord,n,task", [("127.0.0.1:9000", 4, 2),
                                          ("host:1", 1, 0)])
def test_env_contract_equals_reference(coord, n, task):
    assert (launch.worker_envs(coord, n, task)
            == ref_launch.worker_envs(coord, n, task))
    for role in ("scheduler", "server", "worker"):
        assert (launch.ps_envs("h", 5, n, 2, role, task)
                == ref_launch.ps_envs("h", 5, n, 2, role, task))
    with pytest.raises(DMLCError, match="host:port"):
        launch.worker_envs("nocolon", 1, 0)
    with pytest.raises(DMLCError, match="role"):
        launch.ps_envs("h", 5, 1, 1, "boss")


def test_alias_reads(monkeypatch):
    for name in (launch.ENV_COORD, launch.ENV_NWORKER, launch.ENV_TASK_ID,
                 "DMLC_TRACKER_URI", "DMLC_NUM_WORKER", "DMLC_TASK_ID",
                 "DMLC_ROLE"):
        monkeypatch.delenv(name, raising=False)
    assert launch._getenv(launch.ENV_COORD) is None
    monkeypatch.setenv("DMLC_TRACKER_URI", "10.0.0.1:7")
    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    assert launch._getenv(launch.ENV_COORD) == "10.0.0.1:7"
    assert launch._getenv(launch.ENV_NWORKER) == "3"
    monkeypatch.setenv(launch.ENV_COORD, "127.0.0.1:8")
    assert launch._getenv(launch.ENV_COORD) == "127.0.0.1:8"  # ours wins
    assert launch.get_role() == ref_launch.get_role() == "worker"
    monkeypatch.setenv("DMLC_ROLE", "server")
    assert launch.get_role() == "server"
    with pytest.raises(DMLCError, match="WORKER gang"):
        launch.init_from_env(device="cpu")


def test_init_from_env_without_coordinator_is_single_process(monkeypatch):
    import torch.distributed as dist
    for name in (launch.ENV_COORD, "DMLC_TRACKER_URI", "DMLC_ROLE"):
        monkeypatch.delenv(name, raising=False)
    assert launch.init_from_env(device="cpu") == (0, 1)
    assert not dist.is_initialized()
    launch.finalize()  # no group: a no-op


def test_free_ports_are_distinct():
    ports = launch.find_free_ports(16)
    assert len(set(ports)) == 16
    assert all(0 < p < 65536 for p in ports)
    assert 0 < launch.find_free_port() < 65536


_RANK = (
    "import json, os, sys\n"
    "from dmlc_tpu_torch.parallel.launch import ENV_NWORKER, ENV_TASK_ID, "
    "_getenv\n"
    "rank = int(_getenv(ENV_TASK_ID))\n"
    "with open(os.path.join(sys.argv[1], f'{rank}.json'), 'w') as f:\n"
    "    json.dump({'rank': rank, 'world': int(_getenv(ENV_NWORKER)),\n"
    "               'role': os.environ['DMLC_ROLE'],\n"
    "               'extra': os.environ.get('EXTRA')}, f)\n")


def test_launch_local_spawns_workers_with_their_ranks(tmp_path):
    codes = launch.launch_local(
        2, [sys.executable, "-c", _RANK, str(tmp_path)],
        env={**ENV, "EXTRA": "x"}, timeout=60)
    assert codes == [0, 0]
    got = [json.load(open(tmp_path / f"{r}.json")) for r in range(2)]
    assert got == [{"rank": r, "world": 2, "role": "worker", "extra": "x"}
                   for r in range(2)]


def test_launch_local_propagates_a_failure_and_kills_the_gang(tmp_path):
    marker = tmp_path / "survivor"
    slow = (f"import time; time.sleep(30); "
            f"open({str(marker)!r}, 'w').write('x')")
    fail = ("import os, sys, time; from dmlc_tpu_torch.parallel.launch "
            "import ENV_TASK_ID, _getenv\n"
            "if _getenv(ENV_TASK_ID) == '1': sys.exit(3)\n" + slow)
    t0 = time.monotonic()
    with pytest.raises(DMLCError, match="exit codes"):
        launch.launch_local(2, [sys.executable, "-c", fail], env=ENV,
                            timeout=60)
    assert time.monotonic() - t0 < 25
    assert not marker.exists()


def test_launch_local_kills_everyone_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(DMLCError, match="timeout"):
        launch.launch_local(2, [sys.executable, "-c",
                                "import time; time.sleep(60)"],
                            env=ENV, timeout=2)
    assert time.monotonic() - t0 < 20


# each analytic obs plane's option, the env it sets and the value a
# worker must see there (gang_poll_s reaches rank 0 only)
_OBS_OPTION_ENV = {
    "history_s": ("DMLC_TPU_HISTORY_S", "1.0"),
    "gang_poll_s": ("DMLC_TPU_GANG_POLL_S", "1.0"),
    "profile_hz": ("DMLC_TPU_PROFILE_HZ", "10.0"),
    "control": ("DMLC_TPU_CONTROL", "1"),
    "scheduler": ("DMLC_TPU_SCHED", "quantum=4,queue=32"),
    "slo": ("DMLC_TPU_SLO", "1"),
}


@pytest.mark.parametrize("option,value", [
    ("history_s", 1.0), ("gang_poll_s", 1.0),
    ("profile_hz", 10.0), ("control", True),
    ("scheduler", "quantum=4,queue=32"), ("slo", True)])
def test_obs_plane_options_set_their_env(option, value):
    """The analytic obs planes' options hand their workers the
    reference's env contracts; ``gang_poll_s`` goes to rank 0 only."""
    name, want = _OBS_OPTION_ENV[option]
    code = ("import os, sys\n"
            "rank = int(os.environ['DMLC_TPU_TASK_ID'])\n"
            f"got = os.environ.get({name!r})\n"
            f"want = {want!r} if rank == 0 or {option != 'gang_poll_s'} "
            "else None\n"
            "sys.exit(0 if got == want else 3)\n")
    assert launch.launch_local(2, [sys.executable, "-c", code], env=ENV,
                               timeout=60, **{option: value}) == [0, 0]


@pytest.mark.parametrize("option", ["flight_dir", "restart_policy",
                                    "faults"])
def test_resilience_options_are_ported(option, tmp_path):
    # the resilience plane's three options leave the refusal list: a
    # clean worker under each exits 0 and the launch returns its code
    value = {"flight_dir": str(tmp_path / "flight"), "restart_policy": 1,
             "faults": "site=never.fires,fault=ioerror,nth=9"}[option]
    assert launch.launch_local(1, [sys.executable, "-c", "pass"],
                               env=ENV, timeout=60,
                               **{option: value}) == [0]


# each gang-plane option and the env its worker must see
_GANG_OPTION_ENV = {
    "serve_ports": ("DMLC_TPU_SERVE_PORT", "DMLC_TPU_SERVE_PORTS"),
    "rendezvous": ("DMLC_TPU_RNDV_URI", "DMLC_TPU_RNDV_PORT",
                   "DMLC_TPU_RNDV_GANG"),
    "heartbeat_grace_s": ("DMLC_TPU_RNDV_URI", "DMLC_TPU_RNDV_PORT"),
}


@pytest.mark.parametrize("option,value", [
    ("serve_ports", True), ("rendezvous", True), ("heartbeat_grace_s", 1.0)])
def test_gang_options_are_ported(option, value):
    """The gang plane's options leave the refusal list: each hands its
    worker the reference's env contract (``heartbeat_grace_s`` with the
    rendezvous it tunes), and the launch returns the worker's code."""
    kw = {option: value}
    if option == "heartbeat_grace_s":
        kw["rendezvous"] = True
    code = ("import os, sys\n"
            f"names = {_GANG_OPTION_ENV[option]!r}\n"
            "sys.exit(0 if all(os.environ.get(n) for n in names) "
            "else 3)\n")
    assert launch.launch_local(1, [sys.executable, "-c", code], env=ENV,
                               timeout=60, **kw) == [0]


def test_serve_ports_one_a_worker(tmp_path):
    """serve_ports takes an explicit list, one port a worker, and
    refuses a list of another length; each worker sees its own port and
    the gang's list."""
    ports = launch.find_free_ports(2)
    code = ("import os, sys\n"
            "r = int(os.environ['DMLC_TPU_TASK_ID'])\n"
            "open(os.path.join(sys.argv[1], f'{r}.txt'), 'w').write(\n"
            "    os.environ['DMLC_TPU_SERVE_PORT'] + ' ' +\n"
            "    os.environ['DMLC_TPU_SERVE_PORTS'])\n")
    assert launch.launch_local(2, [sys.executable, "-c", code,
                                   str(tmp_path)], env=ENV, timeout=60,
                               serve_ports=ports) == [0, 0]
    for r in range(2):
        assert (tmp_path / f"{r}.txt").read_text() == \
            f"{ports[r]} {ports[0]},{ports[1]}"
    with pytest.raises(DMLCError, match="one port per worker"):
        launch.launch_local(2, [sys.executable, "-c", "pass"],
                            serve_ports=ports[:1])


def test_elastic_gang_returns_a_dead_members_code():
    """In a rendezvous gang a worker that dies (with no restart left)
    shrinks the membership: launch_local returns its code instead of
    raising, as the reference's does; without the rendezvous the same
    death raises."""
    code = ("import os, sys, time\n"
            "r = int(os.environ['DMLC_TPU_TASK_ID'])\n"
            "sys.exit(3) if r == 1 else time.sleep(1.0)\n")
    assert launch.launch_local(2, [sys.executable, "-c", code], env=ENV,
                               timeout=60, rendezvous=True) == [0, 3]
    with pytest.raises(DMLCError):
        launch.launch_local(2, [sys.executable, "-c", code], env=ENV,
                            timeout=60)


def test_unknown_option_is_a_type_error():
    with pytest.raises(TypeError, match="bogus"):
        launch.launch_local(1, [sys.executable, "-c", "pass"], bogus=1)


_GLOO = (
    "import json, sys\n"
    "import torch, torch.distributed as dist\n"
    "from dmlc_tpu_torch.parallel.launch import finalize, init_from_env\n"
    "rank, world = init_from_env(device='cpu')\n"
    "t = torch.tensor([rank + 1.0])\n"
    "dist.all_reduce(t)\n"
    "backend = dist.get_backend()\n"
    "finalize()\n"
    "with open(sys.argv[1] + f'/{rank}.json', 'w') as f:\n"
    "    json.dump([rank, world, backend, float(t), dist.is_initialized()],"
    " f)\n")


def test_init_from_env_forms_a_gloo_group(tmp_path):
    launch.launch_local(2, [sys.executable, "-c", _GLOO, str(tmp_path)],
                        env=ENV, timeout=60)
    got = [json.load(open(tmp_path / f"{r}.json")) for r in range(2)]
    assert got == [[r, 2, "gloo", 3.0, False] for r in range(2)]


def test_init_from_env_on_cuda_needs_a_card(monkeypatch):
    """No card here: device cuda (the default) raises rather than falling
    back to gloo."""
    import torch
    assert not torch.cuda.is_available()
    monkeypatch.setenv(launch.ENV_COORD, "127.0.0.1:1")
    monkeypatch.delenv("DMLC_ROLE", raising=False)
    with pytest.raises(DMLCError, match="NCCL"):
        launch.init_from_env()


# ---------------------------------------------------------------- PS roles

# each process writes what the reference's PS test reads: its role and
# task id in the file name, the PS root and world sizes in the body, and
# beside them the worker contract it was given (empty for service roles)
_ROLE = (
    "import json, os, sys\n"
    "e = os.environ\n"
    "role = e.get('DMLC_ROLE', 'worker')\n"
    "tid = e.get('DMLC_TASK_ID', 'x')\n"
    "keys = ('DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', 'DMLC_NUM_SERVER',\n"
    "        'DMLC_NUM_WORKER', 'DMLC_TPU_TASK_ID', 'DMLC_TPU_NUM_WORKER',\n"
    "        'DMLC_TPU_COORDINATOR_URI')\n"
    "with open(os.path.join(sys.argv[1], f'role-{role}-{tid}'), 'w') as f:\n"
    "    json.dump({k: e.get(k) for k in keys}, f)\n")


def _roles(tmp_path):
    return {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("role-*"))}


@pytest.mark.parametrize("num_servers", [1, 2])
def test_ps_role_set_equals_the_reference(tmp_path, num_servers):
    """launch_local(2, num_servers=N): N + 3 processes, workers first in
    rank order, then the scheduler, then the servers, every code 0;
    each sees the env the reference's ps_envs gives its role on the one
    PS root, and only the workers carry the worker contract."""
    codes = launch.launch_local(
        2, [sys.executable, "-c", _ROLE, str(tmp_path)], env=ENV,
        timeout=60, num_servers=num_servers)
    assert codes == [0] * (3 + num_servers)
    got = _roles(tmp_path)
    want = (["role-scheduler-0"]
            + [f"role-server-{i}" for i in range(num_servers)]
            + ["role-worker-0", "role-worker-1"])
    assert sorted(got) == sorted(want)
    uri = got["role-scheduler-0"]["DMLC_PS_ROOT_URI"]
    port = int(got["role-scheduler-0"]["DMLC_PS_ROOT_PORT"])
    assert uri == "127.0.0.1" and 0 < port < 65536
    for name, env in got.items():
        role, tid = name.split("-")[1], int(name.split("-")[2])
        ref = ref_launch.ps_envs(uri, port, 2, num_servers, role, tid)
        assert {k: env[k] for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
                                    "DMLC_NUM_SERVER", "DMLC_NUM_WORKER")} \
            == {k: ref[k] for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
                                    "DMLC_NUM_SERVER", "DMLC_NUM_WORKER")}
        if role == "worker":
            assert env["DMLC_TPU_TASK_ID"] == str(tid)
            assert env["DMLC_TPU_NUM_WORKER"] == "2"
            # the coordinator and the PS root are two distinct ports
            coord_port = int(env["DMLC_TPU_COORDINATOR_URI"].split(":")[1])
            assert coord_port != port
        else:
            assert env["DMLC_TPU_TASK_ID"] is None


def test_ps_role_set_equals_the_reference_launch(tmp_path):
    """The reference's launch_local(num_servers=2) and the port's give
    the same role set with the same env keys and sizes (the ports
    differ: each probes its own)."""
    ref_dir, dir_ = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    dir_.mkdir()
    ref_codes = ref_launch.launch_local(
        2, [sys.executable, "-c", _ROLE, str(ref_dir)], env=ENV,
        timeout=60, num_servers=2)
    codes = launch.launch_local(
        2, [sys.executable, "-c", _ROLE, str(dir_)], env=ENV, timeout=60,
        num_servers=2)
    assert codes == ref_codes == [0] * 5
    ref, got = _roles(ref_dir), _roles(dir_)
    assert sorted(got) == sorted(ref)

    def shape(env):
        return {k: (v if k in ("DMLC_NUM_SERVER", "DMLC_NUM_WORKER",
                               "DMLC_TPU_TASK_ID", "DMLC_TPU_NUM_WORKER",
                               "DMLC_PS_ROOT_URI") else v is not None)
                for k, v in env.items()}
    assert {n: shape(e) for n, e in got.items()} == \
        {n: shape(e) for n, e in ref.items()}


def test_service_roles_that_outlive_the_workers_are_drained(tmp_path):
    """A scheduler and a server that wait for work forever do not hang
    the launch once every worker finished: the supervisor terminates
    them after its grace and the launch returns."""
    code = ("import os, time\n"
            "if os.environ.get('DMLC_ROLE') != 'worker':\n"
            "    time.sleep(300)\n")
    t0 = time.monotonic()
    codes = launch.launch_local(1, [sys.executable, "-c", code], env=ENV,
                                timeout=120, num_servers=1)
    assert time.monotonic() - t0 < 60
    assert codes[0] == 0 and len(codes) == 3


def test_a_dead_worker_kills_the_waiting_role_set(tmp_path):
    """The reference's tests/test_launch.py case: with num_servers > 0
    and NO timeout, a worker dying at startup must not leave the
    scheduler and servers running; the launch raises with the codes and
    every survivor is gone."""
    script = (
        "import os, sys, time\n"
        "role = os.environ.get('DMLC_ROLE', 'worker')\n"
        "if role == 'worker' and os.environ['DMLC_TASK_ID'] == '0':\n"
        "    sys.exit(7)\n"
        f"open(r'{tmp_path}' + f'/pid-{{role}}-' +\n"
        "     os.environ.get('DMLC_TASK_ID', 'x'), 'w')"
        ".write(str(os.getpid()))\n"
        "time.sleep(300)\n")
    t0 = time.monotonic()
    with pytest.raises(DMLCError, match="exit codes"):
        launch.launch_local(2, [sys.executable, "-c", script], env=ENV,
                            num_servers=1)
    assert time.monotonic() - t0 < 60
    time.sleep(0.2)
    for pid_file in tmp_path.glob("pid-*"):
        text = pid_file.read_text()
        if text:
            with pytest.raises(OSError):
                os.kill(int(text), 0)


def test_negative_num_servers_is_refused():
    with pytest.raises(DMLCError, match="num_servers"):
        launch.launch_local(1, [sys.executable, "-c", "pass"],
                            num_servers=-1)

# ---------------------------------------------------------------- CLI, ssh


def test_cli_main_runs_a_gang(tmp_path):
    code = ("import os, sys\n"
            "open(os.path.join(sys.argv[1], 'cli-' +\n"
            "     os.environ['DMLC_TPU_TASK_ID']), 'w').close()\n")
    assert launch.main(["-n", "2", "--", sys.executable, "-c", code,
                        str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cli-0", "cli-1"]


def test_cli_main_with_servers_as_a_module(tmp_path):
    """``python -m dmlc_tpu_torch.parallel.launch -n 2 -s 1 -- cmd``: the
    CLI as a user runs it, spawning the PS role set."""
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.parallel.launch", "-n", "2",
         "-s", "1", "--", sys.executable, "-c", _ROLE, str(tmp_path)],
        env={**os.environ, **ENV}, cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(_roles(tmp_path)) == [
        "role-scheduler-0", "role-server-0", "role-worker-0",
        "role-worker-1"]


def test_cli_failure_and_refusals(tmp_path):
    with pytest.raises(DMLCError, match="exit codes"):
        launch.main(["-n", "1", "--", sys.executable, "-c",
                     "import sys; sys.exit(4)"])
    with pytest.raises(DMLCError, match="no worker command"):
        launch.main(["-n", "1"])
    with pytest.raises(DMLCError, match="local-cluster only"):
        launch.main(["--cluster", "ssh", "-n", "1", "-s", "1", "--", "x"])
    with pytest.raises(DMLCError, match="--host-file"):
        launch.main(["--cluster", "ssh", "-n", "1", "--", "x"])
    with pytest.raises(SystemExit):
        launch.main(["--", "x"])  # -n is required


@pytest.mark.parametrize("hosts,n,cmd", [
    (["hostA", "hostB"], 4, ["python", "train.py"]),
    (["h0"], None, ["python", "-c", "print('a b')", "--flag=x y"]),
    (["a", "b", "c"], 2, ["./run.sh", "it's"]),
])
def test_ssh_lines_equal_the_reference(monkeypatch, hosts, n, cmd):
    for name in ("DMLC_TPU_RNDV_URI", "DMLC_TPU_RNDV_PORT",
                 "DMLC_TPU_RNDV_GANG"):
        monkeypatch.delenv(name, raising=False)
    want = ref_launch.launch_ssh(hosts, cmd, "hostA:9000", num_workers=n,
                                 dry_run=True)
    got = launch.launch_ssh(hosts, cmd, "hostA:9000", num_workers=n,
                            dry_run=True)
    assert got == want and len(got) == (n or len(hosts))
    assert "DMLC_TPU_RNDV" not in "".join(got)
    want = ref_launch.launch_ssh(hosts, cmd, "hostA:9000", num_workers=n,
                                 dry_run=True, rendezvous_addr=("hostA", 9100),
                                 rendezvous_gang="g1")
    got = launch.launch_ssh(hosts, cmd, "hostA:9000", num_workers=n,
                            dry_run=True, rendezvous_addr=("hostA", 9100),
                            rendezvous_gang="g1")
    assert got == want
    assert all("DMLC_TPU_RNDV_GANG=g1" in line for line in got)


def test_ssh_runs_its_lines_and_raises_on_a_failure(tmp_path, monkeypatch):
    """Without dry_run each line runs (here under a stub ``ssh`` on PATH
    that runs the remote command locally); a failed host raises."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "ssh"
    stub.write_text("#!/bin/bash\nshift 3\nexec bash -c \"$1\"\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    out = tmp_path / "out"
    out.mkdir()
    # the lines single-quote the remote command as the reference's do, so
    # the worker is a script file (a quote in an argument would end them)
    script = tmp_path / "w.py"
    script.write_text("import os, sys\nopen(os.path.join(sys.argv[1], "
                      "os.environ['DMLC_TPU_TASK_ID']), 'w').close()\n")
    launch.launch_ssh(["h0", "h1"], [sys.executable, str(script), str(out)],
                      "h0:1", num_workers=3)
    assert sorted(p.name for p in out.iterdir()) == ["0", "1", "2"]
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nsys.exit(2)\n")
    with pytest.raises(DMLCError, match="ssh worker failure"):
        launch.launch_ssh(["h0"], [sys.executable, str(bad)], "h0:1")


@pytest.mark.parametrize("env,addr,gang", [
    ({}, None, None),
    ({}, ("10.0.0.9", 7000), None),
    ({}, ("h", 1), "g2"),
    ({"DMLC_TPU_RNDV_URI": "10.0.0.5", "DMLC_TPU_RNDV_PORT": "9200"},
     None, None),
    ({"DMLC_TPU_RNDV_URI": "10.0.0.5", "DMLC_TPU_RNDV_PORT": "9200",
      "DMLC_TPU_RNDV_GANG": "gx"}, None, None),
    ({"DMLC_TPU_RNDV_URI": "10.0.0.5"}, None, None),
    ({"DMLC_TPU_RNDV_URI": "10.0.0.5", "DMLC_TPU_RNDV_PORT": "9200"},
     ("explicit", 1), "g3"),
])
def test_rendezvous_envs_equal_the_reference(monkeypatch, env, addr, gang):
    for name in ("DMLC_TPU_RNDV_URI", "DMLC_TPU_RNDV_PORT",
                 "DMLC_TPU_RNDV_GANG"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert launch.rendezvous_envs(addr, gang) == \
        ref_launch.rendezvous_envs(addr, gang)
