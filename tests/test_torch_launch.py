"""The port's launcher (``dmlc_tpu_torch.parallel.launch``) against the
JAX package's: the topology helpers and the env contract equal the
reference's exactly; ``launch_local`` runs real worker processes (ranks
read from their env, a failure propagated, a gang killed at its
timeout); every option that waits for an unported plane raises a named
error, and the resilience plane's options (``flight_dir``,
``restart_policy``, ``faults``) and the gang plane's (``serve_ports``,
``rendezvous``, ``heartbeat_grace_s``) are accepted; ``init_from_env`` without a coordinator is single-process mode
and, with one, forms a gloo group in a subprocess (never in this
process).
"""

import json
import os
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


@pytest.mark.parametrize("option,value", [
    ("num_servers", 1),
    ("history_s", 1.0), ("gang_poll_s", 1.0),
    ("profile_hz", 10.0), ("control", True), ("scheduler", True),
    ("slo", True)])
def test_unported_options_raise_named_errors(option, value):
    with pytest.raises(DMLCError, match="not ported.*waits for"):
        launch.launch_local(1, [sys.executable, "-c", "pass"],
                            **{option: value})


@pytest.mark.parametrize("option", ["flight_dir", "restart_policy",
                                    "faults"])
def test_resilience_options_are_ported(option, tmp_path):
    # the resilience plane's three options leave the refusal list: a
    # clean worker under each exits 0 and the launch returns its code
    value = {"flight_dir": str(tmp_path / "flight"), "restart_policy": 1,
             "faults": "site=never.fires,fault=ioerror,nth=9"}[option]
    assert option not in launch._NOT_PORTED
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
    assert option not in launch._NOT_PORTED
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
