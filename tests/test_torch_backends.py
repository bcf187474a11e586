"""The port's cluster submit generators (``dmlc_tpu_torch.parallel.backends``)
against the JAX package's: ``mpi_command``, ``slurm_script``,
``sge_script`` and ``kubernetes_manifest`` give the reference's strings
(and manifest) for the same arguments, with and without the rendezvous
contract, from an explicit address or the submit host's env. The
generated scripts and the mpirun line are also run, under stub
schedulers on PATH (a fake ``srun``/``mpirun``, SGE's task id), so the
rank injection executes; ``submit=True`` runs the mpirun line and raises
on a failure, as the reference's does."""

import json
import os
import stat
import subprocess
import sys

import pytest

from dmlc_tpu.parallel import backends as ref_backends
from dmlc_tpu_torch.parallel import backends
from dmlc_tpu_torch.utils.logging import DMLCError

COORD = "10.0.0.1:9876"
RNDV_NAMES = ("DMLC_TPU_RNDV_URI", "DMLC_TPU_RNDV_PORT",
              "DMLC_TPU_RNDV_GANG")

# worker: append "<rank> <nworker> <coord> <rank> <role>" to RESULTS
WORKER = [sys.executable, "-c",
          "import os;"
          "f=open(os.environ['RESULTS'],'a');"
          "f.write(' '.join([os.environ['DMLC_TPU_TASK_ID'],"
          "os.environ['DMLC_TPU_NUM_WORKER'],"
          "os.environ['DMLC_TPU_COORDINATOR_URI'],"
          "os.environ['DMLC_TASK_ID'],os.environ['DMLC_ROLE'],"
          "os.environ.get('DMLC_TPU_RNDV_GANG', '-')])+'\\n');"
          "f.close()"]

COMMANDS = {"plain": ["python", "train.py"],
            "quoted": ["python", "-c", "print('it''s a b')", "--x=a b"],
            "worker": WORKER}
CASES = [(2, "plain", None, None), (4, "quoted", None, None),
         (3, "worker", ("rndv.example", 9901), "g1"),
         (1, "plain", ("h", 1), None)]


@pytest.fixture(autouse=True)
def _no_rendezvous_env(monkeypatch):
    for name in RNDV_NAMES:
        monkeypatch.delenv(name, raising=False)


def _both(fn_name, *args, **kw):
    return (getattr(backends, fn_name)(*args, **kw),
            getattr(ref_backends, fn_name)(*args, **kw))


@pytest.mark.parametrize("n,cmd,addr,gang", CASES)
def test_mpi_command_equals_reference(n, cmd, addr, gang):
    for hf in (None, "/etc/hosts file"):
        got, want = _both("mpi_command", n, COMMANDS[cmd], COORD,
                          host_file=hf, rendezvous_addr=addr,
                          rendezvous_gang=gang)
        assert got == want and got.startswith(f"mpirun -n {n}")


@pytest.mark.parametrize("n,cmd,addr,gang", CASES)
def test_slurm_script_equals_reference(n, cmd, addr, gang):
    for kw in ({}, {"partition": "gpu", "job_name": "j",
                    "time_limit": "02:00:00"}):
        got, want = _both("slurm_script", n, COMMANDS[cmd], COORD,
                          rendezvous_addr=addr, rendezvous_gang=gang, **kw)
        assert got == want and f"#SBATCH --ntasks={n}" in got


@pytest.mark.parametrize("n,cmd,addr,gang", CASES)
def test_sge_script_equals_reference(n, cmd, addr, gang):
    for kw in ({}, {"queue": "gpu.q", "job_name": "j"}):
        got, want = _both("sge_script", n, COMMANDS[cmd], COORD,
                          rendezvous_addr=addr, rendezvous_gang=gang, **kw)
        assert got == want and f"#$ -t 1-{n}" in got


@pytest.mark.parametrize("n,cmd,addr,gang", CASES)
def test_kubernetes_manifest_equals_reference(n, cmd, addr, gang):
    got, want = _both("kubernetes_manifest", n, COMMANDS[cmd], COORD,
                      image="my/img:1", job_name="job",
                      rendezvous_addr=addr, rendezvous_gang=gang)
    assert got == want
    assert json.dumps(got) == json.dumps(want)  # the same order too
    env = got["spec"]["template"]["spec"]["containers"][0]["env"]
    names = [e["name"] for e in env]
    assert "DMLC_TPU_TASK_ID" in names and "DMLC_TASK_ID" in names
    assert len(names) == len(set(names))


def test_the_submit_hosts_rendezvous_env_is_forwarded(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_RNDV_URI", "10.0.0.5")
    monkeypatch.setenv("DMLC_TPU_RNDV_PORT", "9200")
    for name, kw in (("mpi_command", {}), ("slurm_script", {}),
                     ("sge_script", {}),
                     ("kubernetes_manifest", {"image": "i"})):
        got, want = _both(name, 2, ["w"], COORD, **kw)
        assert got == want
        assert "10.0.0.5" in json.dumps(got)


def test_a_world_of_zero_is_refused():
    for name, kw in (("mpi_command", {}), ("slurm_script", {}),
                     ("sge_script", {}),
                     ("kubernetes_manifest", {"image": "i"})):
        with pytest.raises(DMLCError, match="num_workers"):
            getattr(backends, name)(0, ["w"], COORD, **kw)

# ---------------------------------------------------------------- executed


def _write_stub(dir_path, name, body):
    p = os.path.join(dir_path, name)
    with open(p, "w") as f:
        f.write("#!/bin/bash\n" + body)
    os.chmod(p, os.stat(p).st_mode | stat.S_IEXEC)


MPIRUN = r"""
n=1; declare -a exports
while [ $# -gt 0 ]; do
  case "$1" in
    -n) n="$2"; shift 2;;
    -x) exports+=("$2"); shift 2;;
    --hostfile) shift 2;;
    *) break;;
  esac
done
for ((r=0; r<n; r++)); do
  env "${exports[@]}" OMPI_COMM_WORLD_RANK=$r "$@" || exit 1
done
"""


def _results(path):
    with open(path) as f:
        return sorted(line.split() for line in f.read().splitlines())


def _expect(n, gang="-"):
    return sorted([str(r), str(n), COORD, str(r), "worker", gang]
                  for r in range(n))


def test_mpi_submit_runs_the_line(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _write_stub(str(bindir), "mpirun", MPIRUN)
    results = tmp_path / "out.txt"
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("RESULTS", str(results))
    line = backends.mpi_command(3, WORKER, COORD, submit=True,
                                rendezvous_addr=("r", 1),
                                rendezvous_gang="g9")
    assert line == ref_backends.mpi_command(3, WORKER, COORD,
                                            rendezvous_addr=("r", 1),
                                            rendezvous_gang="g9")
    assert _results(results) == _expect(3, "g9")
    with pytest.raises(DMLCError, match="mpirun exited"):
        backends.mpi_command(1, [sys.executable, "-c",
                                 "import sys; sys.exit(5)"], COORD,
                             submit=True)


def test_slurm_script_runs_under_a_stub_srun(tmp_path):
    script = backends.slurm_script(3, WORKER, COORD, partition="gpu")
    syn = subprocess.run(["bash", "-n"], input=script, text=True,
                         capture_output=True)
    assert syn.returncode == 0, syn.stderr
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _write_stub(str(bindir), "srun",
                'for r in 0 1 2; do SLURM_PROCID=$r "$@" || exit 1; done\n')
    results = tmp_path / "out.txt"
    sh = tmp_path / "job.sh"
    sh.write_text(script)
    run = subprocess.run(
        ["bash", str(sh)],
        env={**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}",
             "RESULTS": str(results)},
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert _results(results) == _expect(3)


def test_sge_script_runs_once_a_task(tmp_path):
    script = backends.sge_script(3, WORKER, COORD, queue="gpu.q",
                                 rendezvous_addr=("r", 2),
                                 rendezvous_gang="gs")
    results = tmp_path / "out.txt"
    sh = tmp_path / "job.sh"
    sh.write_text(script)
    for task in (1, 2, 3):
        run = subprocess.run(
            ["bash", str(sh)],
            env={**os.environ, "SGE_TASK_ID": str(task),
                 "RESULTS": str(results)},
            capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
    assert _results(results) == _expect(3, "gs")
