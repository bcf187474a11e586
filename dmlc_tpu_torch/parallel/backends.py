"""Cluster submission backends: command/manifest generation.

Copy of ``dmlc_tpu/parallel/backends.py`` with its imports rewritten to
``dmlc_tpu_torch``, over the port's ``worker_envs`` and
``rendezvous_envs``: each generator's output is string for string the
reference's for the same arguments.

Reference: tracker/dmlc_tracker/{mpi,slurm,sge,kubernetes}.py — thin
per-scheduler submit wrappers around the same env contract. Re-designed
as pure generators (return the command line / script / manifest) so they
are testable without the scheduler; ``submit=True`` executes them.

The reference's YARN Java client (tracker/yarn/*.java) and mesos.py are
explicit non-goals (SURVEY.md §7): both are thin wrappers over the same
env contract and plug in the same way via these generators.
"""

from __future__ import annotations

import shlex
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

from dmlc_tpu_torch.parallel.launch import rendezvous_envs, worker_envs
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["mpi_command", "slurm_script", "sge_script",
           "kubernetes_manifest"]


def _rank_agnostic_envs(num_workers: int, coordinator: str,
                        rendezvous_addr: Optional[Tuple[str, int]] = None,
                        rendezvous_gang: Optional[str] = None
                        ) -> Dict[str, str]:
    """worker_envs minus the per-rank ids (schedulers inject those),
    plus the rendezvous contract (``DMLC_TPU_RNDV_URI/PORT/GANG``) —
    explicit addr wins, else the submit host's own env is forwarded, so
    scheduler-launched gangs reach the same elastic membership service
    that launch_local/launch_ssh gangs do."""
    check(num_workers >= 1, "num_workers must be >= 1")
    envs = worker_envs(coordinator, num_workers, 0)
    envs.pop("DMLC_TPU_TASK_ID")
    envs.pop("DMLC_TASK_ID")
    envs.update(rendezvous_envs(rendezvous_addr, rendezvous_gang))
    return envs


def mpi_command(num_workers: int, command: Sequence[str], coordinator: str,
                host_file: Optional[str] = None,
                submit: bool = False,
                rendezvous_addr: Optional[Tuple[str, int]] = None,
                rendezvous_gang: Optional[str] = None) -> str:
    """mpirun launch line (reference: mpi.py — MPI as a *launcher* only;
    data-plane comms stay the gang's own collectives, never MPI)."""
    # rank-dependent task id comes from the MPI rank at runtime
    envs = _rank_agnostic_envs(num_workers, coordinator,
                               rendezvous_addr, rendezvous_gang)
    exports = " ".join(f"-x {k}={shlex.quote(v)}" for k, v in envs.items())
    hf = f"--hostfile {shlex.quote(host_file)} " if host_file else ""
    cmd_str = " ".join(shlex.quote(c) for c in command)
    # single shlex.quote layer around the whole inner script: manual
    # '...' wrapping broke on commands containing quotes (regression
    # caught by tests/test_backends_exec.py stub execution)
    inner = ("DMLC_TPU_TASK_ID=$OMPI_COMM_WORLD_RANK "
             "DMLC_TASK_ID=$OMPI_COMM_WORLD_RANK exec " + cmd_str)
    line = (f"mpirun -n {num_workers} {hf}{exports} "
            f"sh -c {shlex.quote(inner)}")
    if submit:
        rc = subprocess.run(line, shell=True).returncode
        if rc:
            raise DMLCError(f"mpirun exited {rc}")
    return line


def slurm_script(num_workers: int, command: Sequence[str], coordinator: str,
                 job_name: str = "dmlc-tpu", partition: Optional[str] = None,
                 time_limit: str = "01:00:00",
                 rendezvous_addr: Optional[Tuple[str, int]] = None,
                 rendezvous_gang: Optional[str] = None) -> str:
    """sbatch script (reference: slurm.py). Task id = $SLURM_PROCID."""
    envs = _rank_agnostic_envs(num_workers, coordinator,
                               rendezvous_addr, rendezvous_gang)
    exports = "\n".join(f"export {k}={shlex.quote(v)}"
                        for k, v in envs.items())
    part = f"#SBATCH --partition={partition}\n" if partition else ""
    cmd_str = " ".join(shlex.quote(c) for c in command)
    # one shlex.quote layer for the bash -c payload (see mpi_command)
    inner = ("DMLC_TPU_TASK_ID=$SLURM_PROCID DMLC_TASK_ID=$SLURM_PROCID "
             "exec " + cmd_str)
    return f"""#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --ntasks={num_workers}
#SBATCH --time={time_limit}
{part}{exports}
srun bash -c {shlex.quote(inner)}
"""


def sge_script(num_workers: int, command: Sequence[str], coordinator: str,
               job_name: str = "dmlc-tpu", queue: Optional[str] = None,
               rendezvous_addr: Optional[Tuple[str, int]] = None,
               rendezvous_gang: Optional[str] = None) -> str:
    """qsub array-job script (reference: sge.py). Task id = $SGE_TASK_ID-1."""
    envs = _rank_agnostic_envs(num_workers, coordinator,
                               rendezvous_addr, rendezvous_gang)
    exports = "\n".join(f"export {k}={shlex.quote(v)}"
                        for k, v in envs.items())
    q = f"#$ -q {queue}\n" if queue else ""
    cmd_str = " ".join(shlex.quote(c) for c in command)
    return f"""#!/bin/bash
#$ -N {job_name}
#$ -t 1-{num_workers}
#$ -cwd
{q}{exports}
export DMLC_TPU_TASK_ID=$(($SGE_TASK_ID - 1))
export DMLC_TASK_ID=$DMLC_TPU_TASK_ID
exec {cmd_str}
"""


def kubernetes_manifest(num_workers: int, command: Sequence[str],
                        coordinator: str, image: str,
                        job_name: str = "dmlc-tpu",
                        rendezvous_addr: Optional[Tuple[str, int]] = None,
                        rendezvous_gang: Optional[str] = None) -> Dict:
    """Indexed-completion k8s Job (reference: kubernetes.py). Task id =
    $JOB_COMPLETION_INDEX (native indexed jobs replace the reference's
    hand-rolled pod numbering)."""
    envs = _rank_agnostic_envs(num_workers, coordinator,
                               rendezvous_addr, rendezvous_gang)
    env_list = [{"name": k, "value": v} for k, v in envs.items()]
    index_ref = {"valueFrom": {"fieldRef": {"fieldPath":
        "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}}
    env_list.append({"name": "DMLC_TPU_TASK_ID", **index_ref})
    env_list.append({"name": "DMLC_TASK_ID", **index_ref})
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": job_name},
        "spec": {
            "completions": num_workers,
            "parallelism": num_workers,
            "completionMode": "Indexed",
            "template": {
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "worker",
                        "image": image,
                        "command": list(command),
                        "env": env_list,
                    }],
                },
            },
        },
    }
