"""Multi-process distributed training via the launcher + rendezvous.

Twin of ``examples/distributed_launch.py`` on ``dmlc_tpu_torch``. The
reference launches jobs with ``dmlc-submit --cluster local -n N`` and a
socket tracker; here the same shape is ``launch_local`` and a
``torch.distributed`` group formed from the env contract
(``dmlc_tpu_torch.parallel.launch``, with the reference's ``DMLC_*``
names).

Run directly: this script re-executes ITSELF as 2 worker processes
(``--worker``), each owning 2 parts of one 4-part mesh. The workers
rendezvous, stream disjoint shards through ShardedRowBlockIter, train a
SparseLinearModel collectively (gradients all-reduced over the group),
checkpoint, and exit. The parent then restores the checkpoint in one
process and prints the loss.

On the card (the default) each rank needs a CUDA card of its own: NCCL
refuses two ranks on one card. On a host with fewer cards than ranks
the script raises ``NotEnoughCardsError`` before it starts anything.
``--device cpu`` runs the workers on the host over gloo. There is no
fallback from one to the other. It prints what the reference's example
prints, its device counts in mesh parts.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
NUM_FEATURES = 512
WORKERS = 2
PARTS_PER_WORKER = 2


def make_data(path: str) -> None:
    import numpy as np
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for i in range(4000):
            idx = np.sort(rng.choice(NUM_FEATURES, rng.randint(2, 10),
                                     replace=False))
            feats = " ".join(f"{j}:{rng.rand():.4f}" for j in idx)
            f.write(f"{i % 2} {feats}\n")


def worker(data: str, ckpt: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    from dmlc_tpu_torch.models import SparseLinearModel
    from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

    # a card a rank: rank r (its task id) takes card r
    dev = torch.device(device if device == "cpu" else
                       f"cuda:{int(os.environ['DMLC_TPU_TASK_ID'])}")
    rank, world = init_from_env(device=dev)
    mesh = Mesh((PARTS_PER_WORKER * world,), ("data",),
                group=dist.group.WORLD, device=dev)
    model = SparseLinearModel(NUM_FEATURES, learning_rate=0.5, device=dev)
    step = model.make_sharded_train_step(mesh)
    it = ShardedRowBlockIter(data, mesh, format="libsvm",
                             row_bucket=256, nnz_bucket=2048)
    loss = None
    for _epoch in range(3):
        for batch in it:
            loss = step(batch)
    ShardedCheckpoint(ckpt).save(1, model.state_dict(),
                                 metadata={"loss": float(loss)})
    # one write a line: the two workers share the parent's stdout
    sys.stdout.write(f"[worker {rank}/{world}] devices={mesh.size} "
                     f"final loss={float(loss):.4f}\n")
    sys.stdout.flush()
    it.close()
    finalize()


def main(device: str) -> None:
    import torch

    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
    from dmlc_tpu_torch.parallel.launch import (
        NotEnoughCardsError, launch_local,
    )

    if device == "cuda" and torch.cuda.device_count() < WORKERS:
        raise NotEnoughCardsError(
            f"distributed_launch on the card runs {WORKERS} NCCL ranks, "
            f"one CUDA card each; this host has "
            f"{torch.cuda.device_count()} (pass --device cpu for gloo "
            "on the host)")
    with TemporaryDirectory() as tmp:
        data = os.path.join(tmp.path, "dist.libsvm")
        ckpt = os.path.join(tmp.path, "ckpt")
        make_data(data)
        env = {"PYTHONPATH": os.pathsep.join(
            [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
        launch_local(WORKERS, [sys.executable, os.path.abspath(__file__),
                               "--worker", data, ckpt, "--device", device],
                     env=env, timeout=600)

        # restore on the parent (another process count: resharding-legal)
        flat, meta = ShardedCheckpoint(ckpt).restore()
        print(f"parent restored params w[:4]={flat['w'][:4].tolist()} "
              f"trained loss={meta['loss']:.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default: NCCL, a card a rank) or cpu "
                         "(gloo)")
    ap.add_argument("--worker", nargs=2, metavar=("DATA", "CKPT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.device)
    else:
        main(args.device)
