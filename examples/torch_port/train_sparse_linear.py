"""End-to-end example through the PyTorch port: sharded libsvm ingest ->
data-parallel training -> sharded checkpoint -> resume.

Twin of ``examples/train_sparse_linear.py`` on ``dmlc_tpu_torch`` (the
reference's downstream usage: InputSplit -> Parser -> RowBlockIter
feeding a learner, reference: test/dataiter_test.cc + docs):

  1. generate a libsvm training file from a hidden linear rule
  2. ShardedRowBlockIter: every part of an 8-part mesh reads its own
     InputSplit partition; blocks are padded, stacked and copied to the
     device as one batch of the mesh's parts
  3. SparseLinearModel's sharded step: a CSR SpMV forward a part (the
     CUDA kernels on the card), the logistic loss summed over the parts
     and the group, SGD on the replicated parameters
  4. ShardedCheckpoint save / restore, then training resumes

Runs on the CUDA card; ``--device cpu`` runs it on the host (the
kernels' plain versions). There is no fallback: without a card and
without ``--device cpu`` it fails. One process drives the 8 parts; for
one process a host, launch it with ``python -m
dmlc_tpu_torch.parallel.launch --help``. It prints what the reference's
example prints, its device counts in mesh parts.
"""

import argparse
import os
import time

import numpy as np
import torch

from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.models import SparseLinearModel
from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

NUM_FEATURES = 2048
NUM_ROWS = 20_000
EPOCHS = 4
PARTS = 8


def make_dataset(path: str, seed: int = 0) -> np.ndarray:
    """libsvm file whose labels follow a hidden sparse linear rule."""
    rng = np.random.RandomState(seed)
    w_true = np.zeros(NUM_FEATURES, np.float32)
    hot = rng.choice(NUM_FEATURES, 64, replace=False)
    w_true[hot] = rng.randn(64)
    with open(path, "w") as f:
        for _ in range(NUM_ROWS):
            nnz = rng.randint(8, 40)
            idx = np.sort(rng.choice(NUM_FEATURES, nnz, replace=False))
            val = rng.rand(nnz).astype(np.float32)
            margin = float((val * w_true[idx]).sum())
            label = 1 if margin > 0.5 else 0
            f.write(f"{label} "
                    + " ".join(f"{j}:{v:.6f}" for j, v in zip(idx, val))
                    + "\n")
    return w_true


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)
    mesh = Mesh((PARTS,), ("data",), device=device)
    print(f"mesh: {mesh.size} devices on axis 'data'")

    with TemporaryDirectory() as tmp:
        data = os.path.join(tmp.path, "train.libsvm")
        make_dataset(data)

        model = SparseLinearModel(NUM_FEATURES, learning_rate=0.5,
                                  device=device)
        step_fn = model.make_sharded_train_step(mesh)

        ckpt = ShardedCheckpoint(os.path.join(tmp.path, "ckpt"))
        # ONE iterator for the whole run (recreating it per epoch would
        # re-parse and re-agree every time): single-process runs stream
        # epoch 0, re-parse + tee epoch 1, and REPLAY the retained
        # rounds from memory thereafter — watch the per-epoch
        # 'parsed'/'replayed' tag below
        train_iter = ShardedRowBlockIter(data, mesh, format="libsvm",
                                         row_bucket=256, nnz_bucket=8192)
        step = 0
        for epoch in range(EPOCHS):
            losses = []
            replays_before = train_iter.replay_epochs
            t0 = time.perf_counter()
            for batch in train_iter:
                losses.append(float(step_fn(batch)))
                step += 1
            wall = time.perf_counter() - t0
            src = ("replayed" if train_iter.replay_epochs > replays_before
                   else "parsed")
            print(f"epoch {epoch}: mean loss {np.mean(losses):.4f} "
                  f"({step} steps, {wall:.2f}s, {src})")
            ckpt.save(step, model.state_dict())

        # simulate a restart: restore the latest checkpoint into a fresh
        # model and take one step
        resumed = SparseLinearModel(NUM_FEATURES, learning_rate=0.5,
                                    device=device)
        restored, _meta = ckpt.restore(like=resumed.state_dict())
        resumed.load_state_dict(restored)
        np.testing.assert_allclose(resumed.w.detach().cpu().numpy(),
                                   model.w.detach().cpu().numpy())
        resume_step = resumed.make_sharded_train_step(mesh)
        for batch in ShardedRowBlockIter(data, mesh, format="libsvm",
                                         row_bucket=256, nnz_bucket=8192):
            loss = resume_step(batch)
            break
        print(f"resumed from step {ckpt.latest_step()}, "
              f"next-step loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
