"""End-to-end example through the PyTorch port: libsvm-with-qid ingest ->
pairwise ranking.

Twin of ``examples/train_ranking.py`` on ``dmlc_tpu_torch``. The qid
column closed into a loop: the libsvm parser (reference:
src/data/libsvm_parser.h ``qid:`` tokens) fills RowBlock.qid, the
sharded ingest pads it (-1) into device batches, and SparseRankingModel
— the rank:pairwise objective that column exists to feed — trains with
its sharded step over an 8-part mesh (on the card: the pairwise loss
kernel and its gradient, the SpMV and its transpose). The data is
query-grouped with graded relevance from a hidden scorer, so pairwise
accuracy provably rises.

Runs on the CUDA card; ``--device cpu`` runs it on the host (the
kernels' plain versions). There is no fallback: without a card and
without ``--device cpu`` it fails. It prints what the reference's
example prints, its device counts in mesh parts.
"""

import argparse
import os

import numpy as np
import torch

from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.models import SparseRankingModel
from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

NCOL = 32
NQUERIES = 64
DOCS_PER_Q = 6
EPOCHS = 40
PARTS = 8


def make_ranking_libsvm(path: str) -> None:
    """Query-grouped rows with graded labels (0/1/2) from a hidden
    linear scorer — the signal pairwise training should recover."""
    rng = np.random.RandomState(0)
    w_true = np.random.RandomState(7).randn(NCOL)
    with open(path, "w") as f:
        for q in range(NQUERIES):
            for _ in range(DOCS_PER_Q):
                nnz = rng.randint(3, 8)
                idx = np.sort(rng.choice(NCOL, nnz, replace=False))
                vals = rng.rand(nnz)
                score = float((vals * w_true[idx]).sum())
                grade = int(np.digitize(score, [0.6, 1.4]))
                feats = " ".join(f"{j}:{v:.4f}" for j, v in zip(idx, vals))
                f.write(f"{grade} qid:{q} {feats}\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)

    with TemporaryDirectory() as tmp:
        data = os.path.join(tmp.path, "train.libsvm")
        make_ranking_libsvm(data)

        mesh = Mesh((PARTS,), ("data",), device=device)
        print(f"mesh: {mesh.size} devices on {device.type}")

        # modest row bucket: the pairwise loss is O(row_bucket^2)
        it = ShardedRowBlockIter(data, mesh, format="libsvm",
                                 row_bucket=64, nnz_bucket=512)
        batches = list(it)
        model = SparseRankingModel(NCOL, learning_rate=1.0, device=device)
        model.validate_batch(batches[0])  # qid flowed to the device
        step = model.make_sharded_train_step(mesh)

        # accuracy evaluated per part (a flat concatenation would need
        # offsets rebuilt; the per-part view is exact)
        def accuracy():
            accs = []
            for b in batches:
                for d in range(b["label"].shape[0]):
                    flat = {k: b[k][d] for k in
                            ("offset", "index", "value", "label",
                             "weight", "qid")}
                    a = model.pairwise_accuracy(flat)
                    if np.isfinite(a):
                        accs.append(a)
            return float(np.mean(accs))

        acc0 = accuracy()
        for epoch in range(EPOCHS):
            for batch in batches:
                loss = step(batch)
            loss = float(loss)  # per-epoch sync
            if (epoch + 1) % 10 == 0:
                print(f"epoch {epoch + 1}: pairwise loss {loss:.4f}")
        acc1 = accuracy()
        print(f"pairwise accuracy {acc0:.3f} -> {acc1:.3f} "
              f"(qid groups parsed from text, pairs formed on device)")
        assert acc1 > max(acc0, 0.8), (acc0, acc1)
        print("OK")


if __name__ == "__main__":
    main()
