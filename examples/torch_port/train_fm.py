"""End-to-end example through the PyTorch port: libfm ingest -> FM and
field-aware FFM training.

Twin of ``examples/train_fm.py`` on ``dmlc_tpu_torch``. The libfm format
family closed into a loop: LibFMParser (reference:
src/data/libfm_parser.h) parses field:index:value text, and
SparseFMModel — the second-order FM that format family exists to feed —
trains on the resulting CSR batches with its sharded step over an
8-part mesh, followed by SparseFFMModel, which additionally consumes the
parsed field[] column (fields flow text -> parser -> padded batch ->
device). On the card the pair terms run through the FM and FFM kernels
and their gradients. The training data follows a pure INTERACTION rule
(label = XOR over feature pairs), which a linear model provably cannot
fit and the FM's pairwise term can.

Both models start from the factors the reference's ``init_params(seed=2)``
draws (``dmlc_tpu_torch.testing.reference_normal`` recomputes them in
numpy), so the two examples train from the same point.

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
from dmlc_tpu_torch.models import SparseFFMModel, SparseFMModel
from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
from dmlc_tpu_torch.testing import reference_normal

NPAIRS = 4
NCOL = 2 * NPAIRS + 2   # pair features + 2 context features
ROWS = 320
EPOCHS = 60
PARTS = 8
SEED = 2


def make_libfm(path: str) -> None:
    """label = XOR(which side of a pair fired, context bit): zero linear
    signal by construction."""
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for _ in range(ROWS):
            a, b, cbit = rng.randint(NPAIRS), rng.randint(2), rng.randint(2)
            feats = sorted({2 * a + b, 2 * NPAIRS + cbit})
            y = 1 if b == cbit else 0
            # field:index:value — field 0 = pair features, 1 = context
            # (plain FM ignores fields; the FFM below consumes them)
            toks = " ".join(
                f"{0 if j < 2 * NPAIRS else 1}:{j}:1" for j in feats)
            f.write(f"{y} {toks}\n")


def with_reference_init(model, shape):
    """``model`` with V set to the reference's ``init_params(seed=2)``
    factors: init_scale times its normal draws."""
    V = np.float32(model.init_scale) * reference_normal(SEED, shape)
    with torch.no_grad():
        model.V.copy_(torch.from_numpy(V))
    return model


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)

    with TemporaryDirectory() as tmp:
        data = os.path.join(tmp.path, "train.libfm")
        make_libfm(data)

        mesh = Mesh((PARTS,), ("data",), device=device)
        print(f"mesh: {mesh.size} devices on {device.type}")

        it = ShardedRowBlockIter(data, mesh, format="libfm",
                                 row_bucket=64, nnz_bucket=256)
        batches = list(it)
        model = with_reference_init(
            SparseFMModel(NCOL, num_factors=4, learning_rate=1.0,
                          device=device), (NCOL, 4))
        step = model.make_sharded_train_step(mesh)
        # field-aware FFM on the same batches: the field[] column the
        # libfm parser filled is consumed on the device
        ffm = with_reference_init(
            SparseFFMModel(NCOL, num_fields=2, num_factors=4,
                           learning_rate=1.0, device=device), (NCOL, 2, 4))
        fstep = ffm.make_sharded_train_step(mesh)

        ffm.validate_batch(batches[0])  # field ids fit num_fields
        loss0 = float(model.global_loss(batches[0], mesh))
        f0 = float(ffm.global_loss(batches[0], mesh))

        def train(m, step_fn, tag):
            for epoch in range(EPOCHS):
                for batch in batches:
                    loss = step_fn(batch)
                loss = float(loss)
                if (epoch + 1) % 20 == 0:
                    print(f"{tag} epoch {epoch + 1}: loss {loss:.4f}")
            return float(m.global_loss(batches[0], mesh))

        loss1 = train(model, step, "FM")
        print(f"loss {loss0:.4f} -> {loss1:.4f} "
              f"(pure-interaction rule: a linear model stays ~0.69)")
        assert loss1 < 0.3, "FM failed to learn the XOR rule"

        f1 = train(ffm, fstep, "FFM")
        print(f"FFM: loss {f0:.4f} -> {f1:.4f} "
              f"(field[] parsed from text and consumed on device)")
        assert f1 < 0.3, "FFM failed to learn the XOR rule"
        print("OK")


if __name__ == "__main__":
    main()
