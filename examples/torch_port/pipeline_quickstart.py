"""Pipeline quickstart through the PyTorch port: the declarative
dataset-graph composition layer.

Twin of ``examples/pipeline_quickstart.py`` on ``dmlc_tpu_torch``. One
chain replaces the hand-wired InputSplit → Parser → ThreadedIter →
device-transfer stack (``dmlc_tpu_torch.pipeline``):

  1. declare:   from_uri → parse → batch → prefetch → to_device
  2. run:       iterate the built pipeline, one epoch per pass
  3. observe:   per-stage stats snapshot (throughput, wait, occupancy)
  4. tune:      the autotuner adjusts "auto" depths between epochs
  5. shard:     the same graph lowers to a part mesh's batches

Runs on the CUDA card; ``--device cpu`` runs it on the host (the
kernels' plain versions, no card needed). There is no fallback: without
a card and without ``--device cpu`` it fails. It prints what the
reference's example prints, its device counts in mesh parts (one part:
this process drives one device).
"""

import argparse
import os

import numpy as np
import torch

from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.parallel.sharded import Mesh
from dmlc_tpu_torch.pipeline import Pipeline


def make_data(path: str, rows: int = 20000) -> str:
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for i in range(rows):
            nnz = rng.randint(4, 12)
            idx = np.sort(rng.choice(1000, nnz, replace=False))
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{v:.4f}" for j, v in zip(idx, rng.rand(nnz))) + "\n")
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)

    with TemporaryDirectory() as tmp:
        uri = make_data(os.path.join(tmp.path, "train.libsvm"))

        # 1-2. declare the graph, run two epochs on the device
        built = (Pipeline.from_uri(uri)
                 .parse(format="libsvm")
                 .batch(4096)
                 .prefetch(depth="auto")
                 .to_device(device, window="auto")
                 .build(autotune=True))
        for epoch in range(2):
            batches = rows = 0
            for batch in built:
                batches += 1
                rows += int(batch["offset"].shape[0]) - 1
            print(f"epoch {epoch}: {batches} device batches, {rows} rows")

        # 3. per-stage telemetry of the last epoch
        snap = built.stats()
        for st in snap["stages"]:
            occ = (f" occupancy={st['queue_occupancy']:.2f}"
                   if st["queue_occupancy"] is not None else "")
            print(f"  stage {st['name']}: items={st['items']} "
                  f"rows={st['rows']} wait={st['wait_s']:.3f}s{occ}")

        # 4. the depths the autotuner owns (vs the old constants)
        report = built.autotune_report()
        print(f"autotuned knobs: {report['values']} "
              f"(changed: {report['tuned'] or 'none yet'})")
        built.close()

        # 5. the same declarative graph, sharded over a part mesh
        mesh = Mesh((1,), ("data",), device=device)
        sharded = (Pipeline.from_uri(uri)
                   .parse(format="libsvm")
                   .shard(mesh, row_bucket=1 << 10, nnz_bucket=1 << 14)
                   .build())
        total = 0
        for batch in sharded:
            # one tensor per field, the mesh's parts on dim 0
            assert batch["offset"].shape[0] == mesh.size
            assert batch["offset"].device.type == device.type
            total += int(batch["num_rows"].sum())
        print(f"sharded: {total} rows across {mesh.size} devices")
        sharded.close()
        print("pipeline quickstart OK")


if __name__ == "__main__":
    main()
