"""Worker for bench_suite config 7 (multi-process ingest throughput).

Counterpart of ``dmlc_tpu/bench_mp_worker.py``. Run under
``parallel.launch_local`` as a REAL 2-process ``torch.distributed``
gang: each process joins the group (``init_from_env``), streams its
parts of a criteo-shaped libsvm file through ShardedRowBlockIter for
three epochs, and writes per-epoch wall times. Epoch 1 parses AND
carries the one-time round-count agreement (one all-gather);
epochs 2+ run collective-free and serve the retained rounds
(``replay_epochs``, ``replay_tier`` in the output).

Each rank holds a ``Mesh`` of 2 parts on its device, as each of the
reference's workers holds 2 host devices. The group is gloo by default:
NCCL needs a card a rank (it refuses two ranks on one card), so with
``nccl`` rank r takes card r and the caller checks there is one.

Under ``launch_local(trace_dir=...)`` each rank records its run and
exports a rank-tagged trace (``obs.trace.trace_if_env``), as the
reference's worker does. Trimmed from the reference: its other obs,
rendezvous, scheduler and SLO ``install_if_env`` hooks (their planes
are not ported).

Usage: bench_mp_worker.py <data_uri> <out_dir> [<device> [gloo|nccl]]
(device ``cuda`` by default).
"""

import json
import os
import sys
import time


def main() -> int:
    # the rank-tagged gang trace under launch_local(trace_dir=...) (a
    # no-op without DMLC_TPU_TRACE_DIR)
    from dmlc_tpu_torch.obs.trace import trace_if_env
    with trace_if_env():
        return _run()


def _run() -> int:
    data_uri, out_dir = sys.argv[1], sys.argv[2]
    device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    backend = sys.argv[4] if len(sys.argv) > 4 else "gloo"
    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

    dev = torch.device(device)
    if backend == "nccl":
        rank = int(os.environ.get("DMLC_TASK_ID", "0"))
        dev = torch.device("cuda", rank)
        pid, nprocs = init_from_env(device=dev)
    else:
        pid, nprocs = init_from_env(device="cpu")
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = Mesh((2 * nprocs,), ("data",), group=group, device=dev)
    it = ShardedRowBlockIter(data_uri, mesh, format="libsvm",
                             row_bucket=1 << 11, nnz_bucket=1 << 16,
                             chunk_size=4 << 20)
    epoch_walls = []
    nbatches = 0
    for _ in range(3):
        t0 = time.perf_counter()
        n = 0
        for _batch in it:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            n += 1
        epoch_walls.append(time.perf_counter() - t0)
        nbatches = n
    with open(os.path.join(out_dir, f"bench-mp-{pid}.json"), "w") as f:
        json.dump({"rank": pid, "world": nprocs, "batches": nbatches,
                   "epoch_walls": epoch_walls,
                   "replay_epochs": it.replay_epochs,
                   "page_replay_epochs": it.page_replay_epochs,
                   "replay_tier": it.replay_tier}, f)
    it.close()
    finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
