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

Like the reference's worker, it opts in to every live plane (each a no-op
without its env var): the status server, rendezvous membership, the
multi-tenant scheduler, SLOs, the time-series ring, the flight recorder,
the gang aggregator, the sampling profiler, and under
``launch_local(trace_dir=...)`` a rank-tagged trace
(``obs.trace.trace_if_env``).

Usage: bench_mp_worker.py <data_uri> <out_dir> [<device> [gloo|nccl]]
(device ``cuda`` by default).
"""

import json
import os
import sys
import time


def main() -> int:
    # live-telemetry opt-ins (each a no-op without its env var): the
    # per-rank status server under launch_local(serve_ports=...), the
    # crash flight recorder under launch_local(flight_dir=...), and the
    # rank-tagged gang trace under launch_local(trace_dir=...)
    from dmlc_tpu_torch.obs.aggregate import install_if_env as gang_if_env
    from dmlc_tpu_torch.obs.flight import install_if_env
    from dmlc_tpu_torch.obs.profile import install_if_env as prof_if_env
    from dmlc_tpu_torch.obs.serve import serve_if_env
    from dmlc_tpu_torch.obs.slo import install_if_env as slo_if_env
    from dmlc_tpu_torch.obs.timeseries import install_if_env as hist_if_env
    from dmlc_tpu_torch.obs.trace import trace_if_env
    from dmlc_tpu_torch.pipeline.scheduler import (
        install_if_env as sched_if_env,
    )
    from dmlc_tpu_torch.rendezvous import install_if_env as rndv_if_env
    serve_if_env()
    rndv_if_env()     # DMLC_TPU_RNDV_URI/PORT: elastic membership
    sched_if_env()    # DMLC_TPU_SCHED: multi-tenant scheduler
    slo_if_env()      # DMLC_TPU_SLO: declared objectives on /slo
    hist_if_env()     # before flight: DMLC_TPU_HISTORY_S must win
    install_if_env()
    gang_if_env()     # DMLC_TPU_GANG_POLL_S (rank 0 only): /gang
    prof_if_env()     # DMLC_TPU_PROFILE_HZ: /profile flamegraphs
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
