"""Worker for bench_suite config 21 (ckpt_restore_fanout).

Counterpart of ``dmlc_tpu/bench_ckpt_worker.py``: the same leaves, steps
and reports, so the two packages' gangs save the same pages.

Two modes, two real gangs over one ``obj://`` checkpoint root:

- ``save`` — a THREE-writer gang under ``launch_local(
  rendezvous=True)``: each rank device-direct-saves its own disjoint
  leaves (``w<rank>/l<i>``) with ``save(step, tree, writer=rank,
  num_writers=3)``, mid-epoch (the rank has live rendezvous progress
  when the step lands, so the gang stamp rides in meta.json). A
  second save with ONE mutated leaf measures the incremental path:
  unchanged pages dedup by content digest and upload nothing.

- ``restore`` — a TWO-rank gang under ``launch_local(
  serve_ports=True)``, each rank a cold host (its OWN page-store
  root): ``prefetch()`` wire-fetches only the pages ``content_owner``
  assigns to this rank at world 2 (an elastic re-cut: the saving
  world was 3), a file barrier guarantees every page is staged at
  its owner, then a FULL ``restore(like=None)`` assembles every
  leaf — the other half arriving from the peer's ``/pages`` tier,
  not the wire. Each rank reports its wire/peer/local byte split
  plus a per-leaf digest so the suite can prove the different-world
  restore byte-identical.

Usage: bench_ckpt_worker.py <out_dir> <save|restore> <total_mb>
"""

import hashlib
import json
import os
import sys
import time

from dmlc_tpu_torch.bench_peer_worker import barrier

ROOT = "obj://bench/ckpt"
WRITERS = 3      # saving gang world
# leaves per writer (96 pages gang-wide): content_owner cuts pages by
# digest hash, so enough pages are needed for the per-rank byte split
# to concentrate near 1/N — a handful of big pages can skew 60/40
LEAVES = 32
STEP = 5         # first full save
STEP_INCR = 6    # the incremental re-save (one leaf mutated)


def _leaf(writer, i, elems):
    import numpy as np
    # seed stride > LEAVES: every leaf distinct gang-wide, else
    # content digests dedup across writers and shrink the page set
    rng = np.random.RandomState(1000 + writer * 100 + i)
    return rng.rand(elems).astype(np.float32)


def _tree(writer, elems):
    return {f"w{writer}": {f"l{i}": _leaf(writer, i, elems)
                           for i in range(LEAVES)}}


def _shas(host):
    return {k: hashlib.sha256(
        memoryview(v).tobytes()).hexdigest()[:16]
        for k, v in host.items()}


def _wire():
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.counter("objstore.bytes").value


def fanout_restore(ck, out_dir, rank, world, like=None, sync=None):
    """The gang's cold restore of ``ck``: every ``/pages`` server up,
    ``prefetch()`` (the wire fetch of the pages ``content_owner``
    assigns to this rank), every page staged at its owner, then the
    full ``restore(like=like)`` (then ``sync()``, when given, so a
    restore onto the card is timed to its end). Returns (the tree, the
    user metadata, this rank's report: seconds, bytes and the
    local/peer/wire split)."""
    wire0 = _wire()
    # all /pages servers up before anyone's prefetch
    barrier(out_dir, "serve-up", rank, world, timeout_s=180.0)
    t0 = time.perf_counter()
    ck.prefetch()
    prefetch_s = time.perf_counter() - t0
    # every page staged at its content_owner before assembly: no rank
    # races ahead and pays wire for a peer's unfetched page
    barrier(out_dir, "prefetched", rank, world, timeout_s=180.0)
    t1 = time.perf_counter()
    tree, user = ck.restore(like=like)
    if sync is not None:
        sync()
    t2 = time.perf_counter()
    return tree, user, {
        "wall_s": t2 - t0, "prefetch_s": prefetch_s, "restore_s": t2 - t1,
        "restored_bytes": ck.last_restore_bytes_read,
        "wire_bytes": _wire() - wire0,
        "split": {"local": ck.last_restore_local_bytes,
                  "peer": ck.last_restore_peer_bytes,
                  "wire": ck.last_restore_wire_bytes}}


def main() -> int:
    out_dir, mode, total_mb = sys.argv[1], sys.argv[2], int(sys.argv[3])
    rank = int(os.environ["DMLC_TPU_TASK_ID"])
    world = int(os.environ["DMLC_TPU_NUM_WORKER"])

    # own page-store root per rank — restore ranks are cold hosts, and
    # a shared store would serve pages through the filesystem and
    # falsify the wire split
    from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR
    os.environ[ENV_STORE_DIR] = os.path.join(out_dir,
                                             f"store-{mode}-{rank}")

    from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
    from dmlc_tpu_torch.io.stream import create_stream

    elems = (total_mb << 20) // (WRITERS * LEAVES * 4)
    ck = ShardedCheckpoint(ROOT)

    if mode == "save":
        from dmlc_tpu_torch.rendezvous import install_if_env as rndv_if_env
        cli = rndv_if_env()
        if cli is None:
            raise RuntimeError("bench_ckpt_worker save mode needs "
                               "launch_local(rendezvous=True)")
        # mid-epoch: commit live progress BEFORE the step lands, so
        # the checkpoint's gang stamp describes a consuming gang
        v = cli.view()
        if v["epoch"] is not None:
            cli.commit(rank, 1, epoch=v["epoch"])
        tree = _tree(rank, elems)
        t0 = time.perf_counter()
        ck.save(STEP, tree, metadata={"epoch": 0, "batch": 1},
                writer=rank, num_writers=world)
        full_wall = time.perf_counter() - t0
        full_written = ck.last_save_bytes_written
        barrier(out_dir, "full-save", rank, world, timeout_s=180.0)
        # the incremental re-save: rank 0 mutates ONE leaf of 96
        if rank == 0:
            tree["w0"]["l0"] = tree["w0"]["l0"] + 1.0
        t0 = time.perf_counter()
        ck.save(STEP_INCR, tree, metadata={"epoch": 0, "batch": 2},
                writer=rank, num_writers=world)
        incr_wall = time.perf_counter() - t0
        flat = {f"w{rank}/{k}": a for k, a in tree[f"w{rank}"].items()}
        out = {"rank": rank, "mode": mode,
               "full_written": full_written,
               "full_wall_s": full_wall,
               "incr_written": ck.last_save_bytes_written,
               "incr_reused": ck.last_save_bytes_reused,
               "incr_wall_s": incr_wall,
               "leaves": _shas(flat)}
        cli.leave()
    else:
        from dmlc_tpu_torch.obs.serve import serve_if_env
        if serve_if_env() is None:
            raise RuntimeError("bench_ckpt_worker restore mode needs "
                               "launch_local(serve_ports=True)")
        host, user, report = fanout_restore(ck, out_dir, rank, world)
        out = {"rank": rank, "mode": mode, "step": ck.latest_step(),
               "user": user, "leaves": _shas(host), **report}
        # stay alive (serving) until every rank finished assembling
        barrier(out_dir, "done", rank, world, timeout_s=180.0)
    with create_stream(os.path.join(out_dir,
                                    f"{mode}-{rank}.json"), "w") as s:
        s.write(json.dumps(out).encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
