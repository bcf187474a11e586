"""Worker for bench_suite config 20 (elastic_reshard).

Copy of ``dmlc_tpu/bench_elastic_worker.py`` with its imports rewritten
to ``dmlc_tpu_torch``: the same arc, constants and report.

Run under ``parallel.launch_local(rendezvous=True, serve_ports=True)``
as a REAL gang that lives through the full elastic arc:

- ranks 0 and 1 join at startup (world 2) and start consuming a
  part-sharded ``obj://`` corpus through epoch-fenced progress
  commits — each commit is a heartbeat carrying ``{part: records}``
  plus the member's view of the membership epoch, so a batch counts
  exactly once no matter how the roster moves mid-flight;
- rank 2 deliberately joins LATE (it waits for rank 0's grow marker)
  — the 2→3 GROW resharding two partially-consumed parts onto it
  mid-epoch, where it resumes from the merged progress prefix
  instead of replaying from record 0;
- after a fixed number of commits rank 2 leaves cleanly — the 3→2
  SHRINK — and the survivors adopt its parts, again resuming
  mid-part from the committed prefix.

Each rank reports its committed ranges (with a per-batch digest so
the suite can prove byte-identical exactly-once coverage against the
local corpus), the wire bytes replay-from-zero would have re-pulled
(``saved_bytes``: the prefix skipped on every part adopted
mid-consumption), and the reshard cost (epoch-bump delivery to the
first post-reshard committed batch).

Usage: bench_elastic_worker.py <out_dir> <n_parts> <rec_bytes>
       <recs_per_part>
"""

import hashlib
import json
import os
import sys
import time

GROW_MARKER = "grow.marker"
BATCH = 4          # records per fenced commit
LEAVE_AFTER = 10   # rank 2 leaves after this many committed batches


def main() -> int:
    out_dir = sys.argv[1]
    n_parts, rec_bytes = int(sys.argv[2]), int(sys.argv[3])
    recs_per_part = int(sys.argv[4])
    rank = int(os.environ["DMLC_TPU_TASK_ID"])

    # own page-store root per rank — adopted parts must cost wire (or
    # prefix-skip), never a shared-filesystem freebie
    from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR
    os.environ[ENV_STORE_DIR] = os.path.join(out_dir, f"store-{rank}")

    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu_torch.io.stream import (
        create_seek_stream_for_read,
        create_stream,
    )
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    from dmlc_tpu_torch.obs.serve import serve_if_env
    from dmlc_tpu_torch.rendezvous import elastic
    from dmlc_tpu_torch.rendezvous import install_if_env as rndv_if_env

    # small blocks: an ownership handoff mid-part re-pulls at most one
    # straddled block, so the gang-total wire stays ≈ 1× the corpus
    objstore.configure(block_bytes=256 << 10)
    serve_if_env()

    if rank == 2:
        # the late joiner: the gang runs at world 2 until rank 0 has
        # consumed enough to make the mid-epoch grow meaningful
        marker = os.path.join(out_dir, GROW_MARKER)
        deadline = time.monotonic() + 120.0
        while not os.path.exists(marker):
            if time.monotonic() > deadline:
                raise TimeoutError("grow marker never appeared")
            time.sleep(0.02)

    cli = rndv_if_env()
    if cli is None:
        raise RuntimeError("bench_elastic_worker needs "
                           "launch_local(rendezvous=True)")

    epochs = []                 # (epoch, world) at each delivery
    reshard_at = [None]         # epoch-bump delivery timestamp
    cli.on_change(lambda v: (
        epochs.append([v["epoch"], v["world"]]),
        reshard_at.__setitem__(0, time.monotonic())))

    committed = []              # [part, start, end, sha8]
    touched = set()             # parts this rank has read before
    saved_bytes = 0             # wire bytes replay-from-zero re-pulls
    reshard_costs = []
    wire0 = REGISTRY.counter("objstore.bytes").value

    def read_range(p: int, start: int, end: int) -> bytes:
        s = create_seek_stream_for_read(
            f"obj://bench/elastic/part-{p}.bin")
        try:
            s.seek(start * rec_bytes)
            want = (end - start) * rec_bytes
            buf = b""
            while len(buf) < want:
                chunk = s.read(want - len(buf))
                if not chunk:
                    break
                buf += chunk
            return buf
        finally:
            s.close()

    def done() -> bool:
        return all(int(cli.progress.get(str(p), 0)) >= recs_per_part
                   for p in range(n_parts))

    grow_written = False
    total = n_parts * recs_per_part
    while cli.rank is not None and not done():
        # ONE consistent snapshot per pass: ownership, resume offset
        # and the commit fence must all come from the same epoch —
        # the background heartbeat thread refreshes the live view
        # concurrently, and a fence stamped fresher than the
        # ownership decision would let a stale owner's batch land
        v = cli.view()
        if v["rank"] is None or v["epoch"] is None:
            break
        progressed = False
        for p in elastic.assign_parts(n_parts, v["world"], v["rank"]):
            start = elastic.resume_skip(v["progress"], p)
            if start >= recs_per_part:
                continue
            adopted = start > 0 and p not in touched
            end = min(start + BATCH, recs_per_part)
            data = read_range(p, start, end)
            if cli.commit(p, end, epoch=v["epoch"]):
                if adopted:
                    # a part adopted mid-consumption: the committed
                    # prefix is exactly what a replay-from-zero
                    # resume would have re-pulled over the wire
                    saved_bytes += start * rec_bytes
                touched.add(p)
                committed.append(
                    [p, start, end,
                     hashlib.sha256(data).hexdigest()[:16]])
                if reshard_at[0] is not None:
                    reshard_costs.append(
                        time.monotonic() - reshard_at[0])
                    reshard_at[0] = None
                progressed = True
            # one batch per pass: re-derive ownership from the view
            # the commit (or its rejection) just delivered
            break
        if rank == 0 and not grow_written:
            got = sum(min(int(cli.progress.get(str(p), 0)),
                          recs_per_part) for p in range(n_parts))
            if got * 4 >= total:  # >= 25% consumed: grow now
                with create_stream(os.path.join(out_dir, GROW_MARKER),
                                   "w") as s:
                    s.write(b"1")
                grow_written = True
        if rank == 2 and len(committed) >= LEAVE_AFTER:
            cli.leave()  # the clean 3->2 shrink
            break
        if not progressed:
            cli.heartbeat()
            time.sleep(0.02)

    wire = REGISTRY.counter("objstore.bytes").value - wire0
    out = {"rank": rank, "member": cli.member, "committed": committed,
           "saved_bytes": saved_bytes, "wire_bytes": wire,
           "reshard_costs": reshard_costs, "epochs": epochs,
           "final_epoch": cli.epoch, "final_world": cli.world}
    with create_stream(os.path.join(out_dir, f"elastic-{rank}.json"),
                       "w") as s:
        s.write(json.dumps(out).encode())
    if rank != 2:
        cli.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
