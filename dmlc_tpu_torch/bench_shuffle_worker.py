"""Worker for bench_suite config 23 (global_shuffle).

Counterpart of ``dmlc_tpu/bench_shuffle_worker.py``; its file barrier
and counter reads are ``bench_peer_worker``'s (``barrier``,
``counters``, ``delta``), which the port's gang workers share.

Run under ``parallel.launch_local(serve_ports=True)`` as a REAL
2-process gang over one larger-than-window RecordIO corpus on shared
disk: each rank gets its OWN page-store root (simulating hosts that do
not share a cache), starts its StatusServer — whose ``/pages``
endpoint doubles as the shuffle window exchange — and drains its
round-robin half of the seeded global permutation:

- window ``w`` is owned by rank ``w % world``: the owner assembles it
  from the source byte ranges (wire), everyone else peer-fetches the
  committed window page from the owner's ``/pages`` — the
  ``shuffle.bytes.peer`` fraction is the config's acceptance;
- a second epoch must replay entirely from the local store on EVERY
  rank (window names are seed/epoch-invariant), wire and peer deltas
  flat;
- each rank reports its delivered records twice: in permutation order
  (per-record sha256, for the cross-world byte-identity merge) and the
  counter deltas. The supervisor round-robin-merges the two ordered
  streams and compares against an in-process world-1 drain — same
  seed ⇒ same global order at any world size.

No torch.distributed group: ranks coordinate through file barriers in
``out_dir``.

Usage: bench_shuffle_worker.py <corpus> <out_dir> <seed> <window_bytes>
"""

import hashlib
import json
import os
import sys
import time

SHUFFLE_COUNTERS = ("shuffle.records.local", "shuffle.records.peer",
                    "shuffle.records.wire", "shuffle.bytes.local",
                    "shuffle.bytes.peer", "shuffle.bytes.wire",
                    "shuffle.windows.built", "shuffle.windows.fetched")


def main() -> int:
    corpus, out_dir = sys.argv[1], sys.argv[2]
    seed, window_bytes = int(sys.argv[3]), int(sys.argv[4])
    rank = int(os.environ["DMLC_TPU_TASK_ID"])
    world = int(os.environ["DMLC_TPU_NUM_WORKER"])

    # each rank its own store root — a shared one would exchange
    # windows through the filesystem and prove nothing about /pages
    from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR
    os.environ[ENV_STORE_DIR] = os.path.join(out_dir, f"store-{rank}")

    from dmlc_tpu_torch.bench_peer_worker import barrier, counters, delta
    from dmlc_tpu_torch.obs.serve import serve_if_env
    from dmlc_tpu_torch.resilience import RetryPolicy, set_policy
    from dmlc_tpu_torch.shuffle import GlobalShuffleSplit

    # patience at the peer seam: a miss usually means the window's
    # owner is still assembling it — short waits keep the non-owner
    # off the wire (it still degrades to the source after the ladder)
    set_policy("io.objstore.peer",
               RetryPolicy(max_attempts=8, base_delay_s=0.05,
                           max_delay_s=0.4))
    srv = serve_if_env()
    if srv is None:
        raise RuntimeError("bench_shuffle_worker needs "
                           "launch_local(serve_ports=...)")

    sp = GlobalShuffleSplit(corpus, rank, world, "recordio", seed=seed,
                            window_bytes=window_bytes)

    def epoch() -> dict:
        before = counters(SHUFFLE_COUNTERS)
        hashes = []
        t0 = time.perf_counter()
        n_bytes = 0
        while True:
            rec = sp.next_record()
            if rec is None:
                break
            n_bytes += len(rec)
            hashes.append(hashlib.sha256(rec).hexdigest())
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "bytes": n_bytes, "n": len(hashes),
                "hashes": hashes,
                "counters": delta(before, counters(SHUFFLE_COUNTERS))}

    # both servers must be serving before any rank's cold epoch: the
    # peer fetch path IS the other rank's StatusServer
    barrier(out_dir, "start", rank, world)
    cold = epoch()
    barrier(out_dir, "cold", rank, world)
    sp.before_first()  # advances to epoch 1
    warm = epoch()
    warm.pop("hashes")  # the merge only needs the cold ordering

    from dmlc_tpu_torch.io.stream import create_stream
    with create_stream(os.path.join(out_dir, f"shuffle-{rank}.json"),
                       "w") as s:
        s.write(json.dumps({"rank": rank, "world": world,
                            "windows": sp.reader.num_windows,
                            "cold": cold, "warm": warm}).encode())
    barrier(out_dir, "done", rank, world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
