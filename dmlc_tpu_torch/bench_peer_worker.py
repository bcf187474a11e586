"""Worker for bench_suite config 15 (peer_hydrate).

Counterpart of ``dmlc_tpu/bench_peer_worker.py``, with the reference's
``install_if_env`` hooks (each a no-op without its env, which config 15
does not set).

Run under ``parallel.launch_local(serve_ports=True)`` as a REAL
N-process gang: each rank gets its OWN page-store root (simulating
separate hosts sharing one object store), starts its StatusServer —
whose ``/pages/<entry>`` endpoint IS the gang data plane — and streams
the full ``obj://`` object twice:

- the COLD epoch is the tentpole's acceptance: hydration groups are
  owned round-robin, the owner GETs its groups from the wire, every
  other rank peer-fetches them from the owner's ``/pages`` — so each
  rank's ``objstore.bytes`` lands near corpus/N and the GANG moves
  ~1× the corpus instead of N×;
- the WARM epoch must be wire-free on EVERY rank (peer-fetched blocks
  hydrated locally), GET and peer-GET counters flat.

No torch.distributed group: ranks coordinate through tiny file
barriers in ``out_dir`` (rank/world from the launch env contract), so
the gang runs anywhere ``launch_local`` does, any number of ranks to a
card or none.

Usage: bench_peer_worker.py <obj_uri> <out_dir> <block_bytes> <coalesce>
"""

import hashlib
import json
import os
import sys
import time


def barrier(out_dir: str, phase: str, rank: int, world: int,
            timeout_s: float = 120.0) -> None:
    """All ranks rendezvous on marker files — bounded, never a hang
    (a missing peer surfaces as a timeout error, and the supervisor
    kills the gang on the first nonzero exit). The gang workers of
    config 21 and of chip_smoke's gang phase share it."""
    from dmlc_tpu_torch.io.stream import create_stream
    with create_stream(os.path.join(out_dir, f"barrier-{phase}.{rank}"),
                       "w") as s:
        s.write(b"1")
    deadline = time.monotonic() + timeout_s
    want = [os.path.join(out_dir, f"barrier-{phase}.{r}")
            for r in range(world)]
    while not all(os.path.exists(p) for p in want):
        if time.monotonic() > deadline:
            raise TimeoutError(f"gang barrier {phase!r}: peers missing "
                               f"after {timeout_s}s")
        time.sleep(0.02)


PEER_COUNTERS = ("objstore.get", "objstore.bytes", "objstore.bytes_served",
                 "objstore.peer.get", "objstore.peer.bytes",
                 "objstore.peer.miss", "objstore.peer.served",
                 "objstore.peer.served_bytes")


def counters(names=PEER_COUNTERS) -> dict:
    """The named counters of this process (by default the wire and
    peer-tier ones; config 23's worker reads the shuffle tiers')."""
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    return {name: REGISTRY.counter(name).value for name in names}


def delta(a: dict, b: dict) -> dict:
    """What each counter of ``a`` moved by ``b``."""
    return {k: b[k] - a[k] for k in a}


def epoch(uri: str) -> dict:
    """One full sequential read of ``uri``: its wall seconds, byte
    count, sha256 and the ``counters()`` it moved."""
    from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
    before = counters()
    h = hashlib.sha256()
    n = 0
    t0 = time.perf_counter()
    s = create_seek_stream_for_read(uri)
    while True:
        chunk = s.read(1 << 20)
        if not chunk:
            break
        h.update(chunk)
        n += len(chunk)
    s.close()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "bytes": n, "sha256": h.hexdigest(),
            "counters": delta(before, counters())}


def main() -> int:
    uri, out_dir = sys.argv[1], sys.argv[2]
    block_bytes, coalesce = int(sys.argv[3]), int(sys.argv[4])
    rank = int(os.environ["DMLC_TPU_TASK_ID"])
    world = int(os.environ["DMLC_TPU_NUM_WORKER"])

    # each rank its own store root — the point of the peer tier is
    # ranks that do NOT share a cache; one shared tmpdir would dedup
    # through the filesystem and prove nothing
    from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR
    os.environ[ENV_STORE_DIR] = os.path.join(out_dir, f"store-{rank}")

    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu_torch.obs.aggregate import install_if_env as gang_if_env
    from dmlc_tpu_torch.obs.flight import install_if_env as flight_if_env
    from dmlc_tpu_torch.obs.serve import serve_if_env
    from dmlc_tpu_torch.obs.timeseries import install_if_env as hist_if_env
    from dmlc_tpu_torch.resilience import RetryPolicy, set_policy

    objstore.configure(block_bytes=block_bytes, coalesce=coalesce,
                       parallel=2)
    # patience at the peer seam: a 404 usually means the block's owner
    # is still mid-hydration — short waits here are what keep the
    # non-owner off the wire (it still degrades after the ladder)
    set_policy("io.objstore.peer",
               RetryPolicy(max_attempts=8, base_delay_s=0.05,
                           max_delay_s=0.4))
    srv = serve_if_env()
    if srv is None:
        raise RuntimeError("bench_peer_worker needs "
                           "launch_local(serve_ports=...)")
    from dmlc_tpu_torch.rendezvous import install_if_env as rndv_if_env
    rndv = rndv_if_env()  # DMLC_TPU_RNDV_URI/PORT: elastic membership
    hist_if_env()     # before flight: DMLC_TPU_HISTORY_S must win
    flight_if_env()
    gang_if_env()     # DMLC_TPU_GANG_POLL_S (rank 0): /gang rollups

    # both servers must be up before any rank's cold epoch starts —
    # and every rank must stay alive (serving) until all finished;
    # the trace_if_env wrap makes each rank export a rank-tagged
    # Chrome trace (launch_local(trace_dir=...)) so merged gang
    # timelines carry the flow-linked client/server RPC span pairs
    from dmlc_tpu_torch.obs.trace import trace_if_env
    with trace_if_env():
        barrier(out_dir, "start", rank, world)
        cold = epoch(uri)
        if rndv is not None:
            # one epoch-fenced progress beat: the traced rendezvous
            # commit edge on the same timeline as the data plane
            rndv.commit(f"peer-bench-{rank}", cold["bytes"])
        barrier(out_dir, "cold", rank, world)
        warm = epoch(uri)
    from dmlc_tpu_torch.io.stream import create_stream
    with create_stream(os.path.join(out_dir, f"peer-{rank}.json"),
                       "w") as s:
        s.write(json.dumps({"rank": rank, "world": world,
                            "cold": cold, "warm": warm}).encode())
    barrier(out_dir, "done", rank, world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
