#!/usr/bin/env python3
"""Time the page tier of several checkouts in turns on one card.

Usage: ``python3 scripts/c11_ab.py TREE [TREE ...]``, each TREE the root
of a checkout (a ``git archive`` unpacked into a gitignored directory).
Give the trees in the order to run them, e.g. ``A B B A``.

Each TREE runs in a process of its own, importing that tree's
``chip_smoke.py`` and ``dmlc_tpu_torch``: it builds the tree's kernels
and engine, writes the linear corpus, forms a world-1 NCCL group and
runs ``chip_smoke.spill_path`` (5 sharded training epochs at a 1 MB
replay budget: parse, parse, pages x 3, with the serve thread's passes
over the page file) and configs 8 and 10 of the tree's bench suite at
256 MB over that corpus, each epoch of 8 and 10 led by a host memcpy
gauge. (``spill_path`` prints the sharded path's memory-replay epoch
beside its own; this script does not run the sharded path, so that
figure prints as nan.) Each process prints its log and, last, one JSON
line ``{"tree", "card", "spill", "page_replay", "spill_replay"}``, and
the script prints every tree's JSON line again at the end, in order.
Needs ``torch.cuda.is_available()``.
"""

import inspect
import json
import os
import subprocess
import sys
import tempfile
import time


def gauge(mb: int = 48) -> float:
    """Host memcpy GB/s (the copy of ``bench_transfer.memcpy_gauge``,
    which older trees lack)."""
    import numpy as np
    a = np.full(mb << 20, 7, np.uint8)
    b = np.empty_like(a)
    t0 = time.perf_counter()
    np.copyto(b, a)
    return a.nbytes / (time.perf_counter() - t0) / 1e9


def one(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as c
    card = c.environment()
    c.build_all()
    from dmlc_tpu_torch import bench_suite
    work = tempfile.mkdtemp(prefix="dmlc_c11_ab_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        size = c.write_corpus(path)
        mesh = c.init_nccl()
        nan = float("nan")
        spill = c.spill_path(path, size, c.LEARNING_RATE, mesh, work,
                             {"parse_to_device_gbps_training": [nan] * 3,
                              "steps_per_s": [nan] * 3})
        os.link(path, os.path.join(
            work, "dmlc_tpu_torch_bench_suite.criteo.libsvm"))
        out = {"tree": tree, "card": card, "spill": spill}
        for name, fn in (("page_replay", bench_suite.bench_page_replay),
                         ("spill_replay", bench_suite.bench_spill_replay)):
            kw = {"work": work}
            if "gauge_fn" in inspect.signature(fn).parameters:
                kw["gauge_fn"] = gauge
            out[name] = fn(256, **kw)
            c.log(json.dumps(out[name]))
        from dmlc_tpu_torch.parallel.launch import finalize
        finalize()
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    lines = []
    for tree in argv:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        print(f"c11_ab: {tree} rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            return proc.returncode
        lines.append(proc.stdout.strip().splitlines()[-1])
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
