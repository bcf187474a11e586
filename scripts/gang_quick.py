#!/usr/bin/env python3
"""The gang plane's card checks alone, without the rest of chip_smoke.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/gang_quick.py [--gang-only]``. It builds the kernels
and the engine, writes chip_smoke's linear corpus, runs bench configs 15
(``peer_hydrate``) and 21 (``ckpt_restore_fanout``) over it as
chip_smoke's ``bench_twins`` does (at PEER_HYDRATE_MB and
CKPT_FANOUT_MB), then chip_smoke's ``gang_path`` once. With
``--gang-only`` it skips the two configs and runs ``gang_path`` three
times (each run's gangs join the rendezvous in whatever order their
processes start). Each config prints its JSON, each ``gang_path`` its
line and its numbers, then the card's name and power limit. It holds no
kernel against its plain version: its output is no chip_smoke result.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    card = cs.environment()
    cs.build_all()
    configs = "--gang-only" not in sys.argv
    work = tempfile.mkdtemp(prefix="dmlc_gang_quick_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    t_all = time.perf_counter()
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        t0 = time.perf_counter()
        size = cs.write_corpus(path)
        cs.log(f"corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        if configs:
            from dmlc_tpu_torch.bench_suite import (
                bench_ckpt_restore_fanout, bench_peer_hydrate,
            )
            link = os.path.join(work,
                                "dmlc_tpu_torch_bench_suite.criteo.libsvm")
            os.link(path, link)
            for name, fn in (
                    ("peer_hydrate",
                     lambda: bench_peer_hydrate(cs.PEER_HYDRATE_MB,
                                                work=work)),
                    ("ckpt_restore_fanout",
                     lambda: bench_ckpt_restore_fanout(cs.CKPT_FANOUT_MB,
                                                       work=work))):
                t0 = time.perf_counter()
                out = fn()
                cs.log(f"bench config {name} "
                       f"({time.perf_counter() - t0:.1f} s):")
                cs.log(json.dumps(out))
            os.unlink(link)
        for _ in range(1 if configs else 3):
            stats = cs.gang_path(path, cs.LEARNING_RATE, work)
            cs.log("gang: " + json.dumps(stats))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"gang_quick: {time.perf_counter() - t_all:.1f} s")
    cs.log(card)


if __name__ == "__main__":
    main()
