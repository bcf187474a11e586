#!/usr/bin/env python3
"""The global shuffle plane's card checks alone, without the rest of
chip_smoke.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/shuffle_quick.py [--shuffle-only]``. It builds the
kernels and the engine, writes chip_smoke's linear corpus, runs bench
configs 20 (``elastic_reshard``) and 23 (``global_shuffle``) as
chip_smoke's ``bench_twins`` does (at ELASTIC_MB and GLOBAL_SHUFFLE_MB,
with its checks), then chip_smoke's ``shuffle_path`` once. With
``--shuffle-only`` it skips the two configs and runs ``shuffle_path``
three times. Each config prints its JSON, each ``shuffle_path`` its line
and its numbers, then the card's name and power limit. It holds no
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
    configs = "--shuffle-only" not in sys.argv
    work = tempfile.mkdtemp(prefix="dmlc_shuffle_quick_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    t_all = time.perf_counter()
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        t0 = time.perf_counter()
        size = cs.write_corpus(path)
        cs.log(f"corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        if configs:
            from dmlc_tpu_torch.bench_suite import (
                bench_elastic_reshard, bench_global_shuffle,
            )
            outs = {}
            for name, fn in (
                    ("elastic_reshard",
                     lambda: bench_elastic_reshard(cs.ELASTIC_MB,
                                                   work=work)),
                    ("global_shuffle",
                     lambda: bench_global_shuffle(cs.GLOBAL_SHUFFLE_MB,
                                                  work=work))):
                t0 = time.perf_counter()
                outs[name] = fn()
                cs.log(f"bench config {name} "
                       f"({time.perf_counter() - t0:.1f} s):")
                cs.log(json.dumps(outs[name]))
            cs.require_shuffle_configs(outs["elastic_reshard"],
                                       outs["global_shuffle"])
        for _ in range(1 if configs else 3):
            stats = cs.shuffle_path(path, cs.LEARNING_RATE, work)
            cs.log("shuffle: " + json.dumps(stats))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"shuffle_quick: {time.perf_counter() - t_all:.1f} s")
    cs.log(card)


if __name__ == "__main__":
    main()
