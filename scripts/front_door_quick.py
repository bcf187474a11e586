#!/usr/bin/env python3
"""dmlc-core's front door on the card alone, without the rest of
chip_smoke.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/front_door_quick.py``. It builds the kernels and the
engine, writes chip_smoke's linear corpus, then runs chip_smoke's
``rowiter_path`` (``RowBlockIter.create`` in RAM and through a
``#cache`` page file, into the linear step), ``submit_path`` (the
submit CLI with one scheduler and one server, two workers training on
the card) and ``examples_path`` (the example twins on the card against
their host runs), each with its checks. It prints the phases' lines,
their numbers as JSON, then the card's name and power limit. It holds
no kernel against its plain version: its output is no chip_smoke
result.
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
    card = cs.environment()
    cs.build_all()
    work = tempfile.mkdtemp(prefix="dmlc_front_door_quick_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    t_all = time.perf_counter()
    try:
        path = os.path.join(work, "criteo_shaped.libsvm")
        t0 = time.perf_counter()
        size = cs.write_corpus(path)
        cs.log(f"corpus: {size} bytes in {time.perf_counter() - t0:.1f} s")
        out = {"rowiter": cs.rowiter_path(path, size, cs.LEARNING_RATE,
                                          work),
               "submit": cs.submit_path(path, cs.LEARNING_RATE, work),
               "examples": cs.examples_path(work)}
        cs.log("front door: " + json.dumps(out))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"front door quick: {time.perf_counter() - t_all:.1f} s")
    cs.log(card)


if __name__ == "__main__":
    main()
