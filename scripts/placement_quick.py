#!/usr/bin/env python3
"""The placement plane and configs 9 and 12 on the card alone, without
the rest of chip_smoke.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/placement_quick.py [OUT_JSON]``. It builds the
kernels and the engine, writes chip_smoke's linear and libfm corpora,
then runs chip_smoke's ``placement_path`` (the 628 MB FFM state placed
on a 2x2 mesh of parts, saved, restored onto 4 parts and stepped; a
two-rank gloo gang's placed save; 8 batches through
``to_device(sharding=)``) and configs 9 (``pipeline``, PIPELINE_MB) and
12 (``native_assembly``, ASSEMBLY_MB) over cuts of the linear corpus,
each with its checks. It prints the phases' lines and their numbers as
JSON (also written to OUT_JSON when given), then the card's name and
power limit. It holds no kernel against its plain version: its output
is no chip_smoke result.
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
    from dmlc_tpu_torch.bench_suite import (bench_native_assembly,
                                            bench_pipeline)
    from dmlc_tpu_torch.bench_transfer import memcpy_gauge
    card = cs.environment()
    cs.build_all()
    work = tempfile.mkdtemp(prefix="dmlc_placement_quick_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    t_all = time.perf_counter()
    try:
        linear = os.path.join(work, "criteo_shaped.libsvm")
        cs.write_corpus(linear)
        libfm = os.path.join(work, "criteo_shaped.libfm")
        cs.write_libfm_corpus(libfm)
        t0 = time.perf_counter()
        out = {"placement": cs.placement_path(libfm, linear,
                                              cs.LEARNING_RATE, work, card)}
        cs.log(f"placement phase {time.perf_counter() - t0:.1f} s")
        prefix = "dmlc_tpu_torch_bench_suite."
        for name, mb, fn in (
                ("pipeline", cs.PIPELINE_MB,
                 lambda mb, d: bench_pipeline(mb, work=d)),
                ("native_assembly", cs.ASSEMBLY_MB,
                 lambda mb, d: bench_native_assembly(
                     mb, gauge_fn=memcpy_gauge, work=d))):
            d = os.path.join(work, f"{prefix}cut{mb}")
            os.makedirs(d)
            cs.write_cut(linear, os.path.join(d, prefix + "criteo.libsvm"),
                         mb)
            t0 = time.perf_counter()
            out[name] = fn(mb, d)
            cs.log(f"bench config {name} at {mb} MB "
                   f"({time.perf_counter() - t0:.1f} s):")
            cs.log(json.dumps(out[name]))
        if len(sys.argv) > 1:
            with open(sys.argv[1], "w") as f:
                json.dump(out, f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"placement quick: {time.perf_counter() - t_all:.1f} s")
    cs.log(card)


if __name__ == "__main__":
    main()
