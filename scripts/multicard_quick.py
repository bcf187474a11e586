#!/usr/bin/env python3
"""chip_smoke's multi-card phase alone, without the rest of chip_smoke.

Usage, from the root of a checkout on a machine with CUDA cards:
``python3 scripts/multicard_quick.py [--out DIR]``. It builds the
kernels and the engine, writes chip_smoke's 256 MB linear corpus, then
runs chip_smoke's ``multicard_path`` over the host's cards (up to 4, one
NCCL rank a card): (a) ``python -m dmlc_tpu_torch.graft --cards W``;
(b) two epochs of ``SparseLinearModel(10^6)`` data parallel, 2 parts a
rank, and its first steps held to flat steps on one card; (c) the FFM's
628 MB state placed a slice a card, saved by every rank and restored
onto another mesh; (d) ``distributed_launch.py`` on the cards against
its ``--device cpu`` run; (e) config 7 over NCCL beside gloo. On a host
of one card it runs only the refusals (and writes no corpus). It prints the phase's lines, its
numbers as JSON (also written to ``DIR/multicard.json``, beside the
NCCL logs of leg (a) under ``DIR/nccl``), then the cards' names and
power limits. It holds no kernel against its plain version: its output
is no chip_smoke result.

``--device cpu --cards N`` rehearses the legs on the host over gloo, N
ranks, at chip_smoke's ``MULTICARD_REHEARSAL`` widths (10^5 features,
1024-row batches, a 16 MB corpus), as ``tests/test_torch_multicard.py``
does in every test run; the launch counts, the NCCL legs and config 7 over NCCL are the
card's alone.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cards", type=int, default=2,
                    help="ranks of the host rehearsal (--device cpu)")
    ap.add_argument("--out", default=None,
                    help="directory for multicard.json and the NCCL logs")
    args = ap.parse_args()
    on_card = args.device == "cuda"
    if on_card:
        card = cs.environment()
        cs.build_all()
    else:
        for name, value in cs.MULTICARD_REHEARSAL.items():
            setattr(cs, name, value)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dmlc_multicard_quick_")
    os.environ["DMLC_TPU_TORCH_PAGESTORE_DIR"] = os.path.join(work, "pages")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t_all = time.perf_counter()
    try:
        linear = None
        if not on_card or torch.cuda.device_count() >= 2:
            linear = os.path.join(work, "criteo_shaped.libsvm")
            t0 = time.perf_counter()
            size = cs.write_corpus(linear)
            cs.log(f"corpus: {size} bytes in "
                   f"{time.perf_counter() - t0:.1f} s")
        out = cs.multicard_path(linear, cs.LEARNING_RATE, work,
                                device=args.device, cards=args.cards,
                                keep=args.out)
        cs.log(json.dumps(out))
        if args.out:
            with open(os.path.join(args.out, "multicard.json"), "w") as f:
                json.dump(out, f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"multicard quick: {time.perf_counter() - t_all:.1f} s")
    if on_card:
        cs.log(card)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        cs.log(f"cards: {smi.stdout.strip().splitlines()}")


if __name__ == "__main__":
    main()
