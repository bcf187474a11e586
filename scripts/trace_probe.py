#!/usr/bin/env python3
"""Probe torch.profiler's device traces through a whole chip_smoke run.

Usage, from the root of a checkout on a machine with a CUDA card:
``python3 scripts/trace_probe.py``. It runs ``chip_smoke.main()`` with a
probe after each phase: a trace of one small kernel (``x * 3 + 1``,
opened by torch's spin kernel), reporting the kernels it kept and the
traces chip_smoke had taken so far. When a probe keeps no kernel, it
tries, in turn and logging each result: a second trace at once; one
after 5 s idle; one of host and device activity; one after
``gc.collect()`` and ``torch.cuda.empty_cache()``; one at once again;
one after 20 s idle. Each line starts with ``PROBE``; chip_smoke's own
output follows as usual (its last line, on success, is its result).
"""

import functools
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

PHASES = ("check_kernels", "check_step_kernels", "check_dense_kernels",
          "main_path", "h2d_gbps", "transfer_probe", "parity", "init_nccl",
          "sharded_path", "spill_path", "cache_path", "checkpoint_path",
          "check_factor_kernels", "check_factor_shapes", "factor_path",
          "libfm_parity", "checkpoint_ffm", "sharded_parity",
          "check_ranking_kernels", "ranking_path", "ranking_parity",
          "sharded_dryrun", "write_recordio_corpora", "cuda_ingest",
          "recordio_decode", "dense_train")


def kernels(host=False):
    """The kernels with device time that one trace of a small op kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        x * 3 + 1
        torch.cuda.synchronize()
    return sum(1 for e in prof.key_averages() if e.self_device_time_total > 0)


def main():
    import torch
    traces = [0]
    remedies = (
        ("at once", kernels),
        ("after 5 s idle", lambda: (time.sleep(5), kernels())[1]),
        ("host and device", lambda: kernels(host=True)),
        ("after gc and empty_cache",
         lambda: (gc.collect(), torch.cuda.empty_cache(), kernels())[2]),
        ("at once again", kernels),
        ("after 20 s idle", lambda: (time.sleep(20), kernels())[1]))

    def probe(label):
        n = kernels()
        print(f"PROBE after {label}: {n} kernels ({traces[0]} chip_smoke "
              "traces so far)", flush=True)
        if n == 0:
            for name, fn in remedies:
                print(f"PROBE   {name}: {fn()} kernels", flush=True)

    measured = chip_smoke._device_us_by_kernel

    def counted(*args, **kwargs):
        traces[0] += 1
        return measured(*args, **kwargs)

    chip_smoke._device_us_by_kernel = counted
    for name in PHASES:
        phase = getattr(chip_smoke, name)

        def probed(*args, _phase=phase, **kwargs):
            out = _phase(*args, **kwargs)
            probe(_phase.__name__)
            return out

        setattr(chip_smoke, name, functools.wraps(phase)(probed))
    chip_smoke.main()


if __name__ == "__main__":
    main()
