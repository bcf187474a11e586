"""The port's transfer probe (``dmlc_tpu_torch/bench_transfer.py``)
against the JAX package's (``dmlc_tpu/bench_transfer.py``) on the CPU, at
small sizes: the same JSON keys and cell names, each cell a positive
rate, and a put being the port's staged copy (``HostStaging`` slot, then
``copy_to_device``). On the CPU both probes time host copies, so only
the shape of the record is compared, never a rate."""

import json
import sys

import numpy as np
import pytest
import torch

import dmlc_tpu.bench_transfer as ref_probe
from dmlc_tpu_torch import bench_transfer as probe

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_record():
    import contextlib
    import io
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["bench_transfer", "--reps", "1", "--mb", "4"]
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            ref_probe.main()
    finally:
        sys.argv = argv
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_probe_record_has_the_reference_keys_and_cells(ref_record):
    got = probe.probe(CPU, reps=1, mb=4)
    assert set(got) == set(ref_record)
    assert list(got["cells"]) == list(ref_record["cells"])
    assert got["metric"] == ref_record["metric"] and got["reps"] == 1
    assert all(v > 0 for v in got["cells"].values())
    assert got["memcpy_gbps"] > 0 and got["enqueue_cpu_share"] > 0
    json.dumps(got)


def test_main_prints_one_json_line(capsys):
    probe.main(["--reps", "1", "--mb", "2", "--device", "cpu"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["reps"] == 1 and "single-4MB" in rec["cells"]
    # the pageable readings go only in the stderr table
    assert "pageable" in captured.err and "pageable" not in lines[0]


@pytest.mark.parametrize("cell", [
    lambda: probe.cell_single(CPU, 1, 2, 4),
    lambda: probe.cell_threads(CPU, 2, 1, 2, 4),
    lambda: probe.cell_mono(CPU, 2),
    lambda: probe.cell_pageable(CPU, 1, 2, 4),
    lambda: probe.cell_under_cpu_load(CPU, 1, 2, 4)[0],
    lambda: probe.enqueue_cpu_share(CPU, 1, 64),
    lambda: probe.memcpy_gauge(4),
], ids=["single", "threads", "mono", "pageable", "under_load", "cpu_share",
        "gauge"])
def test_each_cell_gives_a_positive_rate(cell):
    assert cell() > 0


def test_a_put_lands_the_chunk_on_the_device():
    putter = probe._Putter(CPU, 2).warm(np.zeros(8, np.uint8))
    buf = np.arange(8, dtype=np.uint8)
    out = putter.put(buf)
    probe._landed(out)
    assert out["x"].tolist() == list(range(8))
    buf[:] = 0  # the put copied the chunk into its own slot
    assert out["x"].tolist() == list(range(8))
