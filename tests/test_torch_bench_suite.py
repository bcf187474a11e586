"""The port's page-tier bench configs (``dmlc_tpu_torch/bench_suite.py``,
configs 8 and 10) against the JAX package's at 1 MB on the CPU: the same
JSON keys, the same replayed content hash, and their own parity asserts
holding; and ``make_libsvm`` writing the reference's bytes from the same
seed. Each package writes under this test's temporary directory.

``make_libsvm`` at the configs' 10^6 features permutes 10^6 indices a
row (minutes), so the configs here read a criteo-shaped corpus that a
quicker seeded writer puts at the paths both packages look for first
(each skips writing a file that is already there); ``make_libsvm``
itself is held to the reference at 10^4 features."""

import json
import os

import numpy as np
import pytest

import dmlc_tpu.bench_suite as ref_bench
from dmlc_tpu_torch import bench_suite


def _criteo_shaped(path, mb=1):
    rng = np.random.RandomState(7)
    lines = []
    for i in range(3000):
        idx = np.unique(rng.randint(0, 10 ** 6, rng.randint(25, 45)))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.rand():.6f}"
                                            for j in idx))
    block = ("\n".join(lines) + "\n").encode()
    with open(path, "wb") as f:
        for _ in range(max(1, (mb << 20) // len(block) + 1)):
            f.write(block)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "_TMP", str(tmp_path / "ref"))
    monkeypatch.setenv("DMLC_TPU_PAGESTORE_DIR", str(tmp_path / "ref_store"))
    monkeypatch.setenv("DMLC_TPU_TORCH_PAGESTORE_DIR",
                       str(tmp_path / "port_store"))
    work = tmp_path / "port"
    work.mkdir()
    for p in (work / "dmlc_tpu_torch_bench_suite.criteo.libsvm",
              tmp_path / "ref.pagerep.libsvm",
              tmp_path / "ref.spillrep.libsvm"):
        _criteo_shaped(str(p))
    return str(work)


def test_make_libsvm_writes_the_reference_bytes(tmp_path):
    for kw in ({}, dict(seed=7, nnz_range=(25, 45), index_space=10 ** 4,
                        real_values=True)):
        a, b = str(tmp_path / "a.libsvm"), str(tmp_path / "b.libsvm")
        assert bench_suite.make_libsvm(a, 1, **kw) == \
            ref_bench.make_libsvm(b, 1, **kw)
        with open(a, "rb") as x, open(b, "rb") as y:
            assert x.read() == y.read()
        os.remove(a)
        os.remove(b)


def test_page_replay_matches_reference(dirs):
    got = bench_suite.bench_page_replay(1, device="cpu", work=dirs)
    want = ref_bench.bench_page_replay(1)
    assert set(got) == set(want)
    assert got["hash"] == want["hash"]
    assert (got["bytes"], got["text_bytes"]) == (want["bytes"],
                                                 want["text_bytes"])
    assert got["platform"] == "cpu" and len(got["epoch_walls"]) == 3
    json.dumps(got)


def test_spill_replay_matches_reference(dirs):
    kw = dict(replay_epochs=3, row_bucket=512, nnz_bucket=512 * 45)
    got = bench_suite.bench_spill_replay(1, device="cpu", work=dirs, **kw)
    want = ref_bench.bench_spill_replay(1, **kw)
    assert set(got) == set(want)
    # page_bytes differ by the spill header's fingerprint: its path
    for k in ("bytes", "rounds", "mode", "config"):
        assert got[k] == want[k], k
    assert got["platform"] == "cpu" and len(got["replay_epoch_walls"]) == 3
    # close() deleted the spill file under the work directory
    assert os.listdir(os.path.join(dirs, "spill")) == []
    json.dumps(got)


def test_main_prints_one_line_a_config(dirs, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench_suite, "CONFIGS", {
        8: ("page_replay", lambda mb: calls.append(mb) or {"gbps": 1.0}),
        10: ("spill_replay", lambda mb: 1 / 0)})
    bench_suite.main(["--mb", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert calls == [3]
    assert json.loads(lines[0]) == {"gbps": 1.0}
    assert json.loads(lines[1])["config"] == "spill_replay"
    assert "error" in json.loads(lines[1])


# ------------------------------------------------- configs 4 and 7, gauges

def _return_keys(fn):
    """The keys of the dict literal that ``fn`` returns last."""
    import ast
    import inspect
    import textwrap
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    rets = [n for n in ast.walk(tree)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in rets[-1].value.keys}


def test_prefetch_matches_reference(dirs, tmp_path):
    """Config 4: four parts on threads, each copying its blocks through
    its own staging pool; the reference's keys and content hash."""
    _criteo_shaped(str(tmp_path / "ref.criteo.libsvm"))
    got = bench_suite.bench_prefetch(1, device="cpu", work=dirs)
    want = ref_bench.bench_prefetch(1, True)
    assert set(got) == set(want)
    for k in ("hash", "bytes", "rows", "hosts", "to_device", "config"):
        assert got[k] == want[k], k
    json.dumps(got)


def test_multiprocess_runs_a_two_process_gang(dirs):
    """Config 7: two launch_local workers over a gloo group, each a Mesh
    of 2 parts on the CPU, three epochs; the reference's keys."""
    got = bench_suite.bench_multiprocess_ingest(1, device="cpu", work=dirs)
    assert set(got) == _return_keys(ref_bench.bench_multiprocess_ingest)
    assert got["procs"] == 2 and got["bytes"] == os.path.getsize(
        os.path.join(dirs, "dmlc_tpu_torch_bench_suite.criteo.libsvm"))
    assert got["batches_per_epoch"] > 0
    assert got["replay_epochs"] == 2 and got["replay_tier"] == "memory"
    assert [n for n in os.listdir(dirs) if n.startswith("dmlc_torch_bench_mp_")
            ] == []
    json.dumps(got)


def test_multiprocess_over_nccl_needs_a_card_a_rank(dirs):
    from dmlc_tpu_torch.utils.logging import DMLCError
    with pytest.raises(DMLCError, match="card a rank"):
        bench_suite.bench_multiprocess_ingest(1, device="cpu", work=dirs,
                                              backend="nccl")


def test_gauge_fn_tags_each_epoch(dirs):
    gauge = iter(range(1, 100))
    got = bench_suite.bench_page_replay(1, gauge_fn=lambda: next(gauge),
                                        device="cpu", work=dirs)
    assert got["epoch_gauges"] == [1.0, 2.0, 3.0]
    got = bench_suite.bench_spill_replay(
        1, gauge_fn=lambda: 2.5, replay_epochs=3, row_bucket=512,
        nnz_bucket=512 * 45, device="cpu", work=dirs)
    assert got["parse_epoch_gauge"] == 2.5
    assert got["epoch_gauges"] == [2.5] * 3
