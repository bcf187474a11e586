"""``python -m dmlc_tpu_torch.bench``, the twin of the repo root's
``bench.py``, on the CPU: its one JSON line has ``bench.py``'s keys
(read from ``bench.py``'s source by ``ast``, as chip_smoke.py reads them), its
corpus has the reference's bytes, its measured chain
(``bench.build_pipeline``) yields the reference chain's padded batches
bit for bit, and its command line fails fast where the reference's does
and where there is no card.

The corpus generator permutes 10^6 indices a row (4000 rows: minutes
of CPU), so the runs read a criteo-shaped corpus that a quicker
seeded writer puts at the path the twin looks for first (it keeps a file
within a quarter of the asked size, as the reference does), and the
corpus test runs both generators with their 4000 template rows cut to
the same few."""

import builtins
import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import bench_py_keys
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu_torch import bench, bench_suite
from dmlc_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
CORPUS = "dmlc_tpu_torch_bench.libsvm"
SUITE_CORPUS = "dmlc_tpu_torch_bench_suite.criteo.libsvm"


def _write_corpus(path, mb=1):
    """Criteo-shaped rows (25-44 distinct indices below 10^6, uniform
    values, labels i % 2) from a seed, until the file passes ``mb`` MB."""
    rng = np.random.RandomState(7)
    with open(path, "w") as f:
        i = 0
        while f.tell() < mb << 20:
            idx = np.unique(rng.randint(0, 10 ** 6, rng.randint(25, 45)))
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.rand():.6f}"
                                          for j in idx) + "\n")
            i += 1


@pytest.fixture
def work(tmp_path):
    """A temp dir holding the twin's corpus and the bench suite's (one
    file, two names), and the environment of a run under it."""
    _write_corpus(str(tmp_path / CORPUS))
    os.link(str(tmp_path / CORPUS), str(tmp_path / SUITE_CORPUS))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_TPU")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path),
               DMLC_TPU_TORCH_PAGESTORE_DIR=str(tmp_path / "store"),
               DMLC_TPU_BENCH_MB="1", DMLC_TPU_BENCH_BUDGET_S="0",
               DMLC_TPU_BENCH_MIN_EPOCHS="3",
               DMLC_TPU_BENCH_HANDWIRED_EPOCHS="1")
    return tmp_path, env


def _run(args, env, timeout=300):
    return subprocess.run([sys.executable, "-m", "dmlc_tpu_torch.bench"]
                          + args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_one_line_with_the_reference_keys(work):
    """The whole twin on the CPU at 1 MB, three epochs, with --trace."""
    tmp, env = work
    trace = str(tmp / "trace.json")
    proc = _run(["--device", "cpu", "--trace", trace], env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout[-2000:]
    out = json.loads(lines[0])
    keys = bench_py_keys()
    assert set(out) == keys[""]
    for name in ("pipeline", "replay", "replay_tier"):
        assert set(out[name]) == keys[name], name
    assert out["metric"] == "libsvm_parse_to_hbm_throughput"
    assert out["vs_baseline"] is None and out["epochs"] >= 3
    assert out["replay_tier"]["mode"] == "pages"
    assert len(out["replay"]["epoch_walls"]) == 5  # REPLAY_EPOCHS' default
    assert len(out["epoch_gauges"]) == out["epochs"]
    assert out["assembly_path"] == "native-padded"
    assert out["analysis"]["bound"] and out["trace"] == trace
    # the controller owned the knobs, so no autotune report
    assert out["control"] is not None and out["pipeline"]["autotune"] is None
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e["ph"] == "X" and e["name"].startswith("pull/")
               for e in events)
    assert os.path.getsize(tmp / CORPUS) < 5 << 19  # the placed corpus kept


def test_corpus_is_the_reference_bytes(tmp_path, monkeypatch):
    """bench.py's ensure_data (loaded from its file, DATA and SIZE_MB
    set on the loaded module) and the twin's write the same bytes at 1
    MB; both generators' 4000 template rows are cut to the same 40 by a
    ``range`` in each module's globals, since each row permutes 10^6
    indices."""
    spec = importlib.util.spec_from_file_location("_root_bench", BENCH_PY)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.DATA, ref.SIZE_MB = str(tmp_path / "ref.libsvm"), 1

    def cut(n):
        return builtins.range(40 if n == 4000 else n)

    for mod in (ref, bench):
        monkeypatch.setattr(mod, "range", cut, raising=False)
    path = str(tmp_path / CORPUS)
    assert bench.ensure_data(path, 1) == ref.ensure_data()
    with open(path, "rb") as a, open(ref.DATA, "rb") as b:
        assert a.read() == b.read()
    monkeypatch.setattr(bench.tempfile, "tempdir", str(tmp_path))
    assert bench.data_path() == path != ref.DATA


def _ref_chain(path):
    """bench.py's measured chain on the JAX CPU device (its lines
    241-253, with its env knobs)."""
    chunk_mb = int(os.environ.get("DMLC_TPU_BENCH_CHUNK_MB", "4"))
    shards = int(os.environ.get("DMLC_TPU_BENCH_SHARDS", "0") or 0)
    parse_kw = {"shards": shards} if shards > 1 else {}
    pl = (RefPipeline.from_uri(path)
          .parse(format="libsvm", engine="auto",
                 chunk_size=chunk_mb << 20, **parse_kw))
    if os.environ.get("DMLC_TPU_BENCH_ASSEMBLY", "auto") != "none":
        rows_pb = int(os.environ.get("DMLC_TPU_BENCH_BATCH_ROWS",
                                     str(8 << 10)))
        nnz_pb = int(os.environ.get("DMLC_TPU_BENCH_NNZ_BUCKET",
                                    str(rows_pb * 45)))
        pl = pl.batch(rows_pb, pad=True, nnz_bucket=nnz_pb)
    return pl.to_device(jax.devices("cpu")[0], window="auto").build(
        autotune=True)


@pytest.mark.parametrize("knobs", [
    {}, {"DMLC_TPU_BENCH_ASSEMBLY": "none"}, {"DMLC_TPU_BENCH_SHARDS": "2"},
], ids=["padded", "raw_blocks", "two_shards"])
def test_chain_matches_the_reference_chain(work, monkeypatch, knobs):
    """Every batch of ``build_pipeline`` on the CPU equals the reference
    chain's bit for bit (offsets as int64 values: the port's offsets
    are int64, the reference's int32 without x64), 512-row batches, and
    the batches' real rows concatenate to the reference's content hash
    and to a direct parse's."""
    tmp, _ = work
    path = str(tmp / CORPUS)
    monkeypatch.setenv("DMLC_TPU_BENCH_BATCH_ROWS", "512")
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    got = bench.build_pipeline(path, torch.device("cpu"))
    want = _ref_chain(path)
    ours, theirs = RowBlockContainer(np.uint32), RefContainer(np.uint32)
    batches = 0
    try:
        for a, b in zip(got, want, strict=True):
            a = {k: v.numpy().copy() for k, v in a.items()}
            b = {k: np.asarray(v) for k, v in b.items()}
            assert set(a) == set(b)
            for k in a:
                if k == "offset":
                    assert a[k].dtype == np.int64
                    np.testing.assert_array_equal(a[k], b[k].astype(np.int64))
                else:
                    assert a[k].dtype == b[k].dtype, k
                    assert a[k].tobytes() == b[k].tobytes(), k
            n = int(a.get("num_rows", len(a["label"])))
            z = int(a.get("num_nnz", a["offset"][n]))
            ours.push_block(RowBlock(offset=a["offset"][:n + 1],
                                     label=a["label"][:n],
                                     index=a["index"][:z],
                                     value=a["value"][:z]))
            theirs.push_block(RefRowBlock(offset=b["offset"][:n + 1],
                                          label=b["label"][:n],
                                          index=b["index"][:z],
                                          value=b["value"][:z]))
            batches += 1
        stats = got.stats()
    finally:
        got.close()
        want.close()
    assert batches >= (1 if knobs.get("DMLC_TPU_BENCH_ASSEMBLY") else 3)
    digest = ours.get_block().content_hash()
    assert digest == theirs.get_block().content_hash()
    assert digest == bench_suite._content_hash(path, "libsvm")
    path_used = {(s.get("extra") or {}).get("assembly_path")
                 for s in stats["stages"]} - {None}
    assert path_used == (set() if knobs.get("DMLC_TPU_BENCH_ASSEMBLY")
                         else {"native-padded"})


@pytest.mark.parametrize("args,rc,says,exc", [
    (["--trace"], 2, "--trace", SystemExit),
    ([], 1, "CUDA card", DMLCError),
], ids=["trace_without_a_path", "no_card_no_cpu_flag"])
def test_command_line_fails_before_the_corpus(tmp_path, monkeypatch, args,
                                              rc, says, exc):
    """``--trace`` without a path exits with 2; with no card and no
    ``--device cpu`` the run fails naming the card. Neither writes a
    corpus. In the process the refusal takes under a second; the
    command pays the package's torch import first."""
    assert not torch.cuda.is_available()  # the CPU test host
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_TPU")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    proc = _run(args, env, timeout=120)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert says in proc.stderr and proc.stdout == ""
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(bench.tempfile, "tempdir", str(tmp_path))
    t0 = time.perf_counter()
    with pytest.raises(exc) as err:
        bench.main(args)
    assert time.perf_counter() - t0 < 1.0
    assert exc is not SystemExit or err.value.code == rc
    assert os.listdir(tmp_path) == []
