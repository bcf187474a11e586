"""The port's bench configs (``dmlc_tpu_torch/bench_suite.py``) against
the JAX package's at 1-2 MB on the CPU: the same
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


def test_remote_hydrate_matches_reference(dirs, tmp_path, monkeypatch):
    """Config 11 at 6 MB (two 4 MB blocks): the reference's JSON keys,
    the same content hash, the same GET counts and wire bytes, cold and
    compressed, and warm epochs with no GET, in both packages."""
    import dmlc_tpu.io.objstore.fs as ref_ofs
    import dmlc_tpu_torch.io.objstore.fs as ofs
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT):
        monkeypatch.delenv(name, raising=False)
    corpus = os.path.join(dirs, "dmlc_tpu_torch_bench_suite.criteo.libsvm")
    _criteo_shaped(corpus, mb=6)
    os.link(corpus, str(tmp_path / "ref.remote.libsvm"))
    saved, ref_saved = ofs.options(), ref_ofs.options()
    try:
        got = bench_suite.bench_remote_hydrate(6, work=dirs)
        want = ref_bench.bench_remote_hydrate(6)
    finally:
        ofs._options.update(saved)
        ref_ofs._options.update(ref_saved)
    assert ofs.client() is None and ref_ofs.client() is None
    assert set(got) == set(want)
    assert set(got["compressed"]) == set(want["compressed"])
    for k in ("hash", "bytes", "cold_gets", "cold_get_bytes", "warm_gets",
              "wire", "config"):
        assert got[k] == want[k], k
    for k in ("cold_gets", "cold_wire_bytes", "warm_gets", "wire_ratio"):
        assert got["compressed"][k] == want["compressed"][k], k
    assert got["bytes"] > 4 << 20 and got["cold_gets"] >= 2
    assert got["warm_gets"] == 0 and got["compressed"]["warm_gets"] == 0
    assert got["pagestore_hit_rate"] == 1.0
    json.dumps(got)


def _unset_gang_env(monkeypatch):
    import dmlc_tpu_torch.io.objstore.fs as ofs
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT, "DMLC_TPU_SERVE_PORT",
                 "DMLC_TPU_SERVE_PORTS", "DMLC_TPU_RNDV_URI",
                 "DMLC_TPU_RNDV_PORT"):
        monkeypatch.delenv(name, raising=False)


def test_peer_hydrate_matches_reference_keys(dirs, monkeypatch):
    """Config 15 at 16 MB (1 MB blocks in groups of 4, so each of the 2
    ranks owns about half): a real 2-process gang of the port's
    ``bench_peer_worker.py``; the reference's JSON keys (and the port's
    served bytes and gang wall beside them), every rank's stream equal
    to the corpus, each rank's wire at most 0.60 of it, peer bytes on
    both, warm epochs with no GET."""
    import hashlib
    _unset_gang_env(monkeypatch)
    corpus = os.path.join(dirs, "dmlc_tpu_torch_bench_suite.criteo.libsvm")
    _criteo_shaped(corpus, mb=16)
    got = bench_suite.bench_peer_hydrate(16, work=dirs)
    assert set(got) == _return_keys(ref_bench.bench_peer_hydrate) | {
        "served_bytes_per_rank", "gang_wall_s"}
    with open(corpus, "rb") as f:
        assert got["hash"] == hashlib.sha256(f.read()).hexdigest()
    assert got["bytes"] == os.path.getsize(corpus)
    assert all(w <= 0.60 * got["bytes"] for w in got["wire_bytes_per_rank"])
    assert all(b > 0 for b in got["peer_bytes_per_rank"])
    assert got["warm_gets"] == [0, 0]
    # served during each rank's own cold epoch (the peer may read on)
    assert sum(got["served_bytes_per_rank"]) > 0
    json.dumps(got)


def test_ckpt_restore_fanout_matches_reference_keys(dirs, monkeypatch):
    """Config 21 at 4 MB: the 3-writer save gang under a rendezvous (its
    stamp in meta.json), the 2-rank fanout restore, the incremental
    re-save and the multipart leg hold their checks; the reference's
    JSON keys, with the stamped meta.json beside them."""
    _unset_gang_env(monkeypatch)
    got = bench_suite.bench_ckpt_restore_fanout(4, work=dirs)
    assert set(got) == _return_keys(ref_bench.bench_ckpt_restore_fanout) \
        | {"save_meta"}
    assert got["per_rank_wire_frac"] <= 0.60
    assert got["gang_wire_frac"] <= 1.3
    assert got["restore_split"]["peer"] > 0
    assert got["restore_split"]["local"] == 0
    assert got["restore_split"]["peer"] + got["restore_split"]["wire"] \
        == 2 * got["bytes"]
    assert 0 < got["incremental_frac"] <= 0.2
    assert got["multipart_speedup"] >= bench_suite.MULTIPART_MIN_SPEEDUP
    assert got["save_meta"]["rendezvous"]["gang"] == "local"
    assert got["save_meta"]["num_processes"] == 3
    json.dumps(got)


def test_elastic_reshard_matches_reference_keys(dirs, monkeypatch):
    """Config 20 at 16 MB (42 records of 64 KB a part, six parts; at the
    reference's floor of 24 records the survivors can finish every part
    before the late joiner's leave is delivered, in either package): the
    2→3→2 gang of the port's ``bench_elastic_worker.py`` covers every
    part exactly once, digest-checked, with both epoch bumps delivered,
    a resumed prefix and gang wire at most 1.3 of the corpus; the
    reference's JSON keys."""
    _unset_gang_env(monkeypatch)
    got = bench_suite.bench_elastic_reshard(16, work=dirs)
    assert set(got) == _return_keys(ref_bench.bench_elastic_reshard)
    assert got["bytes"] == 6 * 42 * (64 << 10)
    assert got["reshard_count"] >= 2 and got["resume_saved_bytes"] > 0
    assert got["gang_wire_frac"] <= 1.3
    assert got["late_joiner_batches"] == 10
    worlds = [w for _, w in got["epochs"]]
    assert 3 in worlds and 2 in worlds[worlds.index(3):]
    json.dumps(got)


def test_global_shuffle_matches_reference(dirs, monkeypatch):
    """Config 23 at 16 MB, the smallest corpus cut into at least 8
    windows of 2 MB: the port's 2-rank gang merges into the world-1
    order with peer bytes on both ranks and a warm epoch that reads
    neither the wire nor a peer; the reference's JSON keys, and its
    order over the same corpus (``make_recordio`` writes the reference's
    bytes): the same sorted-record hash and displacement."""
    from dmlc_tpu.shuffle import GlobalShuffleSplit as RefSplit
    _unset_gang_env(monkeypatch)
    got = bench_suite.bench_global_shuffle(16, work=dirs)
    assert set(got) == _return_keys(ref_bench.bench_global_shuffle)
    assert got["windows"] >= 8 and got["window_bytes"] == 2 << 20
    assert all(f > 0 for f in got["peer_frac_per_rank"])
    assert got["gang_wire_frac"] <= 1.6
    import hashlib
    paths = [os.path.join(dirs, f"dmlc_tpu_torch_bench_suite.shuffle."
                                f"part{k}.rec") for k in range(2)]
    ref = RefSplit(";".join(paths), 0, 1, "recordio", seed=23,
                   window_bytes=2 << 20)
    golden = [hashlib.sha256(r).hexdigest() for r in ref]
    assert len(golden) == got["records"]
    assert got["hash"] == hashlib.sha256(
        "\n".join(sorted(golden)).encode()).hexdigest()
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


# ----------------------------------------- configs 3, 14 and 18 (RecordIO)

@pytest.mark.parametrize("maker,args", [
    ("make_dense_recordio", dict(seed=11)),
    ("make_image_recordio", dict(seed=18, shape=(32, 32, 3))),
])
def test_record_makers_write_the_reference_bytes(tmp_path, maker, args):
    a, b = str(tmp_path / "a.rec"), str(tmp_path / "b.rec")
    assert getattr(bench_suite, maker)(a, 1, **args) == \
        getattr(ref_bench, maker)(b, 1, **args)
    with open(a, "rb") as x, open(b, "rb") as y:
        assert x.read() == y.read()


def test_make_recordio_writes_the_reference_parts(tmp_path):
    got = bench_suite.make_recordio(str(tmp_path / "a"), 2, nparts=4)
    want = ref_bench.make_recordio(str(tmp_path / "b"), 2, nparts=4)
    assert len(got) == len(want) == 4
    for p, q in zip(got, want):
        with open(p, "rb") as x, open(q, "rb") as y:
            assert x.read() == y.read()


def test_recordio_matches_reference(dirs):
    """Config 3: the 4-part split's record count and coverage hash."""
    got = bench_suite.bench_recordio(2, work=dirs)
    want = ref_bench.bench_recordio(2)
    assert set(got) == set(want)
    for k in ("config", "bytes", "records", "engine", "hash"):
        assert got[k] == want[k], k
    json.dumps(got)


@pytest.mark.parametrize("name,shape_keys", [
    ("bench_recio_native", ("rows", "nnz_bucket")),
    ("bench_image_record", ("rows", "shape"))])
def test_decode_configs_match_reference(dirs, name, shape_keys):
    """Configs 14 and 18: the reference's keys, nested too; the padded
    streams' hash (python, native and sharded, each held to the python
    golden's by the config itself) equal to the reference's."""
    gauge = iter(range(1, 100))
    got = getattr(bench_suite, name)(2, gauge_fn=lambda: next(gauge),
                                     work=dirs)
    want = getattr(ref_bench, name)(2, gauge_fn=lambda: 1.0)
    assert set(got) == set(want)
    for k in ("config", "bytes", "hash") + shape_keys:
        assert got[k] == want[k], k
    for contender in ("python", "native", "sharded"):
        assert set(got[contender]) == set(want[contender]), contender
        for k in ("hash", "batches", "assembly_path",
                  "outstanding_after_epoch"):
            assert got[contender][k] == want[contender][k], (contender, k)
    assert got["native"]["assembly_path"] == "native-padded"
    assert got["python"]["epoch_gauges"] == [1.0]
    assert got["native"]["epoch_gauges"] == [2.0, 4.0, 6.0]
    assert len(got["sharded"]["epoch_walls"]) == 3
    json.dumps(got)


def test_configs_table_holds_the_recordio_configs():
    assert {n: name for n, (name, _) in bench_suite.CONFIGS.items()} == {
        1: "libsvm", 2: "csv", 3: "recordio", 4: "prefetch", 5: "parquet",
        6: "indexed_shuffled", 7: "multiprocess", 8: "page_replay",
        10: "spill_replay", 11: "remote_hydrate", 14: "recio_native",
        15: "peer_hydrate", 17: "parquet_native", 18: "image_record",
        20: "elastic_reshard", 21: "ckpt_restore_fanout",
        23: "global_shuffle"}
    for n in bench_suite.CONFIGS:
        assert bench_suite.CONFIGS[n][0] == ref_bench.CONFIGS[n][0]


# ------------------------------------ configs 1, 2, 5, 6 and 17 (formats)

@pytest.fixture
def fmt_dirs(tmp_path, monkeypatch):
    """(the port's work directory, the reference's file prefix)."""
    monkeypatch.setattr(ref_bench, "_TMP", str(tmp_path / "ref"))
    work = tmp_path / "port"
    work.mkdir()
    return str(work)


@pytest.mark.parametrize("maker,args,pyarrow", [
    ("make_csv", dict(), False),
    ("make_csv", dict(seed=1, zero_frac=0.3), False),
    ("make_indexed_recordio", dict(), False),
    ("make_parquet", dict(), True),
    ("make_parquet_decode_bound", dict(seed=17), True),
])
def test_format_makers_write_the_reference_bytes(tmp_path, maker, args,
                                                 pyarrow):
    if pyarrow:
        pytest.importorskip("pyarrow")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert getattr(bench_suite, maker)(a, 1, **args) == \
        getattr(ref_bench, maker)(b, 1, **args)
    for suffix in ([".idx"] if maker == "make_indexed_recordio" else []) + [""]:
        with open(a + suffix, "rb") as x, open(b + suffix, "rb") as y:
            assert x.read() == y.read(), suffix


@pytest.mark.parametrize("name,keys", [
    ("bench_libsvm", ("config", "bytes", "rows", "nnz", "hash")),
    ("bench_csv", ("config", "bytes", "rows", "nnz", "sparse_nnz_frac",
                   "hash")),
    ("bench_parquet", ("config", "bytes", "rows", "nnz", "hash")),
    ("bench_indexed_shuffled", ("config", "bytes", "records", "engine",
                                "hash")),
])
def test_format_configs_match_reference(fmt_dirs, name, keys):
    """Configs 1, 2, 5 and 6 at 1 MB: the reference's keys, and its
    content hash (6: the shuffled order's digest) from the same corpus."""
    if name == "bench_parquet":
        pytest.importorskip("pyarrow")
    got = getattr(bench_suite, name)(1, work=fmt_dirs)
    want = getattr(ref_bench, name)(1)
    assert set(got) == set(want)
    for k in keys:
        assert got[k] == want[k], k
    json.dumps(got)


def _ref_parquet_stream_hash(path):
    """The reference config 17's stream hash of its pyarrow golden."""
    import hashlib
    from dmlc_tpu.data.parser import Parser as RefParser
    h = hashlib.sha256()
    p = RefParser.create(path, 0, 1, format="parquet_native",
                         engine="python", label_column="label")
    for b in p:
        h.update(np.diff(np.asarray(b.offset)).astype("<i8").tobytes())
        h.update(np.ascontiguousarray(b.label).tobytes())
        h.update(np.ascontiguousarray(b.index).astype("<u4").tobytes())
        h.update(np.ascontiguousarray(b.value).tobytes())
    p.destroy()
    return h.hexdigest()


def test_parquet_native_matches_reference(fmt_dirs, tmp_path, monkeypatch):
    """Config 17 at 1 MB: the reference's keys, nested too, every
    contender's stream hash equal to the reference golden's over the
    reference's corpus, no lease outstanding. Its 3x acceptance is a
    measurement of the decode-bound corpus at size: at 1 MB on this CPU
    the reference's own config 17 measured 2.05x and failed it, so the
    speed check's floor is 0 here (the module's constant stays 3)."""
    pytest.importorskip("pyarrow")
    assert bench_suite.PARQUET_NATIVE_MIN_SPEEDUP == 3.0
    monkeypatch.setattr(bench_suite, "PARQUET_NATIVE_MIN_SPEEDUP", 0.0)
    gauge = iter(range(1, 100))
    got = bench_suite.bench_parquet_native(
        1, gauge_fn=lambda: next(gauge), work=fmt_dirs)
    ref_path = str(tmp_path / "ref.decode.parquet")
    assert ref_bench.make_parquet_decode_bound(ref_path, 1, seed=17) == \
        got["bytes"]
    want_hash = _ref_parquet_stream_hash(ref_path)
    assert set(got) == {
        "config", "bytes", "decode_path_golden", "python", "gbps", "hash",
        "epoch_gauges", "native", "sharded2", "sharded4",
        "speedup_native_vs_pyarrow", "speedup_sharded2_vs_native",
        "speedup_sharded4_vs_native"}
    assert got["config"] == "parquet_native"
    assert got["hash"] == want_hash
    for contender in ("python", "native", "sharded2", "sharded4"):
        r = got[contender]
        assert set(r) == {"gbps", "epoch_walls", "epoch_gauges", "rows",
                          "outstanding_after_epoch", "hash"}, contender
        assert r["hash"] == want_hash, contender
        assert len(r["epoch_walls"]) == 3
    for contender in ("native", "sharded2", "sharded4"):
        assert got[contender]["outstanding_after_epoch"] == 0
    # interleaved: the four contenders' epochs take gauges in turns
    assert got["python"]["epoch_gauges"] == [1.0, 5.0, 9.0]
    assert got["native"]["epoch_gauges"] == [2.0, 6.0, 10.0]
    json.dumps(got)


def test_parquet_native_holds_its_acceptance(fmt_dirs, monkeypatch):
    """Config 17 fails when the native decode is under
    PARQUET_NATIVE_MIN_SPEEDUP times the golden."""
    pytest.importorskip("pyarrow")
    from dmlc_tpu_torch.utils.logging import DMLCError
    monkeypatch.setattr(bench_suite, "PARQUET_NATIVE_MIN_SPEEDUP", 1000.0)
    with pytest.raises(DMLCError, match="acceptance: >= 1000.0x"):
        bench_suite.bench_parquet_native(1, gauge_fn=lambda: 1.0,
                                         work=fmt_dirs)
