"""The port's Pipeline (dmlc_tpu_torch.pipeline) against the JAX package's.

Each test runs ``dmlc_tpu.pipeline.Pipeline`` (``to_device`` on JAX's
CPU) and the port's (``to_device(device="cpu")``) on the same seeded
file. Padded batches must match byte for byte: the port's against the
reference's host batches, and by value against the reference's device
batches, whose int64 columns JAX without x64 keeps as int32 (ROADMAP
C2). Unpadded streams must match by ``RowBlock.content_hash()``. The
port's ThreadedIter, stats snapshot and Autotuner are held to the
reference's semantics, ``to_device(sharding=...)`` places each batch's
arrays on a part mesh, tenant builds and streaming sources run beside
the reference's, and the slice
``Pipeline → SparseLinearModel`` matches the reference's 5 SGD steps at rtol=1e-5, atol=1e-6 (CPU fp32 on both
sides, the CSR sums in different orders).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.data.threaded_iter import ThreadedIter as RefThreadedIter
from dmlc_tpu.models.linear import SparseLinearModel as RefModel
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.data.threaded_iter import ThreadedIter
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.pipeline import (
    PIPELINE_STATS_SCHEMA, Autotuner, CompiledPipeline, Knob, Pipeline,
    StageProbe, StageSpec, snapshot)
from dmlc_tpu_torch.pipeline.graph import DeviceBatch
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
ROWS, FEATURES, FIELDS = 1500, 600, 12
BATCH, MAX_NNZ = 256, 12
NNZ_BUCKET = BATCH * MAX_NNZ


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The three layouts over the same seeded rows: libsvm, libfm (one
    nonzero a field) and libsvm with qid (queries of 1-40 rows)."""
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    w_true = np.random.RandomState(7).randn(FEATURES)
    svm, fm, qid = [], [], []
    q, left = 0, 0
    for i in range(ROWS):
        nnz = rng.randint(1, MAX_NNZ + 1)
        idx = np.sort(rng.choice(FEATURES, nnz, replace=False))
        vals = rng.rand(nnz)
        y = 1 if (vals * w_true[idx]).sum() > 1.5 else -1
        feats = " ".join(f"{j}:{v:.5f}" for j, v in zip(idx, vals))
        svm.append(f"{y} {feats}")
        fields = np.sort(rng.choice(FIELDS, min(nnz, FIELDS), replace=False))
        fm.append(f"{y} " + " ".join(f"{f}:{j}:{v:.5f}" for f, j, v in
                                     zip(fields, idx, vals)))
        if left == 0:
            q, left = q + 1, rng.randint(1, 41)
        left -= 1
        qid.append(f"{rng.randint(0, 5)} qid:{q} {feats}")
    return {"libsvm": _write(d / "a.libsvm", svm),
            "libfm": _write(d / "a.libfm", fm),
            "qid": _write(d / "q.libsvm", qid)}


# layout -> (file, format, the padded batch's extra column)
LAYOUTS = {"libsvm": ("libsvm", "libsvm", {}),
           "libfm_field": ("libfm", "libfm", {"want_field": True}),
           "libsvm_qid": ("qid", "libsvm", {"want_qid": True})}


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")


def _padded(pipeline_cls, path, fmt, engine, want, **device):
    return (pipeline_cls.from_uri(path)
            .parse(format=fmt, engine=engine, chunk_size=16 << 10)
            .batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET, **want)
            .to_device(**device).build())


def _host(batch):
    return {k: np.asarray(v).copy() for k, v in batch.items()}


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_padded_batches_match_reference(corpora, native, layout, engine):
    """Two epochs of padded batches through both rungs (the engine's
    fused assembly, and the Python fused golden) of both packages: the
    same number of batches, the port's byte-identical to the reference's
    host batches key by key, and equal in value to its device batches."""
    key, fmt, want = LAYOUTS[layout]
    path = corpora[key]
    ref = _padded(RefPipeline, path, fmt, engine, want)
    ref_host = (RefPipeline.from_uri(path)
                .parse(format=fmt, engine=engine, chunk_size=16 << 10)
                .batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET, **want)
                .prefetch(depth=2).build())
    port = _padded(Pipeline, path, fmt, engine, want, device="cpu")
    try:
        for epoch in range(2):
            got = [_host(b) for b in port]
            gold = [_host(b) for b in ref_host]
            dev = [_host(b) for b in ref]
            assert len(got) == len(gold) == len(dev) == -(-ROWS // BATCH)
            for g, h, d in zip(got, gold, dev):
                assert sorted(g) == sorted(h) == sorted(d)
                for k in g:
                    assert g[k].dtype == h[k].dtype, k
                    assert g[k].tobytes() == h[k].tobytes(), (epoch, k)
                    np.testing.assert_array_equal(g[k], d[k].astype(
                        g[k].dtype), err_msg=k)
            path_ = {"native": "native-padded", "python": "python-fused"}
            assemble = [s for s in port.stats()["stages"]
                        if s["kind"] == "assemble"]
            assert assemble[0]["extra"]["assembly_path"] == path_[engine]
            assert port.epochs == epoch + 1
    finally:
        for b in (ref, ref_host, port):
            b.close()


def _hash(batches, container):
    c = container(np.uint32)
    for b in batches:
        c.push_block(b)
    return c.get_block().content_hash()


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("stages", ["batch", "prefetch", "batch_prefetch"])
def test_unpadded_streams_match_reference(corpora, native, engine, stages):
    def chain(cls):
        p = cls.from_uri(corpora["libsvm"]).parse(
            format="libsvm", engine=engine, chunk_size=16 << 10)
        if "batch" in stages:
            p = p.batch(100)
        if "prefetch" in stages:
            p = p.prefetch(depth=3)
        return p.build()

    with chain(Pipeline) as port:
        got = [_hash(port, RowBlockContainer) for _ in range(2)]
    ref = chain(RefPipeline)
    want = _hash(ref, RefContainer)
    ref.close()
    assert got == [want, want]


@pytest.mark.parametrize("staging", [True, False, "auto"])
@pytest.mark.parametrize("upstream", ["prefetch", "assemble", "map"])
def test_leased_blocks_stay_alive_until_their_copy(corpora, native, upstream,
                                                   staging):
    """The port's TestNativeLeaseDiscipline: native blocks whose arena
    leases travel through prefetch (owned items still carrying a detached
    lease), or straight from the engine's padded assembly (and through a
    map), reach to_device intact — to_device holds each lease until the
    block's bytes are staged or copied, and copies a leased block on the
    aliasing CPU before releasing it."""
    path = corpora["libsvm"]
    p = Pipeline.from_uri(path).parse(format="libsvm", engine="native",
                                      chunk_size=16 << 10)
    if upstream == "prefetch":
        p = p.prefetch(depth=4)
    else:
        p = p.batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET)
        if upstream == "map":
            p = p.map(lambda b: b, name="identity")
    built = p.to_device(device="cpu", window=4, staging=staging).build()
    got_label, got_value = [], []
    for batch in built:
        assert isinstance(batch, DeviceBatch)
        n = int(batch["num_rows"]) if "num_rows" in batch else None
        z = int(batch["num_nnz"]) if "num_nnz" in batch else None
        got_label.append(batch["label"][:n].numpy())
        got_value.append(batch["value"][:z].numpy())
    built.close()
    ref_label, ref_value = [], []
    for b in Parser.create(path, 0, 1, format="libsvm", engine="python"):
        ref_label.append(b.label.copy())
        ref_value.append(b.value.copy())
    np.testing.assert_array_equal(np.concatenate(got_label),
                                  np.concatenate(ref_label))
    np.testing.assert_array_equal(np.concatenate(got_value),
                                  np.concatenate(ref_value))


@pytest.mark.parametrize("staging", [True, False])
def test_to_device_takes_over_a_detached_lease(staging):
    """An owned item that still carries a detached arena lease (prefetch
    over a native parse) hands the lease to to_device, which releases it
    once, itself: at staging, or (unstaged, on the CPU) once the block is
    copied — so the upstream's release-on-next-pull cannot free it."""
    from dmlc_tpu_torch.data.padding import PaddedBatch
    from dmlc_tpu_torch.pipeline.graph import _DeviceRunner, _RunnerBase
    released, items = [], []

    class Lease:
        def __init__(self, i):
            self.i = i

        def release(self):
            released.append(self.i)

    class Up(_RunnerBase):
        kind = "prefetch"

        def epoch(self):
            for i in range(6):
                item = PaddedBatch({"x": np.full(4, i, np.float32)})
                item.lease = Lease(i)
                items.append(item)
                yield item

    runner = _DeviceRunner(Up("up"), "cpu", 2, staging)
    for n, batch in enumerate(runner.epoch()):
        assert float(batch["x"][0]) == n
    assert released == list(range(6))
    assert all(item.lease is None for item in items)


def test_stats_snapshot_has_the_reference_keys(corpora):
    def chain(cls, **device):
        return (cls.from_uri(corpora["libsvm"])
                .parse(format="libsvm", engine="python")
                .batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET)
                .prefetch().to_device(**device).build(autotune=True))

    port, ref = chain(Pipeline, device="cpu"), chain(RefPipeline)
    assert port.stats() is None  # nothing before the first epoch
    got, want = port.run_epoch(), ref.run_epoch()
    json.dumps(got)  # must not raise
    assert set(got) == set(want)
    assert got["schema"] == want["schema"] == PIPELINE_STATS_SCHEMA
    assert got["epoch"] == 1 and got["wall_s"] > 0
    assert set(got["knobs"]) == set(want["knobs"]) == {
        "parse.chunk_prefetch", "prefetch.depth", "device.window"}
    assert [(s["name"], s["kind"]) for s in got["stages"]] == \
        [(s["name"], s["kind"]) for s in want["stages"]]
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w), g["name"]
        assert set(g.get("extra", {})) == set(w.get("extra", {})), g["name"]
        for k in ("items", "rows", "nnz", "queue_cap"):
            assert g[k] == w[k], (g["name"], k)
    # the bytes, but on the device, where JAX keeps int64 columns as
    # int32 (ROADMAP C2); the port's device batches keep the host layout
    for g, w in zip(got["stages"][:-1], want["stages"][:-1]):
        assert g["bytes"] == w["bytes"], g["name"]
    assert got["stages"][-1]["bytes"] == got["stages"][-2]["bytes"]
    assert port.autotune_report()["epochs"] == 1
    port.close()
    ref.close()


def test_stats_count_device_batches_by_their_host_counts():
    """A batch on the device is counted by the rows and nonzeros of its
    host batch, never by reading a device tensor."""
    probe = StageProbe("to_device", "to_device")
    b = DeviceBatch({"label": torch.zeros(8),
                     "num_rows": torch.tensor(5, dtype=torch.int32),
                     "index": torch.zeros(30, dtype=torch.uint32)})
    b.counts = (5, 17)
    probe.record(b, 0.25)
    d = snapshot([probe], 1.0, 1)["stages"][0]
    assert (d["rows"], d["nnz"], d["bytes"]) == (5, 17, 32 + 4 + 120)


def test_native_assembly_fuses_only_directly_on_the_parse(corpora, native):
    def built(*stages):
        p = Pipeline.from_uri(corpora["libsvm"]).parse(format="libsvm",
                                                       engine="native")
        for s in stages:
            p = s(p)
        return p.build()

    pad = lambda p: p.batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET)
    for stages, rung in (((pad,), "native-padded"),
                         ((lambda p: p.map(lambda b: b), pad),
                          "python-fused")):
        with built(*stages) as b:
            snap = b.run_epoch()
        extra = [s["extra"] for s in snap["stages"]
                 if s["kind"] == "assemble"][0]
        assert extra["assembly_path"] == rung
        assert extra["assemble_s"] >= 0


def test_drop_remainder_drops_the_short_tail(corpora, native):
    for engine in ("native", "python"):
        with (Pipeline.from_uri(corpora["libsvm"])
              .parse(format="libsvm", engine=engine)
              .batch(BATCH, drop_remainder=True, pad=True,
                     nnz_bucket=NNZ_BUCKET).build()) as b:
            rows = [int(x["num_rows"]) for x in b]
        assert rows == [BATCH] * (ROWS // BATCH), engine


@pytest.mark.parametrize("kwargs,window_bytes", [
    ({"global_seed": 3, "window_bytes": 1 << 20}, 1 << 20),
    ({"global_seed": 3}, 32 << 20),
])
def test_global_shuffle_stage_lowers(corpora, kwargs, window_bytes):
    """``shuffle(global_seed=...)`` lowers onto a GlobalShuffleSplit (the
    reference's default window of 32 MB when none is given), whose view
    is the process's ``/shuffle`` surface while the chain lives."""
    from dmlc_tpu_torch import shuffle
    with (Pipeline.from_uri(corpora["libsvm"]).shuffle(**kwargs)
          .parse(format="libsvm").build()) as b:
        rows = sum(blk.size for blk in b)
        v = shuffle.view()
        assert (v["seed"], v["window_bytes"], v["world"]) == \
            (3, window_bytes, 1)
    assert rows == v["records"] == v["delivered"] == ROWS


@pytest.mark.parametrize("spec", [(), ("data",)], ids=["replicated",
                                                      "sharded"])
def test_refused_stages_say_not_ported(corpora, spec):
    """``to_device(sharding=...)``, once refused as not ported, places
    every array of a padded batch under the sharding (the reference's
    ``jax.device_put(batch, sharding)``): replicated over 2 parts, both
    parts share one copy equal to the host batch; split over them, the
    batch's offset column (33 long) does not divide and raises naming
    it."""
    from dmlc_tpu_torch.parallel.placement import NamedSharding, P
    from dmlc_tpu_torch.parallel.sharded import Mesh
    sharding = NamedSharding(Mesh((2,), ("data",), device="cpu"), P(*spec))

    def chain():
        return (Pipeline.from_uri(corpora["libsvm"]).parse(format="libsvm")
                .batch(32, pad=True, nnz_bucket=256))

    placed = chain().to_device(sharding=sharding).build()
    if spec:
        with pytest.raises(DMLCError, match="offset: sharding"):
            list(placed)
        return
    host = [{k: np.array(v) for k, v in b.items()} for b in chain().build()]
    got = list(placed)
    assert len(got) == len(host)
    for batch, want in zip(got, host):
        assert set(batch) == set(want)
        for k, v in batch.items():
            shards = v.addressable_shards
            assert [s.replica_id for s in shards] == [0, 1]
            assert shards[0].data is shards[1].data  # one copy
            assert np.array_equal(shards[0].data.numpy(), want[k])


def test_tenant_build_needs_an_installed_scheduler(corpora):
    """``build(tenant=...)`` without a scheduler raises the reference's
    error, in both packages."""
    from dmlc_tpu.pipeline import scheduler as ref_sched
    from dmlc_tpu_torch.pipeline import scheduler as sched
    assert sched.active() is None and ref_sched.active() is None
    with pytest.raises(DMLCError, match="needs an installed scheduler"):
        Pipeline.from_uri(corpora["libsvm"]).parse().build(tenant="feed")
    with pytest.raises(RefDMLCError, match="needs an installed scheduler"):
        RefPipeline.from_uri(corpora["libsvm"]).parse().build(
            tenant="feed")


def test_tenant_build_bills_every_batch_and_stamps_the_snapshot(corpora):
    """A pipeline admitted under a tenant pays one pull a batch, bills
    its rows, withholds the scheduler's knobs from the autotuner and
    stamps its epoch snapshot with the tenant, as the reference's."""
    from dmlc_tpu.pipeline import scheduler as ref_sched
    from dmlc_tpu_torch.pipeline import scheduler as sched
    rows = {}
    for mod, P in ((sched, Pipeline), (ref_sched, RefPipeline)):
        s = mod.install(quantum=4, queue_budget=16)
        try:
            s.add_tenant("feed", weight=2)
            with (P.from_uri(corpora["libsvm"])
                  .parse(format="libsvm", engine="python")
                  .batch(BATCH).prefetch(depth="auto")
                  .build(autotune=True, tenant="feed")) as b:
                n = sum(1 for _ in b)
                assert b.stats()["tenant"] == "feed"
                assert "prefetch.depth" in b.scheduler_owned
                assert b.autotuner is None  # its only knob is owned
                row = s.to_dict()["tenants"]["feed"]
                rows[mod.__name__] = (n, row["pulls"], row["rows"])
        finally:
            mod.uninstall()
    got, want = rows.values()
    assert got == want == (got[0], got[0], ROWS)


def test_from_stream_reads_what_the_file_holds(corpora, tmp_path):
    """``Pipeline.from_stream`` over a finished file ends at its idle
    timeout with the file's rows and a watermark equal to them; the
    stream's blocks hash as the reference's."""
    hashes = []
    for P in (Pipeline, RefPipeline):
        with (P.from_stream(corpora["libsvm"], window_records=200,
                            poll_interval_s=0.01, idle_timeout_s=0.3)
              .parse(format="libsvm").build()) as b:
            c = None
            for blk in b:
                if c is None:
                    c = (RowBlockContainer if P is Pipeline
                         else RefContainer)(blk.index.dtype)
                c.push_block(blk)
            wm = b.stream_stats()
            assert wm["watermark_records"] == ROWS and wm["ended"]
            assert b.stats()["stages"][0]["extra"]["stream"][
                "watermark_records"] == ROWS
            hashes.append(c.get_block().content_hash())
    assert hashes[0] == hashes[1]


# ------------------------------------------------------------- cache

@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Each package's page store root under this test's directory: the
    two derive the same cache-file names."""
    roots = {"port": tmp_path / "port_store", "ref": tmp_path / "ref_store"}
    monkeypatch.setenv("DMLC_TPU_TORCH_PAGESTORE_DIR", str(roots["port"]))
    monkeypatch.setenv("DMLC_TPU_PAGESTORE_DIR", str(roots["ref"]))
    return roots


def _cached(cls, src, engine="python", pad=False, **cache):
    p = (cls.from_uri(src)
         .parse(format="libsvm", engine=engine, chunk_size=16 << 10)
         .cache(rows_per_page=100, **cache))
    if pad:
        p = p.batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET)
        p = p.to_device(device="cpu") if cls is Pipeline else p.prefetch(2)
    return p.build()


def _tier(built):
    return [s for s in built.stats()["stages"]
            if s["kind"] == "cache"][0]["extra"]["replay_tier"]


CACHE_TIERS = {"memory": ({}, "memory"),
               "pages_budget0": ({"memory_budget_bytes": 0}, "pages"),
               "pages_path": ({"path": True}, "pages")}


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("tier", sorted(CACHE_TIERS))
def test_cache_streams_match_reference(corpora, native, stores, tmp_path,
                                       tier, engine):
    """parse → cache in each tier: three epochs of the port's block
    stream hash equal to the reference's and to a direct parse, the
    cache stage reports the tier, and a page cache's file is byte for
    byte the reference's."""
    kw, want_tier = CACHE_TIERS[tier]
    src = corpora["libsvm"]
    port_kw, ref_kw = dict(kw), dict(kw)
    if kw.get("path"):
        port_kw["path"] = str(tmp_path / "port.pages")
        ref_kw["path"] = str(tmp_path / "ref.pages")
    ref = _cached(RefPipeline, src, **ref_kw)
    want = _hash(ref, RefContainer)
    assert _tier(ref) == want_tier
    with _cached(Pipeline, src, engine=engine, **port_kw) as built:
        for _ in range(3):
            assert _hash(built, RowBlockContainer) == want
            assert _tier(built) == want_tier
    ref.close()
    direct = Parser.create(src, 0, 1, format="libsvm", engine="python")
    assert _hash(direct, RowBlockContainer) == want
    if want_tier == "pages":
        if kw.get("path"):
            files = [port_kw["path"], ref_kw["path"]]
        else:
            files = [str(stores[k] / n) for k in ("port", "ref")
                     for n in os.listdir(stores[k])
                     if n.endswith(".pages")]
            assert [os.path.basename(f) for f in files][0].startswith(
                "cache-")
        assert len(files) == 2
        with open(files[0], "rb") as a, open(files[1], "rb") as b:
            assert a.read() == b.read()
    else:
        assert not os.path.exists(stores["port"])


@pytest.mark.parametrize("tier", ["memory", "pages_budget0"])
def test_cache_padded_batches_match_reference(corpora, native, stores,
                                              tier):
    """cache → batch(pad=True) pads through the Python fused golden, in
    both packages, byte for byte, over two epochs."""
    kw = CACHE_TIERS[tier][0]
    ref = _cached(RefPipeline, corpora["libsvm"], pad=True, **kw)
    port = _cached(Pipeline, corpora["libsvm"], engine="native", pad=True,
                   **kw)
    try:
        for _ in range(2):
            got = [_host(b) for b in port]
            gold = [_host(b) for b in ref]
            assert len(got) == len(gold) == -(-ROWS // BATCH)
            for g, h in zip(got, gold):
                assert sorted(g) == sorted(h)
                for k in g:
                    assert g[k].dtype == h[k].dtype, k
                    assert g[k].tobytes() == h[k].tobytes(), k
        assemble = [s for s in port.stats()["stages"]
                    if s["kind"] == "assemble"][0]
        assert assemble["extra"]["assembly_path"] == "python-fused"
    finally:
        port.close()
        ref.close()


def test_cache_rebuilds_a_changed_source(stores, tmp_path):
    """A page cache stamped with its source's fingerprint is rebuilt, not
    replayed, once the source changes, in both packages."""
    src = tmp_path / "d.libsvm"
    src.write_text("1 1:1.0\n0 2:2.0\n" * 50)
    paths = {Pipeline: str(tmp_path / "p.pages"),
             RefPipeline: str(tmp_path / "r.pages")}
    labels = {}
    for version in (1, 2):
        if version == 2:
            src.write_text("1 1:1.0\n1 2:2.0\n" * 60)
        for cls in (Pipeline, RefPipeline):
            with _cached(cls, str(src), path=paths[cls]) as built:
                labels[cls] = sum(float(b.label.sum()) for b in built)
        assert labels[Pipeline] == labels[RefPipeline] == (
            50.0 if version == 1 else 120.0)
        with open(paths[Pipeline], "rb") as a, \
                open(paths[RefPipeline], "rb") as b:
            assert a.read() == b.read()


def test_cache_page_budget_evicts_cold_entries(corpora, stores, tmp_path):
    """page_budget_bytes sets the cache's store budget: a cold entry in
    the same root is evicted, the live cache kept, as in the reference."""
    probe = str(tmp_path / "probe.pages")
    _cached(Pipeline, corpora["libsvm"], path=probe).close()
    budget = os.path.getsize(probe) + 500  # the cache fits, not the cold
    for cls, root in ((Pipeline, tmp_path / "p"), (RefPipeline,
                                                    tmp_path / "r")):
        root.mkdir()
        cold = root / "cold.pages"
        cold.write_bytes(b"x" * 1000)
        os.utime(cold, (1, 1))
        path = str(root / "live.pages")
        with _cached(cls, corpora["libsvm"], path=path,
                     page_budget_bytes=budget) as built:
            built.run_epoch()
            assert _tier(built) == "pages"
        assert os.path.exists(path) and not cold.exists(), cls


def test_shuffle_with_cache_keeps_the_reference_refusal(corpora):
    for cls, err in ((Pipeline, DMLCError), (RefPipeline, RefDMLCError)):
        pipe = cls((StageSpec("source", uri=corpora["libsvm"], part_index=0,
                              num_parts=1, split_type="text"),
                    StageSpec("shuffle", num_shuffle_parts=2, seed=0,
                              global_seed=None, window_bytes=None),
                    StageSpec("parse", format="libsvm", engine="python"),
                    StageSpec("cache", path=None, rows_per_page=100,
                              memory_budget_bytes=None,
                              page_budget_bytes=None)))
        with pytest.raises(err, match="shuffle \\+ cache is not lowerable"):
            pipe.build()


def test_grammar_matches_the_reference(tmp_path):
    root = Pipeline.from_uri(str(tmp_path / "x"))
    a = root.parse(format="libsvm")
    b = a.batch(10)
    assert a.stages != b.stages and len(a.stages) == 2  # immutable
    assert "batch" in repr(b) and "parse" in repr(b)
    for bad in (lambda: root.batch(4).build(),
                lambda: a.to_device(device="cpu").batch(4).build(),
                lambda: a.parse().build(),
                lambda: root.build(),
                lambda: Pipeline((StageSpec("parse"),)).build()):
        with pytest.raises(DMLCError):
            bad()
    with pytest.raises(DMLCError, match="part_index"):
        Pipeline.from_uri("x", part_index=2, num_parts=2)
    with pytest.raises(DMLCError, match="nnz_bucket"):
        a.batch(4, pad=True)


def test_to_device_defaults_to_cuda():
    """The port's entry point targets the card unless told otherwise."""
    p = Pipeline.from_uri("x").parse().to_device()
    assert p.stages[-1].params["device"] is None
    from dmlc_tpu_torch.pipeline.graph import _DeviceRunner
    assert _DeviceRunner(None, None, 2)._device == torch.device("cuda")


# --------------------------------------------------------------- ThreadedIter

def _fill(ti_cls, cap, n, **kw):
    ti = ti_cls(max_capacity=cap, **kw)
    items = iter(range(n))
    ti.init(lambda: next(items, None))
    return ti


@pytest.mark.parametrize("cls", [RefThreadedIter, ThreadedIter],
                         ids=["reference", "port"])
def test_threaded_iter_capacity_stats_and_name(cls):
    ti = _fill(cls, 2, 10, name="q")
    assert ti.name == "q" and ti.capacity == 2
    deadline = time.time() + 5
    while ti.qsize() < 2 and time.time() < deadline:
        time.sleep(0.005)
    time.sleep(0.05)
    assert ti.qsize() == 2  # the producer is blocked on a full queue
    st = ti.stats()
    assert set(st) == {"produced", "producer_block_s"}
    assert st["produced"] == 2
    ti.set_capacity(5)  # a grow wakes the blocked producer
    deadline = time.time() + 5
    while ti.qsize() < 5 and time.time() < deadline:
        time.sleep(0.005)
    assert ti.qsize() == 5 and ti.capacity == 5
    assert [ti.next() for _ in range(10)] == list(range(10))
    assert ti.next() is None
    st = ti.stats()
    assert st["produced"] == 10 and st["producer_block_s"] > 0
    ti.before_first()  # epoch-scoped counters reset
    assert ti.stats()["producer_block_s"] == 0.0
    with pytest.raises((DMLCError, RefDMLCError), match="capacity"):
        ti.set_capacity(0)
    ti.destroy()


def test_threaded_iter_stats_match_reference():
    """Both packages' queues report the same counters for the same
    stream; a shrink drops no queued item."""
    got = []
    for cls in (RefThreadedIter, ThreadedIter):
        ti = _fill(cls, 4, 7)
        deadline = time.time() + 5
        while ti.qsize() < 4 and time.time() < deadline:
            time.sleep(0.005)
        ti.set_capacity(1)
        out = []
        while True:
            x = ti.next()
            if x is None:
                break
            out.append(x)
        got.append((out, ti.stats()["produced"], ti.capacity))
        ti.destroy()
    assert got[0] == got[1] == (list(range(7)), 7, 1)


# ----------------------------------------------------------------- Autotuner

class TestAutotuner:
    """tests/test_pipeline.py::TestAutotuner, against the port's Autotuner."""

    def _snap(self, occupancy, wall=1.0, bytes_=10 ** 9, wait_frac=0.5,
              cap=4):
        return {
            "schema": PIPELINE_STATS_SCHEMA, "epoch": 1, "wall_s": wall,
            "stages": [{"name": "prefetch", "kind": "prefetch",
                        "items": 10, "rows": 100, "nnz": 0,
                        "bytes": bytes_, "wait_s": wait_frac * wall,
                        "wait_frac": wait_frac, "throughput_gbps": None,
                        "rows_per_s": None, "queue_depth_mean": None,
                        "queue_cap": cap,
                        "queue_occupancy": occupancy}],
            "knobs": {},
        }

    def _knob(self, store):
        return Knob("prefetch.depth", "prefetch",
                    lambda: store["v"],
                    lambda n: store.__setitem__("v", n), lo=1, hi=64)

    def test_grows_on_full_queue(self):
        store = {"v": 4}
        t = Autotuner([self._knob(store)])
        t.after_epoch(self._snap(occupancy=0.9))
        assert store["v"] == 8  # trial armed
        t.after_epoch(self._snap(occupancy=0.9, bytes_=2 * 10 ** 9))
        assert store["v"] == 16  # accepted, next trial armed
        assert t.tuned() == {"prefetch.depth": 16}

    def test_reverts_on_regression_and_freezes(self):
        store = {"v": 4}
        t = Autotuner([self._knob(store)], cooldown=5)
        t.after_epoch(self._snap(occupancy=0.9, bytes_=10 ** 9))
        assert store["v"] == 8
        # trial epoch collapses throughput → revert + freeze
        t.after_epoch(self._snap(occupancy=0.9, bytes_=10 ** 8))
        assert store["v"] == 4
        assert t.report()["decisions"][-1]["outcome"] == "reverted"
        # frozen: the same full-queue signal proposes nothing
        t.after_epoch(self._snap(occupancy=0.9))
        assert store["v"] == 4

    def test_shrinks_idle_queue(self):
        store = {"v": 16}
        t = Autotuner([self._knob(store)])
        t.after_epoch(self._snap(occupancy=0.05, wait_frac=0.0))
        assert store["v"] == 8

    def _tier_snap(self, occupancy, tier, bytes_=10 ** 9):
        snap = self._snap(occupancy, bytes_=bytes_)
        snap["stages"][0]["extra"] = {"replay_tier": tier}
        return snap

    def test_tier_flip_discards_pending_trial(self):
        store = {"v": 4}
        t = Autotuner([self._knob(store)])
        t.after_epoch(self._tier_snap(0.9, "parse"))
        assert store["v"] == 8  # trial armed during the parse epoch
        t.after_epoch(self._tier_snap(0.9, "pages", bytes_=5 * 10 ** 9))
        assert store["v"] == 8  # re-armed fresh on the pages epoch...
        d0 = t.report()["decisions"][0]
        assert d0["outcome"] == "discarded (replay tier changed)"
        assert d0["old"] == 4 and d0["new"] == 8
        # ...and judged within the pages regime from then on
        t.after_epoch(self._tier_snap(0.9, "pages", bytes_=5 * 10 ** 9))
        assert t.report()["decisions"][1]["outcome"] == "accepted"

    def test_same_tier_epochs_judge_normally(self):
        store = {"v": 4}
        t = Autotuner([self._knob(store)])
        t.after_epoch(self._tier_snap(0.9, "memory"))
        t.after_epoch(self._tier_snap(0.9, "memory", bytes_=2 * 10 ** 9))
        assert t.report()["decisions"][0]["outcome"] == "accepted"

    def test_grows_the_copy_window_on_drain_wait(self):
        """A windowed stage (to_device) grows while its drain wait
        dominates the epoch."""
        store = {"v": 4}
        knob = Knob("device.window", "to_device", lambda: store["v"],
                    lambda n: store.__setitem__("v", n), lo=1, hi=32)
        snap = self._snap(None)
        snap["stages"][0].update(name="to_device", kind="to_device",
                                 extra={"xfer_wait_s": 0.5})
        Autotuner([knob]).after_epoch(snap)
        assert store["v"] == 8

    def test_converges_on_synthetic_slow_stage(self, corpora):
        """Fast producer, slow consumer: the prefetch queue sits full,
        the tuner must raise its depth from the initial 4 and reach a
        fixed point within a few epochs."""
        built = (Pipeline.from_uri(corpora["libsvm"])
                 .parse(format="libsvm").batch(40)  # ~38 small items
                 .prefetch(depth="auto")
                 .map(lambda b: (time.sleep(0.008), b)[1], name="slow")
                 .build(autotune=True))
        initial = built.knob_values()["prefetch.depth"]
        values = []
        for _ in range(12):
            built.run_epoch()
            values.append(built.knob_values()["prefetch.depth"])
            if (len(values) >= 3 and values[-1] > initial
                    and values[-1] == values[-2] == values[-3]):
                break
        report = built.autotune_report()
        built.close()
        assert values[-1] > initial, (values, report)
        assert values[-1] == values[-2], (values, report)

    def test_no_knobs_no_tuner(self, corpora):
        built = (Pipeline.from_uri(corpora["libsvm"])
                 .parse(format="libsvm", prefetch_depth=2)
                 .build(autotune=True))
        # all depths fixed ⇒ autotune=True binds nothing
        assert built.autotuner is None
        assert isinstance(built, CompiledPipeline)
        built.close()


# ------------------------------------------------------------- the slice

STEPS = 5


@pytest.mark.parametrize("cache", [None, 0], ids=["parse", "page_cache"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_pipeline_to_linear_model_matches_reference(corpora, native, stores,
                                                    engine, cache):
    """Pipeline → SparseLinearModel, 5 SGD steps from zero weights, in both
    packages, straight from the parse and from a page cache
    (``cache(memory_budget_bytes=0)``): losses and the final weights
    allclose."""
    def chain(cls, **device):
        p = cls.from_uri(corpora["libsvm"]).parse(format="libsvm",
                                                  engine=engine)
        if cache is not None:
            p = p.cache(memory_budget_bytes=cache)
        return (p.batch(BATCH, pad=True, nnz_bucket=NNZ_BUCKET)
                .to_device(**device).build(autotune=True))

    ref = RefModel(FEATURES, learning_rate=2.0)
    params = {k: np.asarray(v) for k, v in ref.init_params().items()}
    want = []
    with chain(RefPipeline) as built:
        for batch in built:
            params, loss = ref.train_step(params, dict(batch))
            want.append(float(loss))
            if len(want) == STEPS:
                break
    model = SparseLinearModel(FEATURES, learning_rate=2.0, device="cpu")
    model.load_state_dict(params_from_jax(
        {"w": np.zeros(FEATURES, np.float32), "b": np.float32(0)},
        device="cpu"))
    got = []
    with chain(Pipeline, device="cpu") as built:
        for batch in built:
            assert batch["index"].dtype == torch.uint32
            got.append(float(model.train_step(batch)))
            if len(got) == STEPS:
                break
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    mine = params_to_numpy(model.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(mine[k], np.asarray(params[k]),
                                   rtol=RTOL, atol=ATOL)
    assert np.abs(mine["w"]).max() > 0  # the steps did move the weights
