"""The port's object-store plane (``dmlc_tpu_torch/io/objstore``) held to
the reference's (``dmlc_tpu/io/objstore``).

The reference's ``tests/test_objstore.py`` classes run here against the
port (emulator model, the ``obj://`` FileSystem surface, the seek
stream, page-store hydration, epoch parity, chaos at the GET and PUT
seams, multipart, the stale sweep), with the ``em`` fixture
parametrized over the emulator and the real HTTP client in front of
``tests/objstore_http_server.py``, as the reference's is. Then the
cross-package checks: an object either package's emulator writes reads
back byte for byte through the other's stream, one read sequence gives
equal emulator counters in both, and a Pipeline drain's
``content_hash()`` over ``obj://`` equals the one over the local file,
in the port and in the reference. Every payload is made from a seeded
numpy generator; every wait in these tests is bounded (the emulator's
sleeps are off unless a test shapes the wire itself)."""

import os

import numpy as np
import pytest

import dmlc_tpu.io.objstore as ref_objstore
import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch.io.filesys import FileSystem, URI
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.pagestore import PageStore
from dmlc_tpu_torch.io.stream import (
    create_seek_stream_for_read, create_stream,
)
from dmlc_tpu_torch.resilience import (
    RetryPolicy, inject, reset_policies, retry_counts, set_policy,
)
from dmlc_tpu_torch.utils.logging import DMLCError


def _counter(name):
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    return REGISTRY.counter(name).value


class _HttpBackendHandle:
    """The HTTP backend's handle: object verbs go through the real wire
    client, ground truth (request counters, the on-disk root) stays with
    the inner emulator behind the test endpoint."""

    def __init__(self, client, inner):
        self._client = client
        self._inner = inner
        self.root = inner.root

    def counters(self):
        return self._inner.counters()

    def reset_counters(self):
        return self._inner.reset_counters()

    def __getattr__(self, name):
        return getattr(self._client, name)


def _restore_options(ofs, saved):
    ofs.configure(None, block_bytes=saved["block_bytes"],
                  coalesce=saved["coalesce"], parallel=saved["parallel"],
                  hydrate=saved["hydrate"],
                  put_part_bytes=saved["put_part_bytes"],
                  put_parallel=saved["put_parallel"])
    ofs._options["codec_level"] = saved["codec_level"]


@pytest.fixture(params=["emulator", "http"])
def em(request, tmp_path, monkeypatch):
    """A fresh backend client and an isolated page-store root, with the
    process-wide client, options and policies restored afterwards."""
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
    monkeypatch.delenv(ofs.ENV_ENDPOINT, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "pagestore"))
    saved = ofs.options()
    server = None
    from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
    inner = EmulatedObjectStore(str(tmp_path / "objroot"))
    try:
        if request.param == "emulator":
            handle = objstore.configure(inner, block_bytes=1 << 15,
                                        coalesce=4, parallel=2)
        else:
            from objstore_http_server import ObjstoreHttpServer

            from dmlc_tpu_torch.io.objstore.http_client import (
                HttpObjectStoreClient,
            )
            server = ObjstoreHttpServer(inner)
            client = HttpObjectStoreClient(server.endpoint, encoded=True,
                                           multipart=True)
            objstore.configure(client, block_bytes=1 << 15, coalesce=4,
                               parallel=2)
            handle = _HttpBackendHandle(client, inner)
        yield handle
    finally:
        _restore_options(ofs, saved)
        if server is not None:
            server.close()
        inject.uninstall()
        reset_policies()


def _text_payload(rows=20000, seed=0):
    rng = np.random.RandomState(seed)
    return b"".join(b"%d %d:%.4f %d:%.4f\n"
                    % (i % 2, rng.randint(0, 40), rng.rand(),
                       40 + rng.randint(0, 40), rng.rand())
                    for i in range(rows))


def _noop_sleep(_s):
    pass


# ------------------------------------------------------------ emulator

class TestEmulator:
    def test_put_head_get_round_trip(self, em):
        info = em.put("b", "k/nested/x.bin", b"0123456789")
        assert info.size == 10 and info.etag
        assert em.head("b", "k/nested/x.bin").size == 10
        assert em.get("b", "k/nested/x.bin") == b"0123456789"
        assert em.get("b", "k/nested/x.bin", 2, 5) == b"234"
        assert em.get("b", "k/nested/x.bin", 8, 99) == b"89"

    def test_missing_object_raises(self, em):
        with pytest.raises(FileNotFoundError):
            em.head("b", "ghost")
        with pytest.raises(FileNotFoundError):
            em.get("b", "ghost")

    def test_list_is_prefix_recursive_sorted(self, em):
        for k in ("d/2.bin", "d/sub/3.bin", "d/1.bin", "other.bin"):
            em.put("b", k, b"x")
        got = [o.key for o in em.list("b", "d")]
        assert got == ["d/1.bin", "d/2.bin", "d/sub/3.bin"]
        assert em.is_prefix("b", "d") and not em.is_prefix("b", "zz")

    def test_counters_ground_truth(self, em):
        em.put("b", "k", b"abcdef")
        em.reset_counters()
        em.get("b", "k", 0, 3)
        em.get("b", "k", 3, 6)
        em.head("b", "k")
        c = em.counters()
        assert c["gets"] == 2 and c["get_bytes"] == 6
        assert c["heads"] == 1

    def test_traversal_rejected(self, em):
        with pytest.raises(DMLCError):
            em.head("..", "x")
        with pytest.raises(DMLCError):
            em.head("b", "../escape")


# --------------------------------------------------- FileSystem surface

class TestObjectStoreFileSystem:
    def test_stat_list_through_registry(self, em):
        em.put("bucket", "d/a.bin", b"aaa")
        em.put("bucket", "d/b.bin", b"bb")
        u = URI("obj://bucket/d/a.bin")
        fs = FileSystem.get_instance(u)
        info = fs.get_path_info(u)
        assert (info.size, info.type) == (3, "file")
        assert info.mtime_ns > 0
        d = URI("obj://bucket/d")
        assert fs.get_path_info(d).type == "directory"
        listing = fs.list_directory(d)
        assert [fi.path for fi in listing] == \
            ["obj://bucket/d/a.bin", "obj://bucket/d/b.bin"]
        assert [fi.size for fi in listing] == [3, 2]

    def test_s3_alias_reads_the_same_object(self, em):
        em.put("bucket", "k.bin", b"alias")
        with create_seek_stream_for_read("s3://bucket/k.bin") as s:
            assert s.read_all() == b"alias"
        assert s.path == "s3://bucket/k.bin"

    def test_write_stream_puts_object(self, em):
        with create_stream("obj://bucket/out/w.bin", "w") as s:
            s.write(b"part1-")
            s.write(b"part2")
        assert em.get("bucket", "out/w.bin") == b"part1-part2"

    def test_append_mode_rejected(self, em):
        with pytest.raises(DMLCError, match="no append"):
            create_stream("obj://bucket/x", "a")

    def test_missing_object_propagates(self, em):
        with pytest.raises(FileNotFoundError):
            create_seek_stream_for_read("obj://bucket/ghost.bin")

    def test_unconfigured_plane_error_is_actionable(self, tmp_path,
                                                    monkeypatch):
        import dmlc_tpu_torch.io.objstore.fs as ofs
        monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
        monkeypatch.delenv(ofs.ENV_ENDPOINT, raising=False)
        objstore.configure(None)
        try:
            with pytest.raises(DMLCError, match="DMLC_TPU_OBJSTORE_ROOT"):
                create_seek_stream_for_read("obj://bucket/x")
        finally:
            objstore.configure(None)

    def test_env_contract_builds_emulator(self, tmp_path, monkeypatch):
        import dmlc_tpu_torch.io.objstore.fs as ofs
        objstore.configure(None)
        monkeypatch.setenv(ofs.ENV_ROOT, str(tmp_path / "envroot"))
        try:
            c = objstore.client()
            assert c is not None and c.root == str(tmp_path / "envroot")
        finally:
            objstore.configure(None)

    def test_env_names_are_the_references(self):
        import dmlc_tpu.io.objstore.fs as ref_ofs
        import dmlc_tpu_torch.io.objstore.fs as ofs
        for name in ("ENV_ROOT", "ENV_LATENCY", "ENV_GBPS", "ENV_ENDPOINT",
                     "ENV_AUTH"):
            assert getattr(ofs, name) == getattr(ref_ofs, name)
        assert ofs.options() == dict(ref_ofs.options())

    @pytest.mark.parametrize("peer", [True, False])
    def test_peer_tier_refused_by_name(self, peer):
        """The peer tier is ported: ``configure(peer=...)`` no longer
        refuses, it sets the read option as the reference's does (and
        the test puts the option back)."""
        import dmlc_tpu.io.objstore.fs as ref_ofs
        import dmlc_tpu_torch.io.objstore.fs as ofs
        before = ofs.options()
        assert ref_ofs.options()["peer"] is True  # the default of both
        try:
            objstore.configure(peer=peer)
            assert ofs.options() == dict(before, peer=peer)
        finally:
            objstore.configure(peer=True)
        assert ofs.options() == before


def test_listing_skips_inflight_puts_and_vanished_files(tmp_path,
                                                       monkeypatch):
    """Several writers commit into one emulator root at once (a gang's
    checkpoint): a listing leaves out another process's PUT in flight
    (its ``.tmp.<pid>`` staging file) and a file gone by the time it is
    stat'ed, where the reference's listing raises FileNotFoundError."""
    from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
    em = EmulatedObjectStore(str(tmp_path / "root"))
    em.put("b", "ck/a.idx.json", b"{}")
    em.put("b", "ck/b.idx.json", b"{}")
    (tmp_path / "root" / "b" / "ck" / "c.idx.json.tmp.4242").write_bytes(
        b"{")
    assert [o.key for o in em.list("b", "ck")] == ["ck/a.idx.json",
                                                   "ck/b.idx.json"]
    gone = str(tmp_path / "root" / "b" / "ck" / "b.idx.json")
    real_stat = os.stat

    def racing_stat(path, *a, **kw):
        if str(path) == gone:
            raise FileNotFoundError(path)
        return real_stat(path, *a, **kw)

    monkeypatch.setattr(os, "stat", racing_stat)
    assert [o.key for o in em.list("b", "ck")] == ["ck/a.idx.json"]


# ----------------------------------------------------- the seek stream

class TestObjectSeekStream:
    def test_read_is_byte_identical_across_blocks(self, em):
        payload = bytes(range(256)) * 700  # 175 KiB over 32 KiB blocks
        em.put("b", "x.bin", payload)
        s = create_seek_stream_for_read("obj://b/x.bin")
        assert s.size == len(payload)
        assert s.read_all() == payload
        s.seek(70000)
        assert s.tell() == 70000
        assert s.read(10) == payload[70000:70010]
        s.seek(len(payload))
        assert s.read(10) == b""
        with pytest.raises(DMLCError):
            s.seek(len(payload) + 1)
        with pytest.raises(DMLCError):
            s.write(b"nope")
        s.close()

    def test_coalescing_bounds_request_count(self, em):
        payload = b"z" * (14 * (1 << 15))  # 14 blocks
        em.put("b", "big.bin", payload)
        em.reset_counters()
        s = create_seek_stream_for_read("obj://b/big.bin")
        assert s.read_all() == payload
        s.close()
        # coalesce=4, parallel=2: 4 spans of <=4 blocks, each split
        # into <=2 ranged GETs — far fewer wire calls than 14 blocks
        assert 0 < em.counters()["gets"] <= 8
        assert em.counters()["get_bytes"] == len(payload)

    def test_objstore_metrics_counted(self, em):
        em.put("b", "m.bin", b"q" * 1000)
        g0, b0 = _counter("objstore.get"), _counter("objstore.bytes")
        s = create_seek_stream_for_read("obj://b/m.bin")
        s.read_all()
        s.close()
        assert _counter("objstore.get") > g0
        assert _counter("objstore.bytes") >= b0 + 1000

    def test_changed_object_serves_new_generation(self, em, tmp_path):
        em.put("b", "gen.bin", b"A" * 50000)
        s = create_seek_stream_for_read("obj://b/gen.bin")
        assert s.read_all() == b"A" * 50000
        s.close()
        em.put("b", "gen.bin", b"B" * 60000)  # new size → new etag
        s2 = create_seek_stream_for_read("obj://b/gen.bin")
        assert s2.read_all() == b"B" * 60000
        s2.close()


# ------------------------------------------------- hydration acceptance

class TestHydration:
    def test_second_epoch_is_wire_free(self, em):
        """Epoch 2 over the same obj:// URI performs ZERO emulator GETs:
        hydrated pages serve every block, by the emulator's own request
        counters and the port's objstore.* / pagestore.* counters."""
        payload = _text_payload()
        em.put("bucket", "train/d.libsvm", payload)
        uri = "obj://bucket/train/d.libsvm"
        em.reset_counters()
        g0 = _counter("objstore.get")
        h0 = _counter("pagestore.hit")
        cold = list(InputSplit.create(uri, 0, 1))
        cold_gets = em.counters()["gets"]
        assert cold_gets > 0
        assert _counter("objstore.get") == g0 + cold_gets
        em.reset_counters()
        warm = list(InputSplit.create(uri, 0, 1))
        assert warm == cold
        assert em.counters()["gets"] == 0, \
            "second epoch must not touch the wire"
        assert _counter("objstore.get") == g0 + cold_gets
        assert _counter("pagestore.hit") > h0

    def test_hydrate_off_hits_wire_every_epoch(self, em, tmp_path):
        objstore.configure(hydrate=False)
        payload = b"x" * 100000
        em.put("b", "nh.bin", payload)
        for _ in range(2):
            em.reset_counters()
            s = create_seek_stream_for_read("obj://b/nh.bin")
            assert s.read_all() == payload
            s.close()
            assert em.counters()["gets"] > 0

    def test_hydrated_pages_are_stamped_and_sweepable(self, em,
                                                      tmp_path):
        em.put("b", "sw.bin", b"h" * 40000)
        s = create_seek_stream_for_read("obj://b/sw.bin")
        s.read_all()
        s.close()
        store = PageStore.default()
        assert store.root == str(tmp_path / "pagestore")
        entries = [n for n in os.listdir(store.root)
                   if n.startswith("obj-") and n.endswith(".pages")]
        assert entries
        stamp = store.stamp(entries[0])
        assert stamp["fingerprint"][0][0] == "obj://b/sw.bin"
        # the object changes → the one sweep reclaims the generation
        em.put("b", "sw.bin", b"h" * 41000)
        assert store.sweep() >= len(entries)

    def test_codec_wire_moves_fewer_bytes_and_stays_exact(self, em):
        payload = _text_payload(rows=6000, seed=4)
        em.put("b", "cz.libsvm", payload)
        em.reset_counters()
        with create_seek_stream_for_read("obj://b/cz.libsvm") as s:
            assert s.read_all() == payload
        raw = em.counters()["get_bytes"]
        for n in os.listdir(PageStore.default().root):
            PageStore.default().delete(n)
        objstore.configure(codec_level=6)
        em.reset_counters()
        with create_seek_stream_for_read("obj://b/cz.libsvm") as s:
            assert s.read_all() == payload
        assert 0 < em.counters()["get_bytes"] < raw
        em.reset_counters()
        with create_seek_stream_for_read("obj://b/cz.libsvm") as s:
            assert s.read_all() == payload
        assert em.counters()["gets"] == 0


# ------------------------------------------------ epoch parity pinning

class TestEpochParity:
    def test_text_epoch_byte_identical_to_local(self, em, tmp_path):
        payload = _text_payload()
        em.put("bucket", "d.libsvm", payload)
        local = tmp_path / "d.libsvm"
        local.write_bytes(payload)
        for parts in (1, 3):
            remote_recs, local_recs = [], []
            for k in range(parts):
                remote_recs += list(InputSplit.create(
                    "obj://bucket/d.libsvm", k, parts))
                local_recs += list(InputSplit.create(str(local), k,
                                                     parts))
            assert remote_recs == local_recs

    def test_recordio_epoch_byte_identical_to_local(self, em, tmp_path):
        from dmlc_tpu_torch.io.recordio import RecordIOWriter
        rng = np.random.RandomState(3)
        local = str(tmp_path / "d.rec")
        with create_stream(local, "w") as s:
            w = RecordIOWriter(s)
            for i in range(4000):
                w.write_record(bytes(rng.randint(0, 256,
                                                 rng.randint(1, 200),
                                                 dtype=np.uint8)))
        em.put_file("bucket", "d.rec", local)
        for parts in (1, 2):
            for k in range(parts):
                remote = list(InputSplit.create("obj://bucket/d.rec",
                                                k, parts,
                                                split_type="recordio"))
                loc = list(InputSplit.create(local, k, parts,
                                             split_type="recordio"))
                assert remote == loc

    def test_native_engine_reads_local_files_only(self, em):
        """engine="auto" falls back to the golden parse on obj:// (the
        same rows as a python parse); engine="native" raises, as the
        reference's does."""
        from dmlc_tpu_torch.data.parser import Parser
        from dmlc_tpu_torch.data.rowblock import RowBlockContainer
        em.put("bucket", "n.libsvm", _text_payload(rows=3000, seed=2))
        uri = "obj://bucket/n.libsvm"

        def drain(engine):
            c = RowBlockContainer(np.uint32)
            for b in Parser.create(uri, 0, 1, format="libsvm",
                                   engine=engine):
                c.push_block(b)
            return c.get_block().content_hash()

        assert drain("auto") == drain("python")
        with pytest.raises(DMLCError, match="local files"):
            Parser.create(uri, 0, 1, format="libsvm", engine="native")


def _drain_hash(pipeline_cls, container_cls, uri):
    built = (pipeline_cls.from_uri(uri).parse(format="libsvm")
             .batch(512).build())
    c = container_cls(np.uint32)
    for b in built:
        c.push_block(b)
    built.close()
    return c.get_block().content_hash()


def test_parsed_batches_identical_via_pipeline(em, tmp_path):
    """The reference's Pipeline drain: the same content hash over
    obj:// as over the local file, in the port."""
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.pipeline import Pipeline
    payload = _text_payload(rows=8000)
    em.put("bucket", "p.libsvm", payload)
    local = tmp_path / "p.libsvm"
    local.write_bytes(payload)
    assert _drain_hash(Pipeline, RowBlockContainer,
                       "obj://bucket/p.libsvm") == \
        _drain_hash(Pipeline, RowBlockContainer, str(local))


def test_padded_batches_over_obj_equal_the_local_chain(em, tmp_path):
    """``Pipeline.from_uri("obj://…").parse().batch(pad=True)
    .to_device("cpu")``: every padded batch byte-identical to the same
    chain over the local copy, and the second epoch wire-free."""
    from dmlc_tpu_torch.pipeline import Pipeline
    payload = _text_payload(rows=5000, seed=9)
    em.put("bucket", "pad.libsvm", payload)
    local = tmp_path / "pad.libsvm"
    local.write_bytes(payload)

    def chain(uri):
        return (Pipeline.from_uri(uri).parse(format="libsvm")
                .batch(256, pad=True, nnz_bucket=256 * 2)
                .to_device(device="cpu").build())

    def epoch(built):
        return [{k: v.numpy().tobytes() for k, v in b.items()}
                for b in built]

    with chain(str(local)) as built:
        want = epoch(built)
    em.reset_counters()
    with chain("obj://bucket/pad.libsvm") as built:
        assert epoch(built) == want
        cold = em.counters()["gets"]
        em.reset_counters()
        assert epoch(built) == want
    assert cold > 0 and em.counters()["gets"] == 0
    assert len(want) == -(-5000 // 256)


# ------------------------------------------------------------- chaos

class TestChaos:
    def test_ioerror_at_get_retries_byte_identical(self, em):
        payload = _text_payload(rows=5000)
        em.put("bucket", "c.libsvm", payload)
        want = list(InputSplit.create("obj://bucket/c.libsvm", 0, 1))
        PageStore.default().sweep(max_tmp_age_s=0)
        for n in os.listdir(PageStore.default().root):
            PageStore.default().delete(n)
        set_policy("io.objstore.get",
                   RetryPolicy(max_attempts=4, sleep=_noop_sleep))
        inject.install("site=io.objstore.get,fault=ioerror,times=2")
        got = list(InputSplit.create("obj://bucket/c.libsvm", 0, 1))
        assert got == want
        assert retry_counts().get("io.objstore.get", 0) >= 2

    def test_truncate_at_get_detected_and_refetched(self, em):
        """An injected truncation must be DETECTED against the requested
        range and retried — never handed downstream as shifted bytes."""
        payload = _text_payload(rows=5000)
        em.put("bucket", "t.libsvm", payload)
        want = list(InputSplit.create("obj://bucket/t.libsvm", 0, 1))
        for n in os.listdir(PageStore.default().root):
            PageStore.default().delete(n)
        set_policy("io.objstore.get",
                   RetryPolicy(max_attempts=4, sleep=_noop_sleep))
        inject.install("site=io.objstore.get,fault=truncate,times=3")
        got = list(InputSplit.create("obj://bucket/t.libsvm", 0, 1))
        assert got == want
        assert retry_counts().get("io.objstore.get", 0) >= 3

    def test_really_shrunk_object_surfaces_as_error(self, em):
        em.put("bucket", "shrink.bin", b"L" * 100000)
        split = InputSplit.create("obj://bucket/shrink.bin", 0, 1)
        first = split.next_chunk()
        assert first
        # the SOURCE object shrinks under the live split: the replay
        # must surface an error, never silently shifted/short bytes
        em.put("bucket", "shrink.bin", b"L" * 10)
        set_policy("io.objstore.get",
                   RetryPolicy(max_attempts=2, sleep=_noop_sleep))
        split.before_first()
        with pytest.raises((DMLCError, IOError)):
            while split.next_chunk() is not None:
                pass


# --------------------------------------------------- the write plane

class TestMultipart:
    def _payload(self, n=1 << 18, seed=7):
        return np.random.RandomState(seed).bytes(n)

    def test_multipart_round_trip_with_part_counters(self, em):
        from dmlc_tpu_torch.io.objstore.multipart import MultipartWriter
        data = self._payload(100_000)
        em.reset_counters()
        w = MultipartWriter(em, "b", "mp.bin", "obj://b/mp.bin",
                            part_bytes=1 << 14, parallel=2)
        for i in range(0, len(data), 7777):
            w.write(data[i:i + 7777])
        w.close()
        assert em.get("b", "mp.bin") == data
        c = em.counters()
        assert c["put_parts"] == -(-len(data) // (1 << 14))
        assert c["put_bytes"] == len(data)
        assert c["puts"] == 1  # the complete, not a re-upload
        assert em.list_uploads("b") == []  # staging area drained

    def test_abort_leaves_no_object_and_no_parts(self, em):
        from dmlc_tpu_torch.io.objstore.multipart import MultipartWriter
        w = MultipartWriter(em, "b", "gone.bin", "obj://b/gone.bin",
                            part_bytes=1 << 12, parallel=2)
        w.write(self._payload(1 << 14))
        w.abort()
        with pytest.raises(FileNotFoundError):
            em.head("b", "gone.bin")
        assert em.list_uploads("b") == []

    def test_write_stream_spills_into_multipart(self, em):
        objstore.configure(put_part_bytes=1 << 14, put_parallel=2)
        data = self._payload(90_000)
        em.reset_counters()
        with create_stream("obj://b/auto.bin", "w") as s:
            for i in range(0, len(data), 5000):
                s.write(data[i:i + 5000])
        assert em.get("b", "auto.bin") == data
        c = em.counters()
        assert c["put_parts"] > 0 and c["put_bytes"] == len(data)

    def test_small_write_stream_stays_single_shot(self, em):
        em.reset_counters()
        with create_stream("obj://b/small.bin", "w") as s:
            s.write(b"tiny")
        assert em.get("b", "small.bin") == b"tiny"
        c = em.counters()
        assert c["puts"] == 1 and c["put_parts"] == 0

    def test_complete_with_missing_part_raises(self, em):
        up = em.create_multipart("b", "torn.bin")
        em.put_part("b", "torn.bin", up, 0, b"aa")
        with pytest.raises(FileNotFoundError):
            em.complete_multipart("b", "torn.bin", up, 2)
        with pytest.raises(FileNotFoundError):
            em.head("b", "torn.bin")
        em.abort_multipart("b", "torn.bin", up)

    def test_delete_verb(self, em):
        em.put("b", "d.bin", b"x")
        assert em.delete("b", "d.bin") is True
        assert em.delete("b", "d.bin") is False
        with pytest.raises(FileNotFoundError):
            em.head("b", "d.bin")

    def test_put_wire_model_charges_latency(self, em):
        """The emulator's wire model charges PUTs too: latency_s applies
        to put and put_part."""
        import time as _time

        from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
        shaped = EmulatedObjectStore(em.root, latency_s=0.03)
        t0 = _time.monotonic()
        shaped.put("b", "lat.bin", b"x" * 100)
        assert _time.monotonic() - t0 >= 0.025
        up = shaped.create_multipart("b", "lat2.bin")
        t0 = _time.monotonic()
        shaped.put_part("b", "lat2.bin", up, 0, b"y" * 100)
        assert _time.monotonic() - t0 >= 0.025
        shaped.abort_multipart("b", "lat2.bin", up)


class TestPutChaos:
    """Chaos at the ``io.objstore.put`` seam: a faulted part retries JUST
    that part byte-identically; faults past the ladder abort with no
    partial object visible and the parts swept."""

    def _upload(self, data):
        with create_stream("obj://b/chaos.bin", "w") as s:
            s.write(data)

    def test_nth_part_ioerror_retries_that_part_byte_identical(self, em):
        data = np.random.RandomState(3).bytes(80_000)
        objstore.configure(put_part_bytes=1 << 14, put_parallel=1)
        set_policy("io.objstore.put",
                   RetryPolicy(max_attempts=4, sleep=_noop_sleep))
        inject.install("site=io.objstore.put,fault=ioerror,nth=3")
        self._upload(data)
        assert em.get("b", "chaos.bin") == data
        assert retry_counts().get("io.objstore.put", 0) >= 1

    def test_truncated_part_detected_and_resent(self, em):
        data = np.random.RandomState(4).bytes(60_000)
        objstore.configure(put_part_bytes=1 << 14, put_parallel=1)
        set_policy("io.objstore.put",
                   RetryPolicy(max_attempts=4, sleep=_noop_sleep))
        before = _counter("objstore.put.retries")
        inject.install("site=io.objstore.put,fault=truncate,times=2")
        self._upload(data)
        assert em.get("b", "chaos.bin") == data
        assert _counter("objstore.put.retries") > before

    def test_exhausted_ladder_aborts_no_partial_object(self, em):
        data = np.random.RandomState(5).bytes(80_000)
        objstore.configure(put_part_bytes=1 << 14, put_parallel=2)
        set_policy("io.objstore.put",
                   RetryPolicy(max_attempts=2, sleep=_noop_sleep))
        before = _counter("objstore.put.aborts")
        s = create_stream("obj://b/chaos.bin", "w")
        s.write(data[: 1 << 14])  # spill: the multipart upload is live
        inject.install("site=io.objstore.put,fault=ioerror,times=50")
        with pytest.raises((IOError, OSError, DMLCError)):
            try:
                s.write(data[1 << 14:])
            finally:
                s.close()
        with pytest.raises(FileNotFoundError):
            em.head("b", "chaos.bin")
        assert em.list_uploads("b") == []
        assert _counter("objstore.put.aborts") > before

    def test_single_shot_truncation_never_lands_short(self, em):
        set_policy("io.objstore.put",
                   RetryPolicy(max_attempts=3, sleep=_noop_sleep))
        inject.install("site=io.objstore.put,fault=truncate,times=2")
        with create_stream("obj://b/ss.bin", "w") as s:
            s.write(b"Z" * 5000)
        assert em.get("b", "ss.bin") == b"Z" * 5000

    def test_sweep_reaps_dead_writer_uploads_only(self, em):
        from dmlc_tpu_torch.io.objstore.multipart import sweep_uploads
        live = em.create_multipart("b", "live.bin")
        em.put_part("b", "live.bin", live, 0, b"l")
        dead = em.create_multipart("b", "dead.bin")
        em.put_part("b", "dead.bin", dead, 0, b"d")
        import dmlc_tpu_torch.io.objstore.emulator as _emu
        inner = em if isinstance(em, _emu.EmulatedObjectStore) \
            else em._inner
        mpu = os.path.join(inner.root, "b", ".mpu")
        dead_id = "p999999999-feedbeef"
        os.rename(os.path.join(mpu, dead), os.path.join(mpu, dead_id))
        assert sweep_uploads(em, "b") == 1
        ids = [u for u, _ in em.list_uploads("b")]
        assert ids == [live]
        em.abort_multipart("b", "live.bin", live)

    def test_stale_spill_sweep_reaps_dead_uploads(self, em):
        """``sweep_stale_spill()`` (the restore-time sweep) also reaps a
        dead writer's staged parts in the configured store."""
        from dmlc_tpu_torch.data.row_iter import sweep_stale_spill
        import dmlc_tpu_torch.io.objstore.emulator as _emu
        inner = em if isinstance(em, _emu.EmulatedObjectStore) \
            else em._inner
        objstore.configure(inner)
        dead = inner.create_multipart("b", "orphan.bin")
        inner.put_part("b", "orphan.bin", dead, 0, b"o")
        mpu = os.path.join(inner.root, "b", ".mpu")
        os.rename(os.path.join(mpu, dead),
                  os.path.join(mpu, "p999999998-0badf00d"))
        assert sweep_stale_spill() >= 1
        assert inner.list_uploads("b") == []


# ------------------------------------------------ cross-package parity

@pytest.fixture
def both(tmp_path, monkeypatch):
    """One emulator root configured in BOTH packages (each its own
    emulator object over it, no wire sleeps) and each package its own
    page-store root; both packages' client and options restored
    afterwards."""
    import dmlc_tpu.io.objstore.fs as ref_ofs
    import dmlc_tpu.io.pagestore as ref_ps
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "port_pages"))
    monkeypatch.setattr(ref_ps, "default_store_dir",
                        lambda: str(tmp_path / "ref_pages"))
    saved, ref_saved = ofs.options(), ref_ofs.options()
    root = str(tmp_path / "objroot")
    try:
        port = objstore.configure(root=root, block_bytes=1 << 15,
                                  coalesce=4, parallel=2)
        ref = ref_objstore.configure(root=root, block_bytes=1 << 15,
                                     coalesce=4, parallel=2)
        yield port, ref
    finally:
        _restore_options(ofs, saved)
        _restore_options(ref_ofs, ref_saved)


def test_each_package_reads_the_others_objects(both):
    from dmlc_tpu.io.stream import (
        create_seek_stream_for_read as ref_open,
    )
    port, ref = both
    rng = np.random.RandomState(11)
    a, b = rng.bytes(150_000), rng.bytes(70_001)
    ref.put("bkt", "from_ref.bin", a)
    port.put("bkt", "from_port.bin", b)
    with create_seek_stream_for_read("obj://bkt/from_ref.bin") as s:
        assert s.read_all() == a
    s = ref_open("obj://bkt/from_port.bin")
    assert s.read_all() == b
    s.close()
    assert port.head("bkt", "from_ref.bin").etag == \
        ref.head("bkt", "from_ref.bin").etag


@pytest.mark.parametrize("codec_level", [0, 6])
def test_one_read_sequence_gives_equal_counters(both, codec_level):
    """The same sequence of seeks and reads through each package's
    stream, each over a cold page store: equal bytes and equal emulator
    counters (GETs, wire bytes, HEADs)."""
    from dmlc_tpu.io.stream import (
        create_seek_stream_for_read as ref_open,
    )
    port, ref = both
    objstore.configure(codec_level=codec_level)
    ref_objstore.configure(codec_level=codec_level)
    payload = _text_payload(rows=12000, seed=5)
    port.put("bkt", "seq.libsvm", payload)
    rng = np.random.RandomState(0)
    plan = [(int(rng.randint(0, len(payload))), int(rng.randint(1, 90000)))
            for _ in range(12)]

    def run(opener, em):
        em.reset_counters()
        s = opener("obj://bkt/seq.libsvm")
        out = []
        for pos, n in plan:
            s.seek(pos)
            out.append(s.read(n))
        s.seek(0)
        out.append(s.read_all())
        s.close()
        return out, em.counters()

    got, port_counts = run(create_seek_stream_for_read, port)
    want, ref_counts = run(ref_open, ref)
    assert got == want
    assert got[-1] == payload
    assert port_counts == ref_counts
    assert port_counts["gets"] > 0


def test_pipeline_drain_hash_equal_in_both_packages(both, tmp_path):
    """A Pipeline drain's content_hash is equal over obj:// and over the
    local file, in the port and in the reference."""
    from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
    from dmlc_tpu.pipeline import Pipeline as RefPipeline
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    from dmlc_tpu_torch.pipeline import Pipeline
    port, _ = both
    payload = _text_payload(rows=8000, seed=6)
    port.put("bkt", "p.libsvm", payload)
    local = tmp_path / "p.libsvm"
    local.write_bytes(payload)
    hashes = {
        (pkg, where): _drain_hash(pc, cc, uri)
        for pkg, pc, cc in (("port", Pipeline, RowBlockContainer),
                            ("ref", RefPipeline, RefContainer))
        for where, uri in (("obj", "obj://bkt/p.libsvm"),
                           ("local", str(local)))}
    assert len(set(hashes.values())) == 1, hashes


def test_rpc_spans_of_a_traced_read_match_the_reference(both, tmp_path):
    """A traced cold read opens one ``rpc.client`` span an attempt and
    one ``rpc.server`` span an emulator GET, each pair sharing its
    context, with the verbs of the reference's trace of the same read."""
    from dmlc_tpu.io.stream import (
        create_seek_stream_for_read as ref_open,
    )
    from dmlc_tpu.obs import trace as ref_trace
    from dmlc_tpu_torch.obs import trace
    port, _ = both
    port.put("bkt", "tr.bin", np.random.RandomState(1).bytes(200_000))

    def spans(tr, opener):
        rec = tr.start(capacity=4096)
        try:
            with opener("obj://bkt/tr.bin") as s:
                s.read_all()
        finally:
            tr.stop()
        # events are (ph, name, cat, t0, dur, tid, args)
        ev = [(e[2], e[6]) for e in rec.events()
              if e[2] in ("rpc.client", "rpc.server")]
        return sorted((cat, args["verb"]) for cat, args in ev), ev

    got, ev = spans(trace, create_seek_stream_for_read)

    class _Ref:
        def __init__(self, path):
            self.s = ref_open(path)

        def __enter__(self):
            return self.s

        def __exit__(self, *exc):
            self.s.close()

    want, _ = spans(ref_trace, _Ref)
    assert got == want and got
    # every GET attempt's context is echoed by one server span (the
    # emulator's HEAD has no server half, in both packages)
    gets = {args["trace"] for cat, args in ev
            if cat == "rpc.client" and args["verb"] == "get"}
    assert gets == {args["trace"] for cat, args in ev
                    if cat == "rpc.server"}
