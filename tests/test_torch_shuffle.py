"""The port's global shuffle plane (``dmlc_tpu_torch/shuffle``, the
``/shuffle`` endpoint and the ``Pipeline.shuffle(global_seed=...)``
lowering) held to the reference's ``tests/test_shuffle.py``.

The reference's classes run here against the port: ``TestRecordIndex``
(text, RecordIO, dense and image RecordIO, indexed RecordIO, the
sidecar committed once and rebuilt on change, the multi-file byte
space), ``TestGlobalShuffle`` (purity, exact coverage, the window
budget, the displacement band, the ``epoch_rng`` pin),
``TestWorldCoverage`` (exactly once at worlds 1/2/3, the cross-world
merge, the restart watermark, a 2→3 world change, ``reset_partition``),
``TestPeerExchange`` (windows from a peer's ``/pages`` with their
accounting, a dead peer degrading to the wire),
``TestShuffleSurface::test_live_404_hint_then_rows``,
``TestPipelineLowering`` and ``TestElasticReshard``. Left out:
``TestShuffleSurface::test_render_shuffle_fabricated_view`` and
``::test_cmd_shuffle_exit_codes``, which drive ``scripts/obsctl.py``
(the analytic obs planes, not ported).

Then the cross-package checks, each to exact equality: the port's
``GlobalShuffle`` windows, orders and window orders against the
reference's over a seeded grid of sizes, seeds, window budgets and
epochs 0-2; ``build_record_index``'s offsets, sizes and digest on text,
RecordIO, dense RecordIO and indexed RecordIO; ``GlobalShuffleSplit``'s
record streams at worlds 1, 2 and 3; a global-shuffle ``Pipeline``'s
``RowBlock.content_hash()`` stream.

The ``plane`` fixture gives each test its own page stores (both
packages'), resets both peer tiers and ``/shuffle`` views, and pins
every object-store read option, retry policy and fault plan, restoring
them after, so no test depends on what an earlier test in the same
process left.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch.io.objstore import peer as peer_mod
from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR, PageStore
from dmlc_tpu_torch.io.recordio import (
    DenseRecordWriter, ImageRecordWriter, IndexedRecordIOWriter,
    RecordIOWriter,
)
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.obs.metrics import REGISTRY
from dmlc_tpu_torch.obs.serve import StatusServer
from dmlc_tpu_torch.resilience import inject, reset_policies
from dmlc_tpu_torch.shuffle import (
    GlobalShuffle, GlobalShuffleSplit, ShuffleReader, attach_rendezvous,
    build_record_index, displacement_stats, epoch_rng, install_view, view,
)
from dmlc_tpu_torch.shuffle import exchange as exchange_mod
from dmlc_tpu_torch.utils.logging import DMLCError

# the read options every test here runs under
PLANE_OPTIONS = {"block_bytes": 1 << 15, "coalesce": 2, "parallel": 2,
                 "hydrate": True, "peer": True, "codec_level": 0}


@pytest.fixture()
def plane(tmp_path, monkeypatch):
    """An isolated shuffle plane: private page stores (the port's and
    the reference's), no ambient peer tier, no installed /shuffle view,
    every object-store read option pinned; all restored after."""
    import dmlc_tpu.io.objstore.peer as ref_peer
    import dmlc_tpu.shuffle.exchange as ref_exchange
    import dmlc_tpu_torch.io.objstore.fs as ofs
    from dmlc_tpu.io.pagestore import ENV_STORE_DIR as REF_STORE_DIR
    monkeypatch.setenv(ENV_STORE_DIR, str(tmp_path / "store"))
    monkeypatch.setenv(REF_STORE_DIR, str(tmp_path / "ref-store"))
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT, "DMLC_TPU_SERVE_PORTS",
                 "DMLC_TPU_SERVE_PORT"):
        monkeypatch.delenv(name, raising=False)
    saved = dict(ofs.options())
    objstore.configure(None, **PLANE_OPTIONS)
    peer_mod.reset()
    ref_peer.reset()
    reset_policies()
    inject.uninstall()
    monkeypatch.setattr(exchange_mod, "_VIEW_REF", None)
    monkeypatch.setattr(ref_exchange, "_VIEW_REF", None)
    yield tmp_path
    objstore.configure(None, **{k: v for k, v in saved.items()
                                if k != "codec_level"})
    ofs._options["codec_level"] = saved["codec_level"]
    peer_mod.reset()
    ref_peer.reset()
    reset_policies()
    inject.uninstall()


# ------------------------------------------------------ corpus builders

def _lines(n):
    return [b"line-%05d " % i + b"x" * (i % 37) for i in range(n)]


def _payloads(n):
    return [b"payload-%05d-" % i + b"z" * (i % 53) for i in range(n)]


def make_text(tmp, n=400, name="data.txt"):
    path = str(tmp / name)
    with open(path, "wb") as f:
        f.write(b"\n".join(_lines(n)) + b"\n")
    return path


def make_recordio(tmp, n=400, name="data.rec"):
    path = str(tmp / name)
    with create_stream(path, "w") as s:
        w = RecordIOWriter(s)
        for p in _payloads(n):
            w.write_record(p)
    return path


def make_indexed(tmp, n=400, name="data2.rec"):
    path = str(tmp / name)
    with create_stream(path, "w") as s, \
            create_stream(path + ".idx", "w") as ixs:
        w = IndexedRecordIOWriter(s, ixs)
        for i, p in enumerate(_payloads(n)):
            w.write_record(p, i)
    return path


def make_dense(tmp, n=80, name="d.rec"):
    path = str(tmp / name)
    with create_stream(path, "w") as s:
        w = DenseRecordWriter(s)
        for i in range(n):
            w.write(float(i), np.arange(5, dtype=np.float32) + i)
    return path


def make_libsvm(tmp, n=600, name="train.libsvm"):
    path = str(tmp / name)
    rng = epoch_rng(0, 0)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{i % 2} 1:{rng.rand():.6f} 7:{i}\n")
    return path


# ------------------------------------------------------- the index plane

class TestRecordIndex:
    def test_text_index_matches_lines(self, plane):
        path = make_text(plane, 300)
        idx = build_record_index(path, "text")
        raw = open(path, "rb").read()
        assert idx.n == 300
        got = [raw[o:o + s] for o, s in zip(idx.offsets, idx.sizes)]
        assert got == _lines(300)

    def test_text_skips_empty_lines_and_crlf(self, plane):
        path = str(plane / "gaps.txt")
        with open(path, "wb") as f:
            f.write(b"alpha\r\n\n\nbeta\rgamma")  # no trailing newline
        idx = build_record_index(path, "text")
        raw = open(path, "rb").read()
        got = [raw[o:o + s] for o, s in zip(idx.offsets, idx.sizes)]
        assert got == [b"alpha", b"beta", b"gamma"]

    def test_recordio_index_tiles_the_file(self, plane):
        path = make_recordio(plane, 250)
        idx = build_record_index(path, "recordio")
        assert idx.n == 250
        assert int(idx.offsets[0]) == 0
        assert (idx.offsets[1:] == idx.offsets[:-1] + idx.sizes[:-1]).all()
        assert int(idx.offsets[-1] + idx.sizes[-1]) == \
            os.path.getsize(path)

    def test_dense_and_image_formats(self, plane):
        dense = make_dense(plane, 80)
        img = str(plane / "i.rec")
        with create_stream(img, "w") as s:
            w = ImageRecordWriter(s)
            for i in range(40):
                w.write(float(i), np.full((4, 3), i % 251, np.uint8))
        for path, st, n in ((dense, "recordio_dense", 80),
                            (img, "recordio_image", 40)):
            idx = build_record_index(path, st)
            assert idx.n == n
            assert int(idx.offsets[-1] + idx.sizes[-1]) == \
                os.path.getsize(path)

    def test_indexed_recordio_rides_its_idx(self, plane):
        path = make_indexed(plane, 120)
        idx = build_record_index(path, "indexed_recordio")
        assert idx.n == 120
        sp = GlobalShuffleSplit(path, 0, 1, "indexed_recordio", seed=1,
                                window_bytes=4096)
        assert sorted(sp) == sorted(_payloads(120))

    def test_sidecar_committed_once_and_reused(self, plane, monkeypatch):
        path = make_text(plane, 150)
        idx = build_record_index(path, "text")
        # a second build must come from the committed sidecar: scanning
        # again would be a cache miss — make the scanner explode
        from dmlc_tpu_torch.shuffle import index as index_mod

        def boom(*_a, **_k):
            raise AssertionError("sidecar miss: text rescan")

        monkeypatch.setattr(index_mod, "_scan_text", boom)
        idx2 = build_record_index(path, "text")
        assert (idx2.offsets == idx.offsets).all()
        assert (idx2.sizes == idx.sizes).all()
        assert idx2.fingerprint == idx.fingerprint

    def test_sidecar_rebuilt_when_source_changes(self, plane):
        path = make_text(plane, 50)
        idx = build_record_index(path, "text")
        assert idx.n == 50
        with open(path, "ab") as f:
            f.write(b"appended-line\n")
        os.utime(path, (1, 1))  # force a distinct mtime fingerprint
        idx2 = build_record_index(path, "text")
        assert idx2.n == 51

    def test_multifile_global_byte_space(self, plane):
        a = make_text(plane, 60, "a.txt")
        b = make_text(plane, 40, "b.txt")
        uri = a + ";" + b
        idx = build_record_index(uri, "text")
        assert idx.n == 100
        assert idx.total_bytes == (os.path.getsize(a)
                                   + os.path.getsize(b))
        # a span crossing the file boundary maps to two segments
        segs = list(idx.segments(os.path.getsize(a) - 10,
                                 os.path.getsize(a) + 10))
        assert [(os.path.basename(p), o, ln) for p, o, ln in segs] == \
            [("a.txt", os.path.getsize(a) - 10, 10), ("b.txt", 0, 10)]


# ---------------------------------------------------- the permutation

class TestGlobalShuffle:
    def test_pure_deterministic_exact_coverage(self):
        sizes = np.full(1000, 64)
        g1 = GlobalShuffle(sizes, seed=9, window_bytes=1 << 12)
        g2 = GlobalShuffle(sizes, seed=9, window_bytes=1 << 12)
        for epoch in (0, 1, 7):
            o1, o2 = g1.order(epoch), g2.order(epoch)
            assert (o1 == o2).all()  # pure in (seed, epoch)
            assert sorted(o1.tolist()) == list(range(1000))  # exact
        assert not (g1.order(0) == g1.order(1)).all()
        assert not (g1.order(0) == GlobalShuffle(
            sizes, seed=10, window_bytes=1 << 12).order(0)).all()

    def test_window_byte_budget_bounds_working_set(self):
        rng = epoch_rng(3, 0)
        sizes = rng.randint(10, 3000, size=500)
        budget = 8 << 10
        g = GlobalShuffle(sizes, seed=1, window_bytes=budget)
        for s, e in g.windows():
            if e - s > 1:  # single over-budget records ride alone
                assert int(sizes[s:e].sum()) <= budget
        # the order visits whole windows contiguously: one window of
        # bytes resident at a time
        order = g.order(2)
        spans = g.windows()
        wid_of = np.empty(len(sizes), np.int64)
        for w, (s, e) in enumerate(spans):
            wid_of[s:e] = w
        seen = []
        for w in wid_of[order]:
            if not seen or seen[-1] != w:
                seen.append(w)
        assert len(seen) == len(spans), "window revisited mid-epoch"

    def test_displacement_distribution_vs_uniform(self):
        n = 5000
        g = GlobalShuffle(np.full(n, 100), seed=4,
                          window_bytes=100 * 250)
        for epoch in range(3):
            st = displacement_stats(g.order(epoch))
            # uniform permutation ⇒ normalized mean ≈ 1.0; identity ⇒ 0;
            # a within-window-only shuffle would sit near 250/n ≈ 0.05
            assert 0.8 <= st["normalized_mean"] <= 1.2, st
        assert displacement_stats(np.arange(n))["normalized_mean"] == 0.0

    def test_epoch_rng_compat_pin(self):
        # epoch_rng is the frozen RandomState stream the io/ shuffles
        # draw from — pin its draws against direct construction
        assert (epoch_rng(11, 3).permutation(32)
                == np.random.RandomState(14).permutation(32)).all()


# -------------------------------------- coverage across world sizes

class TestWorldCoverage:
    def _rank_stream(self, path, rank, world, **kw):
        sp = GlobalShuffleSplit(path, rank, world, "recordio", seed=5,
                                window_bytes=4096, **kw)
        return list(sp)

    def test_exactly_once_at_worlds_1_2_3(self, plane):
        path = make_recordio(plane, 300)
        want = sorted(_payloads(300))
        for world in (1, 2, 3):
            streams = [self._rank_stream(path, r, world)
                       for r in range(world)]
            got = [rec for s in streams for rec in s]
            assert len(got) == 300, f"world {world}: duplicated/lost"
            assert sorted(got) == want, f"world {world}: coverage hole"

    def test_same_seed_byte_identity_across_worlds(self, plane):
        path = make_recordio(plane, 300)

        def merged(world):
            its = [iter(self._rank_stream(path, r, world))
                   for r in range(world)]
            out, p = [], 0
            while True:
                rec = next(its[p % world], None)
                if rec is None:
                    break
                out.append(rec)
                p += 1
            # round-robin by position: rank p%world owns position p
            return b"\x00".join(out)

        assert merged(1) == merged(2) == merged(3)

    def test_mid_epoch_restart_resume_identity(self, plane):
        path = make_recordio(plane, 300)
        a = GlobalShuffleSplit(path, 0, 2, "recordio", seed=5,
                               window_bytes=4096)
        a.before_first()
        head = [a.next_record() for _ in range(40)]
        watermark = a.reader.position
        # a fresh process resumes from the checkpointed watermark
        b = GlobalShuffleSplit(path, 0, 2, "recordio", seed=5,
                               window_bytes=4096,
                               start_position=watermark)
        b.before_first()
        assert list(iter(b.next_record, None)) == \
            list(iter(a.next_record, None))
        assert None not in head

    def test_world_change_2_to_3_keeps_exactness(self, plane):
        path = make_recordio(plane, 300)
        idx = build_record_index(path, "recordio")
        g = GlobalShuffle(idx.sizes, 5, window_bytes=4096)
        order = g.order(0)
        watermark = 101
        got = []
        # a 2-gang delivers positions < watermark...
        for rank in range(2):
            r = ShuffleReader(idx, 5, 4096, rank=rank, world=2)
            while r.position + ((rank - r.position) % 2) < watermark:
                got.append(r.next_record_span())
        # ...then a 3-gang (same seed) resumes from the watermark
        for rank in range(3):
            r = ShuffleReader(idx, 5, 4096, rank=rank, world=3,
                              start_position=watermark)
            got.extend(iter(r.next_record_span, None))
        raw = open(path, "rb").read()
        want = [raw[idx.offsets[k]:idx.offsets[k] + idx.sizes[k]]
                for k in order]
        assert sorted(got) == sorted(want)
        assert len(got) == 300  # exactly once despite the reshard

    def test_reset_partition_and_epoch_advance(self, plane):
        path = make_recordio(plane, 200)
        sp = GlobalShuffleSplit(path, 0, 1, "recordio", seed=2,
                                window_bytes=4096)
        e0 = list(sp)
        sp.before_first()
        e1 = list(iter(sp.next_record, None))
        assert e0 != e1 and sorted(e0) == sorted(e1)
        sp.reset_partition(1, 2)
        assert sp.reader.rank == 1 and sp.reader.world == 2
        assert sp.reader.position == 0


# --------------------------------------------- the peer exchange plane

class TestPeerExchange:
    def test_windows_served_from_peer_with_accounting(self, plane):
        path = make_recordio(plane, 400)
        store0 = PageStore.at(str(plane / "rank0-store"))
        store1 = PageStore.at(str(plane / "rank1-store"))
        idx = build_record_index(path, "recordio", store=store0)
        # rank 0 hydrates every window from the source
        r0 = ShuffleReader(idx, 7, 4096, rank=0, world=1, store=store0)
        n0 = sum(1 for _ in iter(r0.next_record_span, None))
        assert n0 == 400 and r0.bytes["wire"] > 0
        assert r0.bytes["peer"] == 0
        with StatusServer(pages_root=store0.root) as srv0, \
                StatusServer(pages_root=store1.root) as srv1:
            # this process plays rank 1: peers = [rank0, self]
            peer_mod.configure(ports=[srv0.port, srv1.port],
                               self_port=srv1.port)
            served0 = REGISTRY.counter("objstore.peer.served").value
            peer_b0 = REGISTRY.counter("shuffle.bytes.peer").value
            idx1 = build_record_index(path, "recordio", store=store1)
            r1 = ShuffleReader(idx1, 7, 4096, rank=0, world=1,
                               store=store1)
            got = list(iter(r1.next_record_span, None))
            assert len(got) == 400
            # even windows are rank0-owned → peer-fetched; odd windows
            # are self-owned → source wire
            assert r1.bytes["peer"] > 0 and r1.bytes["wire"] > 0
            assert r1.records["peer"] > 0
            assert r1.bytes["local"] == 0
            assert REGISTRY.counter("objstore.peer.served").value \
                > served0, "rank0's /pages never served"
            assert REGISTRY.counter("shuffle.bytes.peer").value \
                == peer_b0 + r1.bytes["peer"]
            # the exchange is visible on /metrics
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv1.port}/metrics",
                timeout=5).read().decode()
            assert "dmlc_shuffle_bytes_peer_total" in text
            # a second epoch replays entirely from the local store
            r1.next_epoch()
            wire_before = r1.bytes["wire"]
            peer_before = r1.bytes["peer"]
            assert len(list(iter(r1.next_record_span, None))) == 400
            assert r1.bytes["wire"] == wire_before
            assert r1.bytes["peer"] == peer_before
            assert r1.bytes["local"] > 0

    def test_peer_degrades_to_wire(self, plane):
        path = make_recordio(plane, 100)
        store = PageStore.at(str(plane / "solo-store"))
        idx = build_record_index(path, "recordio", store=store)
        # a tier whose peer is unreachable: fetch_entry returns None
        # and the reader falls back to the source, never raises
        peer_mod.configure(ports=[1, 2], self_port=2,
                           breaker_failures=1, timeout_s=0.1)
        r = ShuffleReader(idx, 1, 4096, rank=0, world=1, store=store)
        got = list(iter(r.next_record_span, None))
        assert len(got) == 100
        assert r.bytes["peer"] == 0 and r.bytes["wire"] > 0


# --------------------------------------------------- the /shuffle surface

def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class TestShuffleSurface:
    def test_live_404_hint_then_rows(self, plane):
        path = make_text(plane, 120)
        with StatusServer() as srv:
            code, doc = _get(srv.port, "/shuffle")
            assert code == 404
            assert "global_seed" in doc["hint"]
            sp = GlobalShuffleSplit(path, 0, 1, "text", seed=3,
                                    window_bytes=2048)
            head = [sp.next_record() for _ in range(10)]
            assert None not in head
            code, doc = _get(srv.port, "/shuffle")
            assert code == 200
            assert doc["seed"] == 3 and doc["records"] == 120
            assert doc["window_bytes"] == 2048
            assert doc["delivered"] == 10
            assert 0 < doc["coverage"] < 1
            tiers = doc["records_by_tier"]
            assert sum(tiers.values()) == 10
            # /shuffle is advertised to the lost
            code, doc = _get(srv.port, "/nope")
            assert "/shuffle" in doc["endpoints"]

    def test_view_is_weak_and_answers_as_the_reference(self, plane):
        """The port's ``/shuffle`` 404 has the reference's shape and
        error; a live reader's 200 has the reference's keys and values
        for the same reads; a collected reader drops back to 404."""
        import gc

        from dmlc_tpu.obs.serve import StatusServer as RefServer
        from dmlc_tpu.shuffle import GlobalShuffleSplit as RefSplit
        path = make_text(plane, 120)
        with StatusServer() as srv, RefServer() as ref:
            (c, d), (rc, rd) = _get(srv.port, "/shuffle"), \
                _get(ref.port, "/shuffle")
            assert c == rc == 404 and set(d) == set(rd) == \
                {"error", "hint"} and d["error"] == rd["error"]
            sp = GlobalShuffleSplit(path, 0, 2, "text", seed=4,
                                    window_bytes=1024)
            rsp = RefSplit(path, 0, 2, "text", seed=4, window_bytes=1024)
            assert [sp.next_record() for _ in range(7)] == \
                [rsp.next_record() for _ in range(7)]
            (c, d), (rc, rd) = _get(srv.port, "/shuffle"), \
                _get(ref.port, "/shuffle")
            assert c == rc == 200 and d == rd
            assert view() == d
            del sp
            gc.collect()
            assert view() is None
            assert _get(srv.port, "/shuffle")[0] == 404
            install_view(ShuffleReader(build_record_index(path, "text"),
                                       seed=1))
            assert view() is None  # held weakly: the temporary is gone


# ------------------------------------------------ pipeline + elastic

class TestPipelineLowering:
    def test_global_shuffle_lowers_and_covers(self, plane):
        from dmlc_tpu_torch.data.parser import Parser
        from dmlc_tpu_torch.pipeline import Pipeline
        path = make_libsvm(plane)

        def run():
            built = (Pipeline.from_uri(path)
                     .shuffle(global_seed=21, window_bytes=4096)
                     .parse(format="libsvm").build())
            rows = sum(b.size for b in built)
            # the split installs itself as the /shuffle view for as
            # long as it is alive (weakly referenced)
            assert view() is not None and view()["seed"] == 21
            built.close()
            return rows

        assert run() == run() == sum(
            b.size for b in Parser.create(path, 0, 1, format="libsvm"))

    def test_global_shuffle_native_engine_refused(self, plane):
        from dmlc_tpu_torch.pipeline import Pipeline
        path = make_text(plane, 10)
        with pytest.raises(DMLCError, match="python parse engine"):
            (Pipeline.from_uri(path).shuffle(global_seed=1)
             .parse(format="libsvm", engine="native").build())

    def test_window_bytes_requires_global_seed(self):
        from dmlc_tpu_torch.pipeline import Pipeline
        with pytest.raises(DMLCError, match="global_seed"):
            Pipeline.from_uri("x").shuffle(window_bytes=1 << 20)


class TestElasticReshard:
    def test_attach_rendezvous_reshards_on_epoch(self, plane):
        path = make_recordio(plane, 60)
        idx = build_record_index(path, "recordio")
        r = ShuffleReader(idx, 2, 4096, rank=0, world=2)

        class FakeClient:
            def __init__(self):
                self.cbs = []

            def on_change(self, fn):
                self.cbs.append(fn)

        c = FakeClient()
        attach_rendezvous(r, c)
        assert len(c.cbs) == 1
        c.cbs[0]({"rank": 2, "world": 3, "epoch": 4})
        assert r.rank == 2 and r.world == 3
        # torn views are ignored, never raise
        c.cbs[0]({"rank": None, "world": 0})
        c.cbs[0]({})
        assert r.rank == 2 and r.world == 3


# ------------------------------------------------ against the reference

_GRID = [(n, seed, wb, kind)
         for n, seed, wb, kind in (
             (1, 0, 1, "flat"), (37, 1, 100, "flat"),
             (500, 2, 4096, "mixed"), (1000, 3, 1 << 12, "flat"),
             (2500, 7, 64 << 10, "mixed"), (4000, 23, 2 << 20, "mixed"),
             (333, 11, 5000, "big"), (0, 5, 1024, "flat"))]


@pytest.mark.parametrize("n,seed,window_bytes,kind", _GRID)
def test_permutation_matches_reference(n, seed, window_bytes, kind):
    from dmlc_tpu.shuffle import GlobalShuffle as RefShuffle
    from dmlc_tpu.shuffle import displacement_stats as ref_disp
    rng = np.random.RandomState(seed + n)
    sizes = {"flat": np.full(n, 64),
             "mixed": rng.randint(10, 3000, size=n),
             "big": rng.randint(1000, 9000, size=n)}[kind]
    port = GlobalShuffle(sizes, seed=seed, window_bytes=window_bytes)
    ref = RefShuffle(sizes, seed=seed, window_bytes=window_bytes)
    assert port.windows() == ref.windows()
    assert port.num_windows == ref.num_windows and port.n == ref.n
    for epoch in range(3):
        o = port.order(epoch)
        assert o.dtype == np.int64
        assert np.array_equal(o, ref.order(epoch))
        assert np.array_equal(port.epoch_window_order(epoch),
                              ref.epoch_window_order(epoch))
        assert displacement_stats(o) == ref_disp(ref.order(epoch))
    for k in range(0, n, max(1, n // 13)):
        assert port.window_of(k) == ref.window_of(k)


@pytest.mark.parametrize("split_type", ["text", "recordio",
                                        "recordio_dense",
                                        "indexed_recordio"])
def test_record_index_matches_reference(plane, split_type):
    from dmlc_tpu.shuffle import build_record_index as ref_build
    path = {"text": lambda: make_text(plane, 300) + ";"
            + make_text(plane, 50, "b.txt"),
            "recordio": lambda: make_recordio(plane, 250),
            "recordio_dense": lambda: make_dense(plane, 80),
            "indexed_recordio": lambda: make_indexed(plane, 120)}[
                split_type]()
    got = build_record_index(path, split_type)
    want = ref_build(path, split_type)
    assert got.n == want.n > 0
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.sizes, want.sizes)
    assert got.digest == want.digest
    assert got.files == want.files and got.total_bytes == want.total_bytes
    # the sidecars are the same bytes (fingerprint aside)
    assert got.to_bytes() == want.to_bytes()
    again = build_record_index(path, split_type)  # from the sidecar
    assert np.array_equal(again.offsets, want.offsets)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("split_type", ["text", "recordio"])
def test_split_streams_match_reference(plane, world, split_type):
    """Each rank's record stream of the port's ``GlobalShuffleSplit``
    over two epochs equals the reference's, record for record."""
    from dmlc_tpu.shuffle import GlobalShuffleSplit as RefSplit
    path = (make_text(plane, 400) if split_type == "text"
            else make_recordio(plane, 400))
    for rank in range(world):
        sp = GlobalShuffleSplit(path, rank, world, split_type, seed=13,
                                window_bytes=3000)
        ref = RefSplit(path, rank, world, split_type, seed=13,
                       window_bytes=3000)
        for _ in range(2):
            got = list(sp)
            assert got and got == list(ref)
        assert sp.reader.view_dict() == ref.reader.view_dict()


@pytest.mark.parametrize("parts", [1, 2])
def test_pipeline_blocks_match_reference(plane, parts):
    """A global-shuffle ``Pipeline`` of the port yields the reference
    ``Pipeline``'s RowBlocks, by ``content_hash()``, epoch by epoch and
    part by part."""
    from dmlc_tpu.pipeline import Pipeline as RefPipeline
    from dmlc_tpu_torch.pipeline import Pipeline
    path = make_libsvm(plane, 3000)

    def hashes(cls, part):
        with (cls.from_uri(path, part_index=part, num_parts=parts)
              .shuffle(global_seed=8, window_bytes=8192)
              .parse(format="libsvm", chunk_size=4096).build()) as built:
            return [[b.content_hash() for b in built] for _ in range(2)]

    for part in range(parts):
        got = hashes(Pipeline, part)
        assert len(got[0]) > 1 and got[0] != got[1]
        assert got == hashes(RefPipeline, part)
