"""The port's gang data plane (``dmlc_tpu_torch/obs/serve.py``'s
``/pages``, ``dmlc_tpu_torch/io/objstore/peer.py``, singleflight in
``io/objstore/fs.py``) held to the reference's ``tests/test_peer.py``.

The reference's classes run here against the port: the ``/pages``
endpoint, a slow transfer beside ``/healthz``, singleflight dedup, the
peer tier (peer ahead of the wire, ``peer=False``, chaos degrading to
the wire, a stale page refetched, a dead peer's breaker, the env
contract), the store-dir env and the two-rank gang acceptance.
``TestPeerTelemetrySurfaces`` (``obs.analyze`` and ``obsctl``) is left
out: the port has neither plane.

Then the cross-package checks: the port's and the reference's
``StatusServer`` over one committed entry answer the same ``/pages``
requests with the same status, headers and bytes; the port's
``PeerTier`` reads a block from the reference's server byte for byte.

Every process-wide read option is pinned by the ``plane`` fixture and
restored after, so no test here depends on what an earlier test in the
same process left (``TestOrdering`` runs the RPC tests and then these in
one process to prove it). Payloads come from seeded numpy generators;
every wait is bounded.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch.io.objstore import peer as peer_mod
from dmlc_tpu_torch.io.pagestore import ENV_STORE_DIR, PageStore
from dmlc_tpu_torch.io.stream import create_seek_stream_for_read
from dmlc_tpu_torch.obs.metrics import REGISTRY
from dmlc_tpu_torch.obs.serve import StatusServer
from dmlc_tpu_torch.resilience import (
    RetryPolicy, inject, reset_policies, set_policy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counter(name):
    return REGISTRY.counter(name).value


def _noop_sleep(_s):
    pass


def _get(url, headers=None, timeout=10.0):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), dict(r.headers.items())


def _payload(rows=6000, seed=0):
    rng = np.random.RandomState(seed)
    return b"".join(b"%d %d:%.4f %d:%.4f\n"
                    % (i % 2, rng.randint(0, 40), rng.rand(),
                       40 + rng.randint(0, 40), rng.rand())
                    for i in range(rows))


# the read options every test here runs under (the reference's plane
# fixture sets the first three and inherits the rest from the process)
PLANE_OPTIONS = {"block_bytes": 1 << 15, "coalesce": 2, "parallel": 2,
                 "hydrate": True, "peer": True, "codec_level": 0}


@pytest.fixture
def plane(tmp_path, monkeypatch):
    """An isolated objstore plane: fresh emulator, per-test LOCAL page
    store root (via the page-store dir env), small blocks, every read
    option pinned, peer tier reset on both sides; options, policies and
    fault plans restored after."""
    import dmlc_tpu_torch.io.objstore.fs as ofs
    monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
    monkeypatch.delenv("DMLC_TPU_SERVE_PORTS", raising=False)
    monkeypatch.delenv("DMLC_TPU_SERVE_PORT", raising=False)
    monkeypatch.setenv(ENV_STORE_DIR, str(tmp_path / "local-store"))
    saved = dict(ofs.options())
    client = objstore.configure(root=str(tmp_path / "objroot"),
                                **PLANE_OPTIONS)
    peer_mod.reset()
    yield client, tmp_path
    objstore.configure(None, **{k: v for k, v in saved.items()
                                if k != "codec_level"})
    ofs._options["codec_level"] = saved["codec_level"]
    peer_mod.reset()
    inject.uninstall()
    reset_policies()


def _hydrate_into(root, uri, payload_len):
    """Fill the page store at ``root`` by streaming the object with
    that store (the 'peer rank already read this' state)."""
    store = PageStore.at(str(root))
    s = create_seek_stream_for_read(uri)
    s._store = store  # this stream hydrates the PEER's store
    s._peer = None
    out = s.read_all()
    s.close()
    assert len(out) == payload_len
    return store


def _entries(store):
    return sorted(n for n in os.listdir(store.root) if n.endswith(".pages"))


# ------------------------------------------------------ /pages endpoint

class TestPagesEndpoint:
    def test_serves_committed_entry_with_headers(self, plane):
        em, tmp = plane
        em.put("b", "x.bin", b"E" * 50000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/x.bin", 50000)
        entries = _entries(store)
        assert entries
        served0 = _counter("objstore.peer.served")
        with StatusServer(pages_root=store.root) as srv:
            status, body, headers = _get(srv.url(f"/pages/{entries[0]}"))
            assert status == 200
            stamp = store.stamp(entries[0])
            assert json.loads(headers["X-Dmlc-Fingerprint"]) == \
                stamp["fingerprint"]
            assert headers["X-Dmlc-Codec"] == stamp.get("codec", "raw")
            # the stored bytes verbatim (here: raw codec level 0)
            assert body == (b"E" * 50000)[:1 << 15]
            # ranged read of the STORED entry bytes
            status, part, headers = _get(
                srv.url(f"/pages/{entries[0]}"),
                headers={"Range": "bytes=10-19"})
            assert status == 206 and part == body[10:20]
            assert headers["Content-Range"] == f"bytes 10-19/{len(body)}"
        assert _counter("objstore.peer.served") >= served0 + 2

    def test_unknown_and_unsafe_names_404(self, plane):
        em, tmp = plane
        (tmp / "peer-store").mkdir()
        with StatusServer(pages_root=str(tmp / "peer-store")) as srv:
            for name in ("ghost.pages", "..%2Fescape", ".hidden",
                         "a%5Cb.pages"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(srv.url(f"/pages/{name}"))
                assert e.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url("/pages/"))
            assert e.value.code == 404

    def test_uncommitted_bare_file_not_served(self, plane):
        """A file without a committed sidecar stamp (a tmp, an alien
        file) is never handed to a peer."""
        em, tmp = plane
        root = tmp / "peer-store"
        root.mkdir()
        (root / "bare.pages").write_bytes(b"x" * 100)
        with StatusServer(pages_root=str(root)) as srv:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url("/pages/bare.pages"))
            assert e.value.code == 404

    def test_stale_fingerprint_rejected_serverside(self, plane):
        """The object changed under the hydrated page: the server
        re-stats the stamped fingerprint and answers 404 — a peer can
        degrade to the wire, it must never serve a stale page."""
        em, tmp = plane
        em.put("b", "st.bin", b"A" * 40000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/st.bin", 40000)
        entries = _entries(store)
        em.put("b", "st.bin", b"A" * 40001)  # size change = stale
        with StatusServer(pages_root=store.root) as srv:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url(f"/pages/{entries[0]}"))
            assert e.value.code == 404
            assert b"stale" in e.value.read()

    def test_freshness_verdict_cached_across_requests(self, plane):
        """Serving the same entry repeatedly within the TTL re-stats
        the origin ONCE — the per-block HEAD must not erode the 1/N
        wire saving the tier delivers."""
        em, tmp = plane
        em.put("b", "ttl.bin", b"T" * 30000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/ttl.bin", 30000)
        entry = _entries(store)[0]
        with StatusServer(pages_root=store.root) as srv:
            em.reset_counters()
            for _ in range(4):
                status, _, _ = _get(srv.url(f"/pages/{entry}"))
                assert status == 200
            assert em.counters()["heads"] <= 1, \
                "every /pages serve re-statted the origin"

    def test_freshness_cache_is_per_server(self, plane):
        """A second server over the same entry judges freshness itself:
        the cache belongs to the server, not to the module (the
        reference keys one module-wide cache across servers)."""
        em, tmp = plane
        em.put("b", "ps.bin", b"P" * 30000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/ps.bin", 30000)
        entry = _entries(store)[0]
        em.reset_counters()
        for _ in range(2):
            with StatusServer(pages_root=store.root) as srv:
                status, _, _ = _get(srv.url(f"/pages/{entry}"))
                assert status == 200
        assert em.counters()["heads"] == 2

    def test_bad_range_416(self, plane):
        em, tmp = plane
        em.put("b", "r.bin", b"R" * 1000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/r.bin", 1000)
        entry = _entries(store)[0]
        with StatusServer(pages_root=store.root) as srv:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url(f"/pages/{entry}"),
                     headers={"Range": "bytes=5000-"})
            assert e.value.code == 416

    def test_pin_held_for_the_transfer_only(self, plane):
        """The entry is pinned (refcounted) while its body is sent, so
        eviction cannot pull it mid-transfer, and unpinned after."""
        em, tmp = plane
        em.put("b", "pin.bin", b"N" * 20000)
        store = _hydrate_into(tmp / "peer-store", "obj://b/pin.bin", 20000)
        entry = _entries(store)[0]
        seen = []
        real_open = store.open_read

        def spy(name):
            seen.append(store._is_pinned(store.path(name)))
            return real_open(name)

        store.open_read = spy
        with StatusServer(pages_root=store.root) as srv:
            assert _get(srv.url(f"/pages/{entry}"))[0] == 200
        assert seen == [True]
        assert not store._is_pinned(store.path(entry))


class TestConcurrentScrape:
    def test_slow_pages_transfer_does_not_starve_healthz(self, plane):
        """A /pages body transfer stuck behind a non-reading client runs
        on its own handler thread; /healthz and /metrics stay live
        meanwhile."""
        em, tmp = plane
        root = tmp / "peer-store"
        store = PageStore.at(str(root))
        w = store.writer("big.pages", fingerprint=None,
                         meta={"codec": "raw"})
        w.write(np.random.default_rng(5).integers(
            0, 256, 8 << 20, dtype=np.uint8).tobytes())
        w.commit()
        with StatusServer(pages_root=str(root)) as srv:
            sock = socket.create_connection(("127.0.0.1", srv.port),
                                            timeout=10)
            try:
                sock.sendall(b"GET /pages/big.pages HTTP/1.1\r\n"
                             b"Host: localhost\r\n\r\n")
                first = sock.recv(1024)  # headers arrived; body huge
                assert b"200" in first.split(b"\r\n", 1)[0]
                t0 = time.perf_counter()
                status, body, _ = _get(srv.url("/healthz"), timeout=5)
                dt = time.perf_counter() - t0
                assert status == 200 and json.loads(body)["ok"]
                assert dt < 5.0
                status, _, _ = _get(srv.url("/metrics"), timeout=5)
                assert status == 200
            finally:
                sock.close()


# --------------------------------------------------------- singleflight

class TestSingleflight:
    def test_concurrent_cold_readers_dedup_onto_one_fetch(self, plane):
        """Two threads cold-read the same object at once: singleflight
        elects one leader per hydration group, the follower reads the
        committed page — the emulator sees less than two streams' worth
        of GET bytes."""
        em, tmp = plane
        em.latency_s = 0.002  # a leader fetch takes real time, so the
        # second thread reliably arrives while it is in flight
        payload = _payload(rows=20000)
        em.put("b", "sf.bin", payload)
        em.reset_counters()
        dedup0 = _counter("pagestore.singleflight.dedup")
        barrier = threading.Barrier(2)
        results = [None, None]

        def read(ix):
            s = create_seek_stream_for_read("obj://b/sf.bin")
            barrier.wait()
            results[ix] = s.read_all()
            s.close()

        threads = [threading.Thread(target=read, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results[0] == payload and results[1] == payload
        assert _counter("pagestore.singleflight.dedup") > dedup0
        assert em.counters()["get_bytes"] < 2 * len(payload)

    def test_follower_whose_block_missed_fetches_itself(self, plane):
        """A follower that waited but finds no committed page (the
        leader's span stopped short) fetches on its own — dedup is an
        optimization, never a correctness dependency."""
        em, tmp = plane
        em.put("b", "solo.bin", b"Q" * 100000)
        s = create_seek_stream_for_read("obj://b/solo.bin")
        import dmlc_tpu_torch.io.objstore.fs as ofs
        key = (s._entry_prefix, s._bb, 0)
        assert ofs._SINGLEFLIGHT.lead(key)  # occupy the leader slot
        try:
            done = threading.Event()
            out = []

            def follower():
                out.append(s.read(10))
                done.set()

            th = threading.Thread(target=follower)
            th.start()
            time.sleep(0.1)
            assert not done.is_set()  # follower parked behind leader
        finally:
            ofs._SINGLEFLIGHT.done(key)
        th.join(timeout=30)
        assert out == [b"Q" * 10]
        s.close()


# ------------------------------------------------------- the peer tier

class TestPeerTier:
    def _peer_server(self, em, tmp, uri, size):
        store = _hydrate_into(tmp / "peer-store", uri, size)
        srv = StatusServer(pages_root=store.root)
        return store, srv

    def test_blocks_served_from_peer_not_wire(self, plane):
        em, tmp = plane
        payload = _payload(rows=12000)
        em.put("b", "p.bin", payload)
        store, srv = self._peer_server(em, tmp, "obj://b/p.bin",
                                       len(payload))
        try:
            peer_mod.configure(ports=[srv.port])
            g0, pg0 = _counter("objstore.get"), \
                _counter("objstore.peer.get")
            em.reset_counters()
            s = create_seek_stream_for_read("obj://b/p.bin")
            assert s.read_all() == payload
            s.close()
            assert em.counters()["gets"] == 0, \
                "peer-owned blocks must not touch the wire"
            assert _counter("objstore.peer.get") > pg0
            assert _counter("objstore.get") == g0
            # and the peer-fetched blocks hydrated LOCALLY: a second
            # epoch is free of both the wire AND the peer
            pg1 = _counter("objstore.peer.get")
            s = create_seek_stream_for_read("obj://b/p.bin")
            assert s.read_all() == payload
            s.close()
            assert em.counters()["gets"] == 0
            assert _counter("objstore.peer.get") == pg1
        finally:
            srv.close()

    def test_peer_off_option_skips_tier(self, plane):
        em, tmp = plane
        payload = b"n" * 80000
        em.put("b", "off.bin", payload)
        store, srv = self._peer_server(em, tmp, "obj://b/off.bin",
                                       len(payload))
        try:
            peer_mod.configure(ports=[srv.port])
            objstore.configure(peer=False)
            em.reset_counters()
            s = create_seek_stream_for_read("obj://b/off.bin")
            assert s.read_all() == payload
            s.close()
            assert em.counters()["gets"] > 0  # straight to the wire
        finally:
            objstore.configure(peer=True)
            srv.close()

    @pytest.mark.parametrize("fault", ["ioerror", "truncate"])
    def test_chaos_degrades_to_wire_byte_identical(self, plane, fault):
        em, tmp = plane
        payload = _payload(rows=9000)
        em.put("b", "ch.bin", payload)
        store, srv = self._peer_server(em, tmp, "obj://b/ch.bin",
                                       len(payload))
        try:
            peer_mod.configure(ports=[srv.port])
            set_policy("io.objstore.peer",
                       RetryPolicy(max_attempts=2, sleep=_noop_sleep))
            inject.install(f"site=io.objstore.peer,fault={fault}")
            m0 = _counter("objstore.peer.miss")
            em.reset_counters()
            s = create_seek_stream_for_read("obj://b/ch.bin")
            assert s.read_all() == payload, \
                "chaos at the peer tier corrupted the stream"
            s.close()
            assert em.counters()["gets"] > 0, "wire fallback missing"
            assert _counter("objstore.peer.miss") > m0
        finally:
            srv.close()

    def test_stale_peer_page_rejected_and_refetched(self, plane):
        """A peer serving a page whose stamp does NOT match this
        reader's fingerprint (an unstamped commit the server cannot
        judge) is rejected CLIENT-side and the block refetched from the
        wire — byte-identical, never the stale bytes."""
        em, tmp = plane
        payload = b"G" * 90000
        em.put("b", "stale.bin", payload)
        store, srv = self._peer_server(em, tmp, "obj://b/stale.bin",
                                       len(payload))
        for name in _entries(store):
            store._stamp_entry(name, {"fingerprint": None, "codec": "raw"})
        try:
            peer_mod.configure(ports=[srv.port])
            set_policy("io.objstore.peer",
                       RetryPolicy(max_attempts=2, sleep=_noop_sleep))
            served0 = _counter("objstore.peer.served")
            g0 = _counter("objstore.peer.get")
            em.reset_counters()
            s = create_seek_stream_for_read("obj://b/stale.bin")
            assert s.read_all() == payload
            s.close()
            assert em.counters()["gets"] > 0, "wire refetch missing"
            assert _counter("objstore.peer.served") > served0, \
                "server never served (test exercised nothing)"
            assert _counter("objstore.peer.get") == g0, \
                "client accepted a stale-stamped peer page"
        finally:
            srv.close()

    def test_dead_peer_breaker_bounds_probes_no_hang(self, plane):
        em, tmp = plane
        payload = b"D" * 200000  # several groups
        em.put("b", "dead.bin", payload)
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        dead_port = sock.getsockname()[1]
        sock.close()
        peer_mod.configure(ports=[dead_port], breaker_failures=2,
                           breaker_snooze_s=60.0)
        set_policy("io.objstore.peer",
                   RetryPolicy(max_attempts=2, sleep=_noop_sleep))
        t0 = time.perf_counter()
        s = create_seek_stream_for_read("obj://b/dead.bin")
        assert s.read_all() == payload
        s.close()
        assert time.perf_counter() - t0 < 30.0, "dead peer ~= hang"
        tier = peer_mod.tier()
        assert tier is not None and not tier.available(0), \
            "breaker never opened on a dead peer"

    def test_tier_env_contract(self, plane, monkeypatch):
        em, tmp = plane
        monkeypatch.setenv("DMLC_TPU_SERVE_PORTS", "7001,7002,7003")
        monkeypatch.setenv("DMLC_TPU_SERVE_PORT", "7002")
        peer_mod.reset()
        t = peer_mod.tier()
        assert t is not None and t.world == 3 and t.self_index == 1
        assert t.remote_count == 2
        assert t.owner_index(0) == 0
        assert t.owner_index(1) is None
        assert t.owner_index(2) == 2
        peer_mod.reset()
        monkeypatch.setenv("DMLC_TPU_SERVE_PORTS", "7001")
        assert peer_mod.tier() is None  # a gang of one has no peers
        peer_mod.reset()
        monkeypatch.setenv("DMLC_TPU_SERVE_PORTS", "9100,910x")
        assert peer_mod.tier() is None
        assert peer_mod.tier() is None  # and stays consistent

    def test_self_owned_span_never_prefetches_a_peer_group(self, plane):
        """With this process rank 0 of 2 and the peer unreachable, a
        self-owned group's wire span stops at the group's end: the first
        read GETs exactly one group's bytes."""
        em, tmp = plane
        payload = b"S" * (8 << 15)  # 8 blocks, 4 groups of 2
        em.put("b", "own.bin", payload)
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        ports = [12345, sock.getsockname()[1]]
        sock.close()
        peer_mod.configure(ports=ports, self_port=12345)
        em.reset_counters()
        s = create_seek_stream_for_read("obj://b/own.bin")
        assert s.read(10) == b"S" * 10
        assert em.counters()["get_bytes"] == 2 << 15
        s.close()


class TestStoreDirEnv:
    def test_default_store_dir_honors_env(self, monkeypatch, tmp_path):
        from dmlc_tpu_torch.io import pagestore
        monkeypatch.setenv(ENV_STORE_DIR, str(tmp_path / "mine"))
        assert pagestore.default_store_dir() == str(tmp_path / "mine")
        monkeypatch.delenv(ENV_STORE_DIR)
        assert pagestore.default_store_dir().endswith(
            "dmlc_tpu_torch_spill")


# ------------------------------------------------- THE gang acceptance

class TestGangAcceptance:
    def test_two_rank_gang_splits_wire_and_goes_warm(self, tmp_path):
        """A REAL 2-process gang over one obj:// object (the port's
        ``bench_peer_worker.py``): cold epoch wire bytes at most 0.60 of
        the object per rank, both peer counters live, warm epoch
        zero-GET and zero-peer everywhere, every stream sha256-identical
        to the local bytes, the gang total 0.9-1.2x the object."""
        import hashlib

        from dmlc_tpu_torch.parallel.launch import launch_local

        payload = _payload(rows=30000)  # ~1 MB
        objroot = tmp_path / "objroot"
        em = objstore.configure(root=str(objroot))
        try:
            em.put("bench", "gang.libsvm", payload)
        finally:
            objstore.configure(None)
        local_hash = hashlib.sha256(payload).hexdigest()
        worker = os.path.join(REPO, "dmlc_tpu_torch", "bench_peer_worker.py")
        out_dir = tmp_path / "gang"
        out_dir.mkdir()
        env = {"DMLC_TPU_OBJSTORE_ROOT": str(objroot),
               "PYTHONPATH": os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p])}
        codes = launch_local(
            2, [sys.executable, worker, "obj://bench/gang.libsvm",
                str(out_dir), str(1 << 16), "2"],
            env=env, serve_ports=True, timeout=180)
        assert codes == [0, 0]
        results = []
        for rank in range(2):
            with open(out_dir / f"peer-{rank}.json") as f:
                results.append(json.load(f))
        size = len(payload)
        for r in results:
            assert r["cold"]["sha256"] == local_hash
            assert r["warm"]["sha256"] == local_hash
            assert r["warm"]["counters"]["objstore.get"] == 0, \
                f"rank {r['rank']} warm epoch hit the wire"
            assert r["warm"]["counters"]["objstore.peer.get"] == 0, \
                f"rank {r['rank']} warm epoch hit the peer"
            assert r["cold"]["counters"]["objstore.peer.bytes"] > 0
            wired = r["cold"]["counters"]["objstore.bytes"]
            assert wired <= 0.60 * size, \
                (f"rank {r['rank']} moved {wired}/{size} wire bytes —"
                 " the peer tier did not carry its half")
        total = sum(r["cold"]["counters"]["objstore.bytes"]
                    for r in results)
        assert 0.9 * size <= total <= 1.2 * size, \
            f"gang total wire bytes {total} vs corpus {size}"


# ------------------------------------------------ cross-package checks

# the response headers both servers must agree on (Server and Date name
# the Python build and the second)
PAGE_HEADERS = ("Content-Type", "Content-Length", "Content-Range",
                "X-Dmlc-Fingerprint", "X-Dmlc-Codec")


def _answer(url, headers=None):
    """(status, selected headers, body) of one GET, errors included."""
    try:
        status, body, hdrs = _get(url, headers=headers)
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), dict(e.headers.items())
    return status, {k: hdrs.get(k) for k in PAGE_HEADERS}, body


@pytest.fixture
def both_planes(plane):
    """The reference's objstore configured onto the same emulator root
    as the port's, so both packages' servers can judge an entry's
    freshness against the same objects."""
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu.io.objstore.fs as ref_ofs
    em, tmp = plane
    saved = dict(ref_ofs.options())
    ref_em = ref_objstore.configure(root=em.root)
    yield em, ref_em, tmp
    ref_objstore.configure(None, block_bytes=saved["block_bytes"],
                           coalesce=saved["coalesce"],
                           parallel=saved["parallel"],
                           hydrate=saved["hydrate"],
                           peer=saved.get("peer", True))
    ref_ofs._options["codec_level"] = saved["codec_level"]


class TestCrossPackage:
    def test_pages_answers_equal_the_references(self, both_planes):
        """One committed entry, the port's and the reference's
        StatusServer over it: full, ranged, unsatisfiable, unsafe and
        missing requests, then the same after the object changed
        (stale fingerprint), answer with equal status, headers and
        bytes."""
        from dmlc_tpu.obs.serve import StatusServer as RefStatusServer
        em, ref_em, tmp = both_planes
        payload = _payload(rows=4000, seed=3)
        em.put("b", "xp.bin", payload)
        store = _hydrate_into(tmp / "peer-store", "obj://b/xp.bin",
                              len(payload))
        entry = _entries(store)[0]
        requests = [(f"/pages/{entry}", None),
                    (f"/pages/{entry}", {"Range": "bytes=100-4195"}),
                    (f"/pages/{entry}", {"Range": "bytes=7-"}),
                    (f"/pages/{entry}", {"Range": "bytes=99999999-"}),
                    ("/pages/..%2Fescape", None),
                    ("/pages/.hidden", None),
                    ("/pages/ghost.pages", None)]
        answers = {}
        for pkg, cls in (("port", StatusServer),
                         ("reference", RefStatusServer)):
            with cls(pages_root=store.root) as srv:
                answers[pkg] = [_answer(srv.url(p), h) for p, h in requests]
        assert answers["port"] == answers["reference"]
        assert [a[0] for a in answers["port"]] == \
            [200, 206, 206, 416, 404, 404, 404]
        assert answers["port"][0][2] == payload[:1 << 15]
        # the object changes under the page: both answer the same 404
        # (the reference's freshness cache is module-wide, so its
        # verdict from the servers above would stand for its TTL)
        sys.modules["dmlc_tpu.obs.serve"]._page_fresh_cache.clear()
        em.put("b", "xp.bin", payload + b"x")
        stale = {}
        for pkg, cls in (("port", StatusServer),
                         ("reference", RefStatusServer)):
            with cls(pages_root=store.root) as srv:
                stale[pkg] = _answer(srv.url(f"/pages/{entry}"))
        assert stale["port"] == stale["reference"]
        assert stale["port"][0] == 404 and b"stale" in stale["port"][2]

    def test_port_tier_reads_from_the_reference_server(self, both_planes):
        """The port's PeerTier fetches every block of an object from the
        reference's StatusServer over a hydrated store: byte for byte,
        and a port stream whose groups the reference server owns reads
        the object with no GET."""
        from dmlc_tpu.obs.serve import StatusServer as RefStatusServer
        em, ref_em, tmp = both_planes
        payload = _payload(rows=9000, seed=4)
        em.put("b", "rt.bin", payload)
        store = _hydrate_into(tmp / "peer-store", "obj://b/rt.bin",
                              len(payload))
        s = create_seek_stream_for_read("obj://b/rt.bin")
        with RefStatusServer(pages_root=store.root) as srv:
            tier = peer_mod.PeerTier([srv.port])
            got = b"".join(
                tier.fetch_entry(0, s._entry(i), s._fingerprint,
                                 s._expected(i))
                for i in range(s._nblocks()))
            assert got == payload
            peer_mod.configure(ports=[srv.port])
            em.reset_counters()
            s2 = create_seek_stream_for_read("obj://b/rt.bin")
            assert s2.read_all() == payload
            s2.close()
            assert em.counters()["gets"] == 0
        s.close()


# ------------------------------------------------------------ ordering

class TestOrdering:
    def test_rpc_then_peer_cases_in_one_process(self):
        """The reference's singleflight and peer-tier cases fail after
        its ``tests/test_rpc.py`` in one process (a case there leaves
        the process-wide ``hydrate=False`` option behind, and the peer
        fixture does not pin it). The port's RPC tests, then its
        singleflight, peer-tier and /pages cases, run in ONE process
        here and all pass."""
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
               "-p", "no:cacheprovider", "-p", "no:randomly",
               "tests/test_torch_rpc.py",
               "tests/test_torch_peer.py::TestSingleflight",
               "tests/test_torch_peer.py::TestPeerTier",
               "tests/test_torch_peer.py::TestPagesEndpoint"]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                              text=True, timeout=300,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        tail = proc.stdout[-3000:] + proc.stderr[-2000:]
        assert proc.returncode == 0, tail
        assert " failed" not in proc.stdout, tail
