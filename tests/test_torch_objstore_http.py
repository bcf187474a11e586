"""The port's real HTTP ranged-GET client
(``dmlc_tpu_torch/io/objstore/http_client.py``) against
``tests/objstore_http_server.py`` (stdlib only; it delegates storage and
request counters to an inner emulator, here the port's), as the
reference's ``tests/test_objstore_http.py`` holds the reference's: the
auth-header hook, Range dialect corner cases, torn-transfer detection,
the dtpc transfer coding, the listing convention, the endpoint env
contract, and import-optionality (in a subprocess). Plus: the
reference's client and the port's, over one endpoint, send the same
requests and read the same bytes."""

import os
import subprocess
import sys

import pytest

import dmlc_tpu_torch.io.objstore as objstore
from dmlc_tpu_torch.io.codec import decode_page, is_encoded
from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
from dmlc_tpu_torch.io.objstore.http_client import (
    HttpObjectStoreClient, RemoteObjectInfo,
)
from dmlc_tpu_torch.utils.logging import DMLCError
from objstore_http_server import ObjstoreHttpServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def srv(tmp_path):
    inner = EmulatedObjectStore(str(tmp_path / "root"))
    server = ObjstoreHttpServer(inner)
    yield server
    server.close()


class TestAuthHook:
    def test_static_headers_and_callable(self, srv):
        c0 = HttpObjectStoreClient(srv.endpoint)
        c0.put("b", "a.bin", b"payload")
        srv.require_headers = {"Authorization": "Bearer tok"}
        with pytest.raises(IOError, match="HTTP 403"):
            c0.get("b", "a.bin", 0, 3)
        static = HttpObjectStoreClient(
            srv.endpoint, auth={"Authorization": "Bearer tok"})
        assert static.get("b", "a.bin", 0, 3) == b"pay"
        calls = []

        def rotating():
            calls.append(1)
            return {"Authorization": "Bearer tok"}

        hook = HttpObjectStoreClient(srv.endpoint, auth=rotating)
        assert hook.get("b", "a.bin", 3, 7) == b"load"
        assert hook.head("b", "a.bin").size == 7
        assert len(calls) == 2, "the auth hook must run PER request"

    def test_denied_put_and_head(self, srv):
        srv.require_headers = {"X-Key": "k"}
        c = HttpObjectStoreClient(srv.endpoint)
        with pytest.raises(IOError):
            c.put("b", "x", b"z")
        with pytest.raises(IOError):
            c.head("b", "x")


class TestRangeDialect:
    def test_open_ended_and_clamped_ranges(self, srv):
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "r.bin", b"0123456789")
        assert c.get("b", "r.bin") == b"0123456789"
        assert c.get("b", "r.bin", 4) == b"456789"
        assert c.get("b", "r.bin", 8, 99) == b"89"  # clamped tail
        assert c.get("b", "r.bin", 5, 5) == b""

    def test_range_ignoring_server_still_exact(self, srv):
        """A server that answers 200 + full body to a Range request:
        the client slices locally — byte-exact, never shifted."""
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "f.bin", bytes(range(100)))
        srv.ignore_range = True
        assert c.get("b", "f.bin", 10, 20) == bytes(range(10, 20))
        assert c.get("b", "f.bin") == bytes(range(100))

    def test_range_ignoring_server_warns_about_wire_cost(self, srv):
        """Each ranged GET against a Range-ignoring server transfers
        the whole object — correct but N× the wire; the operator must
        hear about it (rate-limited warning)."""
        from dmlc_tpu_torch.obs import log as obs_log
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "warn.bin", b"W" * 500)
        srv.ignore_range = True
        obs_log.reset()
        assert c.get("b", "warn.bin", 10, 20) == b"W" * 10
        assert "objstore-http-range-ignored" in obs_log._last_emit
        obs_log.reset()
        # a full-object read is NOT a misuse of such a server: silent
        assert c.get("b", "warn.bin") == b"W" * 500
        assert "objstore-http-range-ignored" not in obs_log._last_emit

    def test_no_change_token_degrades_with_warning(self, srv):
        """An endpoint sending neither ETag nor Last-Modified: change
        detection degrades to size-only — the client must say so."""
        from dmlc_tpu_torch.obs import log as obs_log
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "tok.bin", b"T" * 64)
        srv.no_change_token = True
        obs_log.reset()
        info = c.head("b", "tok.bin")
        assert info.etag == "64-0"  # the degenerate token
        assert "objstore-http-no-change-token" in obs_log._last_emit
        srv.no_change_token = False
        obs_log.reset()
        assert c.head("b", "tok.bin").etag not in ("", "64-0")
        assert "objstore-http-no-change-token" not in obs_log._last_emit

    def test_torn_body_raises_ioerror(self, srv):
        """Content-Length says N, the socket delivers fewer: the
        client must raise a RETRYABLE IOError inside the call — the
        io.objstore.get seam's ladder depends on it."""
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "t.bin", b"Z" * 1000)
        srv.truncate_bodies_to = 100
        with pytest.raises(IOError, match="mid-transfer|torn"):
            c.get("b", "t.bin", 0, 1000)
        srv.truncate_bodies_to = None
        assert c.get("b", "t.bin", 0, 1000) == b"Z" * 1000


class TestEncodedTransfer:
    def test_get_encoded_round_trips_dtpc_frame(self, srv):
        c = HttpObjectStoreClient(srv.endpoint, encoded=True)
        payload = b"compress me " * 500
        c.put("b", "e.bin", payload)
        wire = c.get_encoded("b", "e.bin", 0, len(payload), 6)
        assert is_encoded(wire), "no dtpc frame came back"
        assert len(wire) < len(payload)
        assert decode_page(wire) == payload

    def test_plain_server_reply_stays_unambiguous(self, srv):
        """An endpoint without the coding answers raw bytes; the
        client wraps only what decode_page could misread, so the
        fs.py decode-inside-the-seam path is always correct."""
        c = HttpObjectStoreClient(srv.endpoint, encoded=True)
        payload = b"plain bytes " * 100
        c.put("b", "p.bin", payload)
        srv.support_encoded = False
        wire = c.get_encoded("b", "p.bin", 0, len(payload), 6)
        assert decode_page(wire) == payload
        # a raw payload that STARTS with the frame magic is the
        # ambiguous case: the wrap must keep decode exact
        tricky = b"DTPC" + b"\x00" * 200
        c.put("b", "m.bin", tricky)
        wire = c.get_encoded("b", "m.bin", 0, len(tricky), 6)
        assert decode_page(wire) == tricky

    def test_range_ignoring_dtpc_server_sliced_exactly(self, srv):
        """A server that speaks the coding but ignores Range encodes
        the WHOLE object: the client decodes + slices locally, like
        the plain path — never a permanently-short read."""
        c = HttpObjectStoreClient(srv.endpoint, encoded=True)
        payload = b"whole object " * 300
        c.put("b", "w.bin", payload)
        srv.ignore_range = True
        wire = c.get_encoded("b", "w.bin", 13, 26, 6)
        assert decode_page(wire) == payload[13:26]

    def test_capability_is_per_instance(self, srv):
        plain = HttpObjectStoreClient(srv.endpoint)
        assert not hasattr(plain, "get_encoded"), \
            "fs.py probes hasattr — a plain endpoint must not " \
            "advertise the coding"
        assert hasattr(HttpObjectStoreClient(srv.endpoint,
                                             encoded=True),
                       "get_encoded")


class TestListingConvention:
    def test_listing_unsupported_raises_dmlc_error(self, srv):
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "one.bin", b"x")
        srv.support_list = False
        with pytest.raises(DMLCError, match="dmlc-list"):
            c.list("b")
        assert c.is_prefix("b") is False  # degrades, never raises
        # single-object reads never needed the listing
        assert c.get("b", "one.bin") == b"x"

    def test_info_shape_matches_emulator(self, srv):
        c = HttpObjectStoreClient(srv.endpoint)
        c.put("b", "k.bin", b"abc")
        info = c.head("b", "k.bin")
        assert isinstance(info, RemoteObjectInfo)
        assert (info.size, info.key) == (3, "k.bin")
        assert info.mtime_ns > 0 and info.etag
        listed = c.list("b", "k.bin")
        assert [o.key for o in listed] == ["k.bin"]
        assert listed[0].etag  # the server's etag rides the listing


class TestEndpointContract:
    def test_configure_endpoint_and_env(self, srv, monkeypatch):
        import dmlc_tpu_torch.io.objstore.fs as ofs
        monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
        srv.require_headers = {"Authorization": "Bearer envtok"}
        try:
            c = objstore.configure(
                endpoint=srv.endpoint,
                auth={"Authorization": "Bearer envtok"})
            assert isinstance(c, HttpObjectStoreClient)
            c.put("b", "cfg.bin", b"hi")
            assert c.get("b", "cfg.bin") == b"hi"
            objstore.configure(None)
            # the env contract: endpoint + one static auth header
            monkeypatch.setenv(ofs.ENV_ENDPOINT, srv.endpoint)
            monkeypatch.setenv(ofs.ENV_AUTH,
                               "Authorization: Bearer envtok")
            c2 = objstore.client()
            assert isinstance(c2, HttpObjectStoreClient)
            assert c2.get("b", "cfg.bin") == b"hi"
        finally:
            objstore.configure(None)

    def test_malformed_auth_env_fails_fast(self, srv, monkeypatch):
        """A DMLC_TPU_OBJSTORE_AUTH without the 'Header:' prefix must
        raise at configure time — silently dropping it would send
        unauthenticated requests that die as baffling 403s."""
        import dmlc_tpu_torch.io.objstore.fs as ofs
        monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
        monkeypatch.setenv(ofs.ENV_ENDPOINT, srv.endpoint)
        monkeypatch.setenv(ofs.ENV_AUTH, "Bearer abc123")  # no colon
        try:
            with pytest.raises(DMLCError, match="Header-Name"):
                objstore.client()
        finally:
            objstore.configure(None)

    def test_root_env_outranks_endpoint_env(self, srv, monkeypatch,
                                            tmp_path):
        import dmlc_tpu_torch.io.objstore.fs as ofs
        try:
            monkeypatch.setenv(ofs.ENV_ROOT, str(tmp_path / "root"))
            monkeypatch.setenv(ofs.ENV_ENDPOINT, srv.endpoint)
            c = objstore.client()
            assert isinstance(c, EmulatedObjectStore)
        finally:
            objstore.configure(None)

    def test_bad_endpoint_rejected(self):
        with pytest.raises(DMLCError):
            HttpObjectStoreClient("ftp://host/x")
        with pytest.raises(DMLCError):
            HttpObjectStoreClient("http://")

    def test_traversal_rejected_client_side(self, srv):
        c = HttpObjectStoreClient(srv.endpoint)
        with pytest.raises(DMLCError):
            c.head("..", "x")
        with pytest.raises(DMLCError):
            c.get("b", "../escape")


class TestImportOptional:
    def test_package_import_does_not_load_the_wire_client(self):
        """Importing ``dmlc_tpu_torch`` (which registers ``obj://``) and
        the objstore package leaves the wire client module unloaded;
        only ``configure(endpoint=...)`` loads it. (``http.client``
        itself is imported by torch, so its module is not the probe.)"""
        code = ("import sys; import dmlc_tpu_torch; "
                "import dmlc_tpu_torch.io.objstore; "
                "assert 'dmlc_tpu_torch.io.objstore.http_client' "
                "not in sys.modules, 'wire client imported eagerly'; "
                "from dmlc_tpu_torch.io.filesys import FileSystem; "
                "assert 'obj://' in FileSystem._schemes; "
                "import dmlc_tpu_torch.io.objstore as o; "
                "o.configure(endpoint='http://127.0.0.1:9'); "
                "assert 'dmlc_tpu_torch.io.objstore.http_client' "
                "in sys.modules; print('ok')")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=120, cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0, out.stderr
        assert "ok" in out.stdout


class TestCrossPackage:
    def test_both_clients_read_and_count_alike(self, tmp_path):
        """The reference's client and the port's, each with the coding
        on, over one endpoint: equal bytes for every call, and equal
        counters at the endpoint's emulator for the same calls."""
        from dmlc_tpu.io.objstore.http_client import (
            HttpObjectStoreClient as RefClient,
        )
        inner = EmulatedObjectStore(str(tmp_path / "root"))
        srv = ObjstoreHttpServer(inner)
        payload = bytes(range(256)) * 300
        counts = []
        try:
            for cls in (HttpObjectStoreClient, RefClient):
                counts.append(self._calls(cls, srv, inner, payload))
        finally:
            srv.close()
        assert counts[0] == counts[1]

    @staticmethod
    def _calls(cls, srv, inner, payload):
        c = cls(srv.endpoint, encoded=True, multipart=True)
        c.put("b", "x.bin", payload)
        inner.reset_counters()
        got = [c.get("b", "x.bin", 5, 70000),
               decode_page(c.get_encoded("b", "x.bin", 0, 9000, 6)),
               c.head("b", "x.bin").size,
               [o.key for o in c.list("b", "x.bin")]]
        assert got[0] == payload[5:70000]
        assert got[1] == payload[:9000]
        return inner.counters(), got
