"""The REAL networked object-store client: HTTP ranged GETs (stdlib
``http.client``).

Copy of ``dmlc_tpu/io/objstore/http_client.py`` with its imports
rewritten to ``dmlc_tpu_torch``: the same requests, headers and
multipart convention, so one endpoint serves both packages.

Reference: src/io/s3_filesys.cc — upstream's S3 backend is CURL +
request signing behind the one ``FileSystem`` interface. This module
is the equivalent rung for a host with no cloud SDKs: a plain
HTTP(S) object endpoint (S3-compatible gateways, an nginx bucket
mirror, a dmlc-aware proxy) spoken with nothing but the standard
library, behind the SAME client protocol the emulator implements — so
``ObjectSeekStream``'s block/coalesce/hydrate/peer machinery, the
``io.objstore.*`` retry seams, and every chaos plan apply unchanged.

Import-optional by design: nothing in the package imports this module
until ``objstore.configure(endpoint=...)`` (or the
``DMLC_TPU_OBJSTORE_ENDPOINT`` env contract) names an endpoint — the
emulator remains the test backend, and no new dependency exists
(``http.client`` is stdlib). ``import dmlc_tpu_torch`` leaves
``http.client`` unimported.

Protocol mapping (objects live at ``<endpoint>/<bucket>/<key>``):

- ``get(bucket, key, start, end)`` — ``GET`` with
  ``Range: bytes=start-(end-1)``; a 206 returns the range, a 200 from
  a Range-ignoring server is sliced locally, and a body shorter than
  its ``Content-Length`` raises IOError INSIDE the call — the
  ``io.objstore.get`` seam's short-range check and retry ladder see
  exactly what they see from the emulator;
- ``head(bucket, key)`` — ``HEAD``: size from ``Content-Length``,
  change token from ``ETag`` (falling back to ``size-mtime``), mtime
  from ``X-Dmlc-Mtime-Ns`` or ``Last-Modified``;
- ``put(bucket, key, data)`` — ``PUT`` (2xx = success);
- multipart (only when constructed with ``multipart=True`` — the
  dmlc-gateway write convention, gated per-instance exactly like
  ``encoded``): the upload id is generated client-side
  (``p<pid>-<nonce>``, pid-embedded for the stale sweep), parts travel
  as ``PUT <bucket>/<key>?dmlc-upload=<id>&dmlc-part=<n>``, the final
  object materializes with ``POST ?dmlc-upload=<id>&dmlc-complete=
  <nparts>`` and a torn upload is dropped with ``POST
  ?dmlc-upload=<id>&dmlc-abort=1``; ``list_uploads`` reads ``GET
  <bucket>?dmlc-uploads=1`` so the sweep sees orphaned uploads;
- ``delete(bucket, key)`` — ``DELETE`` (404 = already gone);
- ``list(bucket, prefix)`` / ``is_prefix`` — ``GET
  <endpoint>/<bucket>?dmlc-list=<prefix>`` expecting a JSON array of
  ``{key, size, mtime_ns}``: the listing convention a dmlc-aware
  gateway provides. A plain static server without it raises
  ``DMLCError`` (single-object URIs — the streaming read path — never
  need a listing);
- ``get_encoded(...)`` (only when constructed with ``encoded=True``)
  — the ``io/codec.py`` frame riding HTTP Content-Encoding style: the
  request advertises ``X-Dmlc-Accept-Codec: dtpc``, a reply stamped
  ``X-Dmlc-Codec: dtpc`` is returned as the codec frame (decoded
  inside the ``io.objstore.get`` retry seam, exactly like the
  emulator's modeled transfer coding), and a reply without the stamp
  is wrapped as a stored frame so the decode stays unambiguous.

Auth is a hook, not a policy: pass ``auth`` as a static header dict or
a zero-arg callable returning one (called per request, so rotating
tokens just work); e.g. ``auth=lambda: {"Authorization": f"Bearer "
f"{token()}"}``.
"""

from __future__ import annotations

import http.client
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, urlsplit

from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["HttpObjectStoreClient", "RemoteObjectInfo"]


@dataclass
class RemoteObjectInfo:
    """What a HEAD/listing returns — the emulator's ``ObjectInfo``
    shape with the server's own etag when it sent one."""
    key: str
    size: int
    mtime_ns: int
    etag: str = ""

    def __post_init__(self) -> None:
        if not self.etag:
            self.etag = f"{self.size}-{self.mtime_ns}"


def _parse_http_date_ns(value: Optional[str]) -> int:
    """``Last-Modified`` -> epoch ns (0 when absent/unparseable — the
    etag is the change token; mtime is advisory for fingerprints)."""
    if not value:
        return 0
    try:
        from email.utils import parsedate_to_datetime
        return int(parsedate_to_datetime(value).timestamp() * 1e9)
    except (TypeError, ValueError, OverflowError):
        return 0


class HttpObjectStoreClient:
    """Ranged-GET object client over one HTTP(S) endpoint."""

    def __init__(self, endpoint: str, auth=None, timeout_s: float = 10.0,
                 encoded: bool = False, multipart: bool = False):
        u = urlsplit(endpoint if "://" in endpoint
                     else f"http://{endpoint}")
        check(u.scheme in ("http", "https"),
              f"objstore http: unsupported scheme {u.scheme!r} "
              f"(endpoint {endpoint!r})")
        check(bool(u.hostname), f"objstore http: no host in "
                                f"{endpoint!r}")
        self.endpoint = endpoint
        self._scheme = u.scheme
        self._host = u.hostname
        self._port = u.port
        self._base = u.path.rstrip("/")
        self._auth = auth
        self.timeout_s = float(timeout_s)
        if encoded:
            # capability is per-instance: fs.py probes hasattr(client,
            # "get_encoded"), so only an endpoint KNOWN to speak the
            # dtpc transfer coding exposes the method
            self.get_encoded = self._get_encoded
        if multipart:
            # same gate for the write plane: the MultipartWriter probes
            # hasattr(client, "create_multipart"); a plain endpoint
            # without the dmlc upload convention stays single-shot
            self.create_multipart = self._create_multipart
            self.put_part = self._put_part
            self.complete_multipart = self._complete_multipart
            self.abort_multipart = self._abort_multipart
            self.list_uploads = self._list_uploads

    # -- plumbing

    def _headers(self) -> Dict[str, str]:
        a = self._auth
        if a is None:
            return {}
        return dict(a() if callable(a) else a)

    def _path(self, bucket: str, key: str = "",
              query: str = "") -> str:
        check(bucket and "/" not in bucket and ".." not in bucket,
              f"objstore http: invalid bucket {bucket!r}")
        check(".." not in key.split("/"),
              f"objstore http: invalid key {key!r}")
        p = f"{self._base}/{quote(bucket)}"
        if key:
            p += "/" + quote(key)
        if query:
            p += "?" + query
        return p

    def _request(self, method: str, path: str,
                 headers: Optional[Dict[str, str]] = None,
                 body: Optional[bytes] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        """One request on a fresh connection (parallel span GETs each
        own theirs — no shared-socket state to corrupt on retry). The
        body is length-checked against ``Content-Length``: a torn
        transfer raises here, inside the caller's retry seam.

        Trace propagation (obs.rpc): when the calling thread holds an
        open client span (the io.objstore.* seams open one per
        attempt) its context rides out as the trace header and the
        server's handle-time echo is folded back in. A thread WITHOUT
        one — a multipart part upload on a pool thread — opens its own
        standalone span so every wire hop stays attributable. With
        tracing off both branches cost one global read."""
        import contextlib as _ctx

        from dmlc_tpu_torch.obs import rpc as _rpc
        conn_cls = (http.client.HTTPSConnection
                    if self._scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(self._host, self._port, timeout=self.timeout_s)
        with _ctx.ExitStack() as stack:
            stack.callback(conn.close)
            call = _rpc.active_call()
            if call is None:
                call = stack.enter_context(_rpc.client_span(
                    method.lower(), f"{self._host}:{self._port}"))
            hdrs = self._headers()
            if headers:
                hdrs.update(headers)
            if call is not None:
                _rpc.inject(call.ctx, hdrs)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except http.client.HTTPException as e:
                # protocol-layer trouble (IncompleteRead on a torn
                # body, BadStatusLine from a dying server) is
                # TRANSIENT: surface as IOError so the io.objstore.*
                # retry seams classify and re-fetch it
                raise IOError(
                    f"objstore http: {method} {path} failed mid-"
                    f"transfer: {e!r}") from e
            if call is not None:
                echo = resp.headers.get(_rpc.HANDLE_HEADER)
                if echo is not None:
                    call.note_server(echo)
            declared = resp.headers.get("Content-Length")
            if (method != "HEAD" and declared is not None
                    and declared.isdigit()
                    and len(data) != int(declared)):
                raise IOError(
                    f"objstore http: torn {method} {path}: read "
                    f"{len(data)} of Content-Length {declared}")
            return resp.status, dict(resp.headers.items()), data

    @staticmethod
    def _raise_status(status: int, what: str) -> None:
        if status == 404:
            raise FileNotFoundError(f"objstore http: no object "
                                    f"({what})")
        raise IOError(f"objstore http: {what} -> HTTP {status}")

    def _note_range_ignored(self) -> None:
        """A 200 to a ranged GET: correct (we slice locally) but each
        block fetch re-transfers the WHOLE object — an operator must
        hear about the N× wire cost, not discover it in a bill."""
        from dmlc_tpu_torch.obs.log import warn_limited
        warn_limited(
            "objstore-http-range-ignored",
            f"objstore http: endpoint {self.endpoint} ignores Range "
            "— every block fetch transfers the whole object and is "
            "sliced locally. Front the store with a range-capable "
            "gateway (or raise block_bytes/coalesce toward the "
            "object size).",
            min_interval_s=300.0, all_ranks=True)

    # -- client protocol

    def get(self, bucket: str, key: str, start: int = 0,
            end: Optional[int] = None) -> bytes:
        """Ranged GET: bytes ``[start, end)`` (``end`` None = to the
        object's end)."""
        check(start >= 0, "objstore http: negative range start")
        if end is not None and end <= start:
            return b""
        rng = (f"bytes={start}-{end - 1}" if end is not None
               else f"bytes={start}-")
        status, _, data = self._request(
            "GET", self._path(bucket, key), headers={"Range": rng})
        if status == 206:
            return data
        if status == 200:
            # the server ignored Range and sent the whole object:
            # slice locally so callers still get exact range bytes
            if start or end is not None:
                self._note_range_ignored()
            return data[start:end if end is not None else len(data)]
        if status == 416:
            raise DMLCError(f"objstore http: bad range [{start}, "
                            f"{end}) for {bucket}/{key}")
        self._raise_status(status, f"GET {bucket}/{key}")

    def _get_encoded(self, bucket: str, key: str, start: int, end: int,
                     level: int) -> bytes:
        """Ranged GET with the dtpc transfer coding (see module
        docstring). Always returns bytes :func:`decode_page` handles
        unambiguously."""
        from dmlc_tpu_torch.io.codec import decode_page, encode_page
        rng = f"bytes={start}-{end - 1}"
        status, headers, data = self._request(
            "GET", self._path(bucket, key),
            headers={"Range": rng, "X-Dmlc-Accept-Codec": "dtpc",
                     "X-Dmlc-Codec-Level": str(int(level))})
        if status in (200, 206):
            if headers.get("X-Dmlc-Codec") == "dtpc":
                if status == 200:
                    # a Range-ignoring server encoded the WHOLE
                    # object: decode and slice locally like the plain
                    # path, re-wrapped so the caller's decode stays
                    # exact (a torn frame is transient — IOError, so
                    # the io.objstore.get seam re-fetches)
                    self._note_range_ignored()
                    try:
                        data = decode_page(data)[start:end]
                    except DMLCError as e:
                        raise IOError(
                            f"objstore http: corrupt encoded reply "
                            f"for {bucket}/{key}: {e}") from e
                    return encode_page(data, 0)
                return data
            if status == 200:
                self._note_range_ignored()
                data = data[start:end]
            # plain reply: wrap (level 0 only frames magic-prefixed
            # payloads) so decode_page can never misread raw bytes
            return encode_page(data, 0)
        if status == 416:
            raise DMLCError(f"objstore http: bad range [{start}, "
                            f"{end}) for {bucket}/{key}")
        self._raise_status(status, f"GET(encoded) {bucket}/{key}")

    def head(self, bucket: str, key: str) -> RemoteObjectInfo:
        status, headers, _ = self._request(
            "HEAD", self._path(bucket, key))
        if status != 200:
            self._raise_status(status, f"HEAD {bucket}/{key}")
        size_raw = headers.get("Content-Length", "")
        check(size_raw.isdigit(),
              f"objstore http: HEAD {bucket}/{key} sent no "
              "Content-Length")
        mtime_raw = headers.get("X-Dmlc-Mtime-Ns", "")
        mtime_ns = (int(mtime_raw) if mtime_raw.lstrip("-").isdigit()
                    else _parse_http_date_ns(
                        headers.get("Last-Modified")))
        etag = headers.get("ETag", "").strip('"')
        if not etag and mtime_ns == 0:
            # no change token at all: the derived etag degenerates to
            # "<size>-0", so a SAME-SIZE in-place replacement is
            # invisible to the hydration-generation machinery (stale
            # pages would replay as current). Warn loudly — the fix is
            # an ETag- or Last-Modified-speaking endpoint, or
            # versioned object keys.
            from dmlc_tpu_torch.obs.log import warn_limited
            warn_limited(
                "objstore-http-no-change-token",
                f"objstore http: {self.endpoint}/{bucket}/{key} sent "
                "neither ETag nor a parseable Last-Modified — change "
                "detection degrades to object SIZE only; a same-size "
                "replacement will serve stale hydrated pages. Use an "
                "endpoint with change tokens or versioned keys.",
                min_interval_s=300.0, all_ranks=True)
        return RemoteObjectInfo(
            key=key, size=int(size_raw), mtime_ns=mtime_ns, etag=etag)

    def put(self, bucket: str, key: str,
            data: bytes) -> RemoteObjectInfo:
        status, _, _ = self._request(
            "PUT", self._path(bucket, key), body=bytes(data),
            headers={"Content-Type": "application/octet-stream"})
        if status not in (200, 201, 204):
            self._raise_status(status, f"PUT {bucket}/{key}")
        return self.head(bucket, key)

    def put_file(self, bucket: str, key: str,
                 src_path: str) -> RemoteObjectInfo:
        """Upload a local file (bench/test corpus loader — the
        emulator helper's shape)."""
        from dmlc_tpu_torch.io.stream import create_stream
        with create_stream(src_path, "r") as s:
            return self.put(bucket, key, s.read_all())

    def delete(self, bucket: str, key: str) -> bool:
        """Remove one object; True when it existed."""
        status, _, _ = self._request(
            "DELETE", self._path(bucket, key))
        if status == 404:
            return False
        if status not in (200, 202, 204):
            self._raise_status(status, f"DELETE {bucket}/{key}")
        return True

    # -- multipart upload (exposed only with multipart=True)

    def _create_multipart(self, bucket: str, key: str) -> str:
        """Open an upload. The id is minted client-side (no round
        trip): ``p<pid>-<nonce>``, pid-embedded so the sweep's
        liveness rule applies to orphans."""
        import os as _os
        self._path(bucket, key)  # validate bucket/key
        return f"p{_os.getpid()}-{_os.urandom(4).hex()}"

    def _put_part(self, bucket: str, key: str, upload_id: str,
                  part_num: int, data: bytes) -> None:
        check(part_num >= 0, "objstore http: negative part number")
        status, _, _ = self._request(
            "PUT",
            self._path(bucket, key,
                       query=f"dmlc-upload={quote(upload_id)}"
                             f"&dmlc-part={int(part_num)}"),
            body=bytes(data),
            headers={"Content-Type": "application/octet-stream"})
        if status not in (200, 201, 204):
            self._raise_status(
                status, f"PUT part {part_num} {bucket}/{key}")

    def _complete_multipart(self, bucket: str, key: str,
                            upload_id: str,
                            nparts: int) -> RemoteObjectInfo:
        status, _, _ = self._request(
            "POST",
            self._path(bucket, key,
                       query=f"dmlc-upload={quote(upload_id)}"
                             f"&dmlc-complete={int(nparts)}"))
        if status == 404:
            # a part went missing server-side: the upload is torn, not
            # transient — complete can never succeed, the caller aborts
            raise FileNotFoundError(
                f"objstore http: multipart {bucket}/{key} upload "
                f"{upload_id} has missing parts")
        if status not in (200, 201, 204):
            self._raise_status(status, f"COMPLETE {bucket}/{key}")
        return self.head(bucket, key)

    def _abort_multipart(self, bucket: str, key: str,
                         upload_id: str) -> None:
        status, _, _ = self._request(
            "POST",
            self._path(bucket, key,
                       query=f"dmlc-upload={quote(upload_id)}"
                             "&dmlc-abort=1"))
        if status not in (200, 204, 404):  # 404 = already gone: fine
            self._raise_status(status, f"ABORT {bucket}/{key}")

    def _list_uploads(self, bucket: str) -> List[Tuple[str, str]]:
        """In-flight uploads as ``(upload_id, key)`` via ``GET
        <bucket>?dmlc-uploads=1`` (JSON array of pairs)."""
        status, _, data = self._request(
            "GET", self._path(bucket, query="dmlc-uploads=1"))
        if status != 200:
            raise DMLCError(
                f"objstore http: endpoint has no dmlc-uploads support "
                f"for {bucket!r} (HTTP {status})")
        try:
            return [(str(u), str(k))
                    for u, k in json.loads(data.decode("utf-8"))]
        except (ValueError, TypeError) as e:
            raise DMLCError(
                f"objstore http: malformed dmlc-uploads reply for "
                f"{bucket!r}: {e}") from e

    def list(self, bucket: str, prefix: str = ""
             ) -> List[RemoteObjectInfo]:
        """Objects under ``prefix``, key-sorted — via the dmlc listing
        convention (JSON array at ``?dmlc-list=<prefix>``). Endpoints
        without it raise DMLCError: single-object reads never list."""
        status, _, data = self._request(
            "GET", self._path(bucket,
                              query=f"dmlc-list={quote(prefix)}"))
        if status != 200:
            raise DMLCError(
                f"objstore http: endpoint has no dmlc-list support "
                f"for {bucket!r} (HTTP {status}) — pass single-object "
                "URIs, or front the store with a dmlc-aware gateway")
        try:
            rows = json.loads(data.decode("utf-8"))
            out = [RemoteObjectInfo(key=r["key"], size=int(r["size"]),
                                    mtime_ns=int(r.get("mtime_ns", 0)),
                                    etag=str(r.get("etag", "")))
                   for r in rows]
        except (ValueError, KeyError, TypeError) as e:
            raise DMLCError(
                f"objstore http: malformed dmlc-list reply for "
                f"{bucket!r}: {e}") from e
        out.sort(key=lambda o: o.key)
        return out

    def is_prefix(self, bucket: str, key: str = "") -> bool:
        try:
            listing = self.list(bucket, key)
        except DMLCError:
            return False
        prefix = key.rstrip("/") + "/" if key else ""
        return any(o.key.startswith(prefix) and o.key != key
                   for o in listing)
