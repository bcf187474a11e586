"""obj:// (and s3:// alias) FileSystem: ranged parallel GETs, request
coalescing, and page-store hydration.

Copy of ``dmlc_tpu/io/objstore/fs.py`` with its imports rewritten to
``dmlc_tpu_torch``. The env contract keeps the reference's names
(``DMLC_TPU_OBJSTORE_*``), so one setting configures both packages; the
page-store entries a read hydrates are named and stamped as the
reference's, in the port's own page-store root.

Reference: src/io/s3_filesys.cc — upstream's S3 backend behind the one
``FileSystem`` interface (CURL + HMAC there; a pluggable client
protocol here: the on-disk emulator, or the stdlib HTTP client). The
FileSystem surface is exactly the local one's, so
``InputSplit``/parsers/``create_stream`` work over ``obj://`` URIs
unmodified. The native engine reads local files only: a parse of an
``obj://`` URI with ``engine="auto"`` takes the Python golden parser,
and ``engine="native"`` raises.

Trimmed from the reference: the gang peer tier (``io/objstore/peer.py``
serves pages through the status server of ``obs/serve.py``, which the
port does not have yet). Every block a stream misses comes from the
wire, as the reference's does outside a gang, and ``configure(peer=)``
raises ``DMLCError("... not ported ...")``.

Read path (:class:`ObjectSeekStream`):

- the object is addressed in fixed ``block_bytes`` blocks;
- a block miss first consults the unified page store
  (:mod:`dmlc_tpu_torch.io.pagestore`): hydrated blocks are ordinary
  local pages, so a SECOND epoch over the same object performs ZERO wire
  GETs (the acceptance the ``objstore.*``/``pagestore.*`` counters
  prove);
- on a store miss the stream COALESCES the run of missing blocks ahead
  (up to ``coalesce`` blocks) into one byte span and fetches it with up
  to ``parallel`` concurrent ranged GETs — small adjacent reads become
  few large requests, large spans keep the wire full;
- every wire call runs under ``resilience.guarded()`` at the
  ``io.objstore.get`` / ``io.objstore.stat`` / ``io.objstore.list`` /
  ``io.objstore.put`` sites: transient errors retry under policy, an
  armed FaultPlan injects there, and a truncated GET (chaos or a real
  short object) is DETECTED against the requested range and retried —
  never silently passed downstream;
- wire traffic is counted (``objstore.get``, ``objstore.bytes``) and
  hydration hits/misses ride the page-store counters;
- with a page-codec level (``configure(codec_level=N)`` or the
  ``DMLC_TPU_PAGE_CODEC_LEVEL`` process default) ranges travel
  COMPRESSED (``get_encoded`` transfer coding, decoded inside the
  retry seam) and hydrated blocks are stored as codec frames (the
  sidecar stamps which): ``objstore.bytes`` counts compressed on-wire
  bytes, ``objstore.bytes_served`` the decompressed payload. The trade
  pays when an epoch waits on the wire, and costs when it already
  waits on the CPU.

**Singleflight** (process-local) sits ahead of the wire: concurrent
misses of the same hydration group dedup onto ONE fetch — the leader
fills the store, waiters read the committed page
(``pagestore.singleflight.lead`` / ``pagestore.singleflight.dedup``
counters make the dedup auditable). A waiter whose block the leader's
span did not cover simply fetches it itself.

Hydrated entries are stamped with the object's ``[uri, size, mtime]``
fingerprint AND keyed by its etag: a changed object changes the key
(stale blocks are never served) and the stale sweep reclaims the old
generation's pages.

The wire client is pluggable: the on-disk emulator (tests/bench), or
the REAL networked HTTP ranged-GET client
(:mod:`dmlc_tpu_torch.io.objstore.http_client`, import-optional —
built only when ``configure(endpoint=...)`` /
``DMLC_TPU_OBJSTORE_ENDPOINT`` names one).
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import List, Optional, Tuple

from dmlc_tpu_torch.io.filesys import FileInfo, FileSystem, URI
from dmlc_tpu_torch.io.pagestore import PageStore
from dmlc_tpu_torch.io.stream import MemoryStream, SeekStream, Stream
from dmlc_tpu_torch.obs import rpc as _rpc
from dmlc_tpu_torch.resilience import inject as _inject
from dmlc_tpu_torch.resilience.policy import guarded
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = [
    "ObjectStoreFileSystem", "ObjectSeekStream", "configure", "client",
    "options", "ENV_ROOT", "ENV_LATENCY", "ENV_GBPS", "ENV_ENDPOINT",
    "ENV_AUTH",
]

def _rpc_peer(c) -> str:
    """Edge-table peer label for a backing client: the HTTP endpoint
    when there is one, the emulator otherwise."""
    return getattr(c, "endpoint", None) or "emulator"


ENV_ROOT = "DMLC_TPU_OBJSTORE_ROOT"
ENV_LATENCY = "DMLC_TPU_OBJSTORE_LATENCY_S"
ENV_GBPS = "DMLC_TPU_OBJSTORE_GBPS"
ENV_ENDPOINT = "DMLC_TPU_OBJSTORE_ENDPOINT"
ENV_AUTH = "DMLC_TPU_OBJSTORE_AUTH"  # "Header-Name: value" static auth

_lock = threading.Lock()
_client = None
_options = {
    "block_bytes": 4 << 20,   # hydration/GET granularity
    "coalesce": 4,            # max adjacent missing blocks per span
    "parallel": 4,            # concurrent ranged GETs per span
    "hydrate": True,          # write fetched blocks into the PageStore
    "codec_level": None,      # io.codec level for the wire + hydrated
                              # pages; None = the process default
                              # (DMLC_TPU_PAGE_CODEC_LEVEL), 0 = raw
    "put_part_bytes": 8 << 20,  # write streams spill into a multipart
                              # upload once this many bytes buffer
                              # (client permitting); smaller objects
                              # stay single-shot PUTs
    "put_parallel": 4,        # concurrent part uploads per writer
}


_KEEP = object()  # configure() default: tune options, keep the client


def configure(client_obj=_KEEP, *, root: Optional[str] = None,
              endpoint: Optional[str] = None,
              auth=None,
              latency_s: float = 0.0,
              bandwidth_gbps: Optional[float] = None,
              block_bytes: Optional[int] = None,
              coalesce: Optional[int] = None,
              parallel: Optional[int] = None,
              hydrate: Optional[bool] = None,
              peer: Optional[bool] = None,
              codec_level: Optional[int] = None,
              put_part_bytes: Optional[int] = None,
              put_parallel: Optional[int] = None):
    """Install the process's object-store client and tune the read
    path. Returns the installed client. The client is, in order:
    ``client_obj`` verbatim; an
    :class:`~dmlc_tpu_torch.io.objstore.emulator.EmulatedObjectStore` over
    ``root``; the real networked
    :class:`~dmlc_tpu_torch.io.objstore.http_client.HttpObjectStoreClient`
    over ``endpoint`` (``auth`` = static header dict or a callable
    returning one, the auth-header hook). An explicit
    ``configure(None)`` with neither uninstalls; calling with only
    option kwargs (e.g. ``configure(hydrate=False)``) tunes the read
    path without touching the installed client. ``peer`` names the gang
    peer tier, which is not ported: any value raises."""
    global _client
    if peer is not None:
        raise DMLCError(
            "objstore: the gang peer tier (configure(peer=...)) is not "
            "ported to dmlc_tpu_torch; it waits for the status server "
            "plane (obs/serve.py). Reads take every missing block from "
            "the wire.")
    with _lock:
        if client_obj is _KEEP and root is None and endpoint is None:
            client_obj = _client
        elif client_obj is None or client_obj is _KEEP:
            if root is not None:
                from dmlc_tpu_torch.io.objstore.emulator import (
                    EmulatedObjectStore,
                )
                client_obj = EmulatedObjectStore(
                    root, latency_s=latency_s,
                    bandwidth_gbps=bandwidth_gbps)
            elif endpoint is not None:
                # import-optional: the real wire client loads only
                # when an endpoint names one (the emulator stays the
                # test backend)
                from dmlc_tpu_torch.io.objstore.http_client import (
                    HttpObjectStoreClient,
                )
                client_obj = HttpObjectStoreClient(endpoint, auth=auth)
            else:
                client_obj = None  # explicit uninstall
        _client = client_obj
        for key, val in (("block_bytes", block_bytes),
                         ("coalesce", coalesce),
                         ("parallel", parallel),
                         ("hydrate", hydrate),
                         ("codec_level", codec_level),
                         ("put_part_bytes", put_part_bytes),
                         ("put_parallel", put_parallel)):
            if val is not None:
                _options[key] = val
        check(_options["block_bytes"] >= 1, "block_bytes must be >= 1")
        check(_options["coalesce"] >= 1, "coalesce must be >= 1")
        check(_options["parallel"] >= 1, "parallel must be >= 1")
        check(_options["put_part_bytes"] >= 1,
              "put_part_bytes must be >= 1")
        check(_options["put_parallel"] >= 1, "put_parallel must be >= 1")
    return _client


def client():
    """The configured client; falls back to the ``DMLC_TPU_OBJSTORE_*``
    env contract — an emulator over ``DMLC_TPU_OBJSTORE_ROOT``, else
    the real HTTP client over ``DMLC_TPU_OBJSTORE_ENDPOINT`` (with an
    optional ``DMLC_TPU_OBJSTORE_AUTH="Header: value"`` static auth
    header) — so gang workers inherit the launcher's store with zero
    code. None when nothing is configured."""
    global _client
    with _lock:
        if _client is not None:
            return _client
    root = os.environ.get(ENV_ROOT)
    if root:
        return configure(
            root=root,
            latency_s=float(os.environ.get(ENV_LATENCY, "0") or "0"),
            bandwidth_gbps=(float(os.environ[ENV_GBPS])
                            if os.environ.get(ENV_GBPS) else None))
    endpoint = os.environ.get(ENV_ENDPOINT)
    if endpoint:
        auth = None
        raw = os.environ.get(ENV_AUTH)
        if raw:
            # fail FAST on a malformed value: silently dropping it
            # would send unauthenticated requests and surface only as
            # baffling 403s from the endpoint
            check(":" in raw,
                  f"{ENV_AUTH} must be 'Header-Name: value', got "
                  f"{raw!r}")
            name, _, value = raw.partition(":")
            auth = {name.strip(): value.strip()}
        return configure(endpoint=endpoint, auth=auth)
    return None


def options() -> dict:
    with _lock:
        return dict(_options)


def _count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"objstore.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


def _count_sf(which: str) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"pagestore.singleflight.{which}").inc()
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


def _bucket_key(uri: URI) -> Tuple[str, str]:
    return uri.host, uri.name.lstrip("/")


class _Singleflight:
    """Process-local hydration dedup: concurrent misses of one
    hydration group elect ONE leader whose fetch fills the page store;
    the waiters then read the committed page instead of issuing their
    own GETs. Bounded wait (a crashed leader's followers proceed on
    their own after ``wait_s``) — dedup is an optimization, never a
    correctness dependency."""

    def __init__(self, wait_s: float = 120.0):
        self.wait_s = wait_s
        self._lock = threading.Lock()
        self._inflight: dict = {}

    def lead(self, key) -> bool:
        """True: caller is the leader (MUST call :meth:`done`).
        False: another thread led; its fetch has completed (or the
        bounded wait expired) by the time this returns."""
        with self._lock:
            ev = self._inflight.get(key)
            if ev is None:
                self._inflight[key] = threading.Event()
                return True
        ev.wait(self.wait_s)
        return False

    def done(self, key) -> None:
        with self._lock:
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()


_SINGLEFLIGHT = _Singleflight()


class ObjectSeekStream(SeekStream):
    """SeekStream over one remote object; see the module docstring for
    the block/coalesce/parallel/hydrate read path."""

    def __init__(self, client_obj, protocol: str, bucket: str, key: str,
                 size: int, etag: str, mtime_ns: int,
                 opts: Optional[dict] = None,
                 store: Optional[PageStore] = None):
        opts = opts or options()
        self._c = client_obj
        self._bucket = bucket
        self._key = key
        self.size = int(size)
        self.path = f"{protocol}{bucket}/{key}"
        self._bb = int(opts["block_bytes"])
        self._coalesce = int(opts["coalesce"])
        self._parallel = int(opts["parallel"])
        # page/wire codec: None falls back to the process default
        # (DMLC_TPU_PAGE_CODEC_LEVEL); >0 requests transfer-encoded
        # GETs (client permitting) and stores hydrated blocks encoded
        from dmlc_tpu_torch.io import codec as _codec_mod
        lvl = opts.get("codec_level")
        self._codec_level = (_codec_mod.default_level() if lvl is None
                             else int(lvl))
        self._store = (store if store is not None
                       else (PageStore.default() if opts["hydrate"]
                             else None))
        # the singleflight group: a run of `coalesce` blocks, the span
        # one leader's coalesced fetch covers
        self._group = max(1, self._coalesce)
        # entry names carry the object identity AND its etag: a changed
        # object hydrates a fresh generation, never mixes with the old
        oh = hashlib.sha256(self.path.encode()).hexdigest()[:16]
        eh = hashlib.sha256(str(etag).encode()).hexdigest()[:8]
        self._entry_prefix = f"obj-{oh}-{eh}"
        self._fingerprint = [[self.path, self.size, int(mtime_ns)]]
        self._pos = 0
        self._cur_ix = -1
        self._cur = b""
        self._pool = None

    # -- SeekStream

    def seek(self, pos: int) -> None:
        check(0 <= pos <= self.size,
              f"objstore seek {pos} out of range [0, {self.size}]")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def read(self, nbytes: int) -> bytes:
        if nbytes <= 0 or self._pos >= self.size:
            return b""
        ix = self._pos // self._bb
        off = self._pos - ix * self._bb
        buf = self._block(ix)
        out = buf[off:off + nbytes]
        self._pos += len(out)
        return out

    def write(self, data) -> int:
        raise DMLCError("objstore: read-only stream (write via "
                        "FileSystem.open(uri, 'w'))")

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- block plane

    def _nblocks(self) -> int:
        return (self.size + self._bb - 1) // self._bb

    def _entry(self, ix: int) -> str:
        return f"{self._entry_prefix}.b{ix}.pages"

    def _expected(self, ix: int) -> int:
        return min(self.size, (ix + 1) * self._bb) - ix * self._bb

    def _block(self, ix: int) -> bytes:
        if ix == self._cur_ix:
            return self._cur
        data = self._store_block(ix)
        if data is None:
            data = self._fetch_missing(ix)
        self._cur_ix, self._cur = ix, data
        return data

    def _store_block(self, ix: int) -> Optional[bytes]:
        """Block ``ix`` from the page store, decoded and
        length-validated; None on a miss (a torn/foreign page is
        deleted and reported as a miss — refetch, never serve it)."""
        from dmlc_tpu_torch.io.codec import decode_page
        if self._store is None:
            return None
        s = self._store.open_read(self._entry(ix))
        if s is None:
            return None
        with s:
            data = s.read_all()
        try:
            # hydrated entries may be codec-framed (the sidecar
            # stamps which); raw legacy pages pass through
            data = decode_page(data)
        except DMLCError:
            data = b""  # corrupt frame: treat as torn below
        if len(data) != self._expected(ix):
            self._store.delete(self._entry(ix))
            return None
        return data

    def _fetch_missing(self, ix: int) -> bytes:
        """A store miss: singleflight the hydration group, then the
        wire. The leader's fetch commits the span; followers read the
        committed pages (one GET fills the store for every concurrent
        reader)."""
        if self._store is None:
            # nothing to dedup INTO — every reader fetches its own
            return self._fetch_span(ix)
        key = (self._entry_prefix, self._bb, ix // self._group)
        if _SINGLEFLIGHT.lead(key):
            _count_sf("lead")
            try:
                return self._fetch_span(ix)
            finally:
                _SINGLEFLIGHT.done(key)
        _count_sf("dedup")
        data = self._store_block(ix)
        if data is not None:
            return data
        # the leader's span stopped short of our block (or its commit
        # failed): fetch it ourselves
        return self._fetch_span(ix)

    def _fetch_span(self, ix: int) -> bytes:
        """Fetch the run of store-missing blocks starting at ``ix``
        (request coalescing, at most ``coalesce`` blocks), as up to
        ``parallel`` concurrent ranged GETs; hydrate every fetched
        block. Returns block ``ix``."""
        last = min(ix + self._coalesce, self._nblocks())
        j = ix + 1
        while j < last and not (self._store is not None
                                and self._store.exists(self._entry(j))):
            j += 1
        start, end = ix * self._bb, min(j * self._bb, self.size)
        nblocks = j - ix
        nway = min(self._parallel, nblocks)
        # block-aligned contiguous sub-ranges, one ranged GET each
        per = (nblocks + nway - 1) // nway
        ranges = []
        b = ix
        while b < j:
            hi = min(b + per, j)
            ranges.append((b * self._bb, min(hi * self._bb, self.size)))
            b = hi
        if len(ranges) == 1:
            datas = [self._get_range(*ranges[0])]
        else:
            datas = list(self._executor().map(
                lambda r: self._get_range(*r), ranges))
        span = b"".join(datas)
        check(len(span) == end - start,
              "objstore: span reassembly mismatch")
        first = b""
        for k in range(ix, j):
            lo = k * self._bb - start
            blk = span[lo:lo + self._expected(k)]
            if k == ix:
                first = blk
            if self._store is not None:
                self._hydrate(k, blk)
        return first

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._parallel,
                thread_name_prefix="dmlc_tpu_torch.objstore.get")
        return self._pool

    def _get_range(self, start: int, end: int) -> bytes:
        """One ranged GET under the ``io.objstore.get`` seam. A short
        payload — injected truncation or a really-shrunk object — is
        detected against the requested range and raised as a transient
        IOError, so the site's retry policy re-fetches instead of the
        caller parsing shifted bytes.

        With a codec level (and a client that speaks ``get_encoded``)
        the range travels compressed: the decode runs INSIDE the retry
        seam — a corrupt or truncated wire frame raises and the whole
        GET re-fetches — and the counters stay honest:
        ``objstore.bytes`` counts on-wire (compressed) bytes,
        ``objstore.bytes_served`` the decompressed payload actually
        handed downstream."""
        from dmlc_tpu_torch.io.codec import decode_page
        want = end - start
        encoded = (self._codec_level > 0
                   and hasattr(self._c, "get_encoded"))
        peer = _rpc_peer(self._c)

        def attempt():
            # one client span per ATTEMPT (obs.rpc): the enclosing
            # operation() pins the trace_id, so injected retries show
            # as countable same-trace spans on the timeline
            with _rpc.client_span("get", peer):
                if encoded:
                    wire = self._c.get_encoded(self._bucket, self._key,
                                               start, end,
                                               self._codec_level)
                    wire = _inject.corrupt("io.objstore.get", wire)
                    try:
                        data = decode_page(wire)
                    except DMLCError as e:
                        raise IOError(
                            f"objstore: corrupt encoded GET on "
                            f"{self.path} [{start}, {end}): {e}"
                        ) from e
                else:
                    data = _inject.corrupt(
                        "io.objstore.get",
                        self._c.get(self._bucket, self._key, start,
                                    end))
                    wire = data
                if len(data) != want:
                    raise IOError(
                        f"objstore: short ranged GET on {self.path} "
                        f"[{start}, {end}): got {len(data)}/{want} "
                        "bytes (truncated object or torn transfer)")
                return wire, data

        with _rpc.operation("io.objstore.get", peer=peer):
            wire, data = guarded("io.objstore.get", attempt)
        _count("get")
        _count("bytes", len(wire))
        _count("bytes_served", len(data))
        return data

    def _hydrate(self, ix: int, data: bytes) -> None:
        """Commit a fetched block into the page store (best-effort: a
        full disk degrades to re-fetching, never kills the read). With
        a codec level the entry is stored as a codec frame — fewer NVMe
        bytes per cached block — and the sidecar stamps which codec
        (``"codec"`` in the entry meta)."""
        from dmlc_tpu_torch.io.codec import encode_page, tag
        name = self._entry(ix)
        data = encode_page(data, self._codec_level)
        try:
            w = self._store.writer(
                name, fingerprint=self._fingerprint,
                meta={"block": ix, "codec": tag(self._codec_level)})
            try:
                w.write(data)
            except Exception:
                w.abort()
                raise
            w.commit()
        except Exception as e:  # noqa: BLE001 — cache trouble != I/O failure
            try:
                from dmlc_tpu_torch.obs.log import warn_limited
                warn_limited(
                    "objstore-hydrate-failed",
                    f"objstore: page hydration failed ({e}); reads "
                    "will keep hitting the wire",
                    min_interval_s=60.0, all_ranks=True)
            except Exception:  # noqa: BLE001
                pass


class _ObjectWriteStream(Stream):
    """Write stream over one object. Small objects buffer in RAM and
    land as a single PUT on close (object stores have no append); once
    the buffer crosses ``options()["put_part_bytes"]`` — and the client
    speaks the multipart verbs — the stream spills into a
    :class:`~dmlc_tpu_torch.io.objstore.multipart.MultipartWriter` and the
    rest of the bytes travel as bounded-parallel fixed-size parts. Both
    paths run under the ``io.objstore.put`` seam: transient failures
    retry, a failed upload leaves NO torn object at the key."""

    def __init__(self, client_obj, bucket: str, key: str, path: str,
                 opts: Optional[dict] = None):
        opts = opts or options()
        self._c = client_obj
        self._bucket = bucket
        self._key = key
        self.path = path
        self._part_bytes = int(opts["put_part_bytes"])
        self._put_parallel = int(opts["put_parallel"])
        self._buf: Optional[MemoryStream] = MemoryStream()
        self._mp = None
        self._closed = False

    def _spill(self):
        """Switch to the multipart writer (None when the client does
        not speak the verbs — the stream stays single-shot)."""
        from dmlc_tpu_torch.io.objstore.multipart import (
            MultipartWriter, supports_multipart,
        )
        if not supports_multipart(self._c):
            return None
        self._mp = MultipartWriter(
            self._c, self._bucket, self._key, self.path,
            part_bytes=self._part_bytes, parallel=self._put_parallel)
        return self._mp

    def write(self, data) -> int:
        check(not self._closed, "objstore: write after close")
        if self._mp is not None:
            return self._mp.write(data)
        if self._buf.tell() == 0 and len(data) >= self._part_bytes:
            # a whole part arriving at once: hand it straight to the
            # multipart writer, never staged through the buffer
            mp = self._spill()
            if mp is not None:
                self._buf = None
                return mp.write(data)
        n = self._buf.write(bytes(data))
        if self._buf.tell() >= self._part_bytes and \
                self._spill() is not None:
            self._mp.write(self._buf.getvalue())
            self._buf = None
        return n

    def read(self, nbytes: int) -> bytes:
        raise DMLCError("objstore: write-only stream")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._mp is not None:
            self._mp.close()
            return
        payload = self._buf.getvalue()
        self._buf = None

        def attempt():
            # the writer owns the bytes: injected truncation (chaos at
            # io.objstore.put) is detected HERE and retried — a torn
            # single-shot PUT never lands short
            with _rpc.client_span("put", _rpc_peer(self._c)):
                data = _inject.corrupt("io.objstore.put", payload)
                if len(data) != len(payload):
                    raise IOError(
                        f"objstore: torn PUT on {self.path}: sent "
                        f"{len(data)}/{len(payload)} bytes")
                self._c.put(self._bucket, self._key, data)

        with _rpc.operation("io.objstore.put",
                            peer=_rpc_peer(self._c)):
            guarded("io.objstore.put", attempt)
        _count("put")
        _count("put.bytes", len(payload))


class ObjectStoreFileSystem(FileSystem):
    """The ``obj://`` scheme (``s3://`` aliases to it); resolves the
    process's configured client lazily so registration at import time
    costs nothing."""

    def __init__(self, protocol: str = "obj://"):
        self.protocol = protocol

    def _client(self):
        c = client()
        if c is None:
            raise DMLCError(
                f"filesystem {self.protocol!r}: no object-store "
                f"endpoint configured. Set {ENV_ROOT}=<dir> for the "
                "on-disk emulator, or call "
                "dmlc_tpu_torch.io.objstore.configure(client_or_root).")
        return c

    def open(self, uri: URI, mode: str) -> Stream:
        check(mode in ("r", "w"),
              f"objstore: mode {mode!r} unsupported (no append on "
              "object stores)")
        if mode == "r":
            return self.open_for_read(uri)
        bucket, key = _bucket_key(uri)
        check(bool(bucket) and bool(key),
              f"objstore: need {self.protocol}bucket/key, got "
              f"{uri.str_uri()!r}")
        return _ObjectWriteStream(self._client(), bucket, key,
                                  uri.str_uri())

    def open_for_read(self, uri: URI) -> ObjectSeekStream:
        c = self._client()
        bucket, key = _bucket_key(uri)

        def attempt():
            with _rpc.client_span("stat", _rpc_peer(c)):
                return c.head(bucket, key)

        with _rpc.operation("io.objstore.stat", peer=_rpc_peer(c)):
            info = guarded("io.objstore.stat", attempt)
        _count("stat")
        return ObjectSeekStream(c, self.protocol, bucket, key,
                                size=info.size, etag=info.etag,
                                mtime_ns=info.mtime_ns)

    def get_path_info(self, uri: URI) -> FileInfo:
        c = self._client()
        bucket, key = _bucket_key(uri)
        path = uri.str_uri()

        def stat() -> FileInfo:
            with _rpc.client_span("stat", _rpc_peer(c)):
                try:
                    info = c.head(bucket, key)
                    return FileInfo(path=path, size=info.size,
                                    type="file",
                                    mtime_ns=info.mtime_ns)
                except FileNotFoundError:
                    if c.is_prefix(bucket, key):
                        return FileInfo(path=path, size=0,
                                        type="directory")
                    raise

        with _rpc.operation("io.objstore.stat", peer=_rpc_peer(c)):
            out = guarded("io.objstore.stat", stat)
        _count("stat")
        return out

    def list_directory(self, uri: URI) -> List[FileInfo]:
        c = self._client()
        bucket, key = _bucket_key(uri)

        def attempt():
            with _rpc.client_span("list", _rpc_peer(c)):
                return c.list(bucket, key)

        with _rpc.operation("io.objstore.list", peer=_rpc_peer(c)):
            infos = guarded("io.objstore.list", attempt)
        _count("list")
        return [FileInfo(path=f"{self.protocol}{bucket}/{o.key}",
                         size=o.size, type="file", mtime_ns=o.mtime_ns)
                for o in infos]
