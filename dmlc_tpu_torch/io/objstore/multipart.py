"""Parallel multipart PUT: the objstore write plane.

Copy of ``dmlc_tpu/io/objstore/multipart.py`` with its imports
rewritten to ``dmlc_tpu_torch``.

Reference: src/io/s3_filesys.cc — upstream's S3 ``WriteStream`` is a
multipart upload accumulating fixed-size parts; this is the same shape
behind the pluggable client protocol (emulator + HTTP backends both
speak it — see emulator.py's multipart verbs and http_client.py's
``?dmlc-upload=`` convention).

:class:`MultipartWriter` splits a byte stream into fixed ``part_bytes``
parts uploaded by a bounded worker pool. Every wire call runs under
the ``io.objstore.put`` resilience seam:

- a transient part failure (or an injected ioerror/truncate) retries
  JUST that part, byte-identically — the part buffer is immutable and
  re-sent verbatim, never re-sliced;
- faults past the retry ladder ABORT the whole upload: the staged
  parts are discarded and no object (partial or otherwise) becomes
  visible at the key — readers see the previous generation or nothing;
- a writer that crashes mid-upload leaves parts staged under its
  pid-embedded ``upload_id`` (``p<pid>-<nonce>``):
  :func:`sweep_uploads` reaps them by the ONE pagestore liveness rule
  (``_pid_dead``), riding the existing stale-sweep machinery.

Telemetry (counters of the obs metrics registry):
``objstore.put.parts`` / ``objstore.put.bytes`` per part landed,
``objstore.put.retries`` per re-sent attempt, ``objstore.put.aborts``
per abandoned upload, ``objstore.put`` per object completed.

The FS surface picks this path automatically:
``create_stream("obj://...", "w")`` spills into a multipart upload
once the buffered bytes cross ``options()["put_part_bytes"]`` (and the
configured client speaks multipart); smaller objects stay single-shot
PUTs. ``ShardedCheckpoint`` writes its content-addressed pages through
the same seam.
"""

from __future__ import annotations

import os
from typing import List, Optional

from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.resilience import inject as _inject
from dmlc_tpu_torch.resilience.policy import guarded
from dmlc_tpu_torch.utils.logging import check

__all__ = ["MultipartWriter", "supports_multipart", "sweep_uploads"]

_MULTIPART_VERBS = ("create_multipart", "put_part", "complete_multipart",
                    "abort_multipart")


def supports_multipart(client_obj) -> bool:
    """True when the client speaks the full multipart verb set (the
    hasattr probe, same convention as ``get_encoded``)."""
    return all(hasattr(client_obj, v) for v in _MULTIPART_VERBS)


def _count(which: str, n: int = 1) -> None:
    try:
        from dmlc_tpu_torch.obs.metrics import REGISTRY
        REGISTRY.counter(f"objstore.{which}").inc(n)
    except Exception:  # noqa: BLE001 — telemetry must not break I/O
        pass


class MultipartWriter(Stream):
    """Write-only stream uploading fixed-size parts concurrently.

    ``write()`` buffers; each time ``part_bytes`` accumulate, that part
    is handed to a bounded pool (``parallel`` workers, at most
    ``2 * parallel`` parts in flight so memory stays bounded).
    ``close()`` flushes the remainder part, waits for every part, and
    completes the upload — the object becomes visible atomically, or
    not at all: any part failure past the retry ladder aborts the
    upload and re-raises."""

    def __init__(self, client_obj, bucket: str, key: str, path: str,
                 part_bytes: int = 8 << 20, parallel: int = 4):
        check(part_bytes >= 1, "multipart: part_bytes must be >= 1")
        check(parallel >= 1, "multipart: parallel must be >= 1")
        check(supports_multipart(client_obj),
              f"multipart: client {type(client_obj).__name__} does not "
              "speak the multipart verbs")
        self._c = client_obj
        self._bucket = bucket
        self._key = key
        self.path = path
        self._part_bytes = int(part_bytes)
        self._parallel = int(parallel)
        self._buf = bytearray()
        self._nparts = 0
        self._futures: List = []
        self._pool = None
        self._closed = False
        self._aborted = False
        self._upload_id = guarded(
            "io.objstore.put",
            lambda: client_obj.create_multipart(bucket, key))

    # -- Stream

    def read(self, nbytes: int) -> bytes:
        from dmlc_tpu_torch.utils.logging import DMLCError
        raise DMLCError("multipart: write-only stream")

    def write(self, data) -> int:
        check(not self._closed and not self._aborted,
              "multipart: write after close/abort")
        # slice parts straight from the input: one copy per part
        # (the immutable bytes handed to the pool), never a growing
        # carry buffer shifted per part
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        n = len(mv)
        pb = self._part_bytes
        off = 0
        if self._buf:  # top up the carry to one full part first
            off = min(pb - len(self._buf), n)
            self._buf += mv[:off]
            if len(self._buf) == pb:
                self._submit(bytes(self._buf))
                self._buf = bytearray()
        while n - off >= pb:
            self._submit(bytes(mv[off:off + pb]))
            off += pb
        if off < n:
            self._buf += mv[off:]
        return n

    def close(self) -> None:
        if self._closed or self._aborted:
            return
        self._closed = True
        try:
            if self._buf:
                self._submit(bytes(self._buf))
                self._buf = bytearray()
            for f in self._futures:
                f.result()  # re-raises the first part failure
            guarded("io.objstore.put",
                    lambda: self._c.complete_multipart(
                        self._bucket, self._key, self._upload_id,
                        self._nparts))
            _count("put")
        except BaseException:
            self._abort()
            raise
        finally:
            self._shutdown_pool()

    def abort(self) -> None:
        """Abandon the upload: no object appears at the key, staged
        parts are discarded. Idempotent; safe after a failed close."""
        if self._aborted:
            return
        self._closed = True
        self._abort()
        self._shutdown_pool()

    # -- internals

    def _abort(self) -> None:
        self._aborted = True
        for f in self._futures:
            f.cancel()
        for f in self._futures:
            if not f.cancelled():
                try:
                    f.result()
                except BaseException:  # noqa: BLE001 — already failing
                    pass
        try:
            self._c.abort_multipart(self._bucket, self._key,
                                    self._upload_id)
        except Exception:  # noqa: BLE001 — best-effort; sweep reaps
            pass
        _count("put.aborts")

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._parallel,
                thread_name_prefix="dmlc_tpu_torch.objstore.put")
        return self._pool

    def _submit(self, part: bytes) -> None:
        ix = self._nparts
        self._nparts += 1
        # bound in-flight parts (and their buffers): wait for the
        # oldest before queueing past 2x the pool width
        live = [f for f in self._futures if not f.done()]
        while len(live) >= 2 * self._parallel:
            live[0].result()
            live = [f for f in self._futures if not f.done()]
        self._futures.append(
            self._executor().submit(self._put_part, ix, part))

    def _put_part(self, ix: int, part: bytes) -> None:
        """Upload one part under the ``io.objstore.put`` seam. The
        part bytes are immutable: every retry re-sends them verbatim.
        An injected truncation is detected HERE (the writer owns the
        bytes) and raised as a transient IOError so the site's policy
        retries just this part."""
        attempts = 0

        def attempt():
            nonlocal attempts
            attempts += 1
            payload = _inject.corrupt("io.objstore.put", part)
            if len(payload) != len(part):
                raise IOError(
                    f"objstore: torn part {ix} on {self.path}: sent "
                    f"{len(payload)}/{len(part)} bytes")
            self._c.put_part(self._bucket, self._key, self._upload_id,
                             ix, payload)

        guarded("io.objstore.put", attempt)
        if attempts > 1:
            _count("put.retries", attempts - 1)
        _count("put.parts")
        _count("put.bytes", len(part))


def sweep_uploads(client_obj=None, bucket: Optional[str] = None) -> int:
    """Reap in-flight uploads whose writer process is dead — the
    multipart leg of the stale sweep. Upload ids embed the writer pid
    (``p<pid>-<nonce>``); liveness is the ONE pagestore rule
    (``_pid_dead``), so a crashed writer's staged parts go the same
    way its orphaned .tmp pages do. Live writers' uploads are left
    alone. Returns uploads aborted.

    ``client_obj=None`` resolves the configured client
    (:func:`dmlc_tpu_torch.io.objstore.client`); ``bucket=None`` sweeps
    every bucket the store lists at its root (clients without a
    ``buckets()`` probe sweep nothing without an explicit bucket)."""
    from dmlc_tpu_torch.io.pagestore import _pid_dead
    if client_obj is None:
        from dmlc_tpu_torch.io.objstore.fs import client
        client_obj = client()
    if client_obj is None or not hasattr(client_obj, "list_uploads"):
        return 0
    if bucket is None:
        if not hasattr(client_obj, "buckets"):
            return 0
        buckets = list(client_obj.buckets())
    else:
        buckets = [bucket]
    reaped = 0
    for b in buckets:
        try:
            uploads = client_obj.list_uploads(b)
        except Exception:  # noqa: BLE001 — sweep is best-effort
            continue
        for upload_id, key in uploads:
            pid = _upload_pid(upload_id)
            if pid is None or pid == os.getpid() or not _pid_dead(pid):
                continue
            try:
                client_obj.abort_multipart(b, key, upload_id)
                reaped += 1
            except Exception:  # noqa: BLE001 — next sweep retries
                pass
    return reaped


def _upload_pid(upload_id: str) -> Optional[int]:
    if not upload_id.startswith("p"):
        return None
    head = upload_id[1:].split("-", 1)[0]
    return int(head) if head.isdigit() else None
