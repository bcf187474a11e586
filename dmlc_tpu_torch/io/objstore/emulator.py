"""On-disk fake object store — the test/bench backend of the remote
I/O plane.

Copy of ``dmlc_tpu/io/objstore/emulator.py`` with its imports rewritten
to ``dmlc_tpu_torch``. The layout is the reference's, so either
package's emulator reads a root the other wrote, and the request
counters of one read sequence are equal in both. Unlike the
reference's, ``list`` leaves out another process's PUT in flight (its
``<key>.tmp.<pid>`` file) and a file removed or replaced while the
listing walks: several writers of one checkpoint commit into one root
at once, and the reference's listing then fails on a file it saw that
is gone by its ``stat``.

The ``obj://`` plane is exercised against this emulator wherever no
real endpoint is configured: a directory of ``<root>/<bucket>/<key>``
files behind the same client protocol a real S3/GCS backend would
implement (``get``/``head``/``list``/``put``). Two things make it a
*model* rather than a stub:

- **latency/bandwidth shaping** — every GET *and every PUT* pays
  ``latency_s`` plus ``bytes / bandwidth`` of sleep, so cold-vs-warm
  epoch benchmarks (bench_suite config 11) and multipart-vs-single-shot
  write benchmarks (config 21) measure a believable wire, not a local
  read;
- **first-class chaos** — the client seams (``io.objstore.get`` etc.,
  see fs.py) run under ``resilience.guarded()``, so an armed
  :class:`~dmlc_tpu_torch.resilience.inject.FaultPlan` targets emulator
  traffic exactly as it would real wire calls (ioerror, delay,
  truncate, crash), with the emulator's request counters proving what
  actually hit the "network".

Counters (``gets``/``get_bytes``/``heads``/``lists``/``puts``/
``put_bytes``/``put_parts``) are the ground truth for the
wire-free-second-epoch acceptance and the per-part multipart
accounting: a page-store hit rate can lie, a GET/PUT counter cannot.

Multipart protocol (the write-plane mirror of the ranged-GET read
plane; see io/objstore/multipart.py for the client-side writer):
``create_multipart`` opens an upload (parts stage under a
``.mpu/<upload_id>/`` area the listings never show),
``put_part`` uploads one part (throttled + counted like any wire PUT),
``complete_multipart`` concatenates the parts into the final key
atomically (a metadata op — latency only, no bandwidth charge, like
S3's CompleteMultipartUpload), and ``abort_multipart`` removes the
staged parts without the final key ever existing. ``list_uploads``
exposes in-flight uploads so the stale sweep can reap a dead writer's
orphans (upload ids embed the writer pid — the pagestore liveness
rule).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from dmlc_tpu_torch.obs import rpc as _rpc
from dmlc_tpu_torch.utils.logging import DMLCError, check

__all__ = ["ObjectInfo", "EmulatedObjectStore"]

# the staging name of a single-shot PUT: ``<key>.tmp.<writer pid>``
_INFLIGHT_RE = re.compile(r"\.tmp\.\d+$")


@dataclass
class ObjectInfo:
    """What a HEAD returns: enough for stat, listing, and the
    fingerprint stamp (etag doubles as the change token)."""
    key: str
    size: int
    mtime_ns: int

    @property
    def etag(self) -> str:
        return f"{self.size}-{self.mtime_ns}"


class EmulatedObjectStore:
    """Bucket/key object store over a local directory.

    Thread-safe; ranged GETs are byte-exact (``get(b, k, start, end)``
    returns ``data[start:end]``). Keys may contain '/' — they map to
    nested directories, and :meth:`list` is prefix-recursive the way
    object-store listings are.
    """

    def __init__(self, root: str, latency_s: float = 0.0,
                 bandwidth_gbps: Optional[float] = None):
        self.root = os.path.abspath(root)
        self.latency_s = float(latency_s)
        self.bandwidth_gbps = bandwidth_gbps
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.gets = 0
        self.get_bytes = 0
        self.heads = 0
        self.lists = 0
        self.puts = 0
        self.put_bytes = 0
        self.put_parts = 0

    # -- layout

    def _path(self, bucket: str, key: str = "") -> str:
        check(bucket and "/" not in bucket and ".." not in bucket,
              f"objstore: invalid bucket {bucket!r}")
        check(".." not in key.split("/"),
              f"objstore: invalid key {key!r}")
        p = os.path.join(self.root, bucket, *key.split("/")) if key \
            else os.path.join(self.root, bucket)
        return p

    def _throttle(self, nbytes: int) -> None:
        d = self.latency_s
        if self.bandwidth_gbps:
            d += nbytes / (self.bandwidth_gbps * 1e9)
        if d > 0:
            time.sleep(d)

    # -- client protocol

    def put(self, bucket: str, key: str, data: bytes) -> ObjectInfo:
        """Single-shot PUT. Pays the same latency/bandwidth model as a
        GET — the wire is symmetric, which is what makes multipart's
        parallel parts measurably faster than one serial upload."""
        p = self._path(bucket, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        # emulated_server models the serving half of the hop (obs.rpc):
        # the disk write + modeled wire time IS the handle time a real
        # endpoint would echo, so single-process benches decompose
        # client latency exactly like wire runs
        with _rpc.emulated_server("put"):
            tmp = p + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            self._throttle(len(data))
            os.replace(tmp, p)
        with self._lock:
            self.puts += 1
            self.put_bytes += len(data)
        return self.head(bucket, key, count=False)

    def put_file(self, bucket: str, key: str, src_path: str) -> ObjectInfo:
        """Upload a local file (bench/test corpus loader)."""
        with open(src_path, "rb") as f:
            return self.put(bucket, key, f.read())

    # -- multipart upload (the write-plane protocol)

    def _mpu_dir(self, bucket: str, upload_id: str) -> str:
        check(upload_id and "/" not in upload_id
              and ".." not in upload_id,
              f"objstore: invalid upload id {upload_id!r}")
        return os.path.join(self._path(bucket), ".mpu", upload_id)

    def create_multipart(self, bucket: str, key: str) -> str:
        """Open a multipart upload for ``key``; returns the upload id.
        The id embeds the writer pid (``p<pid>-<nonce>``) so the stale
        sweep can reap a crashed writer's parts by the one pagestore
        liveness rule."""
        self._path(bucket, key)  # validate bucket/key
        nonce = os.urandom(4).hex()
        upload_id = f"p{os.getpid()}-{nonce}"
        d = self._mpu_dir(bucket, upload_id)
        os.makedirs(d, exist_ok=True)
        # the manifest records the target key: list_uploads/sweep can
        # report WHAT a dead writer was uploading, not just that it was
        with open(os.path.join(d, "key"), "w") as f:
            f.write(key)
        return upload_id

    def put_part(self, bucket: str, key: str, upload_id: str,
                 part_num: int, data: bytes) -> None:
        """Upload one part (0-based). Throttled and counted like any
        wire PUT — parts are where multipart's bytes actually move."""
        check(part_num >= 0, "objstore: negative part number")
        d = self._mpu_dir(bucket, upload_id)
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, f"part-{part_num:05d}")
        with _rpc.emulated_server("put"):
            tmp = p + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            self._throttle(len(data))
            os.replace(tmp, p)
        with self._lock:
            self.put_parts += 1
            self.put_bytes += len(data)

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           nparts: int) -> ObjectInfo:
        """Concatenate parts ``0..nparts-1`` into the final key
        atomically and drop the staged parts. A metadata op: latency
        only, no bandwidth charge (the bytes already moved per part).
        A missing part raises FileNotFoundError — non-retryable, the
        upload is torn and the caller must abort."""
        d = self._mpu_dir(bucket, upload_id)
        p = self._path(bucket, key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as out:
            for n in range(nparts):
                part = os.path.join(d, f"part-{n:05d}")
                if not os.path.isfile(part):
                    out.close()
                    os.remove(tmp)
                    raise FileNotFoundError(
                        f"objstore: multipart {bucket}/{key} upload "
                        f"{upload_id} missing part {n}")
                with open(part, "rb") as f:
                    shutil.copyfileobj(f, out)
        self._throttle(0)
        os.replace(tmp, p)
        shutil.rmtree(d, ignore_errors=True)
        with self._lock:
            self.puts += 1
        return self.head(bucket, key, count=False)

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        """Drop an upload's staged parts; the final key never appears.
        Idempotent (aborting an unknown upload is a no-op)."""
        shutil.rmtree(self._mpu_dir(bucket, upload_id),
                      ignore_errors=True)

    def list_uploads(self, bucket: str) -> List[Tuple[str, str]]:
        """In-flight multipart uploads as ``(upload_id, key)`` — the
        sweep's view of what a crashed writer left behind."""
        base = os.path.join(self._path(bucket), ".mpu")
        if not os.path.isdir(base):
            return []
        out: List[Tuple[str, str]] = []
        for upload_id in sorted(os.listdir(base)):
            manifest = os.path.join(base, upload_id, "key")
            try:
                with open(manifest) as f:
                    target = f.read()
            except OSError:
                target = ""
            out.append((upload_id, target))
        return out

    def buckets(self) -> List[str]:
        """Every bucket in the store — lets the bucketless
        :func:`~dmlc_tpu_torch.io.objstore.multipart.sweep_uploads` cover the
        whole root."""
        return sorted(n for n in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, n)))

    def delete(self, bucket: str, key: str) -> bool:
        """Remove one object; True when it existed (object stores have
        DELETE — re-saves of a checkpoint step invalidate their COMMIT
        marker through it)."""
        p = self._path(bucket, key)
        try:
            os.remove(p)
            return True
        except FileNotFoundError:
            return False

    def head(self, bucket: str, key: str,
             count: bool = True) -> ObjectInfo:
        p = self._path(bucket, key)
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"objstore: no object {bucket}/{key}")
        st = os.stat(p)
        if count:
            with self._lock:
                self.heads += 1
        return ObjectInfo(key=key, size=st.st_size,
                          mtime_ns=st.st_mtime_ns)

    def is_prefix(self, bucket: str, key: str = "") -> bool:
        """Whether any object lives under ``key`` as a prefix
        (object-store "directory" semantics)."""
        p = self._path(bucket, key)
        return os.path.isdir(p)

    def list(self, bucket: str, prefix: str = "") -> List[ObjectInfo]:
        """All objects under ``prefix``, key-sorted (recursive, the
        object-store listing shape). In-flight multipart parts (the
        ``.mpu`` staging area) are never listed — an aborted or torn
        upload is invisible, exactly like a real object store."""
        base = self._path(bucket)
        start = self._path(bucket, prefix) if prefix else base
        with self._lock:
            self.lists += 1
        if not os.path.isdir(start):
            if os.path.isfile(start):
                return [self.head(bucket, prefix, count=False)]
            return []
        out: List[ObjectInfo] = []
        for dirpath, dirnames, filenames in os.walk(start):
            if dirpath == base and ".mpu" in dirnames:
                dirnames.remove(".mpu")
            dirnames.sort()
            for name in sorted(filenames):
                if _INFLIGHT_RE.search(name):
                    continue  # a PUT in flight: not an object yet
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, base).replace(os.sep, "/")
                try:
                    st = os.stat(full)
                except FileNotFoundError:
                    continue  # deleted or replaced since the walk
                out.append(ObjectInfo(key=key, size=st.st_size,
                                      mtime_ns=st.st_mtime_ns))
        out.sort(key=lambda o: o.key)
        return out

    def _read_range(self, bucket: str, key: str, start: int,
                    end: Optional[int]) -> bytes:
        check(start >= 0, "objstore: negative range start")
        p = self._path(bucket, key)
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"objstore: no object {bucket}/{key}")
        size = os.path.getsize(p)
        stop = size if end is None else min(end, size)
        if stop < start:
            raise DMLCError(
                f"objstore: bad range [{start}, {end}) for "
                f"{bucket}/{key} (size {size})")
        with open(p, "rb") as f:
            f.seek(start)
            return f.read(stop - start)

    def get(self, bucket: str, key: str, start: int = 0,
            end: Optional[int] = None) -> bytes:
        """Ranged GET: bytes ``[start, end)`` of the object (``end``
        None = to the end). Pays the latency/bandwidth model."""
        with _rpc.emulated_server("get"):
            data = self._read_range(bucket, key, start, end)
            self._throttle(len(data))
        with self._lock:
            self.gets += 1
            self.get_bytes += len(data)
        return data

    def get_encoded(self, bucket: str, key: str, start: int, end: int,
                    level: int) -> bytes:
        """Ranged GET with transfer encoding (the HTTP
        Content-Encoding shape): the payload is the requested range
        wrapped in an ``io.codec`` page frame, and the wire model —
        throttle AND the ``get_bytes`` ground-truth counter — charges
        the ENCODED size. That is what makes a compressed cold epoch
        genuinely move fewer modeled wire bytes; the caller decodes
        under its retry seam and serves the raw range."""
        from dmlc_tpu_torch.io.codec import encode_page
        with _rpc.emulated_server("get"):
            data = encode_page(
                self._read_range(bucket, key, start, end), level)
            self._throttle(len(data))
        with self._lock:
            self.gets += 1
            self.get_bytes += len(data)
        return data

    # -- test/bench helpers

    def reset_counters(self) -> None:
        with self._lock:
            self.gets = self.get_bytes = 0
            self.heads = self.lists = self.puts = 0
            self.put_bytes = self.put_parts = 0

    def counters(self) -> dict:
        with self._lock:
            return {"gets": self.gets, "get_bytes": self.get_bytes,
                    "heads": self.heads, "lists": self.lists,
                    "puts": self.puts, "put_bytes": self.put_bytes,
                    "put_parts": self.put_parts}
