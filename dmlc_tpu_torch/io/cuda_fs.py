"""cuda:// URI scheme: streams that stage bytes straight into device memory.

The port's counterpart of ``dmlc_tpu/io/tpu_fs.py`` (the north-star
contract "Stream/SeekStream gain a tpu:// URI that DMAs RecordIO chunks
straight to device", with the card in place of the TPU). There is no
file → device DMA in PyTorch, so the mechanism is a host read into a
page-locked staging buffer and an asynchronous copy to the card on a
side stream, with a lookahead window so copy N+1 is in flight while the
consumer uses chunk N: the reference's ThreadedInputSplit double buffer,
aimed at the host → device edge.

URI shape: ``cuda:///abs/path`` (or ``cuda://rel/path``); the path after
the scheme is served by the local VFS. Reads and seeks behave as a
normal SeekStream (host bytes); the device API is additive:

- ``CUDASeekStream.read_to_device(n)`` → a uint8 tensor on the device;
- ``CUDASeekStream.device_chunks(chunk_bytes, lookahead)`` → device
  chunks with ``lookahead`` copies in flight;
- ``recordio_device_batches(uri, part, nparts)`` → sharded RecordIO
  record batches on the device (payload u8 + starts/ends i64).

Every device entry point copies to ``torch.device("cuda")`` unless the
caller names another device (``device="cpu"``, as the tests do). Writes
accept bytes, numpy arrays or tensors: a device tensor is pulled to the
host once (the checkpoint-write direction).

Importing this module registers the scheme and touches no device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.filesys import FileInfo, FileSystem, URI
from dmlc_tpu_torch.io.stream import SeekStream, Stream
from dmlc_tpu_torch.utils.logging import check

__all__ = ["CUDAFileSystem", "CUDASeekStream", "CUDAWriteStream",
           "local_path", "recordio_device_batches"]

_SCHEME = "cuda://"


def _inner_path(uri: URI) -> str:
    """cuda:///abs/x -> /abs/x ; cuda://rel/x -> rel/x."""
    return uri.host + uri.name


def local_path(uri: str) -> str:
    """Map a (possibly cuda://) URI to its backing local path — the one
    scheme-strip rule, shared by the native bindings, the page store's
    stat and the device ingest helpers."""
    if uri.startswith(_SCHEME):
        return _inner_path(URI(uri))
    return uri


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def _device_put_safe(arrays: Dict[str, np.ndarray], device: torch.device,
                     recycled: bool, stream=None
                     ) -> Tuple[Dict[str, torch.Tensor], Optional[object]]:
    """Copy host arrays to ``device``, with the CPU alias rule in ONE
    place: ``torch.from_numpy(buf).to("cpu")`` is the same storage, so a
    source that is recycled or overwritten later (a pooled staging
    buffer, a leased native arena) is cloned when the target is the CPU.
    A copy to the card always copies: it is enqueued on ``stream`` (the
    current stream by default), and the returned event follows the last
    copy; the host source must stay untouched until it completes. The
    tensors are safe on the caller's current stream (it waits on the
    event, and the allocator will not reuse their memory before that
    stream is done with them). Returns (tensors, event or None)."""
    srcs = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}
    if device.type != "cuda":
        return ({k: v.clone() for k, v in srcs.items()} if recycled
                else srcs), None
    consumer = torch.cuda.current_stream(device)
    stream = consumer if stream is None else stream
    with torch.cuda.stream(stream):
        out = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
               for k, v in srcs.items()}
        for k, v in srcs.items():
            out[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    if stream is not consumer:
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
    return out, event


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def _side_stream(device: torch.device):
    """A stream for the copies of one device iterator (None on the
    CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class CUDASeekStream(SeekStream):
    """SeekStream over host bytes + the device-chunk staging API."""

    def __init__(self, inner: SeekStream, path: str):
        self._inner = inner
        self.path = path

    # -- plain SeekStream (host bytes)

    def read(self, nbytes: int) -> bytes:
        return self._inner.read(nbytes)

    def write(self, data) -> int:  # pragma: no cover - read stream
        return self._inner.write(data)

    def seek(self, pos: int) -> None:
        self._inner.seek(pos)

    def tell(self) -> int:
        return self._inner.tell()

    def close(self) -> None:
        self._inner.close()

    # -- device staging

    def read_to_device(self, nbytes: int, device=None):
        """Read up to nbytes from the current position into a uint8
        tensor on ``device`` (the card by default); None at EOF.

        On the card the bytes are read in place into a fresh page-locked
        buffer and copied asynchronously (torch keeps that buffer until
        the copy is done), so the call does not wait for the copy. On
        the CPU the tensor is the owned read buffer itself. Unlike
        ``device_chunks`` this one-shot call does not pool: its staging
        buffer's lifetime escapes the call."""
        dev = _device(device)
        if dev.type == "cuda":
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        else:
            host = torch.empty(nbytes, dtype=torch.uint8)
        got = self._inner.readinto(memoryview(host.numpy()))
        if not got:
            return None
        return host[:got].to(dev, non_blocking=True)

    def device_chunks(self, chunk_bytes: int = 4 << 20, lookahead: int = 2,
                      device=None, pool=None) -> Iterator[torch.Tensor]:
        """Iterate the stream as uint8 chunks on ``device`` (the card by
        default) with ``lookahead`` copies in flight (read/copy overlap).

        Each chunk is read in place (``readinto``) into a buffer of a
        ring of REUSED host buffers (``utils.memory.BufferPool``; by
        default the thread's pool, page-locked when the target is the
        card) and copied on a side stream with an event behind it; a
        buffer returns to the pool only once its event has completed.
        On the CPU the staged view is cloned (the alias rule of
        ``_device_put_safe``). The 4 MB default is the reference's; the
        card's chunk sweep is in PERF.md (chip_smoke's ``cuda_ingest``).
        """
        from dmlc_tpu_torch.utils.memory import thread_local_pool
        check(lookahead >= 1, "lookahead must be >= 1")
        dev = _device(device)
        if pool is None:
            pool = thread_local_pool(pin=dev.type == "cuda")
        stream = _side_stream(dev)
        pending: List = []  # (chunk, event, staging buffer to recycle)
        eof = False
        try:
            while True:
                while not eof and len(pending) < lookahead:
                    buf = pool.acquire(chunk_bytes)
                    got = self._inner.readinto(
                        memoryview(buf)[:chunk_bytes])
                    if not got:
                        pool.release(buf)
                        eof = True
                        break
                    put, event = _device_put_safe(
                        {"chunk": buf[:got]}, dev, recycled=True,
                        stream=stream)
                    pending.append((put["chunk"], event, buf))
                if not pending:
                    return
                chunk, event, buf = pending.pop(0)
                _wait(event)  # copy done: buf reusable
                pool.release(buf)
                yield chunk
        finally:
            # the consumer abandoned the generator (break/close/GC) with
            # copies still in flight: drain them before releasing the
            # staging buffers, or the pool could hand a buffer that a
            # copy is still reading to the next reader
            for _, event, buf in pending:
                _wait(event)
                pool.release(buf)


class CUDAWriteStream(Stream):
    """Write stream accepting bytes, numpy arrays or tensors (a device
    tensor is pulled to the host once — the checkpoint-write
    direction)."""

    def __init__(self, inner: Stream, path: str):
        self._inner = inner
        self.path = path

    def write(self, data) -> int:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().contiguous().numpy().tobytes()
        elif not isinstance(data, (bytes, bytearray, memoryview)):
            data = np.asarray(data).tobytes()
        return self._inner.write(data)

    def read(self, nbytes: int) -> bytes:  # pragma: no cover - write stream
        return self._inner.read(nbytes)

    def close(self) -> None:
        self._inner.close()


class CUDAFileSystem(FileSystem):
    """cuda:// scheme: local VFS metadata + device-staging streams."""

    def _local(self) -> FileSystem:
        return FileSystem.get_instance(URI("/"))

    def open(self, uri: URI, mode: str) -> Stream:
        path = _inner_path(uri)
        inner = self._local().open(URI(path), mode)
        if mode == "r":
            return CUDASeekStream(inner, path)
        return CUDAWriteStream(inner, path)

    def open_for_read(self, uri: URI) -> CUDASeekStream:
        path = _inner_path(uri)
        return CUDASeekStream(self._local().open_for_read(URI(path)), path)

    def get_path_info(self, uri: URI) -> FileInfo:
        info = self._local().get_path_info(URI(_inner_path(uri)))
        return FileInfo(path=_SCHEME + info.path, size=info.size,
                        type=info.type)

    def list_directory(self, uri: URI) -> List[FileInfo]:
        return [FileInfo(path=_SCHEME + fi.path, size=fi.size, type=fi.type)
                for fi in self._local().list_directory(URI(_inner_path(uri)))]


def recordio_device_batches(uri: str, part_index: int = 0,
                            num_parts: int = 1, *,
                            chunk_size: int = 4 << 20, lookahead: int = 2,
                            device=None) -> Iterator[dict]:
    """Sharded RecordIO ingest straight to device memory.

    Yields dicts {"payload": u8, "starts": i64, "ends": i64} of tensors
    on ``device`` (the card by default); record i is
    ``payload[starts[i]:ends[i]]``. With the native engine each batch is
    one engine chunk's records, copied from its leased arena on a side
    stream; the lease is released only after its copy's event completes
    (on early close too), and ``lookahead`` batches' copies overlap the
    next chunk's read and decode. Without the engine, the Python
    recordio split gives one batch a chunk. Accepts plain or cuda://
    URIs (the scheme is stripped for the byte source).
    """
    from dmlc_tpu_torch.native import native_available
    uri = local_path(uri)
    check(lookahead >= 1, "lookahead must be >= 1")
    dev = _device(device)
    stream = _side_stream(dev)
    pending: List = []  # (device batch, event, lease or None)

    def pop():
        out, event, lease = pending.pop(0)
        _wait(event)
        if lease is not None:
            lease.release()
        return out

    if native_available():
        from dmlc_tpu_torch.native.bindings import NativeRecordIOReader
        reader = NativeRecordIOReader(uri, part_index, num_parts,
                                      chunk_size=chunk_size)
        try:
            while True:
                batch = reader.next_batch()
                if batch is None:
                    break
                data, starts, ends = batch
                # leased arenas are recycled on release: the alias rule
                put, event = _device_put_safe(
                    {"payload": data, "starts": starts, "ends": ends}, dev,
                    recycled=True, stream=stream)
                pending.append((put, event, reader.detach()))
                if len(pending) > lookahead:
                    yield pop()
            while pending:
                yield pop()
        finally:
            # early close/exception: copies in flight still read the
            # leased arenas — drain them before destroy frees them
            while pending:
                pop()
            reader.destroy()
        return
    from dmlc_tpu_torch.io.input_split import InputSplit
    split = InputSplit.create(uri, part_index, num_parts, "recordio",
                              chunk_size=chunk_size)
    while True:
        chunk = split.next_chunk()
        if chunk is None:
            break
        records = list(split.extract_records(chunk))
        if not records:
            continue
        payload = np.frombuffer(bytearray(b"".join(records)), np.uint8)
        ends = np.cumsum([len(r) for r in records], dtype=np.int64)
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        # owned buffers, never recycled
        put, event = _device_put_safe(
            {"payload": payload, "starts": starts, "ends": ends}, dev,
            recycled=False, stream=stream)
        pending.append((put, event, None))
        if len(pending) > lookahead:
            yield pop()
    while pending:
        yield pop()


FileSystem.register_scheme(_SCHEME, CUDAFileSystem)
