"""The port's ``cuda://`` scheme (``dmlc_tpu_torch/io/cuda_fs.py``)
against the reference's ``tpu://`` (``dmlc_tpu/io/tpu_fs.py``) on JAX's
CPU device, the port with ``device="cpu"``: the stream contract, and the
bytes, records and spans that ``read_to_device``, ``device_chunks`` and
``recordio_device_batches`` return. Inputs come from a seeded numpy
generator; every comparison is exact (bytes), so no tolerance applies.
Also the CPU alias rule (a recycled staging buffer overwritten after its
chunk was yielded leaves the chunk as it was) and the drain on early
close."""

import os

import jax
import numpy as np
import pytest
import torch

from dmlc_tpu.io import create_stream as ref_create_stream
from dmlc_tpu.io import tpu_fs
from dmlc_tpu_torch.io import cuda_fs
from dmlc_tpu_torch.io.filesys import FileSystem, URI
from dmlc_tpu_torch.io.recordio import RECORDIO_MAGIC, RecordIOWriter
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.native import bindings, native_available
from dmlc_tpu_torch.utils.memory import BufferPool

CPU = torch.device("cpu")
MAGIC = RECORDIO_MAGIC.to_bytes(4, "little")


@pytest.fixture
def payload_file(tmp_path):
    p = tmp_path / "blob.bin"
    data = np.random.RandomState(5).bytes(300_001)
    p.write_bytes(data)
    return str(p), data


@pytest.fixture
def rec_file(tmp_path):
    rng = np.random.RandomState(42)
    recs = []
    for i in range(300):
        r = bytearray(rng.bytes(int(rng.randint(1, 5000))))
        if i % 11 == 0 and len(r) >= 8:
            r[4:8] = MAGIC  # escaped: a multi-frame record
        recs.append(bytes(r))
    p = tmp_path / "x.rec"
    with open(p, "wb") as fh:
        w = RecordIOWriter(fh)
        for r in recs:
            w.write_record(r)
    return str(p), recs


@pytest.fixture
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")


def _bytes(t):
    return np.asarray(t).tobytes()


def test_scheme_registered_on_import():
    import dmlc_tpu_torch  # noqa: F401
    assert FileSystem._schemes["cuda://"] is cuda_fs.CUDAFileSystem


def test_import_registers_without_touching_a_device():
    """In a fresh interpreter: ``import dmlc_tpu_torch`` registers
    ``cuda://`` and the RecordIO formats, initialises no CUDA, and
    imports neither jax nor dmlc_tpu."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch, dmlc_tpu_torch\n"
            "from dmlc_tpu_torch.io.filesys import FileSystem\n"
            "from dmlc_tpu_torch.data.parser import PARSER_REGISTRY\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'dmlc_tpu'))\n"
            "ok = ('cuda://' in FileSystem._schemes\n"
            "      and PARSER_REGISTRY.find('recordio_dense') is not None\n"
            "      and PARSER_REGISTRY.find('recordio_image') is not None)\n"
            "print(bad, torch.cuda.is_initialized(), ok)\n"
            "sys.exit(0 if ok and not bad\n"
            "         and not torch.cuda.is_initialized() else 1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_create_read_seek(payload_file):
    path, data = payload_file
    port = create_stream(f"cuda://{path}", "r")
    ref = ref_create_stream(f"tpu://{path}", "r")
    assert isinstance(port, cuda_fs.CUDASeekStream)
    for s in (port, ref):
        assert s.read(16) == data[:16]
        s.seek(1000)
        assert s.tell() == 1000
        assert s.read(8) == data[1000:1008]
        s.seek(len(data) - 4)
        assert s.read(100) == data[-4:]
        s.close()


def test_open_for_read_and_relative_uri(payload_file, monkeypatch):
    path, data = payload_file
    monkeypatch.chdir(os.path.dirname(path))
    name = os.path.basename(path)
    for uri in (f"cuda://{path}", f"cuda://{name}"):
        u = URI(uri)
        s = FileSystem.get_instance(u).open_for_read(u)
        assert s.read_all() == data
        s.close()
    assert cuda_fs.local_path(f"cuda://{name}") == \
        tpu_fs.local_path(f"tpu://{name}") == name
    assert cuda_fs.local_path(path) == path


def test_write_roundtrip(tmp_path):
    p, q = tmp_path / "port.bin", tmp_path / "ref.bin"
    with create_stream(f"cuda://{p}", "w") as s:
        assert isinstance(s, cuda_fs.CUDAWriteStream)
        s.write(b"host-bytes;")
        s.write(np.arange(4, dtype=np.uint8))
        s.write(torch.arange(4, dtype=torch.uint8))
        s.write(torch.arange(3, dtype=torch.float32))
    with ref_create_stream(f"tpu://{q}", "w") as s:
        s.write(b"host-bytes;")
        s.write(np.arange(4, dtype=np.uint8))
        s.write(jax.numpy.arange(4, dtype=jax.numpy.uint8))
        s.write(jax.numpy.arange(3, dtype=jax.numpy.float32))
    assert p.read_bytes() == q.read_bytes()


def test_path_info_and_listing(payload_file, tmp_path):
    path, data = payload_file
    fs = FileSystem.get_instance(URI(f"cuda://{path}"))
    info = fs.get_path_info(URI(f"cuda://{path}"))
    ref = tpu_fs.TPUFileSystem().get_path_info(
        tpu_fs.URI(f"tpu://{path}"))
    assert info.size == ref.size == len(data)
    assert info.path == "cuda://" + path and info.type == "file"
    listing = fs.list_directory(URI(f"cuda://{tmp_path}"))
    assert [fi.path for fi in listing] == [
        "cuda://" + fi.path[len("tpu://"):]
        for fi in tpu_fs.TPUFileSystem().list_directory(
            tpu_fs.URI(f"tpu://{tmp_path}"))]


def test_stat_uri_maps_the_scheme(payload_file):
    from dmlc_tpu_torch.io.pagestore import stat_uri
    path, _ = payload_file
    assert stat_uri(f"cuda://{path}") == stat_uri(path)
    st = os.stat(path)
    assert stat_uri(f"cuda://{path}")[:2] == (st.st_size, st.st_mtime_ns)


def test_read_to_device(payload_file):
    path, data = payload_file
    port = create_stream(f"cuda://{path}", "r")
    ref = ref_create_stream(f"tpu://{path}", "r")
    for n in (4096, 1, 200_000, 200_000):
        got = port.read_to_device(n, device="cpu")
        want = ref.read_to_device(n, device=jax.devices("cpu")[0])
        assert got.dtype == torch.uint8 and got.device == CPU
        assert _bytes(got) == _bytes(want)
        assert port.tell() == ref.tell()
    assert port.read_to_device(10, device="cpu") is None
    assert ref.read_to_device(10) is None
    port.close()
    ref.close()


def test_entry_points_default_to_the_card(payload_file, rec_file):
    """Without ``device=`` they target ``cuda``: on a host without a card
    they raise, never fall back to the CPU."""
    path, _ = payload_file
    s = create_stream(f"cuda://{path}", "r")
    with pytest.raises((RuntimeError, AssertionError)):
        s.read_to_device(16)
    with pytest.raises((RuntimeError, AssertionError)):
        next(s.device_chunks(1 << 16))
    s.close()
    with pytest.raises((RuntimeError, AssertionError)):
        next(cuda_fs.recordio_device_batches(rec_file[0]))


@pytest.mark.parametrize("chunk", [30_000, 1 << 16, 1 << 20])
@pytest.mark.parametrize("lookahead", [1, 3])
def test_device_chunks_match_reference(payload_file, chunk, lookahead):
    path, data = payload_file
    port = create_stream(f"cuda://{path}", "r")
    ref = ref_create_stream(f"tpu://{path}", "r")
    got = [_bytes(c) for c in port.device_chunks(chunk, lookahead,
                                                 device="cpu")]
    want = [_bytes(c) for c in ref.device_chunks(chunk, lookahead)]
    assert got == want
    assert b"".join(got) == data
    port.close()
    ref.close()


def test_device_chunks_alias_rule(payload_file):
    """On the CPU each yielded chunk is a copy: overwriting every pooled
    buffer (the recycled staging) after the yield changes no chunk."""
    path, data = payload_file
    pool = BufferPool()
    s = create_stream(f"cuda://{path}", "r")
    chunks = []
    for c in s.device_chunks(1 << 16, 2, device="cpu", pool=pool):
        chunks.append(c)
        for bucket in pool._free.values():
            for buf in bucket:
                buf[:] = 0xFF
    assert pool.reused > 0  # the staging buffers were recycled
    assert b"".join(_bytes(c) for c in chunks) == data
    s.close()


def test_device_chunks_early_close_drains(payload_file):
    path, data = payload_file
    pool = BufferPool()
    s = create_stream(f"cuda://{path}", "r")
    it = s.device_chunks(1 << 16, 3, device="cpu", pool=pool)
    first = next(it)
    it.close()  # GeneratorExit -> finally: the in-flight buffers return
    assert _bytes(first) == data[:1 << 16]
    assert sum(len(b) for b in pool._free.values()) == 3
    s.close()


def _records(batches):
    out, spans = [], []
    for b in batches:
        payload = np.asarray(b["payload"])
        starts, ends = np.asarray(b["starts"]), np.asarray(b["ends"])
        spans.append((starts.tolist(), ends.tolist()))
        out += [payload[s:e].tobytes() for s, e in zip(starts, ends)]
    return out, spans


@pytest.mark.parametrize("parts", [1, 3])
def test_recordio_device_batches_match_reference(rec_file, parts, native):
    path, recs = rec_file
    got_all = []
    for k in range(parts):
        got = _records(cuda_fs.recordio_device_batches(
            f"cuda://{path}", k, parts, chunk_size=1 << 16, device="cpu"))
        want = _records(tpu_fs.recordio_device_batches(
            f"tpu://{path}", k, parts, chunk_size=1 << 16))
        assert got == want
        for b in cuda_fs.recordio_device_batches(path, k, parts,
                                                 chunk_size=1 << 16,
                                                 device="cpu"):
            assert b["payload"].dtype == torch.uint8
            assert b["starts"].dtype == b["ends"].dtype == torch.int64
            assert b["payload"].device == CPU
        got_all += got[0]
    assert got_all == recs


def test_recordio_device_batches_python_split(rec_file, monkeypatch):
    """Without the engine, the recordio split: one batch a chunk, the
    same records and spans as the reference's fallback."""
    path, recs = rec_file
    monkeypatch.setattr("dmlc_tpu_torch.native.native_available",
                        lambda: False)
    monkeypatch.setattr("dmlc_tpu.native.native_available", lambda: False)
    got = _records(cuda_fs.recordio_device_batches(
        path, chunk_size=1 << 16, lookahead=1, device="cpu"))
    want = _records(tpu_fs.recordio_device_batches(
        path, chunk_size=1 << 16, lookahead=1))
    assert got == want and got[0] == recs and len(got[1]) > 3


def test_recordio_device_batches_alias_rule(rec_file, native):
    """The native batches are copied out of their leased arenas: after
    every later batch (and the reader's reuse of those arenas) the
    first batch still holds its records."""
    path, recs = rec_file
    batches = list(cuda_fs.recordio_device_batches(
        path, chunk_size=1 << 16, lookahead=1, device="cpu"))
    assert len(batches) > 3
    assert _records(batches)[0] == recs


class _CountingReader(bindings.NativeRecordIOReader):
    leases, released, destroyed = [], [], []

    def detach(self):
        lease = super().detach()
        type(self).leases.append(lease)
        return lease

    def destroy(self):
        if getattr(self, "_handle", None):
            type(self).released.append(
                sum(lease._ptr is None for lease in type(self).leases))
            type(self).destroyed.append(True)
        super().destroy()


def test_recordio_device_batches_early_close_drains(rec_file, monkeypatch,
                                                    native):
    """Closed after the first batch with copies in flight: every lease
    taken is released before the reader is destroyed."""
    path, recs = rec_file
    monkeypatch.setattr(bindings, "NativeRecordIOReader", _CountingReader)
    it = cuda_fs.recordio_device_batches(path, chunk_size=1 << 16,
                                         lookahead=2, device="cpu")
    first = next(it)
    got = _records([first])[0]
    it.close()
    assert got == recs[:len(got)]
    assert len(_CountingReader.leases) == 3  # lookahead + the yielded one
    assert _CountingReader.released == [3] and _CountingReader.destroyed


def test_lookahead_must_be_positive(payload_file):
    path, _ = payload_file
    s = create_stream(f"cuda://{path}", "r")
    with pytest.raises(Exception, match="lookahead"):
        next(s.device_chunks(1 << 16, 0, device="cpu"))
    with pytest.raises(Exception, match="lookahead"):
        next(cuda_fs.recordio_device_batches(path, lookahead=0,
                                             device="cpu"))
    s.close()
