"""The port's RecordIO plane against the JAX package's.

The port keeps its own copies of the frame codec and its writers
(``io/recordio.py``), the recordio split (``io/input_split.py``), the
native record reader and the dense and image record parsers. Files must
be byte-identical and each package must read the other's; record streams,
``RowBlock.content_hash()`` and padded batches must equal the
reference's, whole, by part and sharded, escaped multi-frame records and
records that straddle a chunk boundary included. Inputs are drawn from a
seeded numpy generator; every comparison here is exact (bytes), so no
tolerance applies.
"""

import hashlib
import struct

import numpy as np
import pytest

from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.io import input_split as ref_split
from dmlc_tpu.io import recordio as ref_rio
from dmlc_tpu.io.stream import create_stream as ref_create_stream
from dmlc_tpu.native import bindings as ref_bindings
from dmlc_tpu.native import native_available as ref_native_available
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.io import recordio as rio
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.native import bindings
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError

MAGIC = struct.pack("<I", rio.RECORDIO_MAGIC)
MAGIC_F32 = np.frombuffer(MAGIC, "<f4")[0]
SMALL_CHUNK = 64 << 10  # the split's least chunk: records straddle it


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")
    if not ref_native_available():
        pytest.fail("the reference package's native engine did not build")
    return True


def _raw_records(seed=0, count=400, most=6000):
    """Binary records of 0..most bytes; every 9th carries the magic at
    a 4-aligned offset (an escaped multi-frame record), every 13th at an
    unaligned one, and one is the magic twice in a row."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        rec = bytearray(rng.bytes(int(rng.randint(0, most))))
        if i % 9 == 0 and len(rec) >= 12:
            rec[8:12] = MAGIC
        if i % 13 == 0 and len(rec) >= 7:
            rec[3:7] = MAGIC
        out.append(bytes(rec))
    out.append(MAGIC * 2)
    return out


def _dense_rows(seed=0, rows=600):
    """Ragged dense rows (0-39 values, zero-length rows included); every
    17th carries a value whose f32 bits are the frame magic."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(rows):
        vals = rng.standard_normal(int(rng.randint(0, 40))).astype(np.float32)
        if i % 17 == 0 and vals.size >= 3:
            vals[1] = MAGIC_F32
        out.append((float(i % 5) - 2.0, vals))
    return out


def _images(seed=0, records=200, shape=(8, 10, 3)):
    """Uniform HWC u8 images; every 13th spells the magic at a 4-aligned
    pixel offset (the 16-byte header keeps it 4-aligned)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(records):
        px = rng.randint(0, 256, shape).astype(np.uint8)
        if i % 13 == 0:
            px.reshape(-1)[4:8] = np.frombuffer(MAGIC, np.uint8)
        out.append((float(i % 7) - 3.0, px))
    return out


def _write(path, kind, mod, create):
    """Write ``kind``'s corpus with package ``mod``'s writer."""
    with create(str(path), "w") as s:
        if kind == "frames":
            w = mod.RecordIOWriter(s)
            for r in _raw_records():
                w.write_record(r)
        elif kind == "dense":
            w = mod.DenseRecordWriter(s)
            for label, vals in _dense_rows():
                w.write(label, vals)
        elif kind == "image":
            w = mod.ImageRecordWriter(s)
            for label, px in _images():
                w.write(label, px)
        else:  # indexed: keys given and automatic
            with create(str(path) + ".idx", "w") as ix:
                w = mod.IndexedRecordIOWriter(s, ix)
                for i, r in enumerate(_raw_records(seed=1, count=60)):
                    w.write_record(r, key=None if i % 2 else 1000 + i)
    return w.escaped_magic_count


@pytest.mark.parametrize("kind", ["frames", "dense", "image", "indexed"])
def test_writers_are_byte_identical(tmp_path, kind):
    a, b = tmp_path / "port.rec", tmp_path / "ref.rec"
    escaped = _write(a, kind, rio, create_stream)
    assert escaped == _write(b, kind, ref_rio, ref_create_stream)
    assert escaped > 0  # the multi-frame path is in the file
    assert a.read_bytes() == b.read_bytes()
    if kind == "indexed":
        assert (tmp_path / "port.rec.idx").read_bytes() == \
            (tmp_path / "ref.rec.idx").read_bytes()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_the_others_frames(tmp_path, writer):
    path = tmp_path / "x.rec"
    if writer == "port":
        _write(path, "frames", rio, create_stream)
    else:
        _write(path, "frames", ref_rio, ref_create_stream)
    want = _raw_records()
    for mod, create in ((rio, create_stream), (ref_rio, ref_create_stream)):
        with create(str(path), "r") as s:
            r = mod.RecordIOReader(s)
            got = list(iter(r.next_record, None))
        assert got == want
        chunk = path.read_bytes()
        assert list(mod.RecordIOChunkReader(chunk)) == want


def test_payload_codecs_match_reference():
    for label, vals in _dense_rows(seed=3, rows=50):
        p = rio.encode_dense_record(label, vals)
        assert p == ref_rio.encode_dense_record(label, vals)
        got, want = rio.decode_dense_record(p), ref_rio.decode_dense_record(p)
        assert got[0] == want[0] and got[1].tobytes() == want[1].tobytes()
    for label, px in _images(seed=3, records=20, shape=(5, 3, 2)):
        p = rio.encode_image_record(label, px)
        assert p == ref_rio.encode_image_record(label, px)
        got = rio.decode_image_record(p)
        assert got[0] == np.float32(label)
        assert np.array_equal(got[1], ref_rio.decode_image_record(p)[1])
    assert rio.encode_image_record(1.0, np.zeros((2, 3), np.uint8)) == \
        ref_rio.encode_image_record(1.0, np.zeros((2, 3), np.uint8))
    for a, b in ((rio.encode_lrec(3, 77), ref_rio.encode_lrec(3, 77)),
                 (rio.decode_flag(0x7fffffff), ref_rio.decode_flag(0x7fffffff)),
                 (rio.decode_length(0x7fffffff),
                  ref_rio.decode_length(0x7fffffff))):
        assert a == b


@pytest.mark.parametrize("payload,match", [
    (struct.pack("<If", 2, 1.0) + b"\0" * 4, "disagrees"),
    (struct.pack("<If", 2, 1.0) + b"\0" * 12, "disagrees"),
    (b"\0" * 4, "shorter"),
])
def test_dense_payload_length_contract(payload, match):
    for mod in (rio, ref_rio):
        with pytest.raises(Exception, match=match):
            mod.decode_dense_record(payload)


def test_image_payload_length_contract():
    good = rio.encode_image_record(0.0, np.zeros((2, 2, 1), np.uint8))
    for bad, match in ((good[:-1], "disagrees"), (good + b"\0", "disagrees"),
                       (good[:8], "shorter")):
        with pytest.raises(DMLCError, match=match):
            rio.decode_image_record(bad)


def test_truncated_frames_raise(tmp_path):
    path = tmp_path / "t.rec"
    _write(path, "frames", rio, create_stream)
    raw = path.read_bytes()
    with pytest.raises(DMLCError):
        list(rio.RecordIOChunkReader(raw[:-5]))
    with pytest.raises(DMLCError, match="magic"):
        list(rio.RecordIOChunkReader(b"\1\2\3\4" + raw[4:]))


def _split_records(mod_split, uri, part, parts, chunk_size=SMALL_CHUNK):
    return list(mod_split.InputSplit.create(uri, part, parts, "recordio",
                                            chunk_size=chunk_size))


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_recordio_split_matches_reference(tmp_path, parts):
    """Each part k of n gives the reference's record stream (64 KB
    chunks, records up to 6 KB: records straddle chunks), and the parts
    concatenate to every record written."""
    path = tmp_path / "x.rec"
    _write(path, "frames", rio, create_stream)
    from dmlc_tpu_torch.io import input_split as port_split
    got = []
    for k in range(parts):
        mine = _split_records(port_split, str(path), k, parts)
        assert mine == _split_records(ref_split, str(path), k, parts)
        got += mine
    assert got == _raw_records()


def test_recordio_split_over_several_files(tmp_path):
    """A ';'-joined multi-file URI: parts cut across file boundaries."""
    paths = []
    for j in range(3):
        p = tmp_path / f"f{j}.rec"
        with create_stream(str(p), "w") as s:
            w = rio.RecordIOWriter(s)
            for r in _raw_records(seed=10 + j, count=80):
                w.write_record(r)
        paths.append(str(p))
    uri = ";".join(paths)
    from dmlc_tpu_torch.io import input_split as port_split
    for k in range(5):
        assert _split_records(port_split, uri, k, 5) == \
            _split_records(ref_split, uri, k, 5)


def test_recordio_split_chunks_and_rewind(tmp_path):
    path = tmp_path / "x.rec"
    _write(path, "frames", rio, create_stream)
    split = InputSplit.create(str(path), 0, 1, "recordio",
                              chunk_size=SMALL_CHUNK)
    ref = ref_split.InputSplit.create(str(path), 0, 1, "recordio",
                                      chunk_size=SMALL_CHUNK)
    chunks = list(iter(split.next_chunk, None))
    assert chunks == list(iter(ref.next_chunk, None))
    assert len(chunks) > 3
    assert split.bytes_read == ref.bytes_read == path.stat().st_size
    split.before_first()
    assert split.next_batch(7) == _raw_records()[:7]


def _native_records(cls, uri, part, parts, chunk_size):
    r = cls(uri, part, parts, chunk_size=chunk_size)
    try:
        return list(r.records()), r.get_total_size()
    finally:
        r.destroy()


@pytest.mark.parametrize("parts", [1, 3])
def test_native_record_reader_matches_reference(tmp_path, parts, native):
    path = tmp_path / "x.rec"
    _write(path, "frames", rio, create_stream)
    got = []
    for k in range(parts):
        mine = _native_records(bindings.NativeRecordIOReader, str(path), k,
                               parts, SMALL_CHUNK)
        assert mine == _native_records(ref_bindings.NativeRecordIOReader,
                                       str(path), k, parts, SMALL_CHUNK)
        got += mine[0]
    assert got == _raw_records()


def test_native_record_reader_batches_and_leases(tmp_path, native):
    """next_batch's views are valid until the next call; a detached
    lease keeps its batch alive past it."""
    path = tmp_path / "x.rec"
    _write(path, "frames", rio, create_stream)
    r = bindings.NativeRecordIOReader(f"cuda://{path}", chunk_size=SMALL_CHUNK)
    kept, got = [], []
    while True:
        batch = r.next_batch()
        if batch is None:
            break
        data, starts, ends = batch
        kept.append((data, starts, ends, r.detach()))
    for data, starts, ends, lease in kept:
        got += [data[s:e].tobytes() for s, e in zip(starts, ends)]
        lease.release()
    assert got == _raw_records() and len(kept) > 3
    assert r.bytes_read() == r.get_total_size() == path.stat().st_size
    assert r.stats()["chunks"] >= len(kept)
    r.destroy()


def _hash(parser, container_cls):
    c = container_cls(np.uint32)
    for block in parser:
        c.push_block(block)
    if hasattr(parser, "destroy"):
        parser.destroy()
    return c.get_block().content_hash()


FORMATS = {"recordio_dense": "dense", "recordio_image": "image"}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_record_parsers_content_hash(tmp_path, fmt, engine, native):
    path = tmp_path / "x.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    want = _hash(RefParser.create(str(path), format=fmt, engine="python"),
                 RefContainer)
    p = Parser.create(str(path), format=fmt, engine=engine)
    if engine == "native":
        assert type(p).__name__.startswith("Native")
    assert _hash(p, RowBlockContainer) == want


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_record_parsers_by_part(tmp_path, fmt, engine, native):
    """Parts 0-2 of 3 at 64 KB chunks: each part's hash is the
    reference's, the parts tile the file."""
    path = tmp_path / "x.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    whole = RowBlockContainer(np.uint32)
    for k in range(3):
        c = RowBlockContainer(np.uint32)
        p = Parser.create(str(path), k, 3, format=fmt, engine=engine,
                          chunk_size=SMALL_CHUNK)
        for block in p:
            c.push_block(block)
            whole.push_block(block)
        assert c.get_block().content_hash() == _hash(RefParser.create(
            str(path), k, 3, format=fmt, engine="python",
            chunk_size=SMALL_CHUNK), RefContainer)
    assert whole.get_block().content_hash() == _hash(
        RefParser.create(str(path), format=fmt, engine="python"),
        RefContainer)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_native_parse_matches_reference(tmp_path, fmt, shards,
                                                native):
    path = tmp_path / "x.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    p = Parser.create(str(path), format=fmt, engine="native", shards=shards,
                      chunk_size=SMALL_CHUNK)
    assert isinstance(p, bindings.NativeShardedTextParser)
    assert p.shards == shards
    want = _hash(RefParser.create(str(path), format=fmt, engine="native",
                                  shards=shards, chunk_size=SMALL_CHUNK),
                 RefContainer)
    assert _hash(p, RowBlockContainer) == want


def test_parsers_over_the_cuda_scheme(tmp_path, native):
    path = tmp_path / "x.rec"
    _write(path, "dense", rio, create_stream)
    want = _hash(Parser.create(str(path), format="recordio_dense",
                               engine="python"), RowBlockContainer)
    for engine in ("python", "native"):
        assert _hash(Parser.create(f"cuda://{path}", format="recordio_dense",
                                   engine=engine), RowBlockContainer) == want


def _padded(pipeline_cls, path, fmt, engine, rows, nnz_bucket, shards=None):
    """The chain's padded batches (copied out of their leases), its
    assembly path, and the parser's leases out after the epoch."""
    kw = {"shards": shards} if shards else {}
    built = (pipeline_cls.from_uri(str(path))
             .parse(format=fmt, engine=engine, **kw)
             .batch(rows, pad=True, nnz_bucket=nnz_bucket)
             .build())
    batches = [{k: np.array(v) for k, v in b.items()} for b in built]
    snap = built.stats()
    apath = next((x["assembly_path"] for s in snap["stages"]
                  if (x := s.get("extra") or {}).get("assembly_path")), None)
    parser = getattr(built._runners[0], "_parser", None)
    out = (int(parser.outstanding()) if hasattr(parser, "outstanding")
           else None)
    built.close()
    return batches, apath, out


def _same_batches(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("fmt,rows,nnz_bucket", [
    ("recordio_dense", 128, 128 * 40), ("recordio_image", 64, 64 * 240)])
@pytest.mark.parametrize("engine,shards", [
    ("python", None), ("native", None), ("native", 2)])
def test_padded_batches_match_reference(tmp_path, fmt, rows, nnz_bucket,
                                        engine, shards, native):
    path = tmp_path / "x.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    want, ref_path, _ = _padded(RefPipeline, path, fmt, "python", rows,
                                nnz_bucket)
    got, apath, out = _padded(Pipeline, path, fmt, engine, rows, nnz_bucket,
                              shards)
    _same_batches(got, want)
    assert ref_path == "python-fused"
    assert apath == ("python-fused" if engine == "python"
                     else "native-padded")
    if engine == "native":
        assert out == 0  # no lease out after the epoch


def test_image_batches_hold_the_pixels(tmp_path, native):
    path = tmp_path / "x.rec"
    _write(path, "image", rio, create_stream)
    got, _, _ = _padded(Pipeline, path, "recordio_image", "native", 64,
                        64 * 240)
    images = _images()
    first = got[0]
    px = first["value"].reshape(64, 8, 10, 3)
    assert np.array_equal(px, np.stack([p for _, p in images[:64]]))
    assert np.array_equal(first["label"],
                          np.float32([label for label, _ in images[:64]]))


@pytest.mark.parametrize("make", ["single", "gang"])
def test_outstanding_leak_probe(tmp_path, make, native):
    """After each padded cut the padded lease is the only live lease
    (the arenas recycle at the cut), and none after it is released."""
    path = tmp_path / "x.rec"
    _write(path, "dense", rio, create_stream)
    p = (bindings.NativeDenseRecordParser(str(path)) if make == "single"
         else bindings.NativeShardedTextParser(str(path), shards=3,
                                               format="recordio_dense"))
    batches = 0
    while True:
        b = p.next_padded(64, nnz_bucket=64 * 40)
        if b is None:
            break
        batches += 1
        assert p.outstanding() == 1
    assert batches > 1
    lease = p.detach()
    if lease is not None:
        lease.release()
    assert p.outstanding() == 0
    p.destroy()


def test_gang_mode_guard_and_restart(tmp_path, native):
    path = tmp_path / "x.rec"
    _write(path, "dense", rio, create_stream)
    p = bindings.NativeShardedTextParser(str(path), shards=2,
                                         format="recordio_dense")
    assert p.next()
    with pytest.raises(DMLCError, match="padded carry"):
        p.next_padded(64, nnz_bucket=64 * 40)

    def epoch():
        p.before_first()
        h = hashlib.sha256()
        while True:
            b = p.next_padded(64, nnz_bucket=64 * 40)
            if b is None:
                return h.hexdigest()
            for k in sorted(b):
                h.update(np.ascontiguousarray(b[k]).tobytes())

    assert epoch() == epoch()
    with pytest.raises(DMLCError, match="within one"):
        p.next()
    p.destroy()
    p.before_first()  # a no-op once destroyed
    assert not p.next() and p.outstanding() == 0


def _corrupt(path, fmt):
    with create_stream(str(path), "w") as s:
        w = rio.RecordIOWriter(s)
        if fmt == "recordio_dense":
            w.write_record(rio.encode_dense_record(1.0, [1.0]))
            w.write_record(struct.pack("<If", 7, 0.0))  # n=7, no values
        else:
            w.write_record(rio.encode_image_record(
                1.0, np.zeros((2, 2, 1), np.uint8)))
            w.write_record(struct.pack("<IIIf", 4, 4, 3, 0.0) + b"\0" * 5)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_corrupt_payload_raises(tmp_path, fmt, engine, native):
    path = tmp_path / "bad.rec"
    _corrupt(path, fmt)
    p = Parser.create(str(path), format=fmt, engine=engine)
    with pytest.raises(DMLCError, match="disagrees"):
        for _ in p:
            pass
    if hasattr(p, "destroy"):
        p.destroy()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("engine", ["python", "native"])
def test_truncated_file_raises(tmp_path, fmt, engine, native):
    path = tmp_path / "t.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    raw = path.read_bytes()
    path.write_bytes(raw[:-5])  # cut mid-frame
    p = Parser.create(str(path), format=fmt, engine=engine)
    with pytest.raises(DMLCError):
        for _ in p:
            pass
    if hasattr(p, "destroy"):
        p.destroy()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_split_type_guard(tmp_path, fmt, native):
    path = tmp_path / "x.rec"
    _write(path, FORMATS[fmt], rio, create_stream)
    with pytest.raises(DMLCError, match="split_type"):
        Parser.create(str(path), format=fmt, engine="python",
                      split_type="text")
    with pytest.raises(DMLCError, match="split_type"):
        Parser.create(str(path), format=fmt, engine="native",
                      split_type="text")
