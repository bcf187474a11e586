"""The Parquet formats of the port against the JAX package's.

``format="parquet"`` (the pyarrow golden) and ``format="parquet_native"``
(the engine's page decoder, ``engine="native"``) must give the
reference's RowBlocks bit for bit (values compared as raw bits, so NaN
nulls take part): i32/i64/f32/f64 columns with nulls, PLAIN and
dictionary pages, UNCOMPRESSED, SNAPPY and GZIP, a weight column, part
splits by the shared row-group rule, ``shards=2/4``, the padded batches,
and the named create refusals (sparse, a zstd codec, V2 pages, a string
column, a missing label). ``chip_smoke.write_parquet``, the pyarrow-free
writer the card's run uses, is held here to pyarrow and to both
packages' parsers.
"""

import hashlib
import os
import sys

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from dmlc_tpu.data.padding import pad_single as ref_pad_single  # noqa: E402
from dmlc_tpu.data.parquet_parser import ParquetParser as RefGolden  # noqa: E402
from dmlc_tpu.data.parser import Parser as RefParser  # noqa: E402
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer  # noqa: E402
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError  # noqa: E402
from dmlc_tpu_torch.data.parquet_parser import ParquetParser  # noqa: E402
from dmlc_tpu_torch.data.parser import Parser  # noqa: E402
from dmlc_tpu_torch.data.rowblock import RowBlockContainer  # noqa: E402
from dmlc_tpu_torch.native import bindings, native_available  # noqa: E402
from dmlc_tpu_torch.pipeline import Pipeline  # noqa: E402
from dmlc_tpu_torch.utils.logging import DMLCError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")
    return True


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as c
    finally:
        sys.path.remove(REPO)
    return c


def _with_nulls(rng, arr, frac=0.15):
    m = rng.rand(len(arr)) < frac
    a = arr.astype(object)
    a[m] = None
    return pa.array(list(a), type=pa.from_numpy_dtype(arr.dtype))


def _mixed_table(seed=0, n=3000, nulls=True):
    rng = np.random.RandomState(seed)
    wrap = (lambda a: _with_nulls(rng, a)) if nulls else pa.array
    return pa.table({
        "label": pa.array(rng.rand(n).astype(np.float32)),
        "f0": wrap(rng.rand(n).astype(np.float32)),
        "f1": wrap(rng.randn(n).astype(np.float64)),
        "i0": wrap(rng.randint(-1000, 1000, n).astype(np.int32)),
        "i1": wrap((rng.randint(0, 2 ** 62, n) - 2 ** 61).astype(np.int64)),
        "w": pa.array(rng.rand(n).astype(np.float32)),
    })


def _drain(parser_cls, container_cls, path, engine, k=0, n=1,
           fmt="parquet_native", **kw):
    c = container_cls(np.uint32)
    p = parser_cls.create(path, k, n, format=fmt, engine=engine,
                          label_column="label", **kw)
    for b in p:
        c.push_block(b)
    p.destroy()
    return c.get_block()


def _port(path, engine, **kw):
    return _drain(Parser, RowBlockContainer, path, engine, **kw)


def _ref(path, engine="python", **kw):
    return _drain(RefParser, RefContainer, path, engine, **kw)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_blocks_equal(a, b):
    assert a.size == b.size
    for k in ("offset", "label", "index", "value"):
        x, y = _bits(getattr(a, k)), _bits(getattr(b, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert (a.weight is None) == (b.weight is None)
    if a.weight is not None:
        assert np.array_equal(_bits(a.weight), _bits(b.weight))


@pytest.mark.parametrize("compression,use_dict,nulls", [
    ("NONE", False, False), ("NONE", True, True), ("GZIP", False, True),
    ("GZIP", True, False), ("SNAPPY", False, True), ("SNAPPY", True, True),
])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_blocks_match_reference(tmp_path, compression, use_dict, nulls,
                                engine, native):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_mixed_table(nulls=nulls), path, row_group_size=700,
                   compression=compression, use_dictionary=use_dict)
    p = Parser.create(path, format="parquet_native", engine=engine,
                      label_column="label")
    assert isinstance(p, bindings.NativeParquetParser) == (
        engine == "native")
    p.destroy()
    got = _port(path, engine)
    assert got.size == 3000
    _assert_blocks_equal(got, _ref(path))
    _assert_blocks_equal(got, _ref(path, "native"))


@pytest.mark.parametrize("engine", ["python", "native"])
def test_golden_format_and_weight_column(tmp_path, engine, native):
    path = str(tmp_path / "w.parquet")
    pq.write_table(_mixed_table(seed=1, n=500, nulls=False), path,
                   compression="NONE")
    fmt = "parquet" if engine == "python" else "parquet_native"
    got = _port(path, engine, fmt=fmt, weight_column="w")
    assert got.weight is not None
    _assert_blocks_equal(got, _ref(path, fmt="parquet", weight_column="w"))


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("part", range(4))
def test_part_splits_match_reference(tmp_path, engine, part, native):
    """Part ``part`` of 4 by the row-group byte rule (_partition_groups,
    shared by the golden and the engine) holds the reference's rows, and
    the parts concatenate to the whole file in order."""
    path = str(tmp_path / "p.parquet")
    pq.write_table(_mixed_table(seed=2), path, row_group_size=400,
                   compression="NONE")
    got = _port(path, engine, k=part, n=4)
    _assert_blocks_equal(got, _ref(path, k=part, n=4))
    labels = [_port(path, engine, k=k, n=4).label for k in range(4)]
    np.testing.assert_array_equal(np.concatenate(labels),
                                  _ref(path).label)


def test_partition_groups_is_the_reference_rule(tmp_path):
    path = str(tmp_path / "g.parquet")
    pq.write_table(_mixed_table(seed=3), path, row_group_size=250,
                   compression="GZIP")
    files = [pq.ParquetFile(path)]
    entries = [(path, os.path.getsize(path))]
    for n in (1, 2, 3, 5):
        for k in range(n):
            assert (ParquetParser._partition_groups(files, entries, k, n)
                    == RefGolden._partition_groups(files, entries, k, n))


def _stream_hash(parser):
    h = hashlib.sha256()
    rows = 0
    for b in parser:
        h.update(np.diff(np.asarray(b.offset)).astype("<i8").tobytes())
        h.update(np.ascontiguousarray(b.label).tobytes())
        h.update(np.ascontiguousarray(b.index).astype("<u4").tobytes())
        h.update(np.ascontiguousarray(b.value).tobytes())
        rows += b.size
    assert parser.outstanding() <= 1
    parser.destroy()
    return h.hexdigest(), rows


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_equal_the_one_parser_stream(tmp_path, shards, native):
    path = str(tmp_path / "s.parquet")
    pq.write_table(_mixed_table(seed=4), path, row_group_size=300,
                   compression="NONE")
    kw = dict(format="parquet_native", engine="native",
              label_column="label")
    one = _stream_hash(Parser.create(path, **kw))
    sharded = Parser.create(path, shards=shards, **kw)
    assert isinstance(sharded, bindings.NativeShardedTextParser)
    assert _stream_hash(sharded) == one
    assert one[1] == 3000
    _assert_blocks_equal(_port(path, "native", shards=shards), _ref(path))


def test_leases_are_back_after_each_epoch(tmp_path, native):
    path = str(tmp_path / "l.parquet")
    pq.write_table(_mixed_table(seed=5, n=800), path, row_group_size=200,
                   compression="NONE")
    p = Parser.create(path, format="parquet_native", engine="native",
                      label_column="label")
    for _ in range(2):
        p.before_first()
        while p.next():
            pass
        assert p.outstanding() == 0
    assert p.bytes_read() > 0
    p.destroy()


def test_native_padded_batches_equal_pad_single(tmp_path, native):
    path = str(tmp_path / "pad.parquet")
    pq.write_table(_mixed_table(seed=6, n=1000), path, row_group_size=300,
                   compression="NONE")
    rows, nb = 128, 128 * 5
    ref = _ref(path)
    for shards in (None, 2):
        extra = {"shards": shards} if shards else {}
        p = Parser.create(path, format="parquet_native", engine="native",
                          label_column="label", **extra)
        got = []
        while True:
            b = p.next_padded(rows, nnz_bucket=nb)
            if b is None:
                break
            got.append({k: np.array(v) for k, v in b.items()})
        p.destroy()
        assert len(got) == 8
        for i, s in enumerate(range(0, ref.size, rows)):
            want = ref_pad_single(ref.slice(s, min(s + rows, ref.size)),
                                  rows, nb)
            assert sorted(got[i]) == sorted(want)
            for k in want:
                x, y = np.asarray(got[i][k]), np.asarray(want[k])
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def _simple(tmp_path, **write_kw):
    rng = np.random.RandomState(7)
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"label": pa.array(rng.rand(50)
                                                .astype(np.float32)),
                             "f0": pa.array(rng.rand(50)
                                            .astype(np.float32))}),
                   path, **write_kw)
    return path


def _string_file(tmp_path):
    path = str(tmp_path / "str.parquet")
    pq.write_table(pa.table({"label": pa.array([0.0, 1.0]),
                             "name": pa.array(["a", "b"])}), path,
                   compression="NONE")
    return path


REFUSALS = {
    "sparse": (lambda t: _simple(t, compression="NONE"), {"sparse": True},
               "sparse"),
    "zstd": (lambda t: _simple(t, compression="ZSTD"), {}, "codec"),
    "v2_pages": (lambda t: _simple(t, compression="NONE",
                                   data_page_version="2.0"), {}, "V2"),
    "string_column": (_string_file, {}, "physical type"),
    "missing_label": (lambda t: _simple(t, compression="NONE"),
                      {"label_column": "nope"}, "not in the schema"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_named_create_refusals(tmp_path, case, native):
    """engine="native" refuses at create with the reference's message;
    engine="auto" falls back to the pyarrow golden where the reference's
    does (a missing label fails there too), which reads the file as the
    reference's golden does (a string column it refuses, as that one
    does)."""
    make, kw, match = REFUSALS[case]
    path = make(tmp_path)
    kw = dict({"label_column": "label"}, **kw)
    with pytest.raises(RefDMLCError) as want:
        RefParser.create(path, format="parquet_native", engine="native",
                         **kw)
    with pytest.raises(DMLCError, match=match) as got:
        Parser.create(path, format="parquet_native", engine="native", **kw)
    assert str(got.value) == str(want.value)
    if case == "missing_label":
        return
    p = Parser.create(path, format="parquet_native", engine="auto", **kw)
    assert isinstance(p, ParquetParser)
    p.destroy()
    rest = {k: v for k, v in kw.items() if k != "label_column"}
    if case == "string_column":  # the golden cannot read it either
        with pytest.raises(ValueError):
            _ref(path, **rest)
        with pytest.raises(ValueError):
            _port(path, "python", **rest)
        return
    _assert_blocks_equal(_port(path, "python", **rest), _ref(path, **rest))


@pytest.mark.parametrize("fmt", ["parquet", "parquet_native"])
def test_pipeline_shuffle_is_refused(tmp_path, fmt):
    path = _simple(tmp_path, compression="NONE")
    with pytest.raises(DMLCError, match="shuffle is not supported"):
        (Pipeline.from_uri(path).shuffle(num_shuffle_parts=2, seed=1)
         .parse(format=fmt, label_column="label").build())


def test_truncated_file_is_refused(tmp_path, native):
    path = str(tmp_path / "t.parquet")
    pq.write_table(_mixed_table(seed=8, n=200), path, compression="NONE")
    bad = tmp_path / "bad.parquet"
    data = open(path, "rb").read()
    bad.write_bytes(data[:len(data) // 2])
    with pytest.raises(DMLCError):
        Parser.create(str(bad), format="parquet_native", engine="native",
                      label_column="label")


# ------------------------------------------- chip_smoke's Parquet writer

def _tables(c):
    rng = np.random.RandomState(9)
    x = rng.rand(5000, 28).astype(np.float32)
    five = {"label": (rng.rand(5000) < 0.5).astype(np.float32)}
    five.update((f"f{i}", np.ascontiguousarray(x[:, i])) for i in range(28))
    seventeen, nulls = c.decode_table(1, 17)
    return {"config5": (five, 5000 // 16, None),
            "config17": (seventeen, c.DECODE_GROUP_ROWS, nulls)}


@pytest.mark.parametrize("shape", ["config5", "config17"])
def test_chip_smoke_writer_is_read_back(tmp_path, chip_smoke, shape,
                                        native):
    """chip_smoke.write_parquet (numpy only: V1 PLAIN UNCOMPRESSED pages,
    optional columns with definition levels) on a small table: pyarrow
    reads back the columns written (NaN at nulls), the reference's
    pyarrow golden gives the RowBlocks the port's golden gives, and the
    port's NativeParquetParser gives them byte for byte, whole and
    sharded."""
    cols, group_rows, nulls = _tables(chip_smoke)[shape]
    path = str(tmp_path / f"{shape}.parquet")
    size = chip_smoke.write_parquet(path, cols, group_rows, nulls)
    assert size == os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == data[-4:] == b"PAR1"
    table = pq.read_table(path)
    meta = pq.ParquetFile(path).metadata
    rows = len(cols["label"])
    assert table.column_names == list(cols)
    assert meta.num_row_groups == -(-rows // group_rows)
    for name, want in cols.items():
        got = table.column(name).to_numpy(zero_copy_only=False)
        null = (nulls or {}).get(name, np.zeros(rows, bool))
        assert table.column(name).null_count == int(null.sum())
        assert np.array_equal(np.isnan(got), null), name
        assert np.array_equal(got[~null].astype(np.float32), want[~null])
    golden = _ref(path, fmt="parquet")
    _assert_blocks_equal(_port(path, "python", fmt="parquet"), golden)
    _assert_blocks_equal(_port(path, "native"), golden)
    _assert_blocks_equal(_port(path, "native", shards=4), golden)
    feats = [n for n in cols if n != "label"]
    dense = np.stack([cols[n] for n in feats], axis=1)
    for n, null in (nulls or {}).items():
        dense[null, feats.index(n)] = np.nan
    assert np.array_equal(np.isnan(golden.value), np.isnan(dense.ravel()))
    ok = ~np.isnan(dense.ravel())
    assert np.array_equal(golden.value[ok], dense.ravel()[ok])
    assert np.array_equal(golden.label, cols["label"])


# ------------------------------------- the golden over the VFS (C12's cure)

def test_as_file_adapter(tmp_path):
    """Twin of ``tests/test_io.py``'s ``test_as_file_adapter``."""
    import io

    from dmlc_tpu_torch.io.stream import create_stream
    p = str(tmp_path / "t.txt")
    with create_stream(p, "w") as s:
        s.as_file().write(b"line1\nline2\n")
    with create_stream(p, "r") as s:
        assert io.BufferedReader(s.as_file()).readline() == b"line1\n"


def test_as_file_does_not_own_stream_by_default(tmp_path):
    """A temporary adapter (GC'd or closed) must not close the stream out
    from under its owner mid-``with``."""
    from dmlc_tpu_torch.io.stream import create_stream
    p = str(tmp_path / "own.txt")
    with create_stream(p, "w") as s:
        f = s.as_file()
        f.write(b"a\n")
        f.close()          # adapter gone...
        s.write(b"b\n")    # ...stream still usable by its owner
    with create_stream(p, "r") as s:
        assert s.read_all() == b"a\nb\n"


def test_as_file_own_stream_transfers_ownership(tmp_path):
    from dmlc_tpu_torch.io.stream import create_stream
    p = str(tmp_path / "own2.txt")
    with open(p, "w") as f:
        f.write("x")
    s = create_stream(p, "r")
    s.as_file(own_stream=True).close()
    # FileStream drops its file object on close — ownership moved
    assert s._f is None


def test_as_file_seeks_from_end_only_with_a_size(tmp_path):
    """``size=`` makes whence=2 work on a SeekStream (pyarrow finds the
    footer so); without it, and on a stream that cannot seek, the
    adapter raises ``UnsupportedOperation``, as the reference's does."""
    import io

    from dmlc_tpu_torch.io.stream import Stream, create_stream
    p = str(tmp_path / "s.bin")
    with open(p, "wb") as f:
        f.write(bytes(range(100)))
    with create_stream(p, "r") as s:
        f = s.as_file(size=100)
        assert f.seekable() and f.seek(-10, 2) == 90
        assert f.read(3) == bytes([90, 91, 92])
        with pytest.raises(io.UnsupportedOperation, match="size"):
            s.as_file().seek(-1, 2)
    plain = Stream()
    assert not plain.as_file().seekable()
    with pytest.raises(io.UnsupportedOperation):
        plain.as_file().seek(0)


@pytest.fixture
def vfs_parquet(tmp_path):
    path = str(tmp_path / "d.parquet")
    rng = np.random.RandomState(5)
    n = 1000
    table = pa.table({
        "label": rng.randint(0, 2, n).astype(np.float32),
        "f0": rng.rand(n).astype(np.float32),
        "f1": rng.randn(n).astype(np.float32),
        "f2": rng.rand(n).astype(np.float32),
    })
    pq.write_table(table, path, row_group_size=100)
    return path, table


def test_registered_scheme_streams_parquet(vfs_parquet):
    """Twin of ``TestParquetOverVFS::test_registered_scheme_streams_parquet``:
    a scheme registered with ``FileSystem.register_scheme`` whose
    ``open_for_read`` returns a SeekStream feeds pyarrow through the
    ``as_file(size=...)`` adapter, with no local-path escape; its block
    is the local file's."""
    from dmlc_tpu_torch.io.filesys import (
        FileInfo, FileSystem, LocalFileSystem, URI,
    )
    path, table = vfs_parquet
    opened = []

    class PrefixFS(LocalFileSystem):
        """vfsx://<abs path> → local file, paths keep the scheme so
        every re-dispatch stays inside the VFS."""

        def open_for_read(self, uri):
            opened.append(uri.name)
            return super().open_for_read(URI(uri.name))

        def open(self, uri, mode):
            opened.append(uri.name)
            return super().open(URI(uri.name), mode)

        def get_path_info(self, uri):
            info = super().get_path_info(URI(uri.name))
            return FileInfo(path=f"vfsx://{info.path}",
                            size=info.size, type=info.type)

    FileSystem.register_scheme("vfsx://", PrefixFS)
    try:
        block = _drain(Parser, RowBlockContainer, f"vfsx://{path}", "auto",
                       fmt="parquet", prefetch=False)
        assert block.size == 1000
        np.testing.assert_array_equal(
            block.label, table.column("label").to_numpy())
        assert opened, "scheme open() was never exercised"
        _assert_blocks_equal(block, _port(path, "python", fmt="parquet"))
    finally:
        FileSystem._schemes.pop("vfsx://", None)
        FileSystem._instances.pop("vfsx://", None)


def test_non_seekable_scheme_fails_with_guidance(vfs_parquet):
    """Twin of ``TestParquetOverVFS::test_non_seekable_scheme_fails_with_guidance``."""
    from dmlc_tpu_torch.io.filesys import FileInfo, FileSystem, URI
    from dmlc_tpu_torch.io.stream import Stream
    path, _ = vfs_parquet

    class NoSeekFS(FileSystem):
        def open_for_read(self, uri):
            f = open(URI(uri.name).name, "rb")
            s = Stream()  # base Stream: not a SeekStream
            s.read = lambda n: f.read(n)
            s.close = f.close
            return s

        open = open_for_read

        def get_path_info(self, uri):
            return FileInfo(path=f"noseek://{uri.name}",
                            size=os.path.getsize(uri.name), type="file")

    FileSystem.register_scheme("noseek://", NoSeekFS)
    try:
        with pytest.raises(Exception, match="seek|Seek"):
            Parser.create(f"noseek://{path}", 0, 1, format="parquet",
                          prefetch=False)
    finally:
        FileSystem._schemes.pop("noseek://", None)
        FileSystem._instances.pop("noseek://", None)


@pytest.fixture
def obj_parquet(vfs_parquet, tmp_path, monkeypatch):
    """The Parquet file behind ``obj://`` on the port's emulator (an
    isolated page store; the process's client and options restored
    after)."""
    import dmlc_tpu_torch.io.objstore as objstore
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    for name in (ofs.ENV_ROOT, ofs.ENV_ENDPOINT, "DMLC_TPU_SERVE_PORTS",
                 "DMLC_TPU_SERVE_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "pages"))
    saved = ofs.options()
    em = objstore.configure(root=str(tmp_path / "objroot"),
                            block_bytes=1 << 14, coalesce=2, parallel=2,
                            hydrate=True, peer=False, codec_level=0)
    em.put_file("bench", "t/d.parquet", vfs_parquet[0])
    yield "obj://bench/t/d.parquet", vfs_parquet[0]
    objstore.configure(None, **{k: v for k, v in saved.items()
                                if k != "codec_level"})
    ofs._options["codec_level"] = saved["codec_level"]


@pytest.mark.parametrize("fmt", ["parquet", "parquet_native"])
def test_obj_parquet_reads_as_the_local_file(obj_parquet, fmt):
    """C12: ``engine="auto"`` on a Parquet object behind ``obj://`` gives
    the local file's blocks and padded batches, and the reference
    golden's block of the same file."""
    from dmlc_tpu_torch.obs.metrics import REGISTRY
    uri, local = obj_parquet
    gets0 = REGISTRY.counter("objstore.get").value
    got = _drain(Parser, RowBlockContainer, uri, "auto", fmt=fmt)
    assert REGISTRY.counter("objstore.get").value > gets0
    assert got.content_hash() == _port(local, "auto", fmt=fmt).content_hash()
    _assert_blocks_equal(got, _ref(local, fmt="parquet"))

    def batches(u):
        with (Pipeline.from_uri(u)
              .parse(format=fmt, engine="auto", label_column="label")
              .batch(256, pad=True, nnz_bucket=256 * 3)
              .to_device(device="cpu").build()) as built:
            return [hashlib.sha256(b"".join(
                np.ascontiguousarray(b[k].numpy()).tobytes()
                for k in sorted(b))).hexdigest() for b in built]

    want = batches(local)
    assert len(want) == 4 and batches(uri) == want
