"""The port's on-disk row formats against the JAX package's: RowBlock
pages (``RowBlockContainer.save_block``), DiskRowIter page caches and
round-spill files (``dmlc_tpu_torch/data/row_iter.py``) must be byte
for byte the reference's for the same blocks, parser, rounds and meta,
and each package must read the other's. Blocks and files are made from
seeds with numpy; every page store here is rooted under the test's own
temporary directory, one per package."""

import hashlib
import os

import numpy as np
import pytest

from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.row_iter import DiskRowIter as RefDiskRowIter
from dmlc_tpu.data.row_iter import RoundSpillFile as RefSpillFile
from dmlc_tpu.data.row_iter import RoundSpillWriter as RefSpillWriter
from dmlc_tpu.data.row_iter import read_spill_meta as ref_read_spill_meta
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.io.stream import MemoryStream as RefMemoryStream
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.row_iter import (
    DiskRowIter, RoundSpillFile, RoundSpillWriter, read_spill_meta,
    sweep_stale_spill,
)
from dmlc_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io.pagestore import stat_fingerprint
from dmlc_tpu_torch.io.stream import MemoryStream, create_stream
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.utils.logging import DMLCError

COLUMNS = {"bare": (), "value": ("value",), "weight": ("weight",),
           "qid": ("qid",), "field": ("value", "field"),
           "all": ("value", "weight", "qid", "field")}


def _arrays(seed, rows, cols, index_dtype):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, 9, rows)
    offset = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    nnz = int(offset[-1])
    big = 2 ** 40 if index_dtype == np.uint64 else 2 ** 31
    out = {"offset": offset,
           "label": rng.randn(rows).astype(np.float32),
           "index": rng.randint(0, big, nnz).astype(index_dtype)}
    if "value" in cols:
        out["value"] = rng.randn(nnz).astype(np.float32)
    if "weight" in cols:
        out["weight"] = rng.rand(rows).astype(np.float32)
    if "qid" in cols:
        out["qid"] = np.sort(rng.randint(0, 5, rows)).astype(np.int64)
    if "field" in cols:
        out["field"] = rng.randint(0, 39, nnz).astype(np.int64)
    return out


def _pages(cls, stream_cls, blocks):
    s = stream_cls()
    for b in blocks:
        cls.save_block(b, s)
    return s.getvalue()


@pytest.mark.parametrize("index_dtype", [np.uint32, np.uint64],
                         ids=["u32", "u64"])
@pytest.mark.parametrize("cols", sorted(COLUMNS))
def test_save_block_bytes_match_reference(cols, index_dtype):
    blocks = [_arrays(seed, rows, COLUMNS[cols], index_dtype)
              for seed, rows in ((0, 17), (1, 1), (2, 0), (3, 64))]
    port = _pages(RowBlockContainer, MemoryStream,
                  [RowBlock(**a) for a in blocks])
    ref = _pages(RefContainer, RefMemoryStream,
                 [RefRowBlock(**a) for a in blocks])
    assert port == ref
    # each package loads the other's pages, owned and hash-equal
    src = MemoryStream(ref)
    rsrc = RefMemoryStream(port)
    for a in blocks:
        got = RowBlockContainer.load_block(src)
        want = RefContainer.load_block(rsrc)
        assert got.content_hash() == want.content_hash() == \
            RowBlock(**a).content_hash()
        assert got.index.dtype == index_dtype
        assert all(getattr(got, k).flags.owndata for k in a)
    assert RowBlockContainer.load_block(src) is None
    assert RefContainer.load_block(rsrc) is None


def test_container_save_load_round_trip():
    a = _arrays(5, 30, COLUMNS["all"], np.uint64)
    c = RowBlockContainer(np.uint64)
    c.push_block(RowBlock(**a))
    s = MemoryStream()
    c.save(s)
    s.seek(0)
    back = RowBlockContainer()
    assert back.load(s) is True
    assert back.index_dtype == np.uint64
    assert back.get_block().content_hash() == RowBlock(**a).content_hash()
    assert back.load(s) is False


def test_bad_page_magic_and_truncation_raise():
    page = _pages(RowBlockContainer, MemoryStream,
                  [RowBlock(**_arrays(6, 9, ("value",), np.uint32))])
    with pytest.raises(DMLCError, match="bad magic"):
        RowBlockContainer.load_block(MemoryStream(b"XXXX" + page[4:]))
    with pytest.raises(DMLCError, match="unexpected EOF"):
        RowBlockContainer.load_block(MemoryStream(page[:-3]))


NDARRAYS = {
    "u32": np.arange(7, dtype=np.uint32),
    "f64_2d": np.random.RandomState(8).randn(3, 5),
    "scalar": np.array(2.5, dtype=np.float32),
    "empty": np.zeros((0, 4), dtype=np.int64),
    "bool": np.array([True, False, True]),
    "big_endian": np.arange(6, dtype=">i4").reshape(2, 3),
}


@pytest.mark.parametrize("via", ["memory", "file"])
@pytest.mark.parametrize("name", sorted(NDARRAYS))
def test_read_ndarray_matches_reference(tmp_path, name, via):
    """The serializer's arrays against the reference's: the same bytes on
    the wire, the same dtype, shape and values back (0-d, empty, bool and
    big-endian inputs too), each array owning its memory, from a memory
    stream and from a file; a short stream raises."""
    from dmlc_tpu.utils import serializer as ref_ser
    from dmlc_tpu_torch.utils import serializer as ser
    a = NDARRAYS[name]
    s, rs = MemoryStream(), RefMemoryStream()
    ser.write_ndarray(s, a)
    ser.write_ndarray(s, a)
    ref_ser.write_ndarray(rs, a)
    ref_ser.write_ndarray(rs, a)
    raw = s.getvalue()
    assert raw == rs.getvalue()
    if via == "file":
        p = tmp_path / "a.bin"
        p.write_bytes(raw)
        src = create_stream(str(p), "r")
    else:
        src = MemoryStream(raw)
    want = ref_ser.read_ndarray(RefMemoryStream(raw))
    for _ in range(2):
        got = ser.read_ndarray(src)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert got.flags.owndata and got.flags.writeable
    src.close()
    with pytest.raises(DMLCError, match="unexpected EOF"):
        ser.read_ndarray(MemoryStream(raw[:len(raw) // 2 - 1]))


# ------------------------------------------------------------ DiskRowIter

def _write_libsvm(path, seed, rows):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        idx = np.sort(rng.choice(np.arange(1, 400), rng.randint(1, 12),
                                 replace=False))
        lines.append(f"{i % 2} " + " ".join(f"{j}:{rng.rand():.4f}"
                                            for j in idx))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _drain_hash(it):
    c = RowBlockContainer(np.uint32)
    it.before_first()
    while it.next():
        c.push_block(it.value())
    return c.get_block().content_hash()


def _parse_hash(path):
    c = RefContainer(np.uint32)
    p = RefParser.create(path, 0, 1, format="libsvm", engine="python")
    for b in p:
        c.push_block(b)
    return c.get_block().content_hash()


@pytest.mark.parametrize("engine", ["python", "native"])
def test_disk_row_iter_cache_matches_reference(tmp_path, engine):
    if engine == "native" and not native_available():
        pytest.fail("the port's native engine did not build")
    src = _write_libsvm(tmp_path / "d.libsvm", 0, 1000)
    fp = stat_fingerprint([src])
    port_cache = str(tmp_path / "port" / "cache.pages")
    ref_cache = str(tmp_path / "ref" / "cache.pages")
    port = DiskRowIter(lambda: Parser.create(src, 0, 1, format="libsvm",
                                             engine=engine),
                       port_cache, rows_per_page=96, fingerprint=fp)
    ref = RefDiskRowIter(lambda: RefParser.create(src, 0, 1,
                                                  format="libsvm",
                                                  engine="python"),
                         ref_cache, rows_per_page=96, fingerprint=fp)
    with open(port_cache, "rb") as a, open(ref_cache, "rb") as b:
        assert a.read() == b.read()
    with open(port_cache + ".meta.json") as a, \
            open(ref_cache + ".meta.json") as b:
        assert a.read() == b.read()
    want = _parse_hash(src)
    for it in (port, ref):
        assert _drain_hash(it) == want
        assert _drain_hash(it) == want  # a second epoch replays again
    assert port.num_col() == ref.num_col()
    # each package replays the other's cache without rebuilding it
    cross = DiskRowIter(lambda: pytest.fail("rebuilt"), ref_cache,
                        rows_per_page=96, fingerprint=fp)
    assert _drain_hash(cross) == want
    assert cross.num_col() == ref.num_col()
    rcross = RefDiskRowIter(lambda: pytest.fail("rebuilt"), port_cache,
                            rows_per_page=96, fingerprint=fp)
    assert _drain_hash(rcross) == want


def test_disk_row_iter_rebuilds_a_stale_cache(tmp_path):
    src = tmp_path / "d.libsvm"
    src.write_text("1 1:1.0\n0 2:2.0\n" * 50)
    cache = str(tmp_path / "cache.pages")

    def make():
        return DiskRowIter(lambda: Parser.create(str(src), 0, 1,
                                                 format="libsvm",
                                                 engine="python"),
                           cache, fingerprint=stat_fingerprint([str(src)]))

    it = make()
    it.before_first()
    assert it.next()
    assert it.value().label.sum() == 50.0
    del it
    src.write_text("1 1:1.0\n1 2:2.0\n" * 50)  # in-place mutation
    it2 = make()
    total = 0.0
    it2.before_first()
    while it2.next():
        total += it2.value().label.sum()
    assert total == 100.0  # all-ones labels: the NEW source


def test_disk_row_iter_vanished_cache_raises(tmp_path):
    src = _write_libsvm(tmp_path / "d.libsvm", 1, 50)
    cache = str(tmp_path / "c.pages")
    it = DiskRowIter(Parser.create(src, 0, 1, format="libsvm",
                                   engine="python"), cache)
    os.remove(cache)
    with pytest.raises(DMLCError, match="vanished"):
        it.before_first()


# ------------------------------------------------------------ round spill

def _rounds(seed, nparts=3, rounds=4):
    out = []
    for r in range(rounds):
        row = []
        for p in range(nparts):
            rows = 0 if (r == rounds - 1 and p == 0) else 5 + r + p
            a = _arrays(seed * 100 + r * 10 + p, rows, ("value",),
                        np.uint32)
            row.append(a)
        out.append(row)
    return out


def _row_hash(rows):
    h = hashlib.sha256()
    n = 0
    for row in rows:
        for b in row:
            h.update(b.content_hash().encode())
        n += 1
    return h.hexdigest(), n


@pytest.mark.parametrize("level", [0, 6])
def test_round_spill_file_matches_reference(tmp_path, level):
    rounds = _rounds(level)
    meta = {"fingerprint": [["/data/x.libsvm", 1234, 5678]], "k": "v"}
    port_path = str(tmp_path / "port" / "rounds-a-p1-1.pages")
    ref_path = str(tmp_path / "ref" / "rounds-a-p1-1.pages")
    w = RoundSpillWriter(port_path, 3, meta, codec_level=level)
    rw = RefSpillWriter(ref_path, 3, meta, codec_level=level)
    for row in rounds:
        w.add_row([RowBlock(**a) for a in row])
        rw.add_row([RefRowBlock(**a) for a in row])
    f = w.commit()
    rf = rw.commit()
    assert f.rounds == rf.rounds == len(rounds)
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    with open(port_path + ".meta.json") as a, \
            open(ref_path + ".meta.json") as b:
        assert a.read() == b.read()
    assert read_spill_meta(port_path) == ref_read_spill_meta(ref_path)
    assert read_spill_meta(port_path)["_version"] == (2 if level else 1)
    want = _row_hash([[RowBlock(**a) for a in row] for row in rounds])
    # both packages read both files
    assert _row_hash(RoundSpillFile(ref_path, 3, 4).iter_rows()) == want
    assert _row_hash(RefSpillFile(port_path, 3, 4).iter_rows()) == want
    assert _row_hash(f.iter_rows()) == want
    f.delete()
    assert os.listdir(os.path.dirname(port_path)) == []


def test_round_spill_codec_shrinks_the_file(tmp_path):
    sizes = {}
    for level in (0, 6):
        path = str(tmp_path / f"s{level}.pages")
        w = RoundSpillWriter(path, 2, codec_level=level)
        for r in range(5):
            w.add_row([RowBlock(**_arrays(r * 2 + p, 40, ("value",),
                                          np.uint32)) for p in range(2)])
        w.commit()
        sizes[level] = os.path.getsize(path)
        assert read_spill_meta(path)["codec"] == ("zlib:6" if level
                                                  else "raw")
    assert sizes[6] < sizes[0]


def test_round_spill_env_level_applies(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PAGE_CODEC_LEVEL", "4")
    path = str(tmp_path / "env.pages")
    w = RoundSpillWriter(path, 1)
    w.add_row([RowBlock(**_arrays(1, 10, (), np.uint32))])
    w.commit()
    assert read_spill_meta(path)["codec"] == "zlib:4"


def test_round_spill_abort_and_truncation(tmp_path):
    path = str(tmp_path / "s.pages")
    w = RoundSpillWriter(path, 2)
    w.add_row([RowBlock(**_arrays(0, 5, (), np.uint32))] * 2)
    w.abort()
    assert os.listdir(tmp_path) == []
    w = RoundSpillWriter(path, 2)
    w.add_row([RowBlock(**_arrays(0, 5, (), np.uint32))] * 2)
    f = w.commit()
    with pytest.raises(DMLCError, match="width"):
        RoundSpillWriter(str(tmp_path / "t.pages"), 2).add_row([])
    # a reader told of more rounds than the file holds: the missing
    # round is refused, never invented
    with pytest.raises(DMLCError):
        list(RoundSpillFile(f.path, 2, 2).iter_rows())
    assert read_spill_meta(str(tmp_path / "nothing")) is None
    with create_stream(str(tmp_path / "junk.pages"), "w") as s:
        s.write(b"not a spill file")
    assert read_spill_meta(str(tmp_path / "junk.pages")) is None


def test_sweep_stale_spill_reads_the_header(tmp_path):
    src = tmp_path / "src.libsvm"
    src.write_text("1 1:1\n")
    d = tmp_path / "spill"
    path = str(d / "rounds-k-p1-1.pages")
    fp = stat_fingerprint([str(src)])
    w = RoundSpillWriter(path, 1, {"fingerprint": fp})
    w.add_row([RowBlock(**_arrays(0, 3, (), np.uint32))])
    w.commit()
    os.remove(path + ".meta.json")  # only the header stamp is left
    os.rename(path, str(d / "rounds-k-x.pages"))  # no pid in the name
    assert sweep_stale_spill(str(d)) == 0  # fresh: kept
    src.write_text("1 1:1\n0 2:1\n")
    assert sweep_stale_spill(str(d)) == 1  # stale by its header
    assert os.listdir(d) == []
