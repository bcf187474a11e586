"""The indexed RecordIO split of the port against the JAX package's.

``InputSplit.create(uri, k, n, "indexed_recordio", shuffle=, seed=,
batch_size=)`` (``IndexedRecordIOSplit``) and the engine's
``NativeIndexedRecordIOReader`` must give the reference's records in the
reference's order: unshuffled and shuffled (the per-epoch batch shuffle
drawn from ``epoch_rng``, the reference's seed law), over epochs, parts
and batch sizes, with escaped-magic multi-frame records in the file, and
with an index that skips records. A missing ``.idx`` is refused as the
reference refuses it.
"""

import struct

import numpy as np
import pytest

from dmlc_tpu.io import recordio as ref_rio
from dmlc_tpu.io.indexed_recordio_split import (
    IndexedRecordIOSplit as RefSplit)
from dmlc_tpu.io.input_split import InputSplit as RefInputSplit
from dmlc_tpu.io.stream import create_stream as ref_create_stream
from dmlc_tpu_torch.io import recordio as rio
from dmlc_tpu_torch.io.indexed_recordio_split import IndexedRecordIOSplit
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.stream import create_stream
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.native.bindings import NativeIndexedRecordIOReader

MAGIC = struct.pack("<I", rio.RECORDIO_MAGIC)


def _records(seed=0, count=300):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        if i % 13 == 0:  # an escaped-magic multi-frame record
            out.append(MAGIC + rng.bytes(40) + MAGIC)
        else:
            out.append(rng.bytes(int(rng.randint(30, 2000))))
    return out


def _write(path, module, stream):
    with stream(path, "w") as s, stream(path + ".idx", "w") as ix:
        w = module.IndexedRecordIOWriter(s, ix)
        for rec in _records():
            w.write_record(rec)


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.fail("the port's native engine did not build")
    return True


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("indexed") / "x.rec")
    _write(path, rio, create_stream)
    return path


def test_writer_is_the_reference_writer(rec, tmp_path):
    ref = str(tmp_path / "ref.rec")
    _write(ref, ref_rio, ref_create_stream)
    for suffix in ("", ".idx"):
        with open(rec + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def _epochs(split, epochs=2):
    out = []
    for ep in range(epochs):
        if ep:
            split.before_first()
        recs = []
        while True:
            r = split.next_record()
            if r is None:
                break
            recs.append(r)
        out.append(recs)
    return out


def _native_epochs(reader, epochs=2):
    out = []
    for ep in range(epochs):
        if ep:
            reader.before_first()
        out.append(list(reader.records()))
    assert reader.bytes_read() > 0
    reader.destroy()
    return out


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("batch_size", [1, 17, 64])
@pytest.mark.parametrize("part,parts", [(0, 1), (1, 2), (2, 4)])
def test_shuffled_order_matches_reference(rec, seed, batch_size, part,
                                          parts, native):
    kw = dict(shuffle=True, seed=seed, batch_size=batch_size)
    want = _epochs(RefInputSplit.create(rec, part, parts,
                                        "indexed_recordio", **kw))
    split = InputSplit.create(rec, part, parts, "indexed_recordio", **kw)
    assert isinstance(split, IndexedRecordIOSplit)
    assert split.keys() == RefSplit(rec, part, parts, **kw).keys()
    assert _epochs(split) == want
    assert _native_epochs(NativeIndexedRecordIOReader(
        rec, part, parts, **kw)) == want
    if len(want[0]) > 4 * batch_size:  # a reshuffle can't come back equal
        assert want[0] != want[1]


@pytest.mark.parametrize("part,parts", [(0, 1), (0, 3), (1, 3), (2, 3)])
def test_unshuffled_parts_match_reference(rec, part, parts, native):
    want = RefSplit(rec, part, parts)
    got = IndexedRecordIOSplit(rec, part, parts)
    for a, b in zip(got.record_windows(), want.record_windows()):
        np.testing.assert_array_equal(a, b)
    assert got.keys() == want.keys()
    assert got.get_total_size() == want.get_total_size()
    recs = _epochs(got, 1)[0]
    assert recs == _epochs(want, 1)[0]
    assert _native_epochs(NativeIndexedRecordIOReader(rec, part, parts),
                          1)[0] == recs


def test_parts_cover_the_file_once(rec):
    whole = sorted(_epochs(IndexedRecordIOSplit(rec, 0, 1), 1)[0])
    parts = []
    for k in range(4):
        parts += _epochs(IndexedRecordIOSplit(rec, k, 4), 1)[0]
    assert sorted(parts) == whole == sorted(_records())


def test_two_seeds_give_two_orders_of_the_same_records(rec, native):
    plain = sorted(_records())
    orders = []
    for seed in (11, 12):
        got = _native_epochs(NativeIndexedRecordIOReader(
            rec, 0, 1, shuffle=True, seed=seed, batch_size=64), 1)[0]
        assert sorted(got) == plain
        orders.append(got)
    assert orders[0] != orders[1]


def test_chunks_hold_the_records_in_order(rec):
    kw = dict(shuffle=True, seed=3, batch_size=17)
    split = IndexedRecordIOSplit(rec, 0, 1, **kw)
    ref = RefSplit(rec, 0, 1, **kw)
    got = []
    while True:
        chunk = split.next_chunk()
        if chunk is None:
            break
        assert chunk == ref.next_chunk()
        got += list(split.extract_records(chunk))
    assert ref.next_chunk() is None
    assert got == _epochs(IndexedRecordIOSplit(rec, 0, 1, **kw), 1)[0]
    assert split.bytes_read == ref.bytes_read > 0


def test_index_uri_argument_and_uri_spec(rec, tmp_path):
    import shutil
    other = str(tmp_path / "other.idx")
    shutil.copy(rec + ".idx", other)
    want = _epochs(RefSplit(rec, 0, 1), 1)[0]
    assert _epochs(IndexedRecordIOSplit(rec, 0, 1, index_uri=other),
                   1)[0] == want
    assert _epochs(IndexedRecordIOSplit(f"{rec}?index={other}", 0, 1),
                   1)[0] == want


def test_missing_index_is_refused_as_the_reference_refuses_it(tmp_path):
    path = str(tmp_path / "noidx.rec")
    with create_stream(path, "w") as s:
        rio.RecordIOWriter(s).write_record(b"abc")
    with pytest.raises(Exception) as want:
        RefInputSplit.create(path, 0, 1, "indexed_recordio")
    with pytest.raises(Exception) as got:
        InputSplit.create(path, 0, 1, "indexed_recordio")
    assert type(got.value) is type(want.value) is FileNotFoundError
    with pytest.raises(FileNotFoundError):
        NativeIndexedRecordIOReader(path, 0, 1)


@pytest.mark.parametrize("no_mmap", [False, True])
def test_index_that_skips_records(tmp_path, monkeypatch, no_mmap, native):
    """An index of every second record makes each window span two framed
    records: the split returns the first of each window, and the native
    reader (mapped, and by pread) the same."""
    rng = np.random.RandomState(4)
    path = str(tmp_path / "sparse.rec")
    offsets = []
    with open(path, "wb") as fh:
        class _Counting:
            written = 0

            def write(self, d):
                self.written += len(d)
                return fh.write(d)
        cs = _Counting()
        w = rio.RecordIOWriter(cs)
        for i in range(60):
            offsets.append(cs.written)
            w.write_record(MAGIC + rng.bytes(24) if i % 10 == 0
                           else rng.bytes(int(rng.randint(10, 200))))
    with open(path + ".idx", "w") as ix:
        for k, off in enumerate(offsets[::2]):
            ix.write(f"{k}\t{off}\n")
    if no_mmap:
        monkeypatch.setenv("DMLC_TPU_NO_MMAP", "1")
    kw = dict(shuffle=True, seed=2, batch_size=7)
    want = _epochs(RefSplit(path, 0, 1, **kw), 1)[0]
    assert len(want) == 30
    assert _epochs(IndexedRecordIOSplit(path, 0, 1, **kw), 1)[0] == want
    assert _native_epochs(NativeIndexedRecordIOReader(path, 0, 1, **kw),
                          1)[0] == want


def test_detached_leases_outlive_the_next_batch(rec, native):
    r = NativeIndexedRecordIOReader(rec, 0, 1, shuffle=True, seed=11,
                                    batch_size=64)
    held = []
    while True:
        batch = r.next_batch()
        if batch is None:
            break
        held.append((batch, r.detach()))
    got = []
    for (data, starts, ends), lease in held:
        view = memoryview(data)
        got += [bytes(view[int(s):int(e)]) for s, e in zip(starts, ends)]
        lease.release()
    r.destroy()
    assert got == _epochs(RefSplit(rec, 0, 1, shuffle=True, seed=11,
                                   batch_size=64), 1)[0]
