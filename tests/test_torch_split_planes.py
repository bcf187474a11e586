"""The port's split host planes against the JAX package's.

Twins of ``tests/test_input_split.py``'s TestShuffledSplit,
TestThreadedSplit, TestCachedSplit and TestCachedSplitRegressions,
``tests/test_io.py``'s TestTemporaryDirectory and
``tests/test_misc_components.py``'s TestStdinSplit and
TestStdinRegressions. Each case also holds the port's record sequence
equal to the reference's on the same text and RecordIO files: the
shuffled order matches because the two packages share one seed law
(``shuffle.permutation.epoch_rng``). Stdin cases run in subprocesses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dmlc_tpu.io.input_split import InputSplit as RefInputSplit
from dmlc_tpu.io.input_split_shuffle import \
    InputSplitShuffle as RefInputSplitShuffle
from dmlc_tpu.io.recordio import RecordIOWriter as RefRecordIOWriter
from dmlc_tpu.io.stream import create_stream as ref_create_stream
from dmlc_tpu.io.threaded_split import \
    ThreadedInputSplit as RefThreadedInputSplit
from dmlc_tpu.shuffle.permutation import epoch_rng as ref_epoch_rng
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch.io.input_split import InputSplit
from dmlc_tpu_torch.io.input_split_shuffle import InputSplitShuffle
from dmlc_tpu_torch.io.tempdir import TemporaryDirectory
from dmlc_tpu_torch.io.threaded_split import ThreadedInputSplit
from dmlc_tpu_torch.shuffle.permutation import epoch_rng
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def text_uri(tmp_path):
    """Two text files of seeded lines (CRLF and blank lines in one)."""
    rng = np.random.RandomState(5)
    a = b"\n".join(b"a%d %s" % (i, rng.bytes(4).hex().encode())
                   for i in range(700)) + b"\n"
    b = b"\r\n".join(b"b%d" % i for i in range(300)) + b"\r\n\n\nb-last"
    pa, pb = tmp_path / "a.txt", tmp_path / "b.txt"
    pa.write_bytes(a)
    pb.write_bytes(b)
    return f"{pa};{pb}"


@pytest.fixture
def rec_uri(tmp_path):
    """A RecordIO file of seeded records, some holding the magic."""
    rng = np.random.RandomState(6)
    p = str(tmp_path / "r.rec")
    with ref_create_stream(p, "w") as s:
        w = RefRecordIOWriter(s)
        for i in range(400):
            rec = rng.bytes(rng.randint(0, 700))
            if i % 37 == 0:
                rec = b"\x0a\x23\xd7\xce" + rec  # the magic, aligned
            w.write_record(rec)
    return p


def _records(split):
    return [bytes(r) for r in split]


@pytest.mark.parametrize("epoch", [0, 1, 7])
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_epoch_rng_is_the_reference_law(seed, epoch):
    assert (epoch_rng(seed, epoch).permutation(11).tolist()
            == ref_epoch_rng(seed, epoch).permutation(11).tolist())


# --------------------------------------------------------- shuffled


@pytest.mark.parametrize("kind", ["text", "recordio"])
@pytest.mark.parametrize("parts,k,shuffle_parts,seed", [
    (1, 0, 5, 3), (1, 0, 1, 0), (3, 1, 4, 1), (2, 1, 8, 9)])
def test_shuffled_split_equals_reference(text_uri, rec_uri, kind, parts, k,
                                         shuffle_parts, seed):
    uri = text_uri if kind == "text" else rec_uri
    port = InputSplitShuffle.create(uri, k, parts, kind,
                                    num_shuffle_parts=shuffle_parts,
                                    seed=seed, chunk_size=1)
    ref = RefInputSplitShuffle.create(uri, k, parts, kind,
                                      num_shuffle_parts=shuffle_parts,
                                      seed=seed, chunk_size=1)
    for _ in range(3):  # three epochs, each reshuffled alike
        got = _records(port)
        assert got == _records(ref)
    plain = _records(InputSplit.create(uri, k, parts, kind))
    assert sorted(got) == sorted(plain)
    assert port.bytes_read == ref.bytes_read
    assert port.get_total_size() == ref.get_total_size()


def test_shuffle_covers_all(tmp_path):
    lines = [b"%d" % i for i in range(500)]
    p = tmp_path / "s.txt"
    p.write_bytes(b"\n".join(lines) + b"\n")
    split = InputSplitShuffle.create(str(p), 0, 1, "text",
                                     num_shuffle_parts=5, seed=3)
    epoch1 = _records(split)
    epoch2 = _records(split)
    assert sorted(epoch1) == sorted(epoch2) == sorted(lines)
    assert epoch1 != epoch2  # reshuffled across epochs
    ref = RefInputSplitShuffle.create(str(p), 0, 1, "text",
                                      num_shuffle_parts=5, seed=3)
    assert [_records(ref), _records(ref)] == [epoch1, epoch2]


def test_shuffle_deterministic_and_multi_worker(tmp_path):
    lines = [b"%d" % i for i in range(300)]
    p = tmp_path / "m.txt"
    p.write_bytes(b"\n".join(lines) + b"\n")
    a = _records(InputSplitShuffle.create(str(p), 0, 1, "text",
                                          num_shuffle_parts=4, seed=9))
    b = _records(InputSplitShuffle.create(str(p), 0, 1, "text",
                                          num_shuffle_parts=4, seed=9))
    assert a == b
    got = []
    for k in range(3):
        got.extend(_records(InputSplitShuffle.create(
            str(p), k, 3, "text", num_shuffle_parts=4, seed=1)))
    assert sorted(got) == sorted(lines)


def test_shuffled_reset_partition_and_chunks(text_uri):
    port = InputSplitShuffle(text_uri, 0, 2, "text", 3, seed=4)
    ref = RefInputSplitShuffle(text_uri, 0, 2, "text", 3, seed=4)
    port.reset_partition(1, 2)
    ref.reset_partition(1, 2)
    assert _records(port) == _records(ref)
    port.before_first()
    ref.before_first()
    chunks, rchunks = [], []
    while (c := port.next_chunk()) is not None:
        chunks.append(c)
    while (c := ref.next_chunk()) is not None:
        rchunks.append(c)
    assert chunks == rchunks
    assert (list(port.extract_records(chunks[0]))
            == list(ref.extract_records(rchunks[0])))


# --------------------------------------------------------- threaded


@pytest.mark.parametrize("kind", ["text", "recordio"])
def test_threaded_split_equals_plain_and_reference(text_uri, rec_uri, kind):
    uri = text_uri if kind == "text" else rec_uri
    plain = _records(InputSplit.create(uri, 0, 2, kind))
    threaded = ThreadedInputSplit(InputSplit.create(uri, 0, 2, kind,
                                                    chunk_size=1))
    ref = RefThreadedInputSplit(RefInputSplit.create(uri, 0, 2, kind,
                                                     chunk_size=1))
    try:
        got = _records(threaded)
        assert got == plain == _records(ref)
        assert _records(threaded) == plain  # before_first via __iter__
        threaded.reset_partition(1, 2)
        ref.reset_partition(1, 2)
        assert _records(threaded) == _records(ref)
        assert threaded.bytes_read == ref.bytes_read
        assert threaded.get_total_size() == ref.get_total_size()
    finally:
        threaded.destroy()
        ref.destroy()


def test_threaded_split_many_records(tmp_path):
    lines = [b"rec%d" % i for i in range(5000)]
    p = tmp_path / "t.txt"
    p.write_bytes(b"\n".join(lines) + b"\n")
    plain = _records(InputSplit.create(str(p), 0, 2))
    threaded = ThreadedInputSplit(InputSplit.create(str(p), 0, 2))
    try:
        assert _records(threaded) == plain
        assert _records(threaded) == plain
    finally:
        threaded.destroy()


# --------------------------------------------------------- cached


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Each package's default page-store root under this test."""
    monkeypatch.setenv("DMLC_TPU_TORCH_PAGESTORE_DIR",
                       str(tmp_path / "port_store"))
    monkeypatch.setenv("DMLC_TPU_PAGESTORE_DIR", str(tmp_path / "ref_store"))


@pytest.mark.parametrize("kind", ["text", "recordio"])
@pytest.mark.parametrize("parts,k", [(1, 0), (3, 2)])
def test_cache_replay_equals_reference(tmp_path, stores, text_uri, rec_uri,
                                       kind, parts, k):
    uri = text_uri if kind == "text" else rec_uri
    plain = _records(InputSplit.create(uri, k, parts, kind))
    caches = {}
    for side, create in (("port", InputSplit.create),
                         ("ref", RefInputSplit.create)):
        cache = str(tmp_path / f"{side}.cache")
        split = create(f"{uri}#{cache}", k, parts, kind, chunk_size=1)
        assert _records(split) == plain          # write pass
        assert _records(split) == plain          # replay pass
        assert _records(create(f"{uri}#{cache}", k, parts, kind)) == plain
        entry = f"{cache}.p{k}-{parts}"
        assert os.path.exists(entry)
        assert os.path.exists(entry + ".meta.json")
        caches[side] = open(entry, "rb").read()
    assert caches["port"] == caches["ref"]  # the same cache bytes
    # each package replays the other's committed cache
    import shutil
    cross = str(tmp_path / "cross.cache")
    shutil.copy(str(tmp_path / "ref.cache") + f".p{k}-{parts}",
                cross + f".p{k}-{parts}")
    shutil.copy(str(tmp_path / "ref.cache") + f".p{k}-{parts}.meta.json",
                cross + f".p{k}-{parts}.meta.json")
    split = InputSplit.create(f"{uri}#{cross}", k, parts, kind)
    assert _records(split) == plain
    assert split._reader is not None  # served from the cache, not re-read


def test_cache_replay_identical(tmp_path, stores):
    lines = [b"c%d" % i for i in range(1000)]
    data = tmp_path / "d.txt"
    data.write_bytes(b"\n".join(lines) + b"\n")
    cache = tmp_path / "cache.bin"
    uri = f"{data}#{cache}"
    split = InputSplit.create(uri, 0, 1)
    assert _records(split) == lines
    assert os.path.exists(str(cache) + ".p0-1")
    assert os.path.exists(str(cache) + ".p0-1.meta.json")
    assert _records(split) == lines
    assert _records(InputSplit.create(uri, 0, 1)) == lines


def test_cache_rebuilds_after_the_source_changes(tmp_path, stores):
    data = tmp_path / "m.txt"
    data.write_bytes(b"x0\nx1\n")
    uri = f"{data}#{tmp_path / 'm.cache'}"
    assert _records(InputSplit.create(uri, 0, 1)) == [b"x0", b"x1"]
    data.write_bytes(b"y0\ny1\ny2\n")
    os.utime(data, ns=(1, 1))
    got = _records(InputSplit.create(uri, 0, 1))
    ref = _records(RefInputSplit.create(uri, 0, 1))
    assert got == ref == [b"y0", b"y1", b"y2"]


@pytest.mark.parametrize("create", [InputSplit.create, RefInputSplit.create],
                         ids=["port", "ref"])
def test_cached_before_first_rewinds_records(tmp_path, stores, create):
    data = tmp_path / "r.txt"
    data.write_bytes(b"r0\nr1\nr2\n")
    s = create(f"{data}#{tmp_path / 'c.bin'}", 0, 1)
    assert s.next_record() == b"r0"
    s.before_first()
    assert s.next_record() == b"r0"  # must restart, not resume


@pytest.mark.parametrize("create", [InputSplit.create, RefInputSplit.create],
                         ids=["port", "ref"])
def test_cached_bytes_read_resets_per_epoch(tmp_path, stores, create):
    data = tmp_path / "b.txt"
    data.write_bytes(b"x\n" * 100)
    s = create(f"{data}#{tmp_path / 'c2.bin'}", 0, 1)
    _records(s)
    first = s.bytes_read
    _records(s)  # second epoch (replay from cache)
    assert s.bytes_read == first == 200


def test_cached_reset_partition(tmp_path, stores, text_uri):
    port = InputSplit.create(f"{text_uri}#{tmp_path / 'p.c'}", 0, 2)
    ref = RefInputSplit.create(f"{text_uri}#{tmp_path / 'r.c'}", 0, 2)
    _records(port)
    _records(ref)
    port.reset_partition(1, 2)
    ref.reset_partition(1, 2)
    assert _records(port) == _records(ref)
    assert os.path.exists(str(tmp_path / "p.c") + ".p1-2")



# --------------------------------------------------------- tempdir


def test_tempdir_create_delete():
    td = TemporaryDirectory()
    path = td.path
    assert os.path.isdir(path)
    assert os.path.basename(path).startswith("dmlc_tpu_torch.")
    with open(os.path.join(path, "x"), "w") as f:
        f.write("1")
    os.makedirs(os.path.join(path, "nested", "deep"))
    td.close()
    assert not os.path.exists(path)
    td.close()  # idempotent


def test_tempdir_context_manager():
    with TemporaryDirectory(prefix="twin.", verbose=True) as td:
        path = td.path
        assert os.path.isdir(path)
    assert not os.path.exists(path) and td.path == ""


# --------------------------------------------------------- stdin


def _stdin_run(pkg, body, payload):
    code = ("import sys\n"
            f"from {pkg}.io.input_split import InputSplit\n" + body)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], input=payload,
                         capture_output=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout.decode()


@pytest.mark.parametrize("payload", [b"a\nbb\n\nccc\n", b"x\r\ny\r\nlast",
                                     b""])
def test_stdin_records_equal_reference(payload):
    body = ("s = InputSplit.create('-', 0, 1)\n"
            "print([r.decode() for r in s])\n"
            "try:\n"
            "    s.before_first()\n"  # replays what it buffered
            "    print([r.decode() for r in s])\n"
            "except Exception as e:\n"  # nothing buffered: a pipe
            "    print(type(e).__name__, e)\n"  # cannot rewind
            "print(s.bytes_read, s.get_total_size())\n")
    got = _stdin_run("dmlc_tpu_torch", body, payload)
    assert got == _stdin_run("dmlc_tpu", body, payload)
    if payload.startswith(b"a"):
        assert got.splitlines()[0] == "['a', 'bb', 'ccc']"


def test_stdin_streaming_chunks_bounded():
    body = ("s = InputSplit.create('-', 0, 1, chunk_size=1)\n"
            "chunks = 0; recs = 0\n"
            "while True:\n"
            "    c = s.next_chunk()\n"
            "    if c is None: break\n"
            "    chunks += 1; recs += len(list(s.extract_records(c)))\n"
            "print(chunks, recs)\n")
    payload = b"".join(b"line-%06d\n" % i for i in range(200000))
    got = _stdin_run("dmlc_tpu_torch", body, payload)
    assert got == _stdin_run("dmlc_tpu", body, payload)
    chunks, recs = map(int, got.split())
    assert recs == 200000 and chunks > 10  # streamed, not slurped


def test_stdin_through_the_parser():
    """The python parser reads a piped libsvm stream (no prefetch thread:
    a pipe cannot rewind), with the reference's blocks."""
    body = ("from {pkg}.data.parser import Parser\n"
            "p = Parser.create('-', format='libsvm')\n"
            "rows = [(b.size, b.offset.tolist(), b.index.tolist(),"
            " b.value.tolist()) for b in p]\n"
            "print(p._prefetch is None, rows)\n")
    payload = b"1 1:0.5 3:2\n0 2:1\n\n1 7:0.25\n"
    got = _stdin_run("dmlc_tpu_torch", body.format(pkg="dmlc_tpu_torch"),
                     payload)
    assert got == _stdin_run("dmlc_tpu", body.format(pkg="dmlc_tpu"),
                             payload)
    assert got.startswith("True [(3,")


@pytest.mark.parametrize("args,match", [(("-", 0, 1, "recordio"), "text"),
                                        (("-", 1, 4), "one part")])
def test_stdin_refusals_equal_reference(args, match):
    with pytest.raises(DMLCError, match=match) as port:
        InputSplit.create(*args)
    with pytest.raises(RefDMLCError, match=match) as ref:
        RefInputSplit.create(*args)
    assert str(port.value) == str(ref.value)
