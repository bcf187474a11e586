"""The page tier's raw route on the CPU: ``RoundSpillFile.read_round_into``
and ``ops.pages.round_unpack_plain`` over rounds written by the port's
and the reference's ``RoundSpillWriter``.

Every case holds two properties: the raw route's batch is, byte for
byte, what ``stack_padded_rows`` makes over ``RoundSpillFile.iter_rows``
(the port's), and what the reference's ``stack_padded_rows`` makes over
the reference's ``iter_rows`` of the same file; and the table a header
scan builds equals the one the writer kept. The kernel itself
(``csrc/pages.cu``) runs only on the card: ``chip_smoke.py`` holds it
to this plain version byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import stack_padded_rows as ref_stack
from dmlc_tpu.data.row_iter import RoundSpillFile as RefSpillFile
from dmlc_tpu.data.row_iter import RoundSpillWriter as RefSpillWriter
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu_torch.data.padding import stack_padded_rows
from dmlc_tpu_torch.data.row_iter import (
    ROUND_TABLE_COLUMNS, RoundSpillFile, RoundSpillWriter, RoundTable,
)
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.ops import pages
from dmlc_tpu_torch.utils.logging import DMLCError

RB, NB = 8, 32  # row_bucket, nnz_bucket


def _arrays(rng, n, nnz=None, index=np.uint32, value=True, weight=False,
            qid=False, field=False):
    """One block's arrays: n rows, nnz nonzeros (random under the
    buckets when None), floats with a -0.0 and a NaN among them, and
    u64 indices past 2^32 (a u32 output keeps their low bits)."""
    if nnz is None:
        nnz = int(rng.randint(0, min(NB, 4 * n) + 1)) if n else 0
    cuts = np.sort(rng.randint(0, nnz + 1, max(n - 1, 0)))
    offset = np.concatenate([[0], cuts, [nnz]]) if n else np.zeros(1)
    top = 1 << 40 if index == np.uint64 else 1 << 31
    floats = lambda k: np.where(  # noqa: E731
        rng.rand(k) < 0.1, -0.0, rng.randn(k)).astype(np.float32)
    label = floats(n)
    if n > 2:
        label[2] = np.nan
    out = {"offset": offset.astype(np.int64), "label": label,
           "index": rng.randint(0, top, nnz, dtype=np.int64).astype(index)}
    if value:
        out["value"] = floats(nnz)
    if weight:
        out["weight"] = floats(n)
    if qid:
        out["qid"] = rng.randint(-1, 50, n).astype(np.int64)
    if field:
        out["field"] = rng.randint(0, 39, nnz).astype(np.int64)
    return out


def _empty(index=np.uint32):
    return {"offset": np.zeros(1, np.int64),
            "label": np.zeros(0, np.float32), "index": np.zeros(0, index)}


# each case: (parts, the round builder, codec level); a builder gives a
# list of rounds, each a list of one block's arrays a part
CASES = {
    "one_part": (1, lambda g: [[_arrays(g, 5)] for _ in range(3)], 0),
    "four_parts": (4, lambda g: [[_arrays(g, int(g.randint(1, RB + 1)))
                                  for _ in range(4)] for _ in range(3)], 0),
    "empty_pads": (4, lambda g: [[_arrays(g, 6), _empty(), _arrays(g, 3),
                                  _empty()],
                                 [_empty()] * 4], 0),
    "full_buckets": (2, lambda g: [[_arrays(g, RB, NB),
                                    _arrays(g, RB, NB)]], 0),
    "no_value": (2, lambda g: [[_arrays(g, 4, value=False)] * 2], 0),
    "weight": (2, lambda g: [[_arrays(g, 7, weight=True),
                              _arrays(g, 2)]], 0),
    "qid": (2, lambda g: [[_arrays(g, 5, qid=True), _arrays(g, 3)],
                          [_empty(), _arrays(g, 4, qid=True)]], 0),
    "field": (3, lambda g: [[_arrays(g, 5, field=True), _empty(),
                             _arrays(g, 6)]], 0),
    "every_optional": (2, lambda g: [[_arrays(g, 6, weight=True, qid=True,
                                              field=True, value=False)] * 2],
                       0),
    "u64": (2, lambda g: [[_arrays(g, 5, index=np.uint64),
                           _empty(np.uint64)]], 0),
    "u64_then_u32": (2, lambda g: [[_arrays(g, 5, index=np.uint64),
                                    _arrays(g, 4)]], 0),
    "u32_then_u64": (2, lambda g: [[_arrays(g, 5),
                                    _arrays(g, 4, index=np.uint64)]], 0),
    "codec": (4, lambda g: [[_arrays(g, int(g.randint(0, RB + 1)),
                                     weight=True, qid=True, field=True)
                             for _ in range(4)] for _ in range(3)], 6),
    "codec_u64": (1, lambda g: [[_arrays(g, RB, NB, index=np.uint64)]], 6),
}


def _write(tmp_path, case, seed):
    parts, build, level = CASES[case]
    rounds = build(np.random.RandomState(seed))
    port = str(tmp_path / "port" / "r.pages")
    ref = str(tmp_path / "ref" / "r.pages")
    w = RoundSpillWriter(port, parts, {"k": case}, codec_level=level)
    rw = RefSpillWriter(ref, parts, {"k": case}, codec_level=level)
    for row in rounds:
        w.add_row([RowBlock(**a) for a in row])
        rw.add_row([RefRowBlock(**a) for a in row])
    return w.commit(), rw.commit(), rounds


def _raw_route(f, r, want_qid, want_field):
    t = f.table
    buf = np.zeros(t.max_size + 8, np.uint8)
    size = f.read_round_into(r, buf)
    rows = t.blocks[r]
    ib = int(rows[0, ROUND_TABLE_COLUMNS.index("index_bytes")])
    return pages.round_unpack_plain(
        torch.from_numpy(buf[:size]), torch.from_numpy(rows.copy()), RB, NB,
        pages.INDEX_DTYPES[ib], want_qid, want_field)


def _same_bytes(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, (what, k)
        assert g.tobytes() == np.ascontiguousarray(v).tobytes(), (what, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_route_is_both_packages_stack(tmp_path, case):
    """read_round_into + round_unpack_plain over each round of the port's
    file and of the reference's (byte-identical files) gives the bytes of
    both packages' stack_padded_rows over their iter_rows, and the header
    scan's table is the writer's."""
    f, rf, rounds = _write(tmp_path, case, seed=sorted(CASES).index(case))
    with open(f.path, "rb") as a, open(rf.path, "rb") as b:
        assert a.read() == b.read()
    assert RoundTable.scan(f.path, f.nparts, f.rounds) == f.table
    ref_file = RoundSpillFile(rf.path, rf.nparts, rf.rounds)  # scanned
    assert ref_file.table == f.table
    port_rows = list(f.iter_rows())
    ref_rows = list(RefSpillFile(rf.path, rf.nparts, rf.rounds).iter_rows())
    assert len(port_rows) == len(ref_rows) == len(rounds)
    for r, (row, ref_row) in enumerate(zip(port_rows, ref_rows)):
        for want_qid in (False, True):
            for want_field in (False, True):
                if not want_qid and any(b.qid is not None for b in row):
                    continue
                if not want_field and any(b.field is not None for b in row):
                    continue
                what = (case, r, want_qid, want_field)
                for pf in (f, ref_file):
                    got = _raw_route(pf, r, want_qid, want_field)
                    _same_bytes(got, stack_padded_rows(
                        row, RB, NB, want_qid, want_field), what)
                    _same_bytes(got, ref_stack(
                        ref_row, RB, NB, want_qid, want_field), what)
    f.close()
    ref_file.close()


def test_round_unpack_on_cpu_is_the_plain_version(tmp_path):
    """On CPU tensors the wrapper runs the plain version, into ``out=``
    too, and counts no launch; its checks refuse a wrong call."""
    f, _, _ = _write(tmp_path, "every_optional", seed=3)
    t = f.table
    buf = np.zeros(t.max_size, np.uint8)
    size = f.read_round_into(0, buf)
    raw = torch.from_numpy(buf[:size])
    table = torch.from_numpy(t.blocks[0].copy())
    before = pages.round_unpack.launches
    want = pages.round_unpack_plain(raw, table, RB, NB, torch.uint32,
                                    True, True)
    got = pages.round_unpack(raw, table, RB, NB, torch.uint32, True, True)
    spec = pages.unpack_spec(2, RB, NB, torch.uint32, True, True)
    out = {k: torch.full(shape, 7, dtype=dt) if dt != torch.uint32 else
           torch.zeros(shape, dtype=dt) for k, (shape, dt) in spec.items()}
    into = pages.round_unpack(raw, table, RB, NB, torch.uint32, True, True,
                              out=out)
    assert into is out
    for k in want:
        assert got[k].numpy().tobytes() == want[k].numpy().tobytes()
        assert out[k].numpy().tobytes() == want[k].numpy().tobytes()
    assert pages.round_unpack.launches == before
    with pytest.raises(DMLCError, match="did not ask"):
        pages.round_unpack(raw, table, RB, NB, torch.uint32, False, True)
    with pytest.raises(DMLCError, match="row bucket too small"):
        pages.round_unpack(raw, table, 4, NB, torch.uint32, True, True)
    with pytest.raises(DMLCError, match="uint8"):
        pages.round_unpack(raw.to(torch.int8), table, RB, NB, torch.uint32,
                           True, True)
    with pytest.raises(DMLCError, match="out="):
        pages.round_unpack(raw, table, RB, NB, torch.uint32, True, False,
                           out=out)
    f.close()


def test_read_round_into_refuses_a_changed_or_short_file(tmp_path):
    """A round whose pages no longer sit where the table says, a file
    cut short, and a scan told of more rounds than the file holds each
    raise the DMLCError ``iter_rows`` raises."""
    f, _, _ = _write(tmp_path, "four_parts", seed=5)
    t = f.table
    buf = np.zeros(t.max_size, np.uint8)
    data = open(f.path, "rb").read()
    pos = int(t.start[1]) + int(t.blocks[1, 2, 0])  # round 1, part 2
    with open(f.path, "wb") as out:
        out.write(data[:pos] + b"XXXX" + data[pos + 4:])
    f.read_round_into(0, buf)
    with pytest.raises(DMLCError, match="do not match its table"):
        f.read_round_into(1, buf)
    with pytest.raises(DMLCError):
        list(RoundSpillFile(f.path, f.nparts, f.rounds).iter_rows())
    f.close()
    with open(f.path, "wb") as out:
        out.write(data[:int(t.start[2]) + 10])
    with pytest.raises(DMLCError, match="truncated page stream"):
        f.read_round_into(2, buf)
    f.close()
    with open(f.path, "wb") as out:
        out.write(data)
    with pytest.raises(DMLCError):
        RoundTable.scan(f.path, f.nparts, f.rounds + 1)
    assert RoundTable.scan(f.path, f.nparts, f.rounds) == t
    os.remove(f.path)


# ------------------------------------------------------- read-ahead stager

def _many_rounds(g, rounds=12, parts=4):
    """Seeded rounds of ``parts`` blocks each, some of them empty pads,
    with every optional array somewhere, u32 indices throughout."""
    out = []
    for r in range(rounds):
        row = []
        for p in range(parts):
            n = int(g.randint(0, RB + 1))
            row.append(_empty() if (r + p) % 5 == 4 else _arrays(
                g, n, weight=bool(g.randint(2)), qid=True,
                field=bool(g.randint(2))))
        out.append(row)
    return out


def _stager_file(tmp_path, level, seed=11):
    """The port's and the reference's spill files of ``_many_rounds``,
    and the reference's stacked batch a round (qid and field asked
    for)."""
    rounds = _many_rounds(np.random.RandomState(seed))
    port = str(tmp_path / f"port{level}" / "r.pages")
    ref = str(tmp_path / f"ref{level}" / "r.pages")
    w = RoundSpillWriter(port, 4, {"k": "many"}, codec_level=level)
    rw = RefSpillWriter(ref, 4, {"k": "many"}, codec_level=level)
    for row in rounds:
        w.add_row([RowBlock(**a) for a in row])
        rw.add_row([RefRowBlock(**a) for a in row])
    f = w.commit()
    want = [ref_stack(row, RB, NB, True, True)
            for row in RefSpillFile(rw.commit().path, 4,
                                    len(rounds)).iter_rows()]
    return f, want


def _stager(monkeypatch, f, readers, group_bytes=1):
    """A CPU stager over ``f`` with ``readers`` page readers (the
    module's PAGE_READERS) reading groups of up to ``group_bytes``
    (PAGE_GROUP_BYTES; 1 reads a round at a time)."""
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.device_iter import HostStaging
    monkeypatch.setattr(sharded, "PAGE_READERS", readers)
    monkeypatch.setattr(sharded, "PAGE_GROUP_BYTES", group_bytes)
    return sharded.RawRoundStager(f, torch.device("cpu"), RB, NB,
                                  HostStaging(3 + readers), None)


@pytest.mark.parametrize("group_bytes", [1, 2000])
@pytest.mark.parametrize("level", [0, 6])
@pytest.mark.parametrize("readers", [1, 2, 3, 4])
def test_read_ahead_gives_each_round_in_order(tmp_path, monkeypatch, level,
                                              readers, group_bytes):
    """RawRoundStager with 1, 2, 3 (the default) and 4 reader threads,
    over a 12-round spill file (raw and codec-paged), a round a read or
    groups of rounds up to 2000 bytes:
    every round's batch is the reference's
    stack_padded_rows's, byte for byte, and the batches come in round
    order although the reads end out of order (each read is held back
    by a seeded delay, longer for earlier rounds)."""
    import time
    from dmlc_tpu_torch.parallel.sharded import round_groups
    f, want = _stager_file(tmp_path, level)
    groups = round_groups(f.table.size, group_bytes)
    assert (len(groups) == f.rounds) == (group_bytes == 1)
    delay = np.random.RandomState(readers).rand(f.rounds) * 0.004
    read = RoundSpillFile.read_rounds_into
    ended = []

    def slow_read(self, r0, r1, buf, stream=None):
        time.sleep(delay[r0] + 0.002 * (f.rounds - r0) / f.rounds)
        out = read(self, r0, r1, buf, stream)
        ended.append(r0)
        return out

    monkeypatch.setattr(RoundSpillFile, "read_rounds_into", slow_read)
    st = _stager(monkeypatch, f, readers, group_bytes)
    try:
        got = [st(r, True, True) for r in range(f.rounds)]
    finally:
        st.close()
    assert len(got) == len(want) == 12
    for r, (g, w) in enumerate(zip(got, want)):
        _same_bytes(g, w, (level, readers, r))
        assert g.counts == (int(w["num_rows"].sum()),
                            int(w["num_nnz"].sum()))
    assert sorted(ended) == [r0 for r0, _ in groups]
    if readers > 1 and group_bytes == 1:
        assert ended != sorted(ended)  # the reads did end out of order
    assert st.staging.in_flight == 0
    with pytest.raises(DMLCError, match="round 3 asked for"):
        _stager(monkeypatch, f, readers)(3, True, True)


def test_round_groups():
    """Round 0 alone, then consecutive rounds in groups of at most twice
    the bytes of the group before, up to the byte cap; a round past the
    cap alone."""
    from dmlc_tpu_torch.parallel.sharded import round_groups
    assert round_groups([5, 3, 3, 3, 9, 2, 1], 7) == [
        (0, 1), (1, 3), (3, 4), (4, 5), (5, 7)]
    assert round_groups([4] * 12, 64) == [(0, 1), (1, 3), (3, 7), (7, 12)]
    assert round_groups([4] * 12, 12) == [(0, 1), (1, 3), (3, 6), (6, 9),
                                          (9, 12)]
    assert round_groups([5, 3, 3], 1) == [(0, 1), (1, 2), (2, 3)]
    assert round_groups([], 8) == []


def test_the_stager_reads_ahead_and_closes_its_readers(tmp_path,
                                                       monkeypatch):
    """The stager keeps ``readers`` groups read ahead of the group it
    stages, no more, each in a slot of its own, hands every slot back,
    and close() stops its reader threads."""
    import threading
    f, _ = _stager_file(tmp_path, 0)
    started = []
    st = _stager(monkeypatch, f, 3)
    submit = st._reads.submit
    st._reads.submit = (lambda r0, r1, buf, after: started.append(r0)
                        or submit(r0, r1, buf, after))
    for r in range(5):
        st(r, True, True)
        assert started == list(range(min(r + 4, f.rounds)))
    st.close()
    assert st.staging.in_flight == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spill.read") and t.is_alive()]


def test_close_waits_for_a_call_in_progress(tmp_path, monkeypatch):
    """close() from another thread while a call waits on its round's read
    (an abandoned epoch's serve thread) lets that call end first, hands
    every slot back, and a later call raises."""
    import threading
    f, want = _stager_file(tmp_path, 0)
    entered, gate = threading.Event(), threading.Event()
    read = RoundSpillFile.read_rounds_into

    def held_read(self, r0, r1, buf, stream=None):
        entered.set()
        gate.wait(10)
        return read(self, r0, r1, buf, stream)

    monkeypatch.setattr(RoundSpillFile, "read_rounds_into", held_read)
    st = _stager(monkeypatch, f, 2)
    got = []
    call = threading.Thread(target=lambda: got.append(st(0, True, True)))
    call.start()
    assert entered.wait(10)  # the call holds the stager, waiting on a read
    closer = threading.Thread(target=st.close)
    closer.start()
    closer.join(0.3)
    assert closer.is_alive() and not got  # close waits for the call
    gate.set()
    call.join(10)
    closer.join(10)
    assert not closer.is_alive() and len(got) == 1
    _same_bytes(got[0], want[0], "closed")
    assert st.staging.in_flight == 0
    with pytest.raises(DMLCError, match="closed"):
        st(1, True, True)


@pytest.mark.parametrize("change", ["truncated", "rewritten"])
@pytest.mark.parametrize("level", [0, 6])
def test_a_group_read_raises_at_the_changed_round(tmp_path, monkeypatch,
                                                  level, change):
    """One read of a group of rounds over a file cut short inside round 7,
    or whose round 7 was rewritten, gives the rounds before it whole and
    raises the round's DMLCError at round 7, after their batches."""
    f, want = _stager_file(tmp_path, level)
    data = open(f.path, "rb").read()
    at = int(f.table.start[7])
    if change == "truncated":
        data, match = data[:at + 10], "truncated page stream"
    else:
        data = data[:at] + b"XXXX" + data[at + 4:]
        match = "round 7's pages do not match its table"
    with open(f.path, "wb") as out:
        out.write(data)
    st = _stager(monkeypatch, f, 2, group_bytes=1 << 20)
    # round 7 is read with rounds before it, by one read
    assert [g for g in st._groups if g[0] < 7 < g[1]]
    got = []
    with pytest.raises(DMLCError, match=match):
        for r in range(f.rounds):
            got.append(st(r, True, True))
    st.close()
    assert len(got) == 7 and st.staging.in_flight == 0
    for r, (g, w) in enumerate(zip(got, want)):
        _same_bytes(g, w, (level, change, r))


def _page_iter(tmp_path, monkeypatch, readers, rows=150, group_bytes=1,
               **kw):
    """A ShardedRowBlockIter over 4 CPU parts of a seeded libsvm file,
    past a tiny replay budget (so its third epoch is a page epoch), with
    ``readers`` page readers reading groups of up to ``group_bytes`` (1:
    a round a read); and its parse epoch's batches, copied."""
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    monkeypatch.setattr(sharded, "PAGE_READERS", readers)
    monkeypatch.setattr(sharded, "PAGE_GROUP_BYTES", group_bytes)
    p = tmp_path / "d.libsvm"
    rng = np.random.RandomState(29)
    p.write_bytes(b"".join(
        f"{i % 2} qid:{i // 4} ".encode() + b" ".join(
            f"{j}:{rng.rand():.6f}".encode() for j in sorted(
                rng.choice(60, int(rng.randint(1, 9)), replace=False)))
        + b"\n" for i in range(rows)))
    it = ShardedRowBlockIter(str(p), Mesh((4,), ("data",), device="cpu"),
                             format="libsvm", row_bucket=4, nnz_bucket=32,
                             agreement_cache_bytes=256,
                             first_epoch_cache="never",
                             spill_dir=str(tmp_path / "spill"), **kw)
    parse = [{k: v.numpy().copy() for k, v in b.items()} for b in it]
    again = [{k: v.numpy().copy() for k, v in b.items()} for b in it]
    _same_epochs(again, parse)
    assert it._round_store.tier == "pages" and it.raw_page_epochs == 0
    return it, parse


def _same_epochs(got, want):
    assert len(got) == len(want) > 0
    for r, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), r
        for k in w:
            a = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert a.dtype == w[k].dtype and a.shape == w[k].shape, (r, k)
            assert a.tobytes() == w[k].tobytes(), (r, k)


@pytest.mark.parametrize("group_bytes", [1, 1 << 20])
@pytest.mark.parametrize("readers", [1, 2, 4])
def test_page_epochs_keep_every_batch(tmp_path, monkeypatch, readers,
                                      group_bytes):
    """Page epochs with 1, 2 and 4 readers, a round a read or groups of
    rounds, give the parse epoch's batches in order; a list of all of an
    epoch's batches, kept through the next page epoch, still holds each
    round's bytes (no output is reused); and each batch's tensors are
    views of one storage, each key at a multiple of 256 bytes."""
    it, parse = _page_iter(tmp_path, monkeypatch, readers,
                           group_bytes=group_bytes)
    kept = list(it)
    assert it.replay_tier == "pages" and it.raw_page_epochs == 1
    _same_epochs(list(it), parse)
    assert it.raw_page_epochs == 2
    _same_epochs(kept, parse)
    for b in kept:
        assert len({t.untyped_storage().data_ptr() for t in b.values()}) == 1
        assert all(t.is_contiguous()
                   and t.storage_offset() * t.element_size() % 256 == 0
                   for t in b.values())
    it.close()


@pytest.mark.parametrize("change", ["truncated", "rewritten"])
def test_a_spill_file_changed_mid_epoch_raises_at_its_round(tmp_path,
                                                            monkeypatch,
                                                            change):
    """A spill file cut short or rewritten in its last round while a page
    epoch runs (4 readers ahead, a round a read) raises the DMLCError of
    its round on the consumer's thread, after every earlier round's
    batch, and the epoch does not fall back to the parse."""
    it, parse = _page_iter(tmp_path, monkeypatch, 4, rows=240)
    f = it._round_store.file
    rounds = f.rounds
    assert rounds >= 12
    last = int(f.table.start[-1])
    got, pages = [], iter(it)
    got.append({k: v.numpy().copy() for k, v in next(pages).items()})
    if change == "truncated":
        with open(f.path, "r+b") as out:
            out.truncate(last + 3)
        match = "truncated page stream"
    else:
        with open(f.path, "r+b") as out:
            out.seek(last)
            out.write(b"XXXX")
        match = "do not match its table"
    with pytest.raises(DMLCError, match=match):
        for b in pages:
            got.append({k: v.numpy().copy() for k, v in b.items()})
    assert len(got) == rounds - 1
    _same_epochs(got, parse[:rounds - 1])
    assert it.replay_tier == "pages" and it.raw_page_epochs == 1
    it.close()


@pytest.mark.parametrize("readers", [1, 4])
def test_read_faults_retry_to_the_same_bytes(tmp_path, monkeypatch, readers):
    """A seeded fault plan failing page reads (``io.stream.read``: the
    first two reads, then one in five) is retried by the readers' own
    streams, and the page epoch still gives the parse epoch's bytes."""
    from dmlc_tpu_torch.resilience import inject
    it, parse = _page_iter(tmp_path, monkeypatch, readers)
    plan = inject.install("site=io.stream.read,fault=ioerror,times=2;"
                          "site=io.stream.read,fault=ioerror,nth=5",
                          seed=17)
    try:
        got = [{k: v.numpy().copy() for k, v in b.items()} for b in it]
    finally:
        inject.uninstall()
    assert plan.injected == 3
    _same_epochs(got, parse)
    assert it.replay_tier == "pages" and it.raw_page_epochs == 1
    it.close()


def test_round_stage_on_cpu_copies_then_unpacks(tmp_path):
    """A ``RoundStage`` call on a CPU buffer copies the round's bytes into
    it and gives the plain version's batch (views of one storage), counts
    no launch, and refuses a host round that is not 1-D uint8, a buffer
    too small and a round the table does not hold."""
    f, _, _ = _write(tmp_path, "every_optional", seed=3)
    buf = np.zeros(f.table.max_size, np.uint8)
    size = f.read_round_into(0, buf)
    host = torch.from_numpy(buf[:size])
    table = torch.from_numpy(f.table.blocks[0].copy())
    raw = torch.full((size + 5,), 9, dtype=torch.uint8)
    before = pages.round_unpack.launches
    stage = pages.RoundStage(raw, table, RB, NB)
    got = stage(host, 0, torch.uint32, True, True)
    want = pages.round_unpack_plain(host, table, RB, NB, torch.uint32, True,
                                    True)
    assert raw[:size].numpy().tobytes() == buf[:size].tobytes()
    assert pages.round_unpack.launches == before
    _same_bytes(got, {k: v.numpy() for k, v in want.items()}, "stage")
    assert len({t.untyped_storage().data_ptr() for t in got.values()}) == 1
    keys, total = pages.unpack_layout(2, RB, NB, torch.uint32, True, True)
    assert [k for k, *_ in keys] == list(want)
    assert all(a % 256 == 0 for _, a, *_ in keys)
    assert total >= sum(n for _, _, n, *_ in keys)
    with pytest.raises(DMLCError, match="does not fit it or dev_raw's"):
        pages.RoundStage(raw[:size - 1], table, RB, NB)(
            host, 0, torch.uint32, True, True)
    with pytest.raises(DMLCError, match="host must be"):
        stage(raw.view(torch.int8), 0, torch.uint32, True, True)
    for r in (1, -1):
        with pytest.raises(DMLCError, match="is not one of the table's 1"):
            stage(host, r, torch.uint32, True, True)
    f.close()


def test_a_key_appearing_inside_a_group_gets_its_own_batch(tmp_path,
                                                           monkeypatch):
    """Rounds read as one group whose later rounds first carry qid: the
    rounds asked for without qid come from the group's one allocation,
    the later ones, asked for with qid, each from their own, all byte for
    byte the reference's stack_padded_rows with the same keys."""
    g = np.random.RandomState(41)
    rounds = [[_arrays(g, 5, qid=r >= 6), _arrays(g, 3)] for r in range(10)]
    path = str(tmp_path / "p" / "r.pages")
    w = RoundSpillWriter(path, 2, {"k": "flip"}, codec_level=0)
    for row in rounds:
        w.add_row([RowBlock(**a) for a in row])
    f = w.commit()
    st = _stager(monkeypatch, f, 2, group_bytes=1 << 20)
    assert [grp for grp in st._groups if grp[0] < 6 < grp[1]]
    got = [st(r, r >= 6, False) for r in range(10)]
    st.close()
    storages = [b["offset"].untyped_storage().data_ptr() for b in got]
    for r, row in enumerate(rounds):
        want = ref_stack([RefRowBlock(**a) for a in row], RB, NB, r >= 6,
                         False)
        _same_bytes(got[r], want, ("flip", r))
    group = next(grp for grp in st._groups if grp[0] < 6 < grp[1])
    assert len(set(storages[group[0]:6])) == 1
    assert len(set(storages[6:group[1]])) == group[1] - 6
