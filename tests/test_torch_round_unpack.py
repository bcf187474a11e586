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
