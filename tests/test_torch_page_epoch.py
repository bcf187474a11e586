"""A page epoch's batches from precomputed group layouts, on the CPU.

``ops.pages.group_layout`` places a group of rounds' batches in one byte
buffer and works out each view's dtype, shape, stride and offset once;
``RoundStage.batches`` makes the buffer and the views from it. The
stager (``parallel.sharded.RawRoundStager``) works out every group's
layout at construction for the keys the iterator asks for. These tests
hold the layout to ``unpack_layout``, and the page epochs it serves to
the reference's ``stack_padded_rows`` byte for byte. That a steady page
epoch makes no new device allocation shows only on the card:
``chip_smoke.py`` prints each page epoch's ``num_device_alloc`` and
holds it to 0 after the first.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import stack_padded_rows as ref_stack
from dmlc_tpu.data.row_iter import RoundSpillFile as RefSpillFile
from dmlc_tpu.data.row_iter import RoundSpillWriter as RefSpillWriter
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu_torch.data.row_iter import ROUND_TABLE_COLUMNS, RoundSpillWriter
from dmlc_tpu_torch.data.rowblock import RowBlock
from dmlc_tpu_torch.ops import pages

RB, NB = 8, 32  # row_bucket, nnz_bucket
U32, U64 = torch.uint32, torch.uint64

PLANS = {
    "one_round": ((U32, False, False),),
    "uniform": ((U32, False, False),) * 5,
    "qid_field": ((U64, True, True),) * 3,
    "mixed": ((U32, False, False), (U64, True, False), (U32, True, True),
              (U64, False, True)),
}


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_group_layout_places_each_round_as_unpack_layout(plan, parts):
    """Each round of a group lies where ``unpack_layout`` places it, the
    rounds back to back: every view's key, dtype and shape are
    ``unpack_spec``'s, its stride contiguous and its offset the round's
    start plus the key's; and ``RoundStage.batches`` makes exactly those
    views of one buffer of the layout's size."""
    plans = PLANS[plan]
    lay = pages.group_layout(parts, RB, NB, plans)
    assert pages.group_layout(parts, RB, NB, plans) is lay  # cached
    assert len(lay.rounds) == len(plans)
    at, dtypes = 0, set()
    for p, keys in zip(plans, lay.rounds):
        want, total = pages.unpack_layout(parts, RB, NB, *p)
        spec = pages.unpack_spec(parts, RB, NB, *p)
        assert [k for k, *_ in keys] == [k for k, *_ in want] == list(spec)
        for (k, dtype, shape, stride, offset), (_, a, n, wshape,
                                                wdtype) in zip(keys, want):
            assert (shape, dtype) == (wshape, wdtype) == spec[k]
            assert stride == torch.empty(shape).stride()
            assert offset * dtype.itemsize == at + a
            assert n == int(np.prod(shape)) * dtype.itemsize
            dtypes.add(dtype)
        at += total
    assert lay.nbytes == at and set(lay.dtypes) == dtypes
    stage = pages.RoundStage(
        torch.zeros(16, dtype=torch.uint8),
        torch.zeros((1, parts, len(ROUND_TABLE_COLUMNS)), dtype=torch.int64),
        RB, NB)
    made = stage.batches(lay)
    assert made[0]["offset"].untyped_storage().nbytes() == lay.nbytes
    assert len({t.untyped_storage().data_ptr()
                for b in made for t in b.values()}) == 1
    for batch, keys in zip(made, lay.rounds):
        assert list(batch) == [k for k, *_ in keys]
        for k, dtype, shape, stride, offset in keys:
            t = batch[k]
            assert (t.dtype, tuple(t.shape), t.stride(),
                    t.storage_offset()) == (dtype, shape, stride, offset)
            assert t.is_contiguous()
    assert [list(b) for b in stage.outputs(plans)] == [list(b) for b in made]


def _arrays(rng, n, qid=True):
    """One block's arrays: n rows of 1-4 nonzeros, qid on each row."""
    nnz = rng.randint(1, 5, n)
    out = {"offset": np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64),
           "label": rng.randn(n).astype(np.float32),
           "index": rng.randint(0, 1 << 31, int(nnz.sum())).astype(
               np.uint32),
           "value": rng.randn(int(nnz.sum())).astype(np.float32)}
    if qid:
        out["qid"] = rng.randint(0, 9, n).astype(np.int64)
    return out


def _spill(tmp_path, rounds, qid_from=0, parts=2):
    """The port's spill file of ``rounds`` seeded rounds (qid on every
    block from round ``qid_from`` on), and the reference's rows of the
    same file."""
    g = np.random.RandomState(29)
    rows = [[_arrays(g, int(g.randint(1, RB + 1)), qid=r >= qid_from)
             for _ in range(parts)] for r in range(rounds)]
    path = str(tmp_path / "port" / "r.pages")
    ref = str(tmp_path / "ref" / "r.pages")
    w = RoundSpillWriter(path, parts, {"k": "epoch"}, codec_level=0)
    rw = RefSpillWriter(ref, parts, {"k": "epoch"}, codec_level=0)
    for row in rows:
        w.add_row([RowBlock(**a) for a in row])
        rw.add_row([RefRowBlock(**a) for a in row])
    rw.commit()
    return w.commit(), list(RefSpillFile(ref, parts, rounds).iter_rows())


def _same_bytes(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, (what, k)
        assert g.tobytes() == np.ascontiguousarray(v).tobytes(), (what, k)


def _stager(monkeypatch, f, want, readers=2, group_bytes=1 << 20):
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.device_iter import HostStaging
    monkeypatch.setattr(sharded, "PAGE_READERS", readers)
    monkeypatch.setattr(sharded, "PAGE_GROUP_BYTES", group_bytes)
    return sharded.RawRoundStager(f, torch.device("cpu"), RB, NB,
                                  HostStaging(3 + readers), None, want)


def test_a_group_asked_for_as_planned_comes_from_its_layout(tmp_path,
                                                            monkeypatch):
    """Rounds asked for with the keys the stager was built for take
    their group's precomputed layout: one storage a group, each of the
    largest group's size, the reference's bytes; the pinned slots all
    come back."""
    f, ref_rows = _spill(tmp_path, 12)
    st = _stager(monkeypatch, f, (True, False))
    assert len(st._groups) < f.rounds
    got = [st(r, True, False) for r in range(f.rounds)]
    st.close()
    assert st.staging.in_flight == 0
    for r, row in enumerate(ref_rows):
        _same_bytes(got[r], ref_stack(row, RB, NB, True, False), r)
    for r0, r1 in st._groups:
        ptrs = {got[r]["offset"].untyped_storage().data_ptr()
                for r in range(r0, r1)}
        assert len(ptrs) == 1, (r0, r1)
        assert got[r0]["offset"].untyped_storage().nbytes() == \
            max(x.nbytes for x in st._layouts) > st._layouts[0].nbytes


def test_a_round_whose_keys_differ_from_the_plan_gets_its_own_batch(
        tmp_path, monkeypatch):
    """A stager built for qid, asked for rounds without it first (their
    groups laid out for the keys asked for when their reads started),
    then with it inside a group: the rounds asked for with other keys
    than their group's plan each get a batch of their own, and every
    batch is the reference's stack_padded_rows with the keys asked
    for."""
    f, ref_rows = _spill(tmp_path, 12, qid_from=5)
    st = _stager(monkeypatch, f, (True, False))
    group = next(g for g in st._groups if g[0] < 5 < g[1])
    got = [st(r, r >= 5, False) for r in range(f.rounds)]
    st.close()
    for r, row in enumerate(ref_rows):
        _same_bytes(got[r], ref_stack(row, RB, NB, r >= 5, False), r)
    ptrs = [b["offset"].untyped_storage().data_ptr() for b in got]
    assert len(set(ptrs[group[0]:5])) == 1
    assert len(set(ptrs[5:group[1]])) == group[1] - 5
    assert ptrs[group[0]] not in ptrs[5:group[1]]


def test_page_epochs_are_the_references_stack_and_kept_batches_stay(
        tmp_path, monkeypatch):
    """Three page epochs of a ShardedRowBlockIter over 2 CPU parts, each
    epoch's batches all kept until the last has run: every batch is, byte
    for byte, the reference's stack_padded_rows over the reference's
    iter_rows of the spill file; every epoch's stager is built for the
    iterator's keys (qid), so no round falls back to a batch of its own
    and each group's rounds share one storage; and the epochs share one
    pool of slots, all back in it after each."""
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    monkeypatch.setattr(sharded, "PAGE_GROUP_BYTES", 1 << 20)
    stagers = []
    init = sharded.RawRoundStager.__init__

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        stagers.append(self)

    monkeypatch.setattr(sharded.RawRoundStager, "__init__", recording_init)
    p = tmp_path / "d.libsvm"
    rng = np.random.RandomState(7)
    p.write_bytes(b"".join(
        f"{i % 2} qid:{i // 3} ".encode() + b" ".join(
            f"{j}:{rng.rand():.6f}".encode() for j in sorted(
                rng.choice(50, int(rng.randint(1, 7)), replace=False)))
        + b"\n" for i in range(160)))
    it = ShardedRowBlockIter(str(p), Mesh((2,), ("data",), device="cpu"),
                             format="libsvm", row_bucket=4, nnz_bucket=32,
                             agreement_cache_bytes=256,
                             first_epoch_cache="never",
                             spill_dir=str(tmp_path / "spill"))
    for _ in range(2):  # the parse epoch, then the re-parse that spills
        list(it)
    f = it._round_store.file
    assert it._round_store.tier == "pages" and f.rounds >= 8
    ref_rows = list(RefSpillFile(f.path, f.nparts, f.rounds).iter_rows())
    epochs = [list(it) for _ in range(3)]
    assert it.replay_tier == "pages" and it.raw_page_epochs == 3
    assert len(stagers) == 3
    # one pool of slots, handed from each page epoch to the next
    assert len({id(st.staging) for st in stagers}) == 1
    assert it._page_staging is stagers[0].staging
    assert it._page_staging.in_flight == 0
    for e, kept in enumerate(epochs):
        assert len(kept) == f.rounds
        st = stagers[e]
        assert st._want == (True, False)
        for r, row in enumerate(ref_rows):
            _same_bytes(kept[r], ref_stack(row, 4, 32, True, False), (e, r))
        for r0, r1 in st._groups:
            assert len({kept[r]["offset"].untyped_storage().data_ptr()
                        for r in range(r0, r1)}) == 1, (e, r0, r1)
    it.close()


def test_an_abandoned_page_epoch_keeps_its_pool_until_it_closes(
        tmp_path, monkeypatch):
    """A page epoch left after its first batch, its generator still open,
    keeps its pool of slots: the next page epoch makes its own and gives
    every batch; the abandoned epoch's pool comes back when it closes."""
    from dmlc_tpu_torch.parallel import sharded
    from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter
    monkeypatch.setattr(sharded, "PAGE_GROUP_BYTES", 1 << 20)
    p = tmp_path / "d.libsvm"
    p.write_bytes(b"".join(f"{i % 2} {i % 40}:1 {40 + i % 9}:2\n".encode()
                           for i in range(120)))
    it = ShardedRowBlockIter(str(p), Mesh((2,), ("data",), device="cpu"),
                             format="libsvm", row_bucket=4, nnz_bucket=32,
                             agreement_cache_bytes=256,
                             first_epoch_cache="never",
                             spill_dir=str(tmp_path / "spill"))
    parse = [{k: v.numpy().copy() for k, v in b.items()} for b in it]
    list(it)  # the re-parse that spills
    list(it)  # a page epoch: its pool is the iterator's now
    pool = it._page_staging
    assert pool is not None and it.replay_tier == "pages"
    left = iter(it)
    next(left)
    assert it._page_staging is None  # the open epoch holds the pool
    got = list(it)
    assert len(got) == len(parse)
    for g, w in zip(got, parse):
        _same_bytes(g, w, "after an abandoned epoch")
    fresh = it._page_staging
    assert fresh is not None and fresh is not pool
    left.close()
    assert it._page_staging is pool and pool.in_flight == 0
    it.close()
