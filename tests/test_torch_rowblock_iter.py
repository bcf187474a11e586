"""``RowBlockIter.create`` (dmlc-core's ``RowBlockIter<I>::Create``) in
the port against the JAX package's: the in-RAM ``BasicRowIter`` and the
``'#cache'`` ``DiskRowIter``, at 1 and 2 parts, for both parse engines.
The concatenated blocks' ``RowBlock.content_hash()`` must equal the
reference's (the byte bar, ROADMAP C3), ``num_col`` too; a cache entry
is named ``<cache>.pages.p<part>-<nparts>`` and stamped with the source
fingerprint as the reference's, its bytes are the reference's, and each
package replays the other's. Corpora are made from seeds with numpy;
every cache lives under the test's own temporary directory (one per
package where both build)."""

import os

import numpy as np
import pytest

import dmlc_tpu.data as ref_data
import dmlc_tpu_torch
import dmlc_tpu_torch.data as data
from dmlc_tpu.data.row_iter import RowBlockIter as RefRowBlockIter
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu_torch.data.parser import DataIter
from dmlc_tpu_torch.data.row_iter import (
    BasicRowIter, DiskRowIter, RowBlockIter,
)
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.native import native_available

ENGINES = ["python"] + (["native"] if native_available() else [])


def _libsvm(path, seed, rows=3000, features=5000):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(rows):
            nnz = rng.randint(0, 30)
            idx = np.sort(rng.choice(features, nnz, replace=False))
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{v:.5f}" for j, v in zip(idx, rng.rand(nnz))) + "\n")
    return str(path)


def _drain(it, container_cls, index_dtype=np.uint32):
    """Every block of one pass, joined; and the pass's block count."""
    c = container_cls(index_dtype)
    blocks = 0
    it.before_first()
    while it.next():
        c.push_block(it.value())
        blocks += 1
    return c.get_block(), blocks


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("num_parts", [1, 2])
def test_in_ram_iter_equals_reference(tmp_path, engine, num_parts):
    path = _libsvm(tmp_path / "a.libsvm", seed=num_parts)
    for part in range(num_parts):
        ref = RefRowBlockIter.create(path, part, num_parts, format="libsvm",
                                     engine=engine)
        got = RowBlockIter.create(path, part, num_parts, format="libsvm",
                                  engine=engine)
        assert isinstance(got, BasicRowIter)
        want, _ = _drain(ref, RefContainer)
        for _ in range(2):  # the pass replays from RAM
            block, blocks = _drain(got, RowBlockContainer)
            assert blocks == 1
            assert block.content_hash() == want.content_hash()
        assert got.num_col() == ref.num_col()
        assert [b.size for b in got] == [want.size]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("num_parts", [1, 2])
def test_cache_iter_equals_reference(tmp_path, engine, num_parts):
    path = _libsvm(tmp_path / "c.libsvm", seed=10 + num_parts)
    for d in ("ref", "port"):
        os.makedirs(tmp_path / d)
    for part in range(num_parts):
        ref_cache = str(tmp_path / "ref" / "pages.cache")
        cache = str(tmp_path / "port" / "pages.cache")
        ref = RefRowBlockIter.create(f"{path}#{ref_cache}", part, num_parts,
                                     format="libsvm", engine=engine)
        got = RowBlockIter.create(f"{path}#{cache}", part, num_parts,
                                  format="libsvm", engine=engine)
        assert isinstance(got, DiskRowIter)
        entry = f"{cache}.pages.p{part}-{num_parts}"
        assert got.cache_file == entry and os.path.exists(entry)
        with open(entry, "rb") as f, \
                open(f"{ref_cache}.pages.p{part}-{num_parts}", "rb") as g:
            assert f.read() == g.read()
        want, _ = _drain(ref, RefContainer)
        build, _ = _drain(got, RowBlockContainer)
        assert build.content_hash() == want.content_hash()
        # a fresh iterator replays the pages: same rows, same num_col
        replay = RowBlockIter.create(f"{path}#{cache}", part, num_parts,
                                     format="libsvm", engine=engine)
        again, _ = _drain(replay, RowBlockContainer)
        assert again.content_hash() == want.content_hash()
        assert got.num_col() == replay.num_col() == ref.num_col()
        del ref, got, replay


def test_each_package_replays_the_others_cache(tmp_path):
    path = _libsvm(tmp_path / "x.libsvm", seed=3)
    cache = str(tmp_path / "shared.cache")
    ref = RefRowBlockIter.create(f"{path}#{cache}", 0, 1, format="libsvm")
    want, _ = _drain(ref, RefContainer)
    entry = cache + ".pages.p0-1"
    # a rebuild publishes a new file by rename (a new inode); a replay
    # only bumps the entry's LRU clock (its mtime)
    inode = os.stat(entry).st_ino
    got = RowBlockIter.create(f"{path}#{cache}", 0, 1, format="libsvm")
    block, _ = _drain(got, RowBlockContainer)
    assert block.content_hash() == want.content_hash()
    assert os.stat(entry).st_ino == inode  # replayed, not rebuilt
    assert got.num_col() == ref.num_col()
    del ref, got

    other = str(tmp_path / "other.cache")
    got = RowBlockIter.create(f"{path}#{other}", 0, 1, format="libsvm")
    mine, _ = _drain(got, RowBlockContainer)
    ref = RefRowBlockIter.create(f"{path}#{other}", 0, 1, format="libsvm")
    theirs, _ = _drain(ref, RefContainer)
    assert theirs.content_hash() == mine.content_hash() == \
        want.content_hash()
    del ref, got


def test_cache_replays_without_the_source_and_parts_stay_apart(tmp_path):
    lines = [f"{i} {i + 1}:1.0" for i in range(100)]
    src = tmp_path / "s.libsvm"
    src.write_text("\n".join(lines) + "\n")
    uri = f"{src}#{tmp_path / 'shared.cache'}"
    it0 = RowBlockIter.create(uri, 0, 2, format="libsvm", prefetch=False)
    it1 = RowBlockIter.create(uri, 1, 2, format="libsvm", prefetch=False)
    lab0 = np.concatenate([b.label for b in it0])
    lab1 = np.concatenate([b.label for b in it1])
    assert set(lab0).isdisjoint(set(lab1))
    assert sorted(np.concatenate([lab0, lab1])) == list(range(100))
    del it0, it1
    src.unlink()
    again = RowBlockIter.create(uri, 0, 2, format="libsvm")
    assert np.array_equal(np.concatenate([b.label for b in again]), lab0)


def test_stamped_cache_rebuilds_on_source_change(tmp_path):
    src = tmp_path / "d.libsvm"
    src.write_text("1 1:1.0\n0 2:2.0\n" * 50)
    uri = f"{src}?format=libsvm#{tmp_path / 'cache'}"
    it = RowBlockIter.create(uri, 0, 1)
    assert sum(float(b.label.sum()) for b in it) == 50.0
    del it
    src.write_text("1 1:1.0\n1 2:2.0\n" * 50)
    it2 = RowBlockIter.create(uri, 0, 1)
    assert sum(float(b.label.sum()) for b in it2) == 100.0


def test_num_col_and_the_value_contract(tmp_path):
    src = tmp_path / "n.libsvm"
    src.write_text("1 3:1\n0 103:2 7:1\n")
    it = RowBlockIter.create(str(src), format="libsvm")
    ref = RefRowBlockIter.create(str(src), format="libsvm")
    assert it.num_col() == ref.num_col() == 104
    fresh = RowBlockIter.create(str(src), format="libsvm")
    with pytest.raises(dmlc_tpu_torch.DMLCError, match="before next"):
        fresh.value()
    with pytest.raises(NotImplementedError):
        RowBlockIter.num_col(object.__new__(RowBlockIter))


def test_exports_equal_the_reference():
    assert issubclass(RowBlockIter, DataIter)
    assert issubclass(DiskRowIter, RowBlockIter)
    assert issubclass(BasicRowIter, RowBlockIter)
    assert data.__all__ == ref_data.__all__
    assert data.RowBlockIter is RowBlockIter
    assert dmlc_tpu_torch.RowBlockIter is RowBlockIter
