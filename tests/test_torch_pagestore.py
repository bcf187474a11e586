"""The port's page store (``dmlc_tpu_torch/io/pagestore.py``): the cases
of ``tests/test_pagestore.py`` that need neither the objstore nor the
resilience plane — atomic commit and abort, fingerprint stamps and the
stale rebuild, budget and LRU eviction sparing pinned entries, the
dead-pid and stale-tmp sweep — plus ``stat_fingerprint`` held equal to
the JAX package's for the same local files, and the two packages'
default roots held apart (both derive the same spill-file names)."""

import json
import os

import numpy as np
import pytest

from dmlc_tpu.io import pagestore as ref_pagestore
from dmlc_tpu_torch.io import pagestore
from dmlc_tpu_torch.io.pagestore import (
    PageStore, fingerprint_fresh, stat_fingerprint, stat_uri,
)


# ------------------------------------------------------ stat plumbing

def test_stat_uri_local(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"abc")
    size, mtime_ns, ctime_ns, ino = stat_uri(str(p))
    st = os.stat(p)
    assert (size, mtime_ns, ctime_ns, ino) == (3, st.st_mtime_ns,
                                               st.st_ctime_ns, st.st_ino)
    assert stat_uri(f"file://{p}") == stat_uri(str(p))
    assert stat_uri(str(p)) == ref_pagestore.stat_uri(str(p))


@pytest.mark.parametrize("scheme", ["", "file://"])
def test_stat_fingerprint_matches_reference(tmp_path, scheme):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        p = tmp_path / f"part{i}.libsvm"
        p.write_bytes(rng.bytes(100 + 37 * i))
        paths.append(scheme + str(p))
    fp = stat_fingerprint(paths)
    assert fp == ref_pagestore.stat_fingerprint(paths)
    assert [e[1] for e in fp] == [100, 137, 174]


def test_fingerprint_fresh_and_stale(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"abc")
    fp = stat_fingerprint([str(p)])
    assert fingerprint_fresh(fp) is True
    p.write_bytes(b"abcd")  # size change
    assert fingerprint_fresh(fp) is False
    assert fingerprint_fresh(None) is None
    assert fingerprint_fresh([[str(tmp_path / "gone"), 1, 2]]) is False
    # a scheme the port has no filesystem for: unknowable, never stale
    assert fingerprint_fresh([["s3://b/k", 1, 2]]) is None


def test_default_roots_differ_and_honour_their_variables(tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv(pagestore.ENV_STORE_DIR, raising=False)
    monkeypatch.delenv(ref_pagestore.ENV_STORE_DIR, raising=False)
    assert pagestore.ENV_STORE_DIR != ref_pagestore.ENV_STORE_DIR
    assert (pagestore.default_store_dir()
            != ref_pagestore.default_store_dir())
    monkeypatch.setenv(pagestore.ENV_STORE_DIR, str(tmp_path / "port"))
    assert pagestore.default_store_dir() == str(tmp_path / "port")
    assert ref_pagestore.default_store_dir() != str(tmp_path / "port")


# --------------------------------------------------------- the store

def _store(tmp_path, budget=None):
    return PageStore.at(str(tmp_path / "store"), byte_budget=budget)


def _commit(st, name, data=b"x", fingerprint=None, meta=None):
    w = st.writer(name, fingerprint=fingerprint, meta=meta)
    w.write(data)
    return w.commit()


def test_commit_publishes_entry_and_stamp(tmp_path):
    st = _store(tmp_path)
    fp = [["src", 10, 20]]
    path = _commit(st, "e1.pages", b"payload", fp, {"k": "v"})
    assert os.path.exists(path)
    stamp = st.stamp("e1.pages")
    assert stamp["fingerprint"] == fp
    assert stamp["k"] == "v"
    assert stamp["bytes"] == len(b"payload")
    assert [n for n in os.listdir(st.root) if ".tmp" in n] == []


def test_commit_matches_reference_sidecar(tmp_path):
    fp = [["src", 10, 20]]
    port = _store(tmp_path)
    ref = ref_pagestore.PageStore.at(str(tmp_path / "ref"))
    for st in (port, ref):
        w = st.writer("e.pages", fingerprint=fp, meta={"k": "v"})
        w.write(b"payload")
        w.commit()
    with open(port.path("e.pages") + pagestore.META_SUFFIX) as f:
        a = json.load(f)
    with open(ref.path("e.pages") + ref_pagestore.META_SUFFIX) as f:
        b = json.load(f)
    assert a == b


def test_abort_leaves_nothing(tmp_path):
    st = _store(tmp_path)
    w = st.writer("e2.pages")
    w.write(b"half")
    w.abort()
    assert os.listdir(st.root) == []


def test_lookup_hits_present_and_misses_absent(tmp_path):
    st = _store(tmp_path)
    assert st.lookup("absent.pages") is None
    _commit(st, "e3.pages")
    assert st.lookup("e3.pages") == st.path("e3.pages")


def test_stale_fingerprint_lookup_deletes_and_misses(tmp_path):
    st = _store(tmp_path)
    _commit(st, "e4.pages", fingerprint=[["s", 1, 2]])
    assert st.lookup("e4.pages", fingerprint=[["s", 1, 2]]) is not None
    assert st.lookup("e4.pages", fingerprint=[["s", 9, 2]]) is None
    assert not st.exists("e4.pages")
    assert st.stamp("e4.pages") is None


def test_open_read_missing_is_none(tmp_path):
    st = _store(tmp_path)
    assert st.open_read("ghost.pages") is None
    _commit(st, "here.pages", b"abc")
    with st.open_read("here.pages") as s:
        assert s.read_all() == b"abc"


def test_budget_lru_eviction_skips_pinned(tmp_path):
    st = _store(tmp_path)
    for i, age in ((0, 100), (1, 200), (2, 300)):
        _commit(st, f"e{i}.pages", b"x" * 100)
        os.utime(st.path(f"e{i}.pages"), (age, age))
    st.pin("e0.pages")  # the oldest is pinned: must survive
    assert st.set_budget(150) == 2
    assert st.exists("e0.pages")
    assert not st.exists("e1.pages")
    assert not st.exists("e2.pages")
    st.unpin("e0.pages")
    assert st.set_budget(10) == 1
    assert not st.exists("e0.pages")


def test_budget_spares_a_live_writers_spill(tmp_path):
    st = _store(tmp_path)
    mine = f"rounds-k-p{os.getpid()}-1.pages"
    _commit(st, mine, b"x" * 100)
    _commit(st, "cold.pages", b"x" * 100)
    os.utime(st.path(mine), (100, 100))  # older, but its writer lives
    assert st.set_budget(150) == 1
    assert st.exists(mine) and not st.exists("cold.pages")
    st.set_budget(None)


def test_used_bytes_counts_recognized_entries_only(tmp_path):
    st = _store(tmp_path)
    _commit(st, "a.pages", b"12345")
    with open(os.path.join(st.root, "alien.bin"), "wb") as f:
        f.write(b"x" * 1000)  # no .pages suffix, no sidecar
    assert st.used_bytes() == 5


def test_for_path_roots_at_directory(tmp_path):
    st, entry = PageStore.for_path(str(tmp_path / "sub" / "c.bin"))
    assert st.root == str(tmp_path / "sub")
    assert entry == "c.bin"
    st2, _ = PageStore.for_path(str(tmp_path / "sub" / "d.bin"))
    assert st2 is st


def test_sweep(tmp_path):
    src = tmp_path / "src.txt"
    src.write_bytes(b"hello\n")
    fp = stat_fingerprint([str(src)])
    stale_fp = [[str(src), fp[0][1] + 7, fp[0][2]]]
    st = _store(tmp_path)
    _commit(st, "fresh.pages", fingerprint=fp)
    _commit(st, "stale.pages", fingerprint=stale_fp)
    with open(st.path("ghost.pages.meta.json"), "w") as f:
        json.dump({}, f)
    open(st.path("dead.pages.tmp"), "wb").close()
    os.utime(st.path("dead.pages.tmp"), (1, 1))
    with open(st.path("alien.dat"), "wb") as f:
        f.write(b"not ours")
    assert st.sweep() == 3  # stale entry, orphan sidecar, old tmp
    assert st.exists("fresh.pages")
    assert st.stamp("fresh.pages")["fingerprint"] == fp
    assert not st.exists("stale.pages")
    assert not os.path.exists(st.path("ghost.pages.meta.json"))
    assert not os.path.exists(st.path("dead.pages.tmp"))
    assert os.path.exists(st.path("alien.dat"))


def test_sweep_removes_dead_owner_entries_and_tmps(tmp_path):
    st = _store(tmp_path)
    os.makedirs(st.root, exist_ok=True)
    name = "rounds-deadbeef-p999999999-1.pages"
    for n in (name, "e.pages.tmp.999999999"):
        with open(st.path(n), "wb") as f:
            f.write(b"x")
    assert st.sweep() == 2
    assert os.listdir(st.root) == []


def test_pin_is_refcounted(tmp_path):
    st = _store(tmp_path)
    _commit(st, "shared.pages", b"x" * 100)
    st.pin("shared.pages")
    st.pin("shared.pages")
    st.unpin("shared.pages")
    assert st.set_budget(10) == 0
    assert st.exists("shared.pages")
    st.unpin("shared.pages")
    assert st.set_budget(10) == 1
    st.set_budget(None)


def test_sweep_skips_pinned_stale_entry(tmp_path):
    src = tmp_path / "s.txt"
    src.write_bytes(b"v1")
    st = _store(tmp_path)
    _commit(st, "live.pages", fingerprint=stat_fingerprint([str(src)]))
    st.pin("live.pages")
    src.write_bytes(b"v2-longer")  # source mutated: stamp stale
    assert st.sweep() == 0
    assert st.exists("live.pages")
    st.unpin("live.pages")
    assert st.sweep() == 1
    assert not st.exists("live.pages")


def test_used_bytes_cache_tracks_commit_and_delete(tmp_path):
    st = _store(tmp_path)
    assert st.used_bytes() == 0
    for i in range(3):
        _commit(st, f"u{i}.pages", b"x" * 10)
    assert st._used_cache == 30
    st.delete("u0.pages")
    assert st._used_cache == 20
    assert st.used_bytes() == 20


def test_sweep_keeps_live_writer_tmp(tmp_path):
    st = _store(tmp_path)
    w = st.writer("live.pages")
    w.write(b"in flight")
    assert st.sweep() == 0  # our own pid: never reaped
    w.abort()


def test_writer_reaps_a_dead_predecessors_tmp(tmp_path):
    st = _store(tmp_path)
    os.makedirs(st.root, exist_ok=True)
    orphan = st.path("e.pages") + ".tmp.999999999"
    open(orphan, "wb").close()
    w = st.writer("e.pages")
    assert not os.path.exists(orphan)
    w.abort()
