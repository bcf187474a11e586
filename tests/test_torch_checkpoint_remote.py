"""Remote (``obj://``) checkpoints of the port (``ShardedCheckpoint`` in
``dmlc_tpu_torch/io/checkpoint.py``) held to the reference's.

The reference's ``TestRemoteCheckpoint`` (tests/test_checkpoint.py) runs
here against the port: content-addressed pages through the objstore
write plane, incremental re-saves that upload only changed pages, COMMIT
gating, writer/num_writers, digest-checked restores and the restore's
local/wire byte split. Then the cross-package checks: the same tree
saved by the reference (numpy on the CPU) and by the port (tensors) into
two emulator roots gives the same object keys with byte-identical
contents, and each package restores the other's checkpoint. Trees are
made from seeded numpy generators; restored leaves must equal the saved
ones bit for bit."""

import os

import numpy as np
import pytest
import torch

import dmlc_tpu.io.checkpoint as ref_ck
from dmlc_tpu_torch.io import checkpoint as ck
from dmlc_tpu_torch.utils.logging import DMLCError

ShardedCheckpoint = ck.ShardedCheckpoint


@pytest.fixture
def remote(tmp_path, monkeypatch):
    """The port's objstore over a fresh emulator and page store, and the
    reference's over its own; both packages' clients and options
    restored afterwards."""
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu.io.objstore.fs as ref_ofs
    import dmlc_tpu.io.pagestore as ref_ps
    import dmlc_tpu_torch.io.objstore as objstore
    import dmlc_tpu_torch.io.objstore.fs as ofs
    import dmlc_tpu_torch.io.pagestore as ps
    from dmlc_tpu_torch.io.objstore.emulator import EmulatedObjectStore
    monkeypatch.delenv(ofs.ENV_ROOT, raising=False)
    monkeypatch.delenv(ofs.ENV_ENDPOINT, raising=False)
    monkeypatch.setattr(ps, "default_store_dir",
                        lambda: str(tmp_path / "pagestore"))
    monkeypatch.setattr(ref_ps, "default_store_dir",
                        lambda: str(tmp_path / "ref_pagestore"))
    saved, ref_saved = ofs.options(), ref_ofs.options()
    em = EmulatedObjectStore(str(tmp_path / "objroot"))
    objstore.configure(em)
    try:
        yield em
    finally:
        for mod, opts in ((objstore, saved), (ref_objstore, ref_saved)):
            mod.configure(
                None, block_bytes=opts["block_bytes"],
                coalesce=opts["coalesce"], parallel=opts["parallel"],
                hydrate=opts["hydrate"],
                put_part_bytes=opts["put_part_bytes"],
                put_parallel=opts["put_parallel"])


def _tree(rng, scale=1.0):
    return {"w": (rng.rand(256, 16) * scale).astype(np.float32),
            "b": rng.rand(64).astype(np.float32),
            "step": np.int64(7)}


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


class TestRemoteCheckpoint:
    def test_save_restore_roundtrip(self, remote):
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        d = c.save(3, _tensors(tree), metadata={"epoch": 2})
        assert d == "obj://b/ck/step-00000003"
        assert c.last_save_bytes_written > 0
        assert c.latest_step() == 3 and c.all_steps() == [3]
        like = {k: torch.zeros(np.shape(v), dtype=t.dtype)
                for (k, v), t in zip(tree.items(),
                                     _tensors(tree).values())}
        restored, user = c.restore(like=like)
        assert user == {"epoch": 2}
        assert all(isinstance(v, torch.Tensor) for v in restored.values())
        assert restored["step"].shape == ()  # a 0-d leaf comes back 0-d
        _equal(restored, tree)
        assert c.last_restore_bytes_read > 0
        host, _ = c.restore()
        _equal(host, tree)

    def test_incremental_save_reuses_unchanged_pages(self, remote):
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        first = c.last_save_bytes_written
        assert first > 0 and c.last_save_bytes_reused == 0
        tree2 = dict(tree, b=(tree["b"] + 1.0))  # one small leaf moves
        remote.reset_counters()
        c.save(2, _tensors(tree2))
        assert c.last_save_bytes_reused > 0
        assert 0 < c.last_save_bytes_written < first // 4
        # the page of b, the index, meta and COMMIT: 4 PUTs
        assert remote.counters()["puts"] == 4
        for step, want in ((1, tree), (2, tree2)):
            got, _ = c.restore(step=step, like=tree)
            _equal(got, want)

    def test_same_tree_resave_uploads_nothing(self, remote):
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        remote.reset_counters()
        c.save(2, _tensors(tree))
        assert c.last_save_bytes_written == 0
        assert c.last_save_bytes_reused > 0
        pages = [k for k in os.listdir(os.path.join(remote.root, "b",
                                                    "ck", "pages"))]
        assert len(pages) == 3
        # no page PUT: only the step's index, meta.json and COMMIT, and
        # no HEAD probe either (the local page store answered)
        counts = remote.counters()
        assert counts["puts"] == 3 and counts["put_parts"] == 0
        assert counts["heads"] == 0

    def test_uncommitted_step_not_restorable(self, remote):
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(4, _tensors(tree))
        remote.delete("b", "ck/step-00000004/COMMIT")  # torn save
        assert c.latest_step() is None
        with pytest.raises(DMLCError, match="no committed"):
            c.restore(like=tree)
        with pytest.raises(DMLCError, match="not committed"):
            c.restore(step=4, like=tree)

    def test_multi_writer_gang_save(self, remote):
        """Two writers with DISJOINT leaves converge on one committed
        step: writer 1 publishes its index first, writer 0 commits only
        after seeing every index."""
        rng = np.random.RandomState(42)
        t0 = {"w0": rng.rand(32, 8).astype(np.float32)}
        t1 = {"w1": rng.rand(16, 4).astype(np.float32)}
        c = ShardedCheckpoint("obj://b/ck")
        c.save(9, _tensors(t1), writer=1, num_writers=2)  # no COMMIT yet
        assert c.latest_step() is None
        c.save(9, _tensors(t0), writer=0, num_writers=2)  # commits
        assert c.latest_step() == 9
        like = {"w0": torch.zeros(32, 8), "w1": torch.zeros(16, 4)}
        restored, _ = c.restore(like=like)
        _equal(restored, {"w0": t0["w0"], "w1": t1["w1"]})
        with pytest.raises(DMLCError, match="outside num_writers"):
            c.save(10, _tensors(t0), writer=2, num_writers=2)

    def test_corrupt_page_detected(self, remote, tmp_path, monkeypatch):
        import dmlc_tpu_torch.io.pagestore as ps
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        # corrupt ONE page object in place (a valid serialized ndarray
        # of wrong content), and point at a fresh page store so restore
        # must take the wire and check the digest
        pages = os.path.join(remote.root, "b", "ck", "pages")
        name = sorted(os.listdir(pages))[0]
        with open(os.path.join(pages, name), "r+b") as f:
            raw = bytearray(f.read())
            raw[-4] ^= 0xFF
            f.seek(0)
            f.write(raw)
        monkeypatch.setattr(ps, "default_store_dir",
                            lambda: str(tmp_path / "pagestore2"))
        with pytest.raises(DMLCError, match="content mismatch"):
            c.restore(like=tree)

    def test_restore_split_accounting(self, remote, tmp_path, monkeypatch):
        import dmlc_tpu_torch.io.pagestore as ps
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        page_bytes = sum(
            os.path.getsize(os.path.join(d, n))
            for d, _, names in os.walk(os.path.join(remote.root, "b",
                                                    "ck", "pages"))
            for n in names)
        # same process: the saver's page store answers everything
        remote.reset_counters()
        c.restore(like=tree)
        assert c.last_restore_local_bytes == c.last_restore_bytes_read \
            == page_bytes
        assert c.last_restore_wire_bytes == 0
        assert c.last_restore_peer_bytes == 0
        assert remote.counters()["get_bytes"] < page_bytes
        # a cold process (fresh page store) pays the wire
        monkeypatch.setattr(ps, "default_store_dir",
                            lambda: str(tmp_path / "pagestore2"))
        c2 = ShardedCheckpoint("obj://b/ck")
        c2.restore(like=tree)
        assert c2.last_restore_wire_bytes == c2.last_restore_bytes_read \
            == page_bytes
        # and the pages it fetched are local for the next restore
        c2.restore(like=tree)
        assert c2.last_restore_local_bytes == page_bytes

    def test_prefetch_is_a_no_op_without_a_peer_tier(self, remote):
        rng = np.random.RandomState(42)
        tree = _tree(rng)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        remote.reset_counters()
        c.prefetch()
        assert remote.counters()["gets"] == 1  # the step's one index
        got, _ = c.restore(like=tree)
        _equal(got, tree)
        with pytest.raises(DMLCError, match="not committed"):
            c.prefetch(step=5)

    def test_large_page_goes_up_as_parts(self, remote):
        """A record past ``put_part_bytes`` travels through the multipart
        writer and restores bit for bit."""
        import dmlc_tpu_torch.io.objstore as objstore
        objstore.configure(put_part_bytes=1 << 14, put_parallel=2)
        rng = np.random.RandomState(3)
        tree = {"V": rng.rand(300, 40).astype(np.float32)}
        remote.reset_counters()
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, _tensors(tree))
        assert remote.counters()["put_parts"] == -(-(48000 + 25) //
                                                  (1 << 14))
        got, _ = c.restore(like={"V": torch.zeros(300, 40)})
        _equal(got, tree)

    def test_no_store_configured_raises(self, remote):
        import dmlc_tpu_torch.io.objstore as objstore
        objstore.configure(None)
        with pytest.raises(DMLCError, match="no object store"):
            ShardedCheckpoint("obj://b/ck").save(1, {"x": np.zeros(2)})

    def test_sharding_tree_still_refused(self, remote):
        """Once refused, ``restore(sharding_tree=)`` on a remote root now
        places the leaf: 4 parts each holding its slice of the stored
        page, the one page read once."""
        from dmlc_tpu_torch.parallel.placement import NamedSharding, P
        from dmlc_tpu_torch.parallel.sharded import Mesh
        x = np.arange(8, dtype=np.float32)
        c = ShardedCheckpoint("obj://b/ck")
        c.save(1, {"x": x})
        sharding = NamedSharding(Mesh((4,), ("data",), device="cpu"),
                                 P("data"))
        got, _ = c.restore(like={"x": np.zeros(8, np.float32)},
                           sharding_tree={"x": sharding})
        assert [sh.data.tolist() for sh in got["x"].addressable_shards] \
            == [x[i:i + 2].tolist() for i in (0, 2, 4, 6)]
        assert c.last_restore_bytes_read == c.last_save_bytes_written


# ------------------------------------------------ cross-package parity

def _walk(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _cross_tree(rng):
    return {"V": rng.rand(97, 5).astype(np.float32),
            "b": np.float32(rng.rand()),
            "w": rng.rand(1000).astype(np.float32),
            "n": rng.randint(0, 9, size=(3, 2)).astype(np.int64)}


@pytest.mark.parametrize("part_bytes", [8 << 20, 1 << 12])
def test_both_packages_write_the_same_objects(remote, tmp_path,
                                              part_bytes):
    """One tree, saved by the reference (numpy) into one emulator root
    and by the port (tensors) into another, twice (steps 1 and 2): the
    same object keys, each byte-identical, single-shot or multipart."""
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu.io.objstore.emulator import EmulatedObjectStore
    objstore.configure(put_part_bytes=part_bytes)
    ref_root = str(tmp_path / "ref_objroot")
    ref_objstore.configure(EmulatedObjectStore(ref_root),
                           put_part_bytes=part_bytes)
    tree = _cross_tree(np.random.RandomState(8))
    meta = {"epoch": 3, "tag": "x"}
    for step in (1, 2):
        ShardedCheckpoint("obj://b/ck").save(step, _tensors(tree),
                                             metadata=meta)
        ref_ck.ShardedCheckpoint("obj://b/ck").save(step, tree,
                                                    metadata=meta)
    port, ref = _walk(remote.root), _walk(ref_root)
    assert sorted(port) == sorted(ref)
    assert len(port) == len(tree) + 2 * 3
    for k in port:
        assert port[k] == ref[k], k


def test_each_package_restores_the_others_checkpoint(remote, tmp_path):
    import dmlc_tpu.io.objstore as ref_objstore
    import dmlc_tpu_torch.io.objstore as objstore
    from dmlc_tpu.io.objstore.emulator import EmulatedObjectStore
    rng = np.random.RandomState(9)
    tree = _cross_tree(rng)
    tree2 = dict(tree, w=tree["w"] * 2)
    ref_root = str(tmp_path / "ref_objroot")
    ref_objstore.configure(EmulatedObjectStore(ref_root))
    ShardedCheckpoint("obj://b/port").save(5, _tensors(tree),
                                           metadata={"by": "port"})
    ref_ck.ShardedCheckpoint("obj://b/ref").save(6, tree2,
                                                 metadata={"by": "ref"})
    # the reference reads the port's root, the port the reference's
    ref_objstore.configure(EmulatedObjectStore(remote.root))
    got, user = ref_ck.ShardedCheckpoint("obj://b/port").restore(
        like=tree)
    assert user == {"by": "port"}
    _equal({k: np.asarray(v) for k, v in got.items()}, tree)
    objstore.configure(root=ref_root)
    c = ShardedCheckpoint("obj://b/ref")
    assert c.latest_step() == 6
    like = {k: torch.zeros(np.shape(v), dtype=t.dtype)
            for (k, v), t in zip(tree2.items(), _tensors(tree2).values())}
    got, user = c.restore(like=like)
    assert user == {"by": "ref"}
    _equal(got, tree2)
    # the pages the port saved itself (all but w's) are in its page
    # store by digest; w's changed page comes from the wire
    assert c.last_restore_wire_bytes + c.last_restore_local_bytes == \
        c.last_restore_bytes_read
    assert c.last_restore_wire_bytes == 4000 + 20


def test_sharded_tree_writes_the_references_objects(remote, tmp_path):
    """A tree whose leaves are placed on 8 parts (``V`` split over its
    rows, ``w`` replicated), saved by the port, and the same tree as
    ``jax.Array``s on the 8 CPU devices saved by the reference: the same
    object keys, each byte-identical (one page a replica-0 shard), and
    each package restores the other's onto 4 parts reading the same
    bytes."""
    import jax
    from jax.sharding import Mesh as RefMesh
    from jax.sharding import NamedSharding as RefNS
    from jax.sharding import PartitionSpec as RefP

    import dmlc_tpu.io.objstore as ref_objstore
    from dmlc_tpu.io.objstore.emulator import EmulatedObjectStore
    from dmlc_tpu_torch.parallel.placement import NamedSharding, P
    from dmlc_tpu_torch.parallel.placement import device_put
    from dmlc_tpu_torch.parallel.sharded import Mesh
    rng = np.random.RandomState(12)
    tree = {"V": rng.rand(96, 5).astype(np.float32),
            "w": rng.rand(40).astype(np.float32)}
    specs = {"V": ("data",), "w": ()}
    mesh = Mesh((8,), ("data",), device="cpu")
    ref_mesh = RefMesh(np.array(jax.devices()[:8]), ("data",))
    ref_root = str(tmp_path / "ref_objroot")
    ref_objstore.configure(EmulatedObjectStore(ref_root))
    ShardedCheckpoint("obj://b/ck").save(1, {
        k: device_put(v, NamedSharding(mesh, P(*specs[k])), name=k)
        for k, v in tree.items()})
    ref_ck.ShardedCheckpoint("obj://b/ck").save(1, {
        k: jax.device_put(v, RefNS(ref_mesh, RefP(*specs[k])))
        for k, v in tree.items()})
    port, ref = _walk(remote.root), _walk(ref_root)
    assert sorted(port) == sorted(ref)
    assert sum(k.startswith(os.path.join("b", "ck", "pages")) for k in port) \
        == 8 + 1
    for k in port:
        assert port[k] == ref[k], k
    # each restores the other's objects onto 4 parts
    mesh4 = Mesh((4,), ("data",), device="cpu")
    ref_mesh4 = RefMesh(np.array(jax.devices()[:4]), ("data",))
    like = {k: np.zeros_like(v) for k, v in tree.items()}
    ref_objstore.configure(EmulatedObjectStore(remote.root))
    import dmlc_tpu_torch.io.objstore as objstore
    objstore.configure(root=ref_root)
    c = ShardedCheckpoint("obj://b/ck")
    got, _ = c.restore(like=like, sharding_tree={
        k: NamedSharding(mesh4, P(*specs[k])) for k in tree})
    r = ref_ck.ShardedCheckpoint("obj://b/ck")
    ref_got, _ = r.restore(like=like, sharding_tree={
        k: RefNS(ref_mesh4, RefP(*specs[k])) for k in tree})
    for k, v in tree.items():
        assert got[k].gather().tobytes() == v.tobytes(), k
        assert np.asarray(ref_got[k]).tobytes() == v.tobytes(), k
    assert c.last_restore_bytes_read == r.last_restore_bytes_read
