"""The port's placement plane (``dmlc_tpu_torch/parallel/placement.py``)
and its sharded checkpoint leaves, held to ``jax.sharding`` and the JAX
package's checkpoint on the 8 virtual CPU devices (``conftest.py``).

- Sharding parity: for meshes (8,), (4, 2) and (2, 4) and the specs a
  mesh's axes allow, at worlds 1, 2 and 4 (rank r of W owning its run of
  parts), each owned part's index, ``replica_id`` and data equal those
  of the device at the same mesh place under ``jax.device_put``.
- ``PlacedTensor``: one copy for a replicated spec, ``local()`` a box or
  a DMLCError, ``gather()``; a dimension that does not divide raises,
  naming the array.
- Checkpoints: the port's save of a placed tree and the reference's of
  the same ``jax.Array``s are byte-identical step directories; each
  package restores the other's onto 8 and 4 parts with equal
  ``last_restore_bytes_read``; the reference's ``TestShardLocalRestore``
  (``tests/test_checkpoint.py``) mirrored, each held to the reference's
  byte count on the same tree; a two-rank gloo gang writes only its own
  placements into its ``shard-<rank>.bin``.
- The dry run's model-axis phase at world 4 over a (2, 2) mesh, where
  each rank owns one of w's two model slices and gathers the other.
- ``Pipeline.to_device(sharding=)``: each array's part tensors equal the
  reference's ``jax.device_put`` shards; ``device=`` with ``sharding=``
  raises the reference's message.

Placements, records and bytes are compared for equality."""

import filecmp
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding as RefNS
from jax.sharding import PartitionSpec as RefP

from dmlc_tpu.io import checkpoint as ref_ck
from dmlc_tpu.pipeline import Pipeline as RefPipeline
from dmlc_tpu_torch.io import checkpoint as ck
from dmlc_tpu_torch.parallel.placement import (
    NamedSharding, P, PlacedTensor, device_put,
)
from dmlc_tpu_torch.parallel.sharded import Mesh
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 8)

MESHES = {(8,): ("data",), (4, 2): ("data", "model"),
          (2, 4): ("data", "model")}
SPECS = [(), ("data",), ("model",), (None, "model"), (("data", "model"),)]
CASES = [(m, spec, world) for m in MESHES for spec in SPECS
         if all(a in MESHES[m] for e in spec
                for a in ((e,) if isinstance(e, str) else e or ()))
         for world in (1, 2, 4)]


def _mesh(shape, rank=0, world=1):
    """A port mesh of ``shape`` on the CPU as rank ``rank`` of ``world``
    sees it (no process group: the run of parts it would own)."""
    m = Mesh(shape, _axes(shape), device="cpu")
    per = m.size // world
    m.rank, m.world = rank, world
    m._owned = range(rank * per, (rank + 1) * per)
    return m


def _axes(shape):
    return MESHES.get(tuple(shape), ("data",))


def _ref_mesh(shape):
    return RefMesh(np.array(jax.devices()[:int(np.prod(shape))])
                   .reshape(shape), _axes(shape))


@pytest.mark.parametrize("mesh_shape,spec,world", CASES,
                         ids=[f"{m}-{s}-w{w}" for m, s, w in CASES])
def test_sharding_matches_jax(mesh_shape, spec, world):
    x = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    ref_mesh = _ref_mesh(mesh_shape)
    ref = jax.device_put(x, RefNS(ref_mesh, RefP(*spec)))
    by_device = {s.device: s for s in ref.addressable_shards}
    flat = list(ref_mesh.devices.flat)
    seen = set()
    for rank in range(world):
        placed = device_put(x, NamedSharding(_mesh(mesh_shape, rank, world),
                                             P(*spec)), name="x")
        parts = [s.part for s in placed.addressable_shards]
        assert parts == list(range(rank * len(flat) // world,
                                   (rank + 1) * len(flat) // world))
        for s in placed.addressable_shards:
            want = by_device[flat[s.part]]
            assert s.index == want.index, s.part
            assert s.replica_id == want.replica_id, s.part
            assert np.array_equal(s.data.numpy(), np.asarray(want.data))
            seen.add(s.part)
    assert seen == set(range(len(flat)))


def test_non_dividing_dimension_names_the_array():
    sharding = NamedSharding(_mesh((4, 2)), P("data"))
    with pytest.raises(DMLCError, match="weights: sharding .* splits "
                                        "dimension 0 into 4 tiles, but its "
                                        "size is 10"):
        device_put(np.zeros(10, np.float32), sharding, name="weights")
    with pytest.raises(ValueError, match="should be divisible by 4"):
        jax.device_put(np.zeros(10, np.float32),
                       RefNS(_ref_mesh((4, 2)), RefP("data")))
    with pytest.raises(DMLCError, match="not one of the mesh's"):
        NamedSharding(_mesh((8,)), P("model"))


def test_replicated_is_one_copy_and_slices_form_boxes():
    x = torch.arange(32.0).reshape(8, 4)
    rep = device_put(x, NamedSharding(_mesh((4, 2)), P()))
    assert len({id(s.data) for s in rep.addressable_shards}) == 1
    assert rep.nbytes == x.numel() * 4
    assert torch.equal(rep.to_full(), x) and np.array_equal(rep.gather(),
                                                            x.numpy())
    assert rep.addressable_shards[0].data.data_ptr() != x.data_ptr()
    # rank 1 of 2 over (4, 2) data x model, split on data: rows 4-7
    half = device_put(x, NamedSharding(_mesh((4, 2), 1, 2), P("data")))
    assert torch.equal(half.local(), x[4:])
    with pytest.raises(DMLCError, match="the whole array needs every part"):
        half.gather()
    # split on (model, data): rank 0 of 2 holds rows 0-1 and 4-5
    gap = device_put(x, NamedSharding(_box_mesh(), P(("model", "data"))))
    assert [s.index for s in gap.addressable_shards] == \
        [(slice(0, 2), slice(None)), (slice(4, 6), slice(None))]
    with pytest.raises(DMLCError, match="do not form one box"):
        gap.local()
    assert isinstance(gap, PlacedTensor) and len(gap.slices()) == 2


def _box_mesh():
    """Rank 0 of 2 over a (2, 2) data x model mesh: parts 0 and 1."""
    m = Mesh((2, 2), ("data", "model"), device="cpu")
    m.rank, m.world, m._owned = 0, 2, range(0, 2)
    return m


# --------------------------------------------------------- checkpoints

def _trees(mesh_shape=(8,)):
    """{"x": arange(64) split on data, "w": ones(5) replicated} as the
    port's placed leaves and as the reference's jax.Arrays."""
    x = np.arange(64, dtype=np.float32)
    w = np.ones(5, np.float32)
    mesh, ref_mesh = _mesh(mesh_shape), _ref_mesh(mesh_shape)
    port = {"x": device_put(x, NamedSharding(mesh, P("data"))),
            "w": device_put(w, NamedSharding(mesh, P()))}
    ref = {"x": jax.device_put(x, RefNS(ref_mesh, RefP("data"))),
           "w": jax.device_put(w, RefNS(ref_mesh, RefP()))}
    return port, ref, {"x": x, "w": w}


def test_step_directories_are_byte_identical(tmp_path):
    port, ref, _ = _trees()
    d_port = ck.ShardedCheckpoint(str(tmp_path / "p")).save(1, port)
    d_ref = ref_ck.ShardedCheckpoint(str(tmp_path / "r")).save(1, ref)
    names = sorted(os.listdir(d_ref))
    assert names == sorted(os.listdir(d_port)) == [
        "COMMIT", "meta.json", "shard-0.bin", "shard-0.idx.json"]
    match, mismatch, errors = filecmp.cmpfiles(d_port, d_ref, names,
                                               shallow=False)
    assert (match, mismatch, errors) == (names, [], [])
    entries = ck.ShardedCheckpoint._scan_bin(os.path.join(d_port,
                                                          "shard-0.bin"))
    assert [e["placement"] for e in entries if e["key"] == "x"] == \
        [((8 * i, 8 * i + 8),) for i in range(8)]
    assert [e["placement"] for e in entries if e["key"] == "w"] == [((0, 5),)]


@pytest.mark.parametrize("saver", ["port", "ref"])
@pytest.mark.parametrize("parts", [8, 4])
def test_each_package_restores_the_others_placed(tmp_path, saver, parts):
    port, ref, want = _trees()
    root = str(tmp_path / "ck")
    if saver == "port":
        ck.ShardedCheckpoint(root).save(1, port)
    else:
        ref_ck.ShardedCheckpoint(root).save(1, ref)
    mesh, ref_mesh = _mesh((parts,)), _ref_mesh((parts,))
    c, r = ck.ShardedCheckpoint(root), ref_ck.ShardedCheckpoint(root)
    got, _ = c.restore(like=want, sharding_tree={
        "x": NamedSharding(mesh, P("data")), "w": NamedSharding(mesh, P())})
    ref_got, _ = r.restore(like=want, sharding_tree={
        "x": RefNS(ref_mesh, RefP("data")), "w": RefNS(ref_mesh, RefP())})
    for k, v in want.items():
        assert isinstance(got[k], PlacedTensor)
        assert got[k].gather().tobytes() == v.tobytes()
        assert np.asarray(ref_got[k]).tobytes() == v.tobytes()
        ref_data = {s.device: s.data for s in ref_got[k].addressable_shards}
        for s in got[k].addressable_shards:
            assert np.array_equal(
                s.data.numpy(),
                np.asarray(ref_data[list(ref_mesh.devices.flat)[s.part]]))
    assert c.last_restore_bytes_read == r.last_restore_bytes_read > 0


class TestShardLocalRestore:
    """The reference's ``TestShardLocalRestore`` on the port, each run
    beside the reference's on the same tree and held to its byte
    count."""

    def _tree(self, n=1 << 12):
        x = np.arange(float(n), dtype=np.float32)
        mesh, ref_mesh = _mesh((8,)), _ref_mesh((8,))
        return ({"x": device_put(x, NamedSharding(mesh, P("data")))},
                {"x": jax.device_put(x, RefNS(ref_mesh, RefP("data")))},
                mesh, ref_mesh)

    @staticmethod
    def _both(tmp_path, port_tree, ref_tree):
        c = ck.ShardedCheckpoint(str(tmp_path / "p"))
        r = ref_ck.ShardedCheckpoint(str(tmp_path / "r"))
        c.save(1, port_tree)
        r.save(1, ref_tree)
        return c, r

    def test_restore_reads_only_needed_placements(self, tmp_path):
        port, ref, _, _ = self._tree()
        c, r = self._both(tmp_path, port, ref)
        got, _ = c.restore(like=port)
        r.restore(like=ref)
        assert np.array_equal(got["x"].gather(), port["x"].gather())
        assert got["x"].sharding is port["x"].sharding
        assert c.last_restore_bytes_read == r.last_restore_bytes_read
        assert c.last_restore_bytes_read <= port["x"].nbytes + 8 * 64

    def test_accounting_scales_with_slice(self, tmp_path):
        port, ref, mesh, ref_mesh = self._tree()
        big = np.zeros(1 << 15, np.float32)
        c, r = self._both(
            tmp_path,
            {"x": port["x"], "big": device_put(big, NamedSharding(mesh,
                                                                  P()))},
            {"x": ref["x"], "big": jax.device_put(big, RefNS(ref_mesh,
                                                             RefP()))})
        got, _ = c.restore(like={"x": port["x"]})
        r.restore(like={"x": ref["x"]})
        assert np.array_equal(got["x"].gather(), port["x"].gather())
        assert c.last_restore_bytes_read == r.last_restore_bytes_read
        assert c.last_restore_bytes_read < big.nbytes // 2

    def test_reshard_on_restore(self, tmp_path):
        port, ref, _, _ = self._tree()
        c, r = self._both(tmp_path, port, ref)
        sh4 = NamedSharding(_mesh((4,)), P("data"))
        like = device_put(np.zeros(1 << 12, np.float32), sh4)
        got, _ = c.restore(like={"x": like})
        ref_like = jax.device_put(np.zeros(1 << 12, np.float32),
                                  RefNS(_ref_mesh((4,)), RefP("data")))
        r.restore(like={"x": ref_like})
        assert np.array_equal(got["x"].gather(), port["x"].gather())
        assert got["x"].sharding is sh4
        assert len(got["x"].slices()) == 4
        assert c.last_restore_bytes_read == r.last_restore_bytes_read

    def test_scalar_leaf_does_not_pull_full_model(self, tmp_path):
        port, ref, _, _ = self._tree()
        c, r = self._both(tmp_path, {"x": port["x"], "step": np.int64(7)},
                          {"x": ref["x"], "step": np.int64(7)})
        got, _ = c.restore(like={"x": port["x"], "step": np.int64(7)})
        r.restore(like={"x": ref["x"], "step": np.int64(7)})
        assert np.array_equal(got["x"].gather(), port["x"].gather())
        assert int(got["step"]) == 7
        assert c.last_restore_bytes_read == r.last_restore_bytes_read
        assert c.last_restore_bytes_read <= port["x"].nbytes + 1024

    def test_replicated_saved_to_sharded_target_reads_once(self, tmp_path):
        _, _, mesh, ref_mesh = self._tree()
        w = np.arange(4096.0, dtype=np.float32)
        c, r = self._both(
            tmp_path, {"w": device_put(w, NamedSharding(mesh, P()))},
            {"w": jax.device_put(w, RefNS(ref_mesh, RefP()))})
        like = device_put(np.zeros(4096, np.float32),
                          NamedSharding(mesh, P("data")))
        got, _ = c.restore(like={"w": like})
        r.restore(like={"w": jax.device_put(
            np.zeros(4096, np.float32), RefNS(ref_mesh, RefP("data")))})
        assert np.array_equal(got["w"].gather(), w)
        assert c.last_restore_bytes_read == r.last_restore_bytes_read
        assert c.last_restore_bytes_read <= w.nbytes + 1024

    def test_missing_index_file_still_restores(self, tmp_path):
        port, ref, _, _ = self._tree()
        c, r = self._both(tmp_path, port, ref)
        for root in (c.root, r.root):
            os.remove(os.path.join(root, "step-00000001", "shard-0.idx.json"))
        got, _ = c.restore(like=port)
        r.restore(like=ref)
        assert np.array_equal(got["x"].gather(), port["x"].gather())
        assert c.last_restore_bytes_read == r.last_restore_bytes_read
        idx = os.path.join(c.root, "step-00000001", "shard-0.idx.json")
        with open(idx, "w") as f:
            f.write('{"entries": [], "bin_size": 1}')
        got, _ = ck.ShardedCheckpoint(c.root).restore(like=port)
        assert np.array_equal(got["x"].gather(), port["x"].gather())


_GANG_SAVE = r"""
import sys
import numpy as np
import torch.distributed as dist
from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
from dmlc_tpu_torch.parallel.placement import NamedSharding, P, device_put
from dmlc_tpu_torch.parallel.sharded import Mesh
rank, world = init_from_env(device="cpu")
assert world == 2
mesh = Mesh((8,), ("data",), group=dist.group.WORLD, device="cpu")
x = np.arange(64, dtype=np.float32)
tree = {"x": device_put(x, NamedSharding(mesh, P("data")), name="x"),
        "w": device_put(np.ones(5, np.float32), NamedSharding(mesh, P()))}
assert [s.part for s in tree["x"].addressable_shards] == \
    list(range(4 * rank, 4 * rank + 4))
ShardedCheckpoint(sys.argv[1]).save(3, tree, metadata={"world": world})
finalize()
"""


def test_two_rank_gang_writes_only_its_placements(tmp_path):
    from dmlc_tpu_torch.parallel.launch import launch_local
    root = str(tmp_path / "gang")
    launch_local(2, [sys.executable, "-c", _GANG_SAVE, root],
                 env={"PYTHONPATH": REPO}, timeout=120)
    d = os.path.join(root, "step-00000003")
    for rank in (0, 1):
        entries = ck.ShardedCheckpoint._scan_bin(
            os.path.join(d, f"shard-{rank}.bin"))
        assert [e["placement"] for e in entries if e["key"] == "x"] == \
            [((8 * p, 8 * p + 8),) for p in range(4 * rank, 4 * rank + 4)]
        # w's replica 0 is part 0's, which rank 0 owns
        assert [e["placement"] for e in entries if e["key"] == "w"] == \
            ([((0, 5),)] if rank == 0 else [])
    want = {"x": np.arange(64, dtype=np.float32),
            "w": np.ones(5, np.float32)}
    got, user = ref_ck.ShardedCheckpoint(root).restore(like=want)
    assert user == {"world": 2}
    for k, v in want.items():
        assert np.asarray(got[k]).tobytes() == v.tobytes()
    got, _ = ck.ShardedCheckpoint(root).restore()
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes()


_MODEL_AXIS = r"""
import sys
import torch.distributed as dist
from dmlc_tpu_torch import graft
from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
from dmlc_tpu_torch.parallel.placement import NamedSharding, P, device_put
from dmlc_tpu_torch.parallel.sharded import Mesh
rank, world = init_from_env(device="cpu")
mesh2 = Mesh((2, 2), ("data", "model"), group=dist.group.WORLD,
             device="cpu")
held = device_put(graft.np.zeros(graft.NUM_FEATURES, graft.np.float32),
                  NamedSharding(mesh2, P("model")), name="w").slices()
assert len(held) == 1, len(held)  # one model coordinate a rank
its = []
loss = graft.model_axis_phase(sys.argv[1], 4, "cpu", dist.group.WORLD, its)
for it in its:
    it.close()
print(f"model-axis rank {rank} loss {loss!r}", flush=True)
finalize()
"""


def test_model_axis_phase_gathers_the_slices_a_rank_lacks(tmp_path):
    """The dry run's model-axis phase as rank r of W = 4 over a (2, 2)
    mesh: each rank owns one of w's 2 model slices, gathers the other
    over the gloo group, and matches the unsharded loss and gradients
    on its batch (the phase's own checks)."""
    from dmlc_tpu_torch import graft
    from dmlc_tpu_torch.parallel.launch import launch_local
    path = str(tmp_path / "dryrun.libsvm")
    graft.write_dryrun_corpus(path, 4)
    codes = launch_local(4, [sys.executable, "-c", _MODEL_AXIS, path],
                         env={"PYTHONPATH": REPO}, timeout=120)
    assert codes == [0, 0, 0, 0]


# ------------------------------------------------ to_device(sharding=)

@pytest.fixture
def dense_libsvm(tmp_path):
    rng = np.random.RandomState(24)
    path = tmp_path / "d.libsvm"
    with open(path, "w") as f:
        for i in range(100):
            idx = np.sort(rng.choice(50, 6, replace=False))
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.rand():.4f}"
                                           for j in idx) + "\n")
    return str(path)


def _drop_offset(b):
    return {k: b[k] for k in ("label", "index", "value")}


@pytest.mark.parametrize("mesh_shape,spec", [((8,), ()), ((8,), ("data",)),
                                             ((4, 2), ("model",))])
def test_to_device_sharding_matches_jax_device_put(dense_libsvm, mesh_shape,
                                                   spec):
    """The port's ``to_device(sharding=)`` and the reference's over the
    same batches (32 rows, 256 nonzeros: every column splits): each
    array's part tensors equal the reference's shards on the device at
    the same mesh place."""
    def chain(pipeline):
        return (pipeline.from_uri(dense_libsvm).parse(format="libsvm")
                .batch(32, pad=True, nnz_bucket=256)
                .map(_drop_offset, name="drop_offset"))

    ref_mesh = _ref_mesh(mesh_shape)
    flat = list(ref_mesh.devices.flat)
    got = list(chain(Pipeline).to_device(sharding=NamedSharding(
        _mesh(mesh_shape), P(*spec))).build())
    want = list(chain(RefPipeline).to_device(sharding=RefNS(
        ref_mesh, RefP(*spec))).build())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            ref_shards = {s.device: s for s in w[k].addressable_shards}
            for s in g[k].addressable_shards:
                r = ref_shards[flat[s.part]]
                assert (s.index, s.replica_id) == (r.index, r.replica_id)
                assert np.array_equal(s.data.numpy(), np.asarray(r.data))


def test_to_device_device_and_sharding_raise_the_references_message(
        dense_libsvm):
    from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
    with pytest.raises(DMLCError) as got:
        Pipeline.from_uri(dense_libsvm).parse().to_device(
            device="cpu", sharding=NamedSharding(_mesh((8,)), P())).build()
    with pytest.raises(RefDMLCError) as want:
        RefPipeline.from_uri(dense_libsvm).parse().to_device(
            device=jax.devices()[0],
            sharding=RefNS(_ref_mesh((8,)), RefP())).build()
    assert str(got.value) == str(want.value)
