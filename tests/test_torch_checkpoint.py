"""The port's local checkpoint plane (``dmlc_tpu_torch/io/checkpoint.py``)
against the JAX package's (``dmlc_tpu/io/checkpoint.py``) on the CPU.

The same parameters, made from a numpy seed, go through both packages:
``save_pytree`` files and single-process ``ShardedCheckpoint`` step
directories are byte-identical, and each package restores the other's; a
reference checkpoint whose leaf is sharded over the 8 CPU devices
restores in the port reading the same bytes. Then twins of the
reference's local tests (``tests/test_checkpoint.py``), a 2-rank gloo
save through ``launch_local``, and the parts left out raising by name.
Also ``utils/json_util.py`` against the reference's."""

import collections
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dmlc_tpu.io import checkpoint as ref_ck
from dmlc_tpu.io.stream import MemoryStream as RefMemoryStream
from dmlc_tpu.utils import json_util as ref_json
from dmlc_tpu_torch.io import checkpoint as ck
from dmlc_tpu_torch.io.stream import MemoryStream
from dmlc_tpu_torch.models.fm import SparseFFMModel
from dmlc_tpu_torch.models.linear import SparseLinearModel
from dmlc_tpu_torch.utils import json_util
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_FILES = ("shard-0.bin", "shard-0.idx.json", "meta.json", "COMMIT")


def _params(seed):
    """A seeded parameter tree as numpy arrays: nested dicts, a list, a
    tuple, a scalar, and int and uint leaves."""
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(37).astype(np.float32),
            "b": np.float32(rng.rand()),
            "V": rng.rand(11, 3, 2).astype(np.float32),
            "opt": {"m": rng.rand(5).astype(np.float32),
                    "steps": np.int64(17)},
            "hist": [rng.rand(2).astype(np.float32),
                     (rng.randint(0, 9, 3).astype(np.uint32),
                      np.float64(2.5))]}


def _torch_tree(tree):
    """The same tree with every leaf a CPU tensor."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return ck._flatten(tree)


def _assert_tree_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------ save_pytree

def test_save_pytree_files_are_byte_identical(tmp_path):
    tree = _params(0)
    ref_path, port_path = str(tmp_path / "ref.bin"), str(tmp_path / "p.bin")
    ref_ck.save_pytree(tree, ref_path)
    ck.save_pytree(_torch_tree(tree), port_path)
    assert _read(port_path) == _read(ref_path)
    # each package loads the other's file
    _assert_tree_equal(ref_ck.load_pytree(port_path, like=tree), tree)
    port_like = _torch_tree(tree)
    got = ck.load_pytree(ref_path, like=port_like)
    assert isinstance(got["opt"]["m"], torch.Tensor)
    assert isinstance(got["hist"][1], tuple)
    _assert_tree_equal(got, tree)
    assert list(ck.load_pytree(ref_path)) == list(ref_ck.load_pytree(
        ref_path))


def test_state_dict_keys_go_in_sorted_order(tmp_path):
    """A state_dict lists w, b, V; jax sorts a dict's keys, so the
    reference's file of the same parameters holds V, b, w, and so must
    the port's."""
    model = SparseFFMModel(13, 3, num_factors=2, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(np.asarray(
                np.random.RandomState(3).rand(*p.shape), np.float32)))
    sd = model.state_dict()
    assert isinstance(sd, collections.OrderedDict)
    assert list(sd) == ["w", "b", "V"]
    as_numpy = {k: v.numpy() for k, v in sd.items()}
    ref_path, port_path = str(tmp_path / "ref.bin"), str(tmp_path / "p.bin")
    ref_ck.save_pytree(as_numpy, ref_path)
    ck.save_pytree(sd, port_path)
    assert _read(port_path) == _read(ref_path)
    assert list(ck.load_pytree(port_path)) == ["V", "b", "w"]
    fresh = SparseFFMModel(13, 3, num_factors=2, device="cpu")
    fresh.load_state_dict(ck.load_pytree(port_path, like=fresh.state_dict()))
    _assert_tree_equal(dict(fresh.state_dict()), as_numpy)


def test_missing_key_raises(tmp_path):
    ck.save_pytree({"a": torch.zeros(2)}, str(tmp_path / "c.bin"))
    with pytest.raises(DMLCError, match="missing"):
        ck.load_pytree(str(tmp_path / "c.bin"), like={"b": torch.zeros(2)})


# ------------------------------------------------------ ShardedCheckpoint

def test_step_dir_is_byte_identical_and_restores_both_ways(tmp_path):
    tree = _params(1)
    ref = ref_ck.ShardedCheckpoint(str(tmp_path / "ref"))
    port = ck.ShardedCheckpoint(str(tmp_path / "port"))
    d_ref = ref.save(4, tree, metadata={"epoch": 2, "note": "x"})
    d_port = port.save(4, _torch_tree(tree),
                       metadata={"epoch": 2, "note": "x"})
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_ref)) \
        == sorted(STEP_FILES)
    for name in STEP_FILES:
        assert _read(os.path.join(d_port, name)) == \
            _read(os.path.join(d_ref, name)), name
    # the port restores the reference's step, the reference the port's
    got, user = ck.ShardedCheckpoint(str(tmp_path / "ref")).restore(
        like=_torch_tree(tree))
    assert user == {"epoch": 2, "note": "x"}
    _assert_tree_equal(got, tree)
    got, user = ref_ck.ShardedCheckpoint(str(tmp_path / "port")).restore(
        like=tree)
    assert user == {"epoch": 2, "note": "x"}
    _assert_tree_equal(got, tree)
    flat, _ = port.restore()
    assert set(flat) == set(k for k, _ in _leaves(tree))


def _ref_sharded_tree(n=64):
    mesh = RefMesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
    x = jax.device_put(jnp.arange(float(n), dtype=jnp.float32),
                       NamedSharding(mesh, P("data")))
    w = jax.device_put(jnp.ones((5,), jnp.float32), NamedSharding(mesh, P()))
    return {"x": x, "w": w}


def test_reference_sharded_leaf_restores_with_the_same_bytes(tmp_path):
    """x was written by the reference as 8 records (one a device); the
    port rebuilds it from them, reading what the reference reads."""
    tree = _ref_sharded_tree()
    ref = ref_ck.ShardedCheckpoint(str(tmp_path / "r"))
    ref.save(1, tree)
    want, _ = ref.restore(like=tree)
    port = ck.ShardedCheckpoint(str(tmp_path / "r"))
    got, _ = port.restore(like={"x": torch.zeros(64), "w": torch.zeros(5)})
    assert port.last_restore_bytes_read == ref.last_restore_bytes_read
    assert got["x"].tolist() == np.asarray(want["x"]).tolist()
    assert got["w"].tolist() == [1.0] * 5
    flat, _ = port.restore()
    np.testing.assert_array_equal(flat["x"], np.arange(64.0))


def _tree(n=1 << 12):
    return {"x": torch.arange(float(n), dtype=torch.float32)}


def test_save_restore_and_steps(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(3, tree, metadata={"epoch": 1})
    assert os.path.exists(os.path.join(d, "COMMIT"))
    c.save(5, tree)
    assert c.all_steps() == [3, 5] and c.latest_step() == 5
    restored, user = c.restore(step=3, like=tree)
    assert user == {"epoch": 1}
    assert torch.equal(restored["x"], tree["x"])
    flat, _ = c.restore()
    np.testing.assert_array_equal(flat["x"], tree["x"].numpy())


def test_uncommitted_not_restored(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(2, tree)
    os.remove(os.path.join(d, "COMMIT"))  # simulate a torn save
    assert c.latest_step() is None
    with pytest.raises(DMLCError, match="no committed"):
        c.restore(like=tree)
    with pytest.raises(DMLCError, match="not committed"):
        c.restore(step=2, like=tree)


def test_leaf_is_written_once(tmp_path):
    big = {"big": torch.zeros(1 << 16)}
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, big)
    assert os.path.getsize(os.path.join(d, "shard-0.bin")) < \
        big["big"].numel() * 4 * 1.5


def test_scalar_leaf_does_not_pull_in_the_full_model(tmp_path):
    tree = _tree()
    full = {"x": tree["x"], "step": np.int64(7)}
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    c.save(1, full)
    restored, _ = c.restore(like=full)
    assert torch.equal(restored["x"], tree["x"])
    assert int(restored["step"]) == 7 and isinstance(restored["step"],
                                                     np.ndarray)
    assert c.last_restore_bytes_read <= tree["x"].numel() * 4 + 1024


def test_restore_reads_only_the_leaves_asked_for(tmp_path):
    tree = _tree()
    full = {"x": tree["x"], "big": torch.zeros(1 << 15)}
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    c.save(1, full)
    restored, _ = c.restore(like={"x": tree["x"]})
    assert torch.equal(restored["x"], tree["x"])
    assert c.last_restore_bytes_read < (1 << 15) * 4 // 2


def test_missing_index_still_restores(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, tree)
    idx = os.path.join(d, "shard-0.idx.json")
    os.remove(idx)  # a lost index: the .bin is scanned
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])
    with open(idx, "w") as f:  # a stale index (wrong bin_size): ignored
        json.dump({"entries": [], "bin_size": 1}, f)
    restored, _ = ck.ShardedCheckpoint(str(tmp_path / "r")).restore(
        like=tree)
    assert torch.equal(restored["x"], tree["x"])


def test_resave_removes_stale_world_shards(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, tree)
    with open(os.path.join(d, "shard-5.bin"), "wb") as f:
        f.write(b"stale")
    with open(os.path.join(d, "shard-5.idx.json"), "w") as f:
        json.dump({"entries": [], "bin_size": 5}, f)
    c.save(1, tree)  # re-save the same step, world 1
    assert not os.path.exists(os.path.join(d, "shard-5.bin"))
    assert not os.path.exists(os.path.join(d, "shard-5.idx.json"))
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])


def test_resave_replaces_data_and_cleans_up(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    c.save(1, tree)
    tree2 = {"x": tree["x"] * 3}
    d = c.save(1, tree2)
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree2["x"])
    assert not os.path.isdir(d + ".new") and not os.path.isdir(d + ".trash")


def test_resave_crash_keeps_the_committed_copy(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, tree)
    os.makedirs(d + ".new")
    with open(os.path.join(d + ".new", "shard-0.bin"), "wb") as f:
        f.write(b"torn re-save garbage")  # no COMMIT: crashed mid-write
    assert c.latest_step() == 1
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])
    c.save(1, tree)  # and a later re-save recovers over the torn .new
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])


def test_interrupted_swap_serves_the_committed_new(tmp_path):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, tree)
    os.rename(d, d + ".new")  # the mid-swap state on disk
    assert c.latest_step() == 1 and c.all_steps() == [1]
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])


def test_both_committed_serve_the_newer_new(tmp_path, monkeypatch):
    tree = _tree()
    newer = {"x": tree["x"] + 100.0}
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    c.save(1, tree)
    monkeypatch.setattr(ck.ShardedCheckpoint, "_swap_in",
                        staticmethod(lambda final: None))
    c.save(1, newer)  # commits .new, "crashes" before the swap
    monkeypatch.undo()
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], newer["x"])
    c.save(2, tree)  # activity elsewhere does not flip step 1's copy
    restored, _ = c.restore(step=1, like=tree)
    assert torch.equal(restored["x"], newer["x"])


def test_save_over_interrupted_swap_crash_keeps_committed(tmp_path,
                                                          monkeypatch):
    tree = _tree()
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    d = c.save(1, tree)
    os.rename(d, d + ".new")  # the step's ONLY committed copy

    def boom(leaf):
        raise RuntimeError("simulated crash mid shard write")

    monkeypatch.setattr(ck.ShardedCheckpoint, "_addressable_shards",
                        staticmethod(boom))
    with pytest.raises(RuntimeError):
        c.save(1, {"x": torch.zeros_like(tree["x"])})
    monkeypatch.undo()
    assert c.latest_step() == 1
    restored, _ = c.restore(like=tree)
    assert torch.equal(restored["x"], tree["x"])


def test_restore_sweeps_stale_spill(tmp_path, monkeypatch):
    """A restore marks a resume boundary: a spill file whose source
    fingerprint no longer stats clean is gone after it, a file of an
    unchanged source stays."""
    from dmlc_tpu_torch.data.row_iter import RoundSpillWriter, \
        default_spill_dir
    from dmlc_tpu_torch.data.rowblock import RowBlockContainer
    monkeypatch.setenv("DMLC_TPU_TORCH_PAGESTORE_DIR", str(tmp_path / "pg"))
    src = tmp_path / "src.libsvm"
    src.write_bytes(b"1 1:1.0\n")
    st = os.stat(src)
    d = default_spill_dir()
    c = RowBlockContainer(np.uint32)
    c.push(1.0, [1], [1.0])
    blk = c.get_block()
    stale = os.path.join(d, "test-stale.pages")
    fresh = os.path.join(d, "test-fresh.pages")
    for path, fp in ((stale, [[str(src), st.st_size + 1, st.st_mtime_ns]]),
                     (fresh, [[str(src), st.st_size, st.st_mtime_ns]])):
        w = RoundSpillWriter(path, nparts=1, meta={"fingerprint": fp})
        w.add_row([blk])
        w.commit()
    tree = _tree()
    root = ck.ShardedCheckpoint(str(tmp_path / "r"))
    root.save(1, tree)
    root.restore(like=tree)
    assert not os.path.exists(stale)
    assert os.path.exists(fresh)


def test_restored_leaves_are_tensors_on_like_devices(tmp_path):
    model = SparseLinearModel(17, device="cpu")
    with torch.no_grad():
        model.w.copy_(torch.arange(17.0))
        model.b.fill_(0.5)
    c = ck.ShardedCheckpoint(str(tmp_path / "r"))
    c.save(1, model.state_dict())
    fresh = SparseLinearModel(17, device="cpu")
    restored, _ = c.restore(like=fresh.state_dict())
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in restored.values())
    fresh.load_state_dict(restored)
    assert torch.equal(fresh.w, model.w) and fresh.b.item() == 0.5


_GANG_SAVE = r"""
import sys
import numpy as np
import torch
from dmlc_tpu_torch.io.checkpoint import ShardedCheckpoint
from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
rank, world = init_from_env(device="cpu")
assert world == 2
rng = np.random.RandomState(5)
tree = {"w": torch.from_numpy(rng.rand(33).astype(np.float32)),
        "b": torch.tensor(1.5), "V": torch.from_numpy(
            rng.rand(7, 2).astype(np.float32))}
ShardedCheckpoint(sys.argv[1]).save(9, tree, metadata={"world": world})
finalize()
"""


def test_two_rank_gloo_save_restores_in_one_process(tmp_path):
    from dmlc_tpu_torch.parallel.launch import launch_local
    root = str(tmp_path / "gang")
    launch_local(2, [sys.executable, "-c", _GANG_SAVE, root],
                 env={"PYTHONPATH": REPO}, timeout=120)
    c = ck.ShardedCheckpoint(root)
    assert c.all_steps() == [9]
    d = os.path.join(root, "step-00000009")
    assert sorted(os.listdir(d)) == sorted(
        STEP_FILES + ("shard-1.bin", "shard-1.idx.json"))
    rng = np.random.RandomState(5)
    want = {"w": rng.rand(33).astype(np.float32), "b": np.float32(1.5),
            "V": rng.rand(7, 2).astype(np.float32)}
    like = {k: torch.zeros(np.shape(v)) for k, v in want.items()}
    got, user = c.restore(like=like)
    assert user == {"world": 2}
    _assert_tree_equal(got, want)
    got, _ = ref_ck.ShardedCheckpoint(root).restore(like=want)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("call", [
    lambda tmp: ck.ShardedCheckpoint("obj://bucket/ck"),
    lambda tmp: ck.ShardedCheckpoint(tmp).prefetch(),
    lambda tmp: ck.ShardedCheckpoint(tmp).save(1, _tree(), writer=0,
                                               num_writers=2),
    lambda tmp: ck.ShardedCheckpoint(tmp).restore(like=_tree(),
                                                  sharding_tree={}),
], ids=["remote_root", "prefetch", "writers", "sharding_tree"])
def test_parts_left_out_raise_by_name(tmp_path, call):
    with pytest.raises(DMLCError, match="not ported"):
        call(str(tmp_path / "r"))


# ------------------------------------------------------------ json_util

def test_json_util_matches_reference():
    obj = {"a": 1, "b": [1.5, "x"], "n": np.int64(7), "blob": b"\x00\x01",
           "arr": np.arange(6, dtype=np.float32).reshape(3, 2)}
    port, ref = MemoryStream(), RefMemoryStream()
    json_util.json_dump(obj, port)
    ref_json.json_dump(obj, ref)
    assert port.getvalue() == ref.getvalue()
    port.seek(0)
    out = json_util.json_load(port)
    assert out["n"] == 7 and out["blob"] == b"\x00\x01"
    np.testing.assert_array_equal(out["arr"], obj["arr"])
    with pytest.raises(DMLCError, match="invalid JSON"):
        json_util.json_load(MemoryStream(b"{nope"))
    h = (json_util.JSONObjectReadHelper()
         .declare_field("name", str)
         .declare_field("opt", int, optional=True, default=3))
    assert h.read_all_fields({"name": "x"}) == {"name": "x", "opt": 3}
    with pytest.raises(DMLCError, match="unknown"):
        h.read_all_fields({"name": "x", "zz": 0})
