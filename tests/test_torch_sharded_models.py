"""The port's data-parallel step (``SparseModelBase.global_loss`` and
``make_sharded_train_step``), its dry run (``dmlc_tpu_torch.graft``)
and its gang launch against the JAX package.

Each model's sharded step starts from the reference's parameters
(``params_from_jax``) on the same 8 padded blocks, the port's mesh 8
parts on the CPU in one process, the reference's its 8-device CPU mesh
(``tests/test_parallel_ops.py:28``). Loss and parameters after a step
agree at rtol=1e-5, atol=1e-6: both sides compute in fp32 on the CPU,
with the CSR sums and the sums over parts in different orders. The
same tolerance holds the sharded step to the port's flat ``train_step``
over the concatenated rows, and the dry run's final weights to the
reference's sharded run of the same file.

Two processes on gloo: two workers started by the port's
``launch_local`` (each under a 60 s timeout) own 4 of the 8 parts each
and train with l2 > 0; rank 0's weights must agree, at the same
tolerance, with the single-process 8-part run of the port and with the
reference's 8-device mesh (the twin of ``tests/test_multiprocess.py``,
which is skipped here because jaxlib has no multiprocess CPU). The
workers run in subprocesses, so no process group reaches this one.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from dmlc_tpu.data.padding import pad_to_bucket as ref_pad_to_bucket
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models import SparseFFMModel as RefFFM
from dmlc_tpu.models import SparseFMModel as RefFM
from dmlc_tpu.models import SparseLinearModel as RefLinear
from dmlc_tpu.models import SparseRankingModel as RefRanking
from dmlc_tpu.parallel import ShardedRowBlockIter as RefIter
from dmlc_tpu.parallel import make_global_batch as ref_make_global_batch
from dmlc_tpu.parallel import stack_device_batches as ref_stack_batches
from dmlc_tpu_torch import graft
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.padding import pad_to_bucket, stack_padded_rows
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models import (
    SparseFFMModel, SparseFMModel, SparseLinearModel, SparseRankingModel,
)
from dmlc_tpu_torch.parallel.launch import launch_local
from dmlc_tpu_torch.parallel.sharded import (
    Mesh, ShardedRowBlockIter, make_global_batch,
)
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
PARTS, NCOL, NFIELDS = 8, 24, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_mesh():
    return RefMesh(np.array(jax.devices()[:PARTS]).reshape(PARTS),
                   ("data",))


@pytest.fixture(scope="module")
def mesh():
    return Mesh((PARTS,), ("data",), device="cpu")


def _blocks(cls, seed, kind, split_query=False):
    """8 blocks of 8 rows: random CSR rows below NCOL; FFM rows carry a
    field per feature; ranking rows carry qids, two queries a part
    (distinct across parts unless ``split_query``: then part 0's second
    query goes on into part 1)."""
    rng = np.random.RandomState(seed)
    fields = rng.randint(0, NFIELDS, size=NCOL)
    w_true = np.random.RandomState(5).randn(NCOL)
    out = []
    for d in range(PARTS):
        c = cls(np.uint32)
        for r in range(8):
            nnz = rng.randint(1, 6)
            idx = np.sort(rng.choice(NCOL, nnz, replace=False))
            val = rng.rand(nnz).astype(np.float32)
            kw = {}
            if kind == "ffm":
                kw["fields"] = fields[idx].astype(np.int64)
            if kind == "ranking":
                q = d * 2 + r // 4
                if split_query and d == 1 and r < 4:
                    q = 1  # part 0's second query, split across parts
                kw["qid"] = q
                label = float(np.digitize((val * w_true[idx]).sum(),
                                          [0.5, 1.2]))
            else:
                label = float(rng.randint(0, 2) * 2 - 1)
            c.push(label, idx, val, **kw)
        out.append(c.get_block())
    return out


def _models(kind, l2, lr=0.3):
    if kind == "linear":
        return (RefLinear(NCOL, l2=l2, learning_rate=lr),
                SparseLinearModel(NCOL, l2=l2, learning_rate=lr,
                                  device="cpu"))
    if kind == "fm":
        return (RefFM(NCOL, num_factors=4, l2=l2, learning_rate=lr),
                SparseFMModel(NCOL, num_factors=4, l2=l2, learning_rate=lr,
                              device="cpu"))
    if kind == "ffm":
        return (RefFFM(NCOL, NFIELDS, num_factors=2, l2=l2,
                       learning_rate=lr),
                SparseFFMModel(NCOL, NFIELDS, num_factors=2, l2=l2,
                               learning_rate=lr, device="cpu"))
    return (RefRanking(NCOL, l2=l2, learning_rate=lr),
            SparseRankingModel(NCOL, l2=l2, learning_rate=lr,
                               device="cpu"))


def _params(ref, seed):
    """The reference's init with a random w (so no margin sits at the
    zero init's tie) and bias."""
    params = {k: np.asarray(v) for k, v in ref.init_params(seed=seed).items()}
    rng = np.random.RandomState(seed)
    params["w"] = (0.3 * rng.randn(NCOL)).astype(np.float32)
    params["b"] = np.float32(0.1)
    return params


def _global_batches(kind, seed, ref_mesh, mesh, split_query=False):
    ref_blocks = _blocks(RefContainer, seed, kind, split_query)
    port_blocks = _blocks(RowBlockContainer, seed, kind, split_query)
    gb_ref = ref_make_global_batch(
        ref_stack_batches([ref_pad_to_bucket(b, 8, 64)
                           for b in ref_blocks]), ref_mesh)
    gb = make_global_batch(stack_padded_rows(port_blocks, 8, 64), mesh)
    c = RowBlockContainer(np.uint32)
    for b in port_blocks:
        c.push_block(b)
    flat = {k: torch.from_numpy(np.asarray(v))
            for k, v in pad_to_bucket(c.get_block(), 64, 512).items()}
    return gb_ref, gb, flat


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["linear", "fm", "ffm", "ranking"])
def test_sharded_step_matches_reference_and_flat(kind, l2, mesh, ref_mesh):
    ref, port = _models(kind, l2)
    params = _params(ref, seed=4)
    port.load_state_dict(params_from_jax(params, device="cpu"))
    flat_model = _models(kind, l2)[1]
    flat_model.load_state_dict(params_from_jax(params, device="cpu"))
    gb_ref, gb, flat = _global_batches(kind, 7, ref_mesh, mesh)

    want_params, want_loss = ref.make_sharded_train_step(ref_mesh)(
        {k: jax.numpy.asarray(v) for k, v in params.items()}, gb_ref)
    loss_value = port.global_loss(gb, mesh)
    loss = port.make_sharded_train_step(mesh)(gb)
    _close(loss, want_loss)
    _close(loss_value, want_loss)
    got = params_to_numpy(port.state_dict())
    for k, v in want_params.items():
        _close(got[k], v)
    # distinct qids a part (ranking): the per-part pairs are all pairs,
    # so the sharded step is the flat step over the same rows
    flat_loss = flat_model.train_step(flat)
    _close(loss, flat_loss)
    for k, v in params_to_numpy(flat_model.state_dict()).items():
        _close(got[k], v)


def test_ranking_pairs_only_inside_a_part(mesh, ref_mesh):
    """A query split across parts 0 and 1: the reference pairs rows only
    inside a device's block, and so does the port, so the step differs
    from the flat step, which pairs the whole query."""
    ref, port = _models("ranking", 0.0)
    params = _params(ref, seed=2)
    port.load_state_dict(params_from_jax(params, device="cpu"))
    gb_ref, gb, flat = _global_batches("ranking", 9, ref_mesh, mesh,
                                       split_query=True)
    want_params, want_loss = ref.make_sharded_train_step(ref_mesh)(
        {k: jax.numpy.asarray(v) for k, v in params.items()}, gb_ref)
    loss = port.make_sharded_train_step(mesh)(gb)
    _close(loss, want_loss)
    for k, v in params_to_numpy(port.state_dict()).items():
        _close(v, want_params[k])
    flat_model = _models("ranking", 0.0)[1]
    flat_model.load_state_dict(params_from_jax(params, device="cpu"))
    assert abs(float(flat_model.loss(flat).detach()) - float(loss)) > 1e-4


def test_ranking_row_limit_applies_to_a_part(mesh):
    """max_row_bucket bounds a part's rows (8 here), not L times them."""
    port = SparseRankingModel(NCOL, max_row_bucket=8, device="cpu")
    gb = make_global_batch(stack_padded_rows(
        _blocks(RowBlockContainer, 3, "ranking"), 8, 64), mesh)
    assert np.isfinite(float(port.make_sharded_train_step(mesh)(gb)))
    small = SparseRankingModel(NCOL, max_row_bucket=4, device="cpu")
    with pytest.raises(DMLCError, match="max_row_bucket"):
        small.make_sharded_train_step(mesh)(gb)


def test_missing_qid_raises_named_error(mesh):
    gb = make_global_batch(stack_padded_rows(
        _blocks(RowBlockContainer, 3, "linear"), 8, 64), mesh)
    with pytest.raises(DMLCError, match="qid"):
        SparseRankingModel(NCOL, device="cpu").make_sharded_train_step(
            mesh)(gb)


# ------------------------------------------------------------ the dry run

def _ref_dryrun_w(path, ref_mesh):
    """The reference's dry run sequence on ``path``: 5 epochs of its
    sharded step from zeros, then one more step on batch 0."""
    model = RefLinear(graft.NUM_FEATURES,
                      learning_rate=graft.LEARNING_RATE)
    it = RefIter(path, ref_mesh, format="libsvm",
                 row_bucket=graft.ROW_BUCKET, nnz_bucket=graft.NNZ_BUCKET)
    batches = list(it)
    step = model.make_sharded_train_step(ref_mesh)
    params = model.init_params()
    for _ in range(5):
        for batch in batches:
            params, _ = step(params, batch)
    params, _ = step(params, batches[0])
    it.close()
    return np.asarray(params["w"]), float(params["b"]), len(batches)


def test_dryrun_multichip_matches_reference(ref_mesh, tmp_path, capsys):
    out = graft.dryrun_multichip(PARTS, device="cpu")
    assert "dryrun_multichip(8)" in capsys.readouterr().out
    path = str(tmp_path / "d.libsvm")
    graft.write_dryrun_corpus(path, PARTS)
    w_ref, b_ref, nbatches = _ref_dryrun_w(path, ref_mesh)
    assert out["batches"] == nbatches
    assert out["replay_epochs"] >= 1 and out["loss5"] < out["loss0"]
    _close(out["w"], w_ref)
    _close(out["b"], b_ref)


def test_entry_loss_matches_reference():
    import __graft_entry__ as ref_graft
    fn, args = graft.entry(device="cpu")
    ref_fn, ref_args = ref_graft.entry()
    _close(fn(*args).detach(), ref_fn(*ref_args))


# ------------------------------------------------------------ two processes

_WORKER = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist
from dmlc_tpu_torch.models import SparseLinearModel
from dmlc_tpu_torch.parallel.launch import finalize, init_from_env
from dmlc_tpu_torch.parallel.sharded import Mesh, ShardedRowBlockIter

path, out_dir, budget0 = sys.argv[1], sys.argv[2], int(sys.argv[3])
rank, world = init_from_env(device="cpu")
mesh = Mesh((8,), ("data",), group=dist.group.WORLD, device="cpu")
kw = {"agreement_cache_bytes": budget0} if rank == 0 and budget0 >= 0 else {}
it = ShardedRowBlockIter(path, mesh, format="libsvm", row_bucket=64,
                         nnz_bucket=2048, **kw)
model = SparseLinearModel(2048, l2=0.01, learning_rate=0.5, device="cpu")
step = model.make_sharded_train_step(mesh)
batches, losses, tiers = [], [], []
for epoch in range(3):
    n = 0
    for batch in it:
        losses.append(float(step(batch)))
        n += 1
    batches.append(n)
    tiers.append(it.replay_tier)
res = {"rank": rank, "world": world, "parts": mesh.local_parts(),
       "batches": batches, "losses": losses, "tiers": tiers,
       "replay_epochs": it.replay_epochs,
       "w": model.w.detach().numpy().tolist(), "b": float(model.b)}
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
it.close()
finalize()
"""


@pytest.fixture(scope="module")
def skewed_file(tmp_path_factory):
    """Record sizes grow sharply along the file, so equal BYTE shards get
    very different ROW counts and early parts exhaust first."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(1200):
        nnz = 2 if i < 900 else rng.randint(30, 60)
        idx = np.sort(rng.choice(2048, nnz, replace=False))
        lines.append(f"{i % 2} " + " ".join(
            f"{j}:{rng.rand():.4f}" for j in idx))
    p = tmp_path_factory.mktemp("mp") / "skew.libsvm"
    p.write_bytes(("\n".join(lines) + "\n").encode())
    return str(p)


def _single_process(path):
    it = ShardedRowBlockIter(path, Mesh((8,), device="cpu"),
                             format="libsvm", row_bucket=64,
                             nnz_bucket=2048)
    model = SparseLinearModel(2048, l2=0.01, learning_rate=0.5,
                              device="cpu")
    step = model.make_sharded_train_step(Mesh((8,), device="cpu"))
    losses = [float(step(b)) for _ in range(3) for b in it]
    it.close()
    return model.w.detach().numpy(), losses


def _reference(path, ref_mesh):
    model = RefLinear(2048, l2=0.01, learning_rate=0.5)
    it = RefIter(path, ref_mesh, format="libsvm", row_bucket=64,
                 nnz_bucket=2048)
    step = model.make_sharded_train_step(ref_mesh)
    params = model.init_params()
    for _ in range(3):
        for batch in it:
            params, _ = step(params, batch)
    it.close()
    return np.asarray(params["w"])


@pytest.mark.parametrize("budget0", [-1, 0], ids=["cached", "rank0_over"])
def test_two_processes_on_gloo_match_one(skewed_file, ref_mesh, tmp_path,
                                         budget0):
    """``cached``: epoch 1 agrees in one all-gather, epochs 2-3 replay
    from memory. ``rank0_over``: rank 0 has no cache budget, so both
    ranks take the per-round done-flag agreement; rank 1 still tees and
    replays. Either way both ranks step together and match one
    process."""
    out_dir = str(tmp_path)
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        "OMP_NUM_THREADS": "1"}
    launch_local(2, [sys.executable, "-c", _WORKER, skewed_file, out_dir,
                     str(budget0)], env=env, timeout=60)
    res = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    assert [r["parts"] for r in res] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert res[0]["batches"] == res[1]["batches"]
    assert len(set(res[0]["batches"])) == 1
    assert res[0]["w"] == res[1]["w"] and res[0]["b"] == res[1]["b"]
    assert res[0]["losses"] == res[1]["losses"]
    if budget0 < 0:
        assert all(r["tiers"] == ["parse", "memory", "memory"] for r in res)
    else:
        assert res[0]["replay_epochs"] == 0
        assert res[1]["replay_epochs"] == 2
    w_single, losses = _single_process(skewed_file)
    assert len(losses) == len(res[0]["losses"])
    _close(res[0]["losses"], losses)
    _close(res[0]["w"], w_single)
    _close(res[0]["w"], _reference(skewed_file, ref_mesh))
