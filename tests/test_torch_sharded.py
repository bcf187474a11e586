"""The port's sharded ingest (``parallel.sharded``, ``ops.csr.
sharded_spmv``, ``Pipeline.shard``) against the JAX package's on its
8-device CPU mesh.

The port's mesh is 8 parts on the CPU in one process; the reference's
is 8 virtual CPU devices (``tests/conftest.py``), built as
``tests/test_parallel_ops.py`` builds it. Batches are held byte for
byte: the reference's iterator runs with its ``make_global_batch``
replaced by a copy of the host ``[D, ...]`` arrays (jax without x64
would turn the int64 columns into int32 on the way to its devices), and
each port batch's tensors, moved back to numpy, must equal them in
dtype and bytes. ``sharded_spmv`` is held at rtol=1e-5, atol=1e-6: both
sides sum each row in fp32 in another order; with ``w[0] = inf`` the
non-finite entries must sit at the same places.
"""


import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

import dmlc_tpu.parallel.sharded as ref_sharded
from dmlc_tpu.data.padding import pad_to_bucket as ref_pad_to_bucket
from dmlc_tpu.data.padding import stack_padded_rows as ref_stack
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.ops import sharded_spmv as ref_sharded_spmv
from dmlc_tpu.parallel import ShardedRowBlockIter as RefIter
from dmlc_tpu.parallel import make_global_batch as ref_make_global_batch
from dmlc_tpu.parallel import stack_device_batches as ref_stack_batches
from dmlc_tpu_torch.data.padding import stack_padded_rows
from dmlc_tpu_torch.data.rowblock import RowBlock, RowBlockContainer
from dmlc_tpu_torch.ops.csr import sharded_spmv
from dmlc_tpu_torch.data.padding import stack_spec
from dmlc_tpu_torch.parallel.device_iter import HostStaging
from dmlc_tpu_torch.parallel.sharded import (
    Mesh, ShardedRowBlockIter, empty_block, make_global_batch,
    make_replicated, next_pow2_bucket, stack_device_batches, stage_round,
)
from dmlc_tpu_torch.pipeline import Pipeline
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
PARTS = 8


@pytest.fixture(scope="module")
def ref_mesh():
    return RefMesh(np.array(jax.devices()[:PARTS]).reshape(PARTS),
                   ("data",))


@pytest.fixture(scope="module")
def mesh():
    return Mesh((PARTS,), ("data",), device="cpu")


@pytest.fixture
def ref_host(monkeypatch):
    """The reference's iterator yielding its host [D, ...] arrays."""
    monkeypatch.setattr(
        ref_sharded, "make_global_batch",
        lambda local, mesh, axis="data": {
            k: np.array(v, copy=True) for k, v in local.items()})


def _block(rng, cls, rows, ncol=50, max_nnz=8, qid=False, field=False,
           weight=False):
    c = cls(np.uint32)
    for i in range(rows):
        nnz = rng.randint(0, max_nnz)
        idx = np.sort(rng.choice(np.arange(1, ncol), nnz, replace=False))
        kw = {}
        if qid:
            kw["qid"] = i // 2
        if weight:
            kw["weight"] = 0.5 + rng.rand()
        if field:
            kw["fields"] = rng.randint(0, 4, nnz)
        c.push(float(rng.randint(0, 2) * 2 - 1), idx,
               rng.rand(nnz).astype(np.float32), **kw)
    return c.get_block()


def _pair(seed, rows, **kw):
    """The same block in the port's RowBlock and the reference's."""
    port = _block(np.random.RandomState(seed), RowBlockContainer, rows, **kw)
    ref = _block(np.random.RandomState(seed), RefContainer, rows, **kw)
    return port, ref


def _ref_empty():
    return RefRowBlock(offset=np.zeros(1, np.int64),
                       label=np.zeros(0, np.float32),
                       index=np.zeros(0, np.uint32))


def _assert_same_bytes(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k in ref:
        a = port[k]
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        a, b = np.asarray(a), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), k


# ------------------------------------------------------------ padding

STACK_CASES = {
    "plain": ([dict(rows=5), dict(rows=3), None], False, False),
    "qid": ([dict(rows=4, qid=True, weight=True), None, dict(rows=2)],
            False, False),
    "field": ([dict(rows=3, field=True), None], False, False),
    "forced": ([dict(rows=2)], True, True),
    "single": ([dict(rows=6)], False, False),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_padded_rows_is_byte_identical(case):
    specs, want_qid, want_field = STACK_CASES[case]
    port_blocks, ref_blocks = [], []
    for i, spec in enumerate(specs):
        if spec is None:
            port_blocks.append(empty_block())
            ref_blocks.append(_ref_empty())
        else:
            p, r = _pair(10 + i, **spec)
            port_blocks.append(p)
            ref_blocks.append(r)
    _assert_same_bytes(stack_padded_rows(port_blocks, 8, 64, want_qid,
                                         want_field),
                       ref_stack(ref_blocks, 8, 64, want_qid, want_field))


@pytest.mark.parametrize("qid", [False, True])
def test_single_full_block_is_a_zero_copy_view(qid):
    """L == 1 and the block exactly bucket-sized: the reference serves
    views of the block's own arrays; so does the port, byte-identical."""
    rows, nnz = 4, 6
    kw = dict(offset=np.array([0, 1, 3, 5, 6], np.int64),
              label=np.ones(rows, np.float32),
              index=np.arange(nnz, dtype=np.uint32),
              value=np.ones(nnz, np.float32),
              weight=np.ones(rows, np.float32),
              qid=np.arange(rows, dtype=np.int64) if qid else None)
    port, ref = RowBlock(**kw), RefRowBlock(**kw)
    out = stack_padded_rows([port], rows, nnz)
    _assert_same_bytes(out, ref_stack([ref], rows, nnz))
    assert np.shares_memory(out["index"], port.index)
    assert np.shares_memory(out["offset"], port.offset)


def _random_round(seed, parts, qid, field):
    """A seeded round of ``parts`` blocks (some empty pads), the same in
    the port's RowBlock and the reference's."""
    rng = np.random.RandomState(seed)
    port_blocks, ref_blocks = [], []
    for i in range(parts):
        rows = int(rng.randint(0, 9))
        if rows == 0 and parts > 1:
            port_blocks.append(empty_block())
            ref_blocks.append(_ref_empty())
            continue
        p, r = _pair(seed * 31 + i, max(rows, 1), qid=qid, field=field,
                     weight=bool(rng.randint(0, 2)))
        port_blocks.append(p)
        ref_blocks.append(r)
    return port_blocks, ref_blocks


OUT_CASES = [(seed, parts, qid, field) for seed in (1, 2, 3)
             for parts in (1, 4) for qid in (False, True)
             for field in (False, True)]


@pytest.mark.parametrize("seed,parts,qid,field", OUT_CASES)
def test_stack_into_out_is_byte_identical(seed, parts, qid, field):
    """stack_padded_rows(out=...) writes every element of the caller's
    arrays (filled with junk first) with the bytes of the port's fresh
    stack and of the reference's, over seeded rounds with and without
    qid and field, one part and four."""
    port_blocks, ref_blocks = _random_round(seed, parts, qid, field)
    for want_qid, want_field in ((False, False), (qid, field)):
        fresh = stack_padded_rows(port_blocks, 8, 64, want_qid, want_field)
        spec = stack_spec(port_blocks, 8, 64, want_qid, want_field)
        out = {}
        for k, (shape, dtype) in spec.items():
            out[k] = np.empty(shape, dtype)
            out[k].view(np.uint8)[...] = 0xA5
        got = stack_padded_rows(port_blocks, 8, 64, want_qid, want_field,
                                out=out)
        assert got is out
        _assert_same_bytes(got, fresh)
        _assert_same_bytes(got, ref_stack(ref_blocks, 8, 64, want_qid,
                                          want_field))


def test_stack_into_out_copies_the_single_full_block():
    """L == 1 and the block exactly bucket-sized: with out= the stack is
    one copy into the caller's arrays, not a view of the block."""
    kw = dict(offset=np.array([0, 1, 3, 5, 6], np.int64),
              label=np.ones(4, np.float32),
              index=np.arange(6, dtype=np.uint32),
              value=np.ones(6, np.float32), weight=np.ones(4, np.float32))
    port, ref = RowBlock(**kw), RefRowBlock(**kw)
    spec = stack_spec([port], 4, 6)
    out = {k: np.zeros(shape, dtype) for k, (shape, dtype) in spec.items()}
    stack_padded_rows([port], 4, 6, out=out)
    _assert_same_bytes(out, ref_stack([ref], 4, 6))
    assert not np.shares_memory(out["index"], port.index)
    with pytest.raises(DMLCError, match="stack_spec"):
        stack_padded_rows([port], 4, 6, want_qid=True, out=out)


class _Event:
    """A stand-in for a CUDA event: pending until synchronized."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_staging_slot_is_never_handed_out_while_its_copy_is_pending():
    spec = {"x": ((2, 3), np.dtype(np.float32)),
            "i": ((2,), np.dtype(np.uint32))}
    pool = HostStaging(slots=2)
    a = pool.acquire(spec)
    ev_a = _Event()
    pool.release(a, ev_a)
    b = pool.acquire(spec)  # a is pending: a second slot
    assert b is not a and pool.allocated == 2
    ev_b = _Event()
    pool.release(b, ev_b)
    c = pool.acquire(spec)  # all allocated, all busy: wait on the oldest
    assert c is a and ev_a.done and not ev_b.done
    assert c["i"].dtype == torch.uint32 and tuple(c["x"].shape) == (2, 3)
    # a finished copy is taken without a wait
    ev_b.done = True
    assert pool.acquire(spec) is b
    # another shape gets its own slot, in place of a free one of another
    # shape when every slot is allocated
    pool.release(b, None)
    pool.release(c, None)
    other = pool.acquire({"x": ((5,), np.dtype(np.float32))})
    assert other is not b and other is not c and pool.allocated == 2
    # a slot released with no event is free at once; on a target that
    # aliases the slot (the CPU), a released slot is never handed out
    cpu = HostStaging(slots=2, alias_unsafe=True)
    s1 = cpu.acquire(spec)
    cpu.release(s1, None)
    assert cpu.acquire(spec) is not s1


def test_stage_round_fills_a_slot_with_the_stack(mesh):
    """stage_round pads and stacks into a staging slot, and the slot goes
    to the device as it stands (make_global_batch(staged=True)), byte
    for byte the fresh stack's batch."""
    blocks = [_pair(s, 4, qid=True)[0] for s in range(PARTS)]
    pool = HostStaging(slots=2, alias_unsafe=True)
    slot = stage_round(blocks, 8, 64, True, False, pool)
    assert isinstance(slot["offset"], torch.Tensor)
    gb = make_global_batch(slot, mesh, staging=pool, staged=True)
    fresh = stack_padded_rows(blocks, 8, 64, True, False)
    _assert_same_bytes(gb, fresh)
    assert gb.counts == (int(fresh["num_rows"].sum()),
                         int(fresh["num_nnz"].sum()))
    with pytest.raises(DMLCError, match="staging pool"):
        make_global_batch(slot, mesh, staged=True)


def test_helpers_match_reference():
    for n in (0, 5, 8, 9, 1000):
        assert next_pow2_bucket(n) == ref_sharded.next_pow2_bucket(n)
    port = [dict(stack_padded_rows([_pair(s, 4)[0]], 8, 64)) for s in (1, 2)]
    ref = [ref_pad_to_bucket(_pair(s, 4)[1], 8, 64) for s in (1, 2)]
    stacked = stack_device_batches([{k: v[0] for k, v in b.items()}
                                    for b in port])
    _assert_same_bytes(stacked, ref_stack_batches(ref))
    with pytest.raises(DMLCError, match="inconsistent batch keys"):
        stack_device_batches([{"a": np.zeros(1)}, {"b": np.zeros(1)}])


# ------------------------------------------------------------ mesh, batch

def test_mesh_owns_every_part_in_one_process():
    m = Mesh((8,), device="cpu")
    assert (m.rank, m.world, m.size) == (0, 1, 8)
    assert m.local_parts() == list(range(8))
    m2 = Mesh((4, 2), ("data", "model"), device="cpu")
    assert m2.parts("data") == 4 and m2.parts("model") == 2
    assert m2.local_parts("data") == [0, 1, 2, 3]
    assert m2.local_parts("model") == [0, 1]
    with pytest.raises(DMLCError, match="mesh shape"):
        Mesh((8,), ("data", "model"), device="cpu")


def test_make_global_batch_layout(mesh):
    blocks = [_pair(s, 4)[0] for s in range(PARTS)]
    local = stack_padded_rows(blocks, 8, 64)
    gb = make_global_batch(local, mesh)
    assert gb["offset"].shape == (PARTS, 9)
    assert gb["index"].dtype == torch.uint32
    assert gb.counts == (int(local["num_rows"].sum()),
                         int(local["num_nnz"].sum()))
    _assert_same_bytes(gb, local)
    with pytest.raises(DMLCError, match="leading part dim"):
        make_global_batch({k: v[:3] for k, v in local.items()}, mesh)
    rep = make_replicated({"w": np.ones(3, np.float32),
                           "b": [np.float32(2)]}, mesh)
    assert rep["w"].device.type == "cpu" and float(rep["b"][0]) == 2.0


# ------------------------------------------------------------ sharded_spmv

def _spmv_blocks(full_part):
    """8 parts padded to (8, 64); part ``full_part`` holds exactly 64
    nonzeros (no padded tail), the others leave a tail of index 0 and
    value 0. No row reads index 0."""
    ports, refs = [], []
    for d in range(PARTS):
        rng = np.random.RandomState(100 + d)
        lens = rng.randint(0, 8, 6)
        if d == full_part:
            lens = np.array([8, 8, 8, 8, 8, 8, 8, 8])
        offset = np.zeros(len(lens) + 1, np.int64)
        offset[1:] = np.cumsum(lens)
        nnz = int(offset[-1])
        kw = dict(offset=offset,
                  label=np.ones(len(lens), np.float32),
                  index=rng.randint(1, 50, nnz).astype(np.uint32),
                  value=rng.rand(nnz).astype(np.float32))
        ports.append(RowBlock(**kw))
        refs.append(RefRowBlock(**kw))
    return ports, refs


@pytest.mark.parametrize("inf_w0", [False, True])
def test_sharded_spmv_matches_reference(mesh, ref_mesh, inf_w0):
    ports, refs = _spmv_blocks(full_part=3)
    local = stack_padded_rows(ports, 8, 64)
    assert local["num_nnz"][3] == 64
    w = np.random.RandomState(5).rand(50).astype(np.float32)
    if inf_w0:
        w[0] = np.inf
    gb = ref_make_global_batch(ref_stack(refs, 8, 64), ref_mesh)
    want = np.asarray(ref_sharded_spmv(gb, w, ref_mesh))
    wt = torch.from_numpy(w.copy()).requires_grad_(True)
    got = sharded_spmv(make_global_batch(local, mesh), wt, mesh)
    assert got.shape == (PARTS, 8)
    assert np.isfinite(want).all()  # the tails never reach a margin
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    if not inf_w0:
        # the gradient in w: K2 per part, summed (jax.vjp of the same)
        g = np.random.RandomState(6).randn(PARTS, 8).astype(np.float32)
        got.backward(torch.from_numpy(g))
        _, vjp = jax.vjp(lambda ww: ref_sharded_spmv(gb, ww, ref_mesh),
                         jax.numpy.asarray(w))
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(vjp(g)[0]),
                                   rtol=RTOL, atol=ATOL)


def test_sharded_spmv_checks_the_part_count(mesh):
    ports, _ = _spmv_blocks(full_part=0)
    gb = make_global_batch(stack_padded_rows(ports, 8, 64), mesh)
    with pytest.raises(DMLCError, match="parts"):
        sharded_spmv(gb, torch.ones(50), Mesh((4,), device="cpu"))


# ------------------------------------------------------------ the iterator

def _write_libsvm(path, seed, n):
    rng = np.random.RandomState(seed)
    lines = [f"{i % 2} {rng.randint(0, 50)}:{rng.rand():.6f}".encode()
             for i in range(n)]
    path.write_bytes(b"\n".join(lines) + b"\n")


def _skewed_qid(path, seed):
    rng = np.random.RandomState(seed)
    lines = [f"{i % 2} qid:{i // 3} {rng.randint(0, 9)}:1"
             for i in range(200)]
    for i in range(20):
        feats = " ".join(f"{j}:{rng.rand():.6f}"
                         for j in sorted(rng.choice(500, 40, replace=False)))
        lines.append(f"{i % 2} qid:{100 + i} {feats}")
    path.write_bytes("\n".join(lines).encode() + b"\n")


def _skewed_field(path, seed):
    rng = np.random.RandomState(seed)
    lines = [f"{i % 2} 1:{rng.randint(0, 9)}:1" for i in range(200)]
    for i in range(20):
        toks = " ".join(f"{rng.randint(0, 6)}:{j}:{rng.rand():.6f}"
                        for j in sorted(rng.choice(500, 40, replace=False)))
        lines.append(f"{i % 2} {toks}")
    path.write_bytes("\n".join(lines).encode() + b"\n")


def _collect(it):
    return [{k: (v.numpy().copy() if isinstance(v, torch.Tensor)
                 else np.array(v, copy=True)) for k, v in b.items()}
            for b in it]


def _same_epochs(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        _assert_same_bytes(a, b)


def _iters(path, mesh, ref_mesh, **kw):
    kw.setdefault("prefetch", False)
    return (ShardedRowBlockIter(str(path), mesh, **kw),
            RefIter(str(path), ref_mesh, **kw))


ITER_CASES = {
    "coverage": (lambda p: _write_libsvm(p, 1, 333), "libsvm",
                 dict(row_bucket=32, nnz_bucket=64)),
    "cached": (lambda p: _write_libsvm(p, 2, 150), "libsvm",
               dict(row_bucket=32, nnz_bucket=64,
                    first_epoch_cache="always")),
    "qid_always": (lambda p: _skewed_qid(p, 3), "libsvm",
                   dict(row_bucket=8, nnz_bucket=64,
                        first_epoch_cache="always")),
    "qid_never": (lambda p: _skewed_qid(p, 3), "libsvm",
                  dict(row_bucket=8, nnz_bucket=64,
                       first_epoch_cache="never")),
    "field": (lambda p: _skewed_field(p, 4), "libfm",
              dict(row_bucket=8, nnz_bucket=64)),
    "over_budget": (lambda p: _write_libsvm(p, 5, 200), "libsvm",
                    dict(row_bucket=32, nnz_bucket=64,
                         first_epoch_cache="always",
                         agreement_cache_bytes=0)),
    "no_replay": (lambda p: _write_libsvm(p, 6, 100), "libsvm",
                  dict(row_bucket=32, nnz_bucket=64, steady_replay=False,
                       first_epoch_cache="always")),
    "native": (lambda p: _write_libsvm(p, 7, 300), "libsvm",
               dict(row_bucket=16, nnz_bucket=32, engine="native")),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_iterator_epochs_match_reference(case, mesh, ref_mesh, ref_host,
                                         tmp_path):
    """Three epochs of each side, byte for byte, with the replay counters
    and tiers of the reference at every epoch."""
    write, fmt, kw = ITER_CASES[case]
    p = tmp_path / f"d.{fmt}"
    write(p)
    it, ref = _iters(p, mesh, ref_mesh, format=fmt, **kw)
    e1 = None
    for _ in range(3):
        got, want = _collect(it), _collect(ref)
        _same_epochs(got, want)
        e1 = e1 or got
        _same_epochs(got, e1)
        assert (it.replay_epochs, it.replay_tier) == (ref.replay_epochs,
                                                      ref.replay_tier)
        assert it._part_rounds == ref._part_rounds
    total = sum(int(b["num_rows"].sum()) for b in e1)
    assert total == sum(1 for _ in open(p))
    if case.startswith("qid") or case == "field":
        assert len(set(it._part_rounds)) > 1  # the skew happened
        key = "qid" if case != "field" else "field"
        assert all(key in b for b in e1)
    it.close()
    ref.close()


def test_replay_counts_and_tiers(mesh, tmp_path):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 8, 150)
    it = ShardedRowBlockIter(str(p), mesh, format="libsvm", row_bucket=32,
                             nnz_bucket=64, prefetch=False,
                             first_epoch_cache="always")
    e1 = _collect(it)
    assert (it.replay_epochs, it.replay_tier) == (0, "parse")
    assert it._round_store is not None and it._round_store.tier == "memory"
    _same_epochs(_collect(it), e1)
    assert (it.replay_epochs, it.replay_tier) == (1, "memory")
    auto = ShardedRowBlockIter(str(p), mesh, format="libsvm", row_bucket=32,
                               nnz_bucket=64, prefetch=False)
    _collect(auto)
    _collect(auto)
    assert auto.replay_epochs == 0  # epoch 2 re-parsed (the tee)
    _same_epochs(_collect(auto), e1)
    assert auto.replay_epochs == 1  # epoch 3 replayed the tee
    assert auto.replay_tier == "memory" and auto.page_replay_epochs == 0


@pytest.mark.parametrize("cache_mode", ["always", "never"])
def test_truncated_file_raises(mesh, tmp_path, cache_mode):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 9, 300)
    it = ShardedRowBlockIter(str(p), mesh, format="libsvm", row_bucket=8,
                             nnz_bucket=16, prefetch=False,
                             first_epoch_cache=cache_mode)
    assert len(_collect(it)) > 0
    data = p.read_bytes()
    cut = data.index(b"\n", len(data) // 4) + 1
    p.write_bytes(data[:cut])  # clean truncation at a line boundary
    with pytest.raises(DMLCError, match="changed between epochs"):
        _collect(it)


def test_rewritten_file_raises(mesh, tmp_path):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 10, 300)
    it = ShardedRowBlockIter(str(p), mesh, format="libsvm", row_bucket=8,
                             nnz_bucket=16, prefetch=False)
    assert len(_collect(it)) > 0
    _write_libsvm(p, 11, 40)  # rewrite, much shorter
    with pytest.raises(DMLCError, match="changed between epochs"):
        _collect(it)


@pytest.mark.parametrize("cache_mode", ["always", "auto"])
def test_appends_stay_invisible_and_replay_reearns(mesh, ref_mesh,
                                                   ref_host, tmp_path,
                                                   cache_mode):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 12, 150)
    it, ref = _iters(p, mesh, ref_mesh, format="libsvm", row_bucket=32,
                     nnz_bucket=64, first_epoch_cache=cache_mode)
    e1 = _collect(it)
    _same_epochs(e1, _collect(ref))
    with open(p, "ab") as f:
        f.write(b"1 3:0.5\n" * 200)
    for _ in range(2):
        got = _collect(it)
        _same_epochs(got, _collect(ref))
        _same_epochs(got, e1)
        assert (it.replay_epochs, it.replay_tier) == (ref.replay_epochs,
                                                      ref.replay_tier)


def test_over_budget_fallback_matches_cached_path(mesh, tmp_path):
    """Over its budget the per-round path serves the cached path's
    batches, and its rounds replay from pages (the page tier is on by
    default, as in the reference)."""
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 13, 200)
    kw = dict(format="libsvm", row_bucket=32, nnz_bucket=64,
              prefetch=False, first_epoch_cache="always")
    fast = ShardedRowBlockIter(str(p), mesh, **kw)
    slow = ShardedRowBlockIter(str(p), mesh, agreement_cache_bytes=2048,
                               spill_dir=str(tmp_path / "spill"), **kw)
    _same_epochs(_collect(slow), _collect(fast))
    _same_epochs(_collect(slow), _collect(fast))
    assert slow.replay_epochs == 1 and slow._round_store.tier == "pages"
    assert fast.replay_epochs == 1 and fast._round_store.tier == "memory"
    slow.close()


# ------------------------------------------------------------ page tier
# twins of tests/test_parallel_ops.py's page-tier tests: each package
# spills into its own directory (both derive the same file names)

def _page_iters(path, mesh, ref_mesh, tmp_path, **kw):
    kw = dict(dict(format="libsvm", row_bucket=32, nnz_bucket=64,
                   prefetch=False, agreement_cache_bytes=2048,
                   first_epoch_cache="always"), **kw)
    return (ShardedRowBlockIter(str(path), mesh,
                                spill_dir=str(tmp_path / "port_spill"), **kw),
            RefIter(str(path), ref_mesh,
                    spill_dir=str(tmp_path / "ref_spill"), **kw))


def _state(it):
    return (it.replay_tier, it.replay_epochs, it.page_replay_epochs)


@pytest.mark.parametrize("cache_mode,level", [("always", 0), ("never", 0),
                                              ("always", 6)])
def test_page_spill_serves_steady_epochs_like_reference(
        mesh, ref_mesh, ref_host, tmp_path, monkeypatch, cache_mode, level):
    """Rounds over a tiny agreement_cache_bytes spill to pages, and every
    steady epoch is served from them, byte for byte the reference's
    (raw rounds and, at level 6, codec-paged ones), with the reference's
    tier and counters at every epoch; the spill files are equal too, and
    close() deletes the port's."""
    monkeypatch.setenv("DMLC_TPU_PAGE_CODEC_LEVEL", str(level))
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 20, 300)
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path,
                          first_epoch_cache=cache_mode)
    e1 = None
    tiers = []
    for epoch in range(4):
        got, want = _collect(it), _collect(ref)
        _same_epochs(got, want)
        e1 = e1 or got
        _same_epochs(got, e1)
        assert _state(it) == _state(ref)
        tiers.append(it.replay_tier)
    spilled = ["parse"] * (1 if cache_mode == "always" else 2)
    assert tiers == spilled + ["pages"] * (4 - len(spilled))
    assert it.page_replay_epochs == 4 - len(spilled)
    port_file = it._round_store.file.path
    ref_file = ref._round_store.file.path
    assert os.path.dirname(port_file) == str(tmp_path / "port_spill")
    with open(port_file, "rb") as a, open(ref_file, "rb") as b:
        assert a.read() == b.read()
    it.close()
    ref.close()
    assert not os.path.exists(port_file)
    assert os.listdir(tmp_path / "port_spill") == []


def _batch_hashes(batches):
    import hashlib
    out = []
    for b in batches:
        h = hashlib.sha256()
        for k in sorted(b):
            h.update(k.encode())
            h.update(np.ascontiguousarray(b[k]).tobytes())
        out.append(h.hexdigest())
    return out


@pytest.mark.parametrize("tier", ["memory", "pages"])
def test_served_tiers_hash_like_the_parse_and_the_reference(
        tier, mesh, ref_mesh, ref_host, tmp_path):
    """The serve thread stacks each round straight into its staging
    slot: every memory- and page-tier epoch hashes batch for batch like
    the parse epoch and like the reference's host batches."""
    p = tmp_path / "d.libsvm"
    _skewed_qid(p, 9)
    budget = 1 << 30 if tier == "memory" else 2048
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path, row_bucket=8,
                          agreement_cache_bytes=budget)
    parse = None
    for epoch in range(3):
        got, want = _batch_hashes(_collect(it)), _batch_hashes(_collect(ref))
        assert got == want
        parse = parse or got
        assert got == parse
    assert it.replay_tier == tier and it._serve_stats["work_s"] > 0
    assert set(it._serve_stats) == {"produced", "producer_block_s",
                                    "work_s", "work_cpu_s"}
    it.close()
    ref.close()


def test_page_spill_mutation_reparses_then_reearns(mesh, ref_mesh,
                                                   ref_host, tmp_path):
    """A page-armed iterator notices the stat change, re-parses one
    clean asserting epoch (appends stay invisible) with the stale spill
    file deleted, and re-earns PAGE replay, as the reference does."""
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 21, 300)
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path)
    e1 = _collect(it)
    _same_epochs(e1, _collect(ref))
    first_spill = it._round_store.file.path
    with open(p, "ab") as f:
        f.write(b"1 3:0.5\n" * 200)
    for want_tier, want_pages in (("parse", 0), ("pages", 1)):
        got = _collect(it)
        _same_epochs(got, _collect(ref))
        _same_epochs(got, e1)
        assert _state(it) == _state(ref)
        assert (it.replay_tier, it.page_replay_epochs) == (want_tier,
                                                           want_pages)
        assert not os.path.exists(first_spill)
    it.close()
    ref.close()


def test_page_spill_truncation_still_raises(mesh, ref_mesh, tmp_path):
    """Truncating the backing file under a page-armed iterator raises
    the mutation error on the fallback re-parse, in both packages."""
    from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 22, 300)
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path, row_bucket=8,
                          nnz_bucket=16)
    assert len(_collect(it)) == len(_collect(ref)) > 0
    assert it._round_store.tier == ref._round_store.tier == "pages"
    data = p.read_bytes()
    cut = data.index(b"\n", len(data) // 4) + 1
    p.write_bytes(data[:cut])
    with pytest.raises(DMLCError, match="changed between epochs"):
        _collect(it)
    with pytest.raises(RefDMLCError, match="changed between epochs"):
        _collect(ref)


def test_page_spill_off_abandons_over_budget(mesh, ref_mesh, ref_host,
                                             tmp_path):
    """page_spill=False: over-budget rounds abandon replay and every
    epoch re-parses, identically, in both packages."""
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 23, 200)
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path, page_spill=False)
    e1 = _collect(it)
    for _ in range(2):
        got = _collect(it)
        _same_epochs(got, _collect(ref))
        _same_epochs(got, e1)
        assert _state(it) == _state(ref) == ("parse", 0, 0)
    assert it._round_store is None and ref._round_store is None
    assert not os.path.exists(tmp_path / "port_spill")


def test_vanished_spill_file_degrades_to_a_reparse(mesh, ref_mesh,
                                                   ref_host, tmp_path):
    """A spill file removed under a page-armed iterator is not a data
    hazard: the epoch re-parses and re-earns a fresh page store."""
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 24, 300)
    it, ref = _page_iters(p, mesh, ref_mesh, tmp_path)
    e1 = _collect(it)
    _collect(ref)
    for x in (it, ref):
        os.remove(x._round_store.file.path)
    for want_tier in ("parse", "pages"):
        got = _collect(it)
        _same_epochs(got, _collect(ref))
        _same_epochs(got, e1)
        assert _state(it) == _state(ref)
        assert it.replay_tier == want_tier
    it.close()
    ref.close()


def test_page_tier_defaults_match_reference():
    """C10: the port's page tier is on by default, with the reference's
    budget, so the two packages pick the same tier for the same shard."""
    import inspect
    port = inspect.signature(ShardedRowBlockIter).parameters
    ref = inspect.signature(RefIter).parameters
    for name in ("page_spill", "agreement_cache_bytes", "spill_dir",
                 "steady_replay", "first_epoch_cache"):
        assert port[name].default == ref[name].default, name
    assert port["page_spill"].default is True


def test_serve_thread_and_prefetch_depth(mesh, tmp_path):
    """The cached epoch and the replay are served by a background thread
    (the shard.serve queue) through HostStaging: the batches are the
    streamed epoch's, whatever the lookahead."""
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 15, 400)
    kw = dict(format="libsvm", row_bucket=16, nnz_bucket=32,
              prefetch=False)
    stream = _collect(ShardedRowBlockIter(str(p), mesh,
                                          first_epoch_cache="never", **kw))
    for depth in (1, 4):
        it = ShardedRowBlockIter(str(p), mesh, first_epoch_cache="always",
                                 **kw)
        it.prefetch_depth = depth
        _same_epochs(_collect(it), stream)
        assert it._serve_stats is not None
        _same_epochs(_collect(it), stream)
        assert it.replay_tier == "memory"


# ------------------------------------------------------------ Pipeline

def test_pipeline_shard_yields_the_iterators_batches(mesh, tmp_path):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 16, 300)
    want = _collect(ShardedRowBlockIter(
        str(p), mesh, format="libsvm", row_bucket=16, nnz_bucket=32,
        engine="native"))
    built = (Pipeline.from_uri(str(p))
             .parse(format="libsvm", engine="native")
             .shard(mesh, row_bucket=16, nnz_bucket=32)
             .prefetch(2)
             .build(autotune=True))
    for epoch in range(3):
        _same_epochs(_collect(built), want)
    stats = built.stats()
    shard = stats["stages"][0]
    assert shard["kind"] == "shard"
    assert shard["items"] == len(want)
    assert shard["rows"] == sum(int(b["num_rows"].sum()) for b in want)
    assert shard["extra"]["replay_tier"] == "memory"
    assert shard["extra"]["replay_epochs"] == 1
    assert "shard.prefetch" in built.knob_values()
    built.close()


def test_pipeline_shard_grammar(mesh, tmp_path):
    p = tmp_path / "d.libsvm"
    _write_libsvm(p, 17, 10)
    with pytest.raises(DMLCError, match="cannot follow"):
        (Pipeline.from_uri(str(p)).parse().shard(mesh)
         .to_device(device="cpu").build())
    with pytest.raises(DMLCError, match="not ported"):
        Pipeline.from_uri(str(p)).parse().to_device(sharding=object())
    built = Pipeline.from_uri(str(p)).shard(mesh, row_bucket=8,
                                            nnz_bucket=16).build()
    assert sum(int(b["num_rows"].sum()) for b in built) == 10
    built.close()
