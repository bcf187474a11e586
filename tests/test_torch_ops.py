"""The CSR ops (K1 forward, K2 weight gradient, K3 padded-row dot, K4
CSR to dense, and the host-side CSR to padded rows) against JAX.

On the CPU the wrappers run their plain PyTorch versions; these are held
to ``dmlc_tpu.ops.csr``'s ``segment_spmv`` and ``jax.grad`` of it in w,
``sdot_rows``, ``csr_to_dense`` and ``csr_to_padded_rows``, on inputs
made with numpy from a seed. Tolerance rtol=1e-5, atol=1e-6: both sides
sum each row (K4: each duplicate column) in fp32, in different orders.
The index rule (ROADMAP C6: low 32 bits, signed, negative counted from
the end) is held to the reference at u32 2³²−1 and 2³¹, u64 2³²+3 and
int32 −1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops.csr import csr_row_ids as ref_row_ids
from dmlc_tpu.ops.csr import csr_to_dense as ref_csr_to_dense
from dmlc_tpu.ops.csr import csr_to_padded_rows as ref_csr_to_padded_rows
from dmlc_tpu.ops.csr import sdot_rows as ref_sdot_rows
from dmlc_tpu.ops.csr import segment_spmv as ref_segment_spmv
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6


def _csr(seed, rows=64, features=500, max_nnz=12, pad_rows=0, pad_nnz=0,
         empty=(), out_of_range=(), raw=(), index_dtype=np.uint32,
         dense=False, lengths=None):
    """A padded CSR batch: ``pad_rows`` empty tail rows, ``pad_nnz``
    zero-valued tail nonzeros, rows in ``empty`` emptied, an index past
    the features in each row of ``out_of_range``, and for each (row, v)
    of ``raw`` the raw index v as the row's first. ``dense``: each row
    holds every index 1 .. features-1 (a narrow model's dense rows, as in
    the ranking path) and then up to ``max_nnz`` of them again.
    ``lengths``: the rows' nonzeros, in place of ``rows`` drawn ones."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_nnz + 1, rows)
    if lengths is not None:
        rows, lens = len(lengths), np.array(lengths)
    if dense:
        lens += features - 1
    lens[list(empty)] = 0
    if pad_rows:
        lens[rows - pad_rows:] = 0
    offset = np.zeros(rows + 1, np.int64)
    offset[1:] = np.cumsum(lens)
    nnz = int(offset[-1])
    index = np.zeros(nnz + pad_nnz, index_dtype)
    if dense:
        index[:nnz] = np.concatenate([
            np.concatenate([np.arange(1, features),
                            rng.randint(1, features, n - features + 1)])
            for n in lens if n])
    else:
        index[:nnz] = rng.randint(0, features, nnz)
    value = np.zeros(nnz + pad_nnz, np.float32)
    value[:nnz] = rng.rand(nnz)
    for r in out_of_range:
        index[offset[r]] = features + 7
    for r, v in raw:
        index[offset[r]] = v
    w = rng.randn(features).astype(np.float32)
    g = rng.randn(rows).astype(np.float32)
    return offset, index, value, w, g


# The row lengths the kernels are held at here and on the card
# (chip_smoke.py): about 16, 32 and 64, the ranking path's 136, and 1000.
ROW_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 136, 1000)

CASES = {
    "plain": dict(seed=0),
    "empty_rows": dict(seed=1, empty=(0, 5, 6, 63)),
    "padded_tail": dict(seed=2, pad_rows=9, pad_nnz=40),
    "out_of_range": dict(seed=3, out_of_range=(4, 17), pad_nnz=5),
    "u64_index": dict(seed=4, index_dtype=np.uint64, pad_rows=3, pad_nnz=8),
    "long_rows": dict(seed=5, rows=16, max_nnz=200),
    "last_feature": dict(seed=6, features=3),
    # the index rule (C6): u32 2^32-1 reads w[F-1], 2^32-5 reads w[F-5],
    # 2^31 and 2^31-1 are invalid
    "c6_u32": dict(seed=8, raw=((3, 2**32 - 1), (9, 2**31), (12, 2**31 - 1),
                                (20, 2**32 - 5))),
    # u64: the low 32 bits count, so 2^32+3 reads w[3], 2^32-2 w[F-2],
    # 2^63+5 w[5], and 2^40+2^31 is invalid
    "c6_u64": dict(seed=9, index_dtype=np.uint64, pad_nnz=4,
                   raw=((3, 2**32 + 3), (9, 2**32 - 2), (14, 2**63 + 5),
                        (20, 2**40 + 2**31))),
    # int32 (csr_to_padded_rows' dtype): -1 reads w[F-1], -F w[0], -F-1
    # is invalid
    "c6_int32": dict(seed=10, index_dtype=np.int32,
                     raw=((3, -1), (7, -500), (9, -501))),
    # a narrow model of 137 weights whose rows hold indices 1-136 and
    # duplicates (the ranking path's shape, where K2 takes its private
    # route on the card), with empty rows and a padded tail
    "narrow_dense": dict(seed=11, rows=40, features=137, max_nnz=6,
                         dense=True, empty=(2, 9), pad_rows=3, pad_nnz=7),
    # rows about the lane counts of K1's routes on the card (16 and 32
    # lanes a row, 64 and 160 nonzeros a pass) and past them, an invalid
    # index in a long row and a padded tail
    "row_lengths": dict(seed=12, lengths=ROW_LENGTHS, out_of_range=(12,),
                        pad_nnz=6),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_forward(offset, index, value, w):
    return np.asarray(ref_segment_spmv(offset, index, value, w,
                                       num_rows=len(offset) - 1))


def _ref_grad(offset, index, value, w, g):
    """The cotangent g pulled back through the reference's forward: the
    gradient jax.value_and_grad takes in the training step."""
    _, pullback = jax.vjp(
        lambda wj: ref_segment_spmv(offset, index, value, wj,
                                    num_rows=len(offset) - 1),
        jnp.asarray(w))
    return np.asarray(pullback(jnp.asarray(g))[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_plain_matches_jax(case):
    offset, index, value, w, _ = _csr(**CASES[case])
    want = _ref_forward(offset, index, value, w)
    got = csr.csr_spmv(_t(offset), _t(index), _t(value), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_plain_matches_jax_grad(case):
    offset, index, value, w, g = _csr(**CASES[case])
    want = _ref_grad(offset, index, value, w, g)
    got = csr.csr_spmv_t(_t(offset), _t(index), _t(value), _t(g),
                         len(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# sm_90's opt-in shared memory a block (the private kernel has no static
# shared memory)
SM90_K2_SHARED = 232448


@pytest.mark.parametrize("features,nnz,route", [
    (137, 557056, "private"),       # the ranking batch: 137 weights
    (8192, 557056, "private"),      # a flush of 264 x 8192 atomics
    (32768, 557056, "global"),      # a flush of 264 x 32768: 15.5 a nonzero
    (10**6, 368640, "global"),      # the linear batch: 10^6 weights
    (60000, 10**9, "global"),       # 240 KB: past a block's shared memory
    (0, 557056, "global"),          # no weight to flush
])
def test_k2_route(features, nnz, route):
    """K2 takes its private route where grad_w fits a block's shared
    memory and its flush (2 blocks an SM x 132 SMs x F atomics) is at
    most K2_FLUSH_PER_NNZ a nonzero; else the global one."""
    assert csr.csr_spmv_t_route(features, nnz, 132, SM90_K2_SHARED) == route


@pytest.mark.parametrize("nnz,rows,route", [
    (368640, 8192, "half"),      # the linear batch: 45 a row
    (327680, 8192, "half"),      # the FM batch: 40 a row
    (557056, 4096, "warp"),      # the ranking batch: 136 a row
    (64 * 8192, 8192, "half"),   # the boundary: 64 a row
    (64 * 8192 + 1, 8192, "warp"),
    (0, 1, "half"),              # an empty batch
])
def test_k1_route(nnz, rows, route):
    """K1 takes 16 lanes a row where the bucket holds at most 64 nonzeros
    a row (a row in one pass of 4 a lane), a warp a row beyond."""
    assert csr.csr_spmv_route(nnz, rows) == route
    assert csr.K1_LANES[route] == {"half": 16, "warp": 32}[route]


def test_out_of_range_gives_nan_row_and_dropped_gradient():
    offset, index, value, w, g = _csr(seed=7, rows=8, out_of_range=(2,))
    y = csr.csr_spmv(_t(offset), _t(index), _t(value), _t(w)).numpy()
    assert np.isnan(y[2]) and np.isfinite(np.delete(y, 2)).all()
    grad = csr.csr_spmv_t(_t(offset), _t(index), _t(value), _t(g),
                          len(w)).numpy()
    assert np.isfinite(grad).all()
    # the out-of-range nonzero is dropped, its row's others are not
    keep = np.ones(len(index), bool)
    keep[offset[2]] = False
    rows = np.repeat(np.arange(8), np.diff(offset))
    want = np.zeros(len(w), np.float32)
    np.add.at(want, index[keep].astype(np.int64), value[keep] * g[rows[keep]])
    np.testing.assert_allclose(grad, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "padded_tail", "out_of_range",
                                  "c6_u64"])
def test_segment_spmv_autograd_pairs_k1_with_k2(case):
    offset, index, value, w, g = _csr(**CASES[case])
    wt = _t(w).requires_grad_()
    y = csr.segment_spmv(_t(offset), _t(index), _t(value), wt,
                         num_rows=len(offset) - 1)
    y.backward(_t(g))
    want = csr.csr_spmv_t(_t(offset), _t(index), _t(value), _t(g), len(w))
    np.testing.assert_array_equal(wt.grad.numpy(), want.numpy())
    np.testing.assert_allclose(
        csr.spmv(_t(offset), _t(index), _t(value), _t(w)).numpy(),
        _ref_forward(offset, index, value, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["plain", "padded_tail", "empty_rows"])
def test_csr_row_ids_matches_jax(case):
    offset, index, *_ = _csr(**CASES[case])
    want = np.asarray(ref_row_ids(jnp.asarray(offset), len(index)))
    got = csr.csr_row_ids(_t(offset), len(index)).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_spmv_checks_num_rows():
    offset, index, value, w, _ = _csr(seed=0)
    with pytest.raises(DMLCError, match="num_rows"):
        csr.segment_spmv(_t(offset), _t(index), _t(value), _t(w),
                         num_rows=len(offset))


# ------------------------------------------------------------ the index rule

# raw index, its dtype, and the entry of w = arange(1, 11) the reference
# reads (None: invalid, NaN)
INDEX_RULE = [
    (2**32 - 1, np.uint32, 9), (2**31, np.uint32, None),
    (2**31 - 1, np.uint32, None), (3, np.uint32, 3),
    (2**32 + 3, np.uint64, 3), (2**32 - 2, np.uint64, 8),
    (-1, np.int32, 9), (-10, np.int32, 0), (-11, np.int32, None),
]


@pytest.mark.parametrize("raw,dtype,entry", INDEX_RULE,
                         ids=[f"{np.dtype(d).name}_{v}"
                              for v, d, _ in INDEX_RULE])
def test_index_rule_matches_reference(raw, dtype, entry):
    """One raw index through K1, K2, K3 and K4: each reads (or scatters
    to) the entry the reference does, and NaN (or nothing) where the
    reference's index is invalid."""
    w = np.arange(1, 11, dtype=np.float32)
    offset = np.array([0, 1], np.int64)
    index = np.array([raw], dtype)
    value = np.ones(1, np.float32)
    y_ref = _ref_forward(offset, index, value, w)
    g_ref = _ref_grad(offset, index, value, w, np.ones(1, np.float32))
    y = csr.csr_spmv(_t(offset), _t(index), _t(value), _t(w)).numpy()
    g = csr.csr_spmv_t(_t(offset), _t(index), _t(value), torch.ones(1),
                       10).numpy()
    want_y = np.nan if entry is None else w[entry]
    want_g = np.zeros(10, np.float32)
    if entry is not None:
        want_g[entry] = 1.0
    np.testing.assert_array_equal(y_ref, [want_y])
    np.testing.assert_array_equal(y, [want_y])
    np.testing.assert_array_equal(g_ref, want_g)
    np.testing.assert_array_equal(g, want_g)
    # K3 over one padded row of one entry, K4 into one row of 10 columns
    sdot = csr.sdot_rows(_t(index.reshape(1, 1)), _t(value.reshape(1, 1)),
                         _t(w)).numpy()
    np.testing.assert_array_equal(
        sdot, np.asarray(ref_sdot_rows(index.reshape(1, 1),
                                       value.reshape(1, 1), w)))
    np.testing.assert_array_equal(sdot, [want_y])
    dense = csr.csr_to_dense(_t(offset), _t(index), _t(value), 1, 10).numpy()
    np.testing.assert_array_equal(
        dense, np.asarray(ref_csr_to_dense(offset, index, value, 1, 10)))
    np.testing.assert_array_equal(dense[0], want_g)


# ------------------------------------------------------------ K3, K4

def _ref_block(seed, rows, ncol, max_nnz, dup=False):
    """tests/test_parallel_ops.py's random_block (sorted distinct columns
    per row); with ``dup`` each row of 2+ nonzeros repeats a column."""
    rng = np.random.RandomState(seed)
    lens, idx, val = [], [], []
    for _ in range(rows):
        nnz = rng.randint(0, max_nnz)
        cols = np.sort(rng.choice(ncol, nnz, replace=False))
        if dup and nnz >= 2:
            cols[-1] = cols[0]
        lens.append(nnz)
        idx.append(cols)
        val.append(rng.rand(nnz).astype(np.float32))
    offset = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (offset, np.concatenate(idx).astype(np.uint32),
            np.concatenate(val).astype(np.float32))


K34_CASES = {
    "dense_7x9": dict(seed=0, rows=7, ncol=9, max_nnz=8),
    "sdot_12x50": dict(seed=1, rows=12, ncol=50, max_nnz=8),
    "duplicates": dict(seed=2, rows=20, ncol=9, max_nnz=8, dup=True),
    "wide": dict(seed=3, rows=30, ncol=137, max_nnz=100),
}


def _pad_tail(offset, index, value, rows=5, nnz=13):
    """The padding layer's tail: empty rows (offset repeats) and
    zero-valued nonzeros with index 0 past offset[-1]."""
    offset = np.concatenate([offset, np.full(rows, offset[-1])])
    return (offset, np.concatenate([index, np.zeros(nnz, index.dtype)]),
            np.concatenate([value, np.zeros(nnz, np.float32)]))


@pytest.mark.parametrize("tail", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("case", sorted(K34_CASES))
def test_csr_to_dense_plain_matches_jax(case, tail):
    offset, index, value = _ref_block(**K34_CASES[case])
    if tail:
        offset, index, value = _pad_tail(offset, index, value)
    rows, cols = len(offset) - 1, K34_CASES[case]["ncol"]
    want = np.asarray(ref_csr_to_dense(offset, index, value, rows, cols))
    got = csr.csr_to_dense(_t(offset), _t(index), _t(value), rows, cols)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, cols)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cols,route", [
    (137, "tile"),       # the ranking batch: 137 weights
    (9, "tile"),
    (8192, "global"),    # a wide matrix: 8 rows of it pass 227 KB
    (SM90_K2_SHARED // (4 * csr.K4_TILE_ROWS), "tile"),  # the boundary
    (SM90_K2_SHARED // (4 * csr.K4_TILE_ROWS) + 1, "global"),
    (0, "global"),       # no column to build
])
def test_csr_to_dense_route(cols, route):
    """K4 builds its rows in shared memory (the tile route) where
    K4_TILE_ROWS rows of the matrix fit a block's opt-in shared memory on
    sm_90 (the tile kernel has no static shared memory), and adds into a
    zeroed matrix in device memory (the global route) past it."""
    assert csr.csr_to_dense_route(cols, SM90_K2_SHARED) == route
    assert csr.K4_TILE_ROWS % 4 == 0  # each block's run on 16 bytes


@pytest.mark.parametrize("k", [None, 3], ids=["all", "cut_to_3"])
@pytest.mark.parametrize("case", sorted(K34_CASES))
def test_sdot_rows_plain_matches_jax(case, k):
    offset, index, value = _ref_block(**K34_CASES[case])
    ncol = K34_CASES[case]["ncol"]
    pi, pv, _ = csr.csr_to_padded_rows(offset, index, value, k)
    w = np.random.RandomState(5).randn(ncol).astype(np.float32)
    want = np.asarray(ref_sdot_rows(pi, pv, w))
    got = csr.sdot_rows(_t(pi), _t(pv), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if k is None:  # every nonzero kept: K3 equals K1 on the same rows
        np.testing.assert_allclose(
            got, csr.csr_spmv(_t(offset), _t(index), _t(value),
                              _t(w)).numpy(), rtol=RTOL, atol=ATOL)


def test_sdot_rows_invalid_index_gives_nan_row():
    pi = np.array([[0, 1], [2, 10], [-1, 3]], np.int32)
    pv = np.array([[1, 1], [1, 0], [1, 1]], np.float32)  # value 0 too
    w = np.arange(1, 11, dtype=np.float32)
    got = csr.sdot_rows(_t(pi), _t(pv), _t(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_sdot_rows(pi, pv, w)))
    np.testing.assert_array_equal(np.isnan(got), [False, True, False])
    assert got[2] == 14.0  # -1 reads w[9]


PADDED_ROWS_CASES = {
    "plain": (dict(seed=0, rows=12, ncol=50, max_nnz=8), None, True),
    "cut": (dict(seed=1, rows=12, ncol=50, max_nnz=8), 2, True),
    "wider": (dict(seed=2, rows=6, ncol=9, max_nnz=8), 11, True),
    "no_values": (dict(seed=3, rows=9, ncol=20, max_nnz=6), None, False),
    "empty": (dict(seed=4, rows=0, ncol=5, max_nnz=3), None, True),
}


@pytest.mark.parametrize("index_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("case", sorted(PADDED_ROWS_CASES))
def test_csr_to_padded_rows_is_byte_identical(case, index_dtype):
    kw, k, with_values = PADDED_ROWS_CASES[case]
    offset, index, value = (_ref_block(**kw) if kw["rows"] else
                            (np.zeros(1, np.int64), np.zeros(0, np.uint32),
                             np.zeros(0, np.float32)))
    index = index.astype(index_dtype)
    if index.size:  # raw indices the int32 cast wraps
        index[0] = 2**32 - 1
        if index_dtype is np.uint64:
            index[-1] = 2**32 + 3
    value = value if with_values else None
    want = ref_csr_to_padded_rows(offset, index, value, k)
    got = csr.csr_to_padded_rows(offset, index, value, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_k3_k4_wrappers_check_their_inputs():
    off = torch.tensor([0, 2], dtype=torch.int64)
    idx = torch.tensor([0, 1], dtype=torch.uint32)
    val = torch.ones(2)
    with pytest.raises(DMLCError, match="2-D"):
        csr.sdot_rows(idx, val, torch.ones(4))
    with pytest.raises(DMLCError, match="index dtype"):
        csr.sdot_rows(idx.reshape(1, 2).to(torch.int64), val.reshape(1, 2),
                      torch.ones(4))
    with pytest.raises(DMLCError, match="w must"):
        csr.sdot_rows(idx.reshape(1, 2), val.reshape(1, 2),
                      torch.ones(4, dtype=torch.float64))
    with pytest.raises(DMLCError, match="num_rows"):
        csr.csr_to_dense(off, idx, val, 2, 4)
    with pytest.raises(DMLCError, match="offset"):
        csr.csr_to_dense(off.to(torch.int32), idx, val, 1, 4)
    meta = torch.device("meta")
    with pytest.raises(DMLCError):
        csr.sdot_rows(idx.reshape(1, 2).to(meta), val.reshape(1, 2).to(meta),
                      torch.ones(4, device=meta))
    with pytest.raises(DMLCError):
        csr.csr_to_dense(off.to(meta), idx.to(meta), val.to(meta), 1, 4)


def test_k3_k4_cpu_calls_do_not_count_as_launches():
    before = (csr.sdot_rows.launches, csr.csr_to_dense.launches)
    off = torch.tensor([0, 2], dtype=torch.int64)
    idx = torch.tensor([0, 3], dtype=torch.uint32)
    csr.sdot_rows(idx.reshape(1, 2), torch.ones(1, 2), torch.ones(4))
    csr.csr_to_dense(off, idx, torch.ones(2), 1, 4)
    assert (csr.sdot_rows.launches, csr.csr_to_dense.launches) == before
