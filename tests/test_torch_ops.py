"""The CSR SpMV pair (K1 forward, K2 weight gradient) against JAX.

On the CPU the wrappers run their plain PyTorch versions; these are held
to ``dmlc_tpu.ops.csr.segment_spmv`` and to ``jax.grad`` of it in w, on
inputs made with numpy from a seed. Tolerance rtol=1e-5, atol=1e-6:
both sides sum each row in fp32, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops.csr import csr_row_ids as ref_row_ids
from dmlc_tpu.ops.csr import segment_spmv as ref_segment_spmv
from dmlc_tpu_torch.ops import csr
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6


def _csr(seed, rows=64, features=500, max_nnz=12, pad_rows=0, pad_nnz=0,
         empty=(), out_of_range=(), index_dtype=np.uint32):
    """A padded CSR batch: ``pad_rows`` empty tail rows, ``pad_nnz``
    zero-valued tail nonzeros, rows in ``empty`` emptied, and an index
    past the features in each row of ``out_of_range``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_nnz + 1, rows)
    lens[list(empty)] = 0
    if pad_rows:
        lens[rows - pad_rows:] = 0
    offset = np.zeros(rows + 1, np.int64)
    offset[1:] = np.cumsum(lens)
    nnz = int(offset[-1])
    index = np.zeros(nnz + pad_nnz, index_dtype)
    index[:nnz] = rng.randint(0, features, nnz)
    value = np.zeros(nnz + pad_nnz, np.float32)
    value[:nnz] = rng.rand(nnz)
    for r in out_of_range:
        index[offset[r]] = features + 7
    w = rng.randn(features).astype(np.float32)
    g = rng.randn(rows).astype(np.float32)
    return offset, index, value, w, g


CASES = {
    "plain": dict(seed=0),
    "empty_rows": dict(seed=1, empty=(0, 5, 6, 63)),
    "padded_tail": dict(seed=2, pad_rows=9, pad_nnz=40),
    "out_of_range": dict(seed=3, out_of_range=(4, 17), pad_nnz=5),
    "u64_index": dict(seed=4, index_dtype=np.uint64, pad_rows=3, pad_nnz=8),
    "long_rows": dict(seed=5, rows=16, max_nnz=200),
    "last_feature": dict(seed=6, features=3),
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


@pytest.mark.parametrize("case", ["plain", "padded_tail", "out_of_range"])
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
