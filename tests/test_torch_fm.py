"""FM and FFM of the port (kernels K5 and K6, their plain versions and the
models) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions. These are held
to the pair terms of ``dmlc_tpu.models.fm._fm_margins`` and
``_ffm_margins`` (with w = 0 and b = 0, so the margin is the pair term)
and to ``jax.vjp`` of them in V, on inputs made with numpy from a seed;
the models' ``train_step`` to the reference's from the same converted
parameters. Tolerance rtol=1e-5, atol=1e-6: both sides compute in fp32
on the CPU, with the segment sums in different orders. For the pair term
itself the rtol applies to the sum of its terms' magnitudes, not to the
result: the reference computes the FFM pair as an ordered-pair total
less a diagonal, which cancel, and the rounding error of a sum scales
with its terms. NaN must sit at the same places on both sides. The index
rule (ROADMAP C6: low 32 bits, signed, negative counted from the end) and
the field rule (low 32 bits, signed, then clipped) are held to the
reference at u32 2³²−1 and 2³¹, u64 2³²+3, int32 −1 and a field of 2³¹.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.rowblock import RowBlock as RefRowBlock
from dmlc_tpu.models.fm import SparseFFMModel as RefFFM
from dmlc_tpu.models.fm import SparseFMModel as RefFM
from dmlc_tpu.models.fm import _ffm_margins, _fm_margins
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.models import SparseFFMModel, SparseFMModel
from dmlc_tpu_torch.ops import fm
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6


def _csr(seed, rows=48, features=200, fields=5, K=4, ffm=False, max_nnz=10,
         pad_rows=0, pad_nnz=0, empty=(), out_of_range=(), bad_field=(),
         raw=(), raw_field=(), tail_raw=(), index_dtype=np.uint32,
         lengths=None):
    """A padded CSR batch with a field column, V and a cotangent g:
    ``pad_rows`` empty tail rows, ``pad_nnz`` zero-valued tail nonzeros,
    rows in ``empty`` emptied, an index past the features in each row of
    ``out_of_range``, a field past the fields (and one below 0) in each
    row of ``bad_field``, and for each (row, v) of ``raw`` (``raw_field``)
    the raw index (field) v as the row's first, and for each (k, v) of
    ``tail_raw`` the raw index v at the k-th tail nonzero. Rows hold up to
    ``max_nnz`` nonzeros over ``fields`` fields, so several nonzeros of a
    row share a field. ``lengths``: the rows' nonzeros, in place of
    ``rows`` drawn ones."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, max_nnz + 1, rows)
    if lengths is not None:
        rows, lens = len(lengths), np.array(lengths)
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
    field = np.zeros(nnz + pad_nnz, np.int64)
    field[:nnz] = rng.randint(0, fields, nnz)
    for r in out_of_range:
        index[offset[r]] = features + 7
    for r in bad_field:
        field[offset[r]] = fields + 3
        field[offset[r] + 1] = -2
    for r, v in raw:
        index[offset[r]] = v
    for r, v in raw_field:
        field[offset[r]] = v
    for k, v in tail_raw:
        index[nnz + k] = v
    shape = (features, fields, K) if ffm else (features, K)
    V = (0.3 * rng.randn(*shape)).astype(np.float32)
    g = rng.randn(rows).astype(np.float32)
    return dict(offset=offset, index=index, value=value, field=field, V=V,
                g=g)


# The row lengths the kernels are held at here and on the card
# (chip_smoke.py): about 16, 32 and 64, the ranking path's 136, and 1000.
ROW_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 136, 1000)

CASES = {
    "plain": dict(seed=0),
    "empty_rows": dict(seed=1, empty=(0, 5, 6, 47)),
    "padded_tail": dict(seed=2, pad_rows=9, pad_nnz=40),
    "out_of_range": dict(seed=3, out_of_range=(4, 17), pad_nnz=5),
    "bad_field": dict(seed=4, bad_field=(2, 30)),
    "u64_index": dict(seed=5, index_dtype=np.uint64, pad_rows=3, pad_nnz=8),
    "long_rows": dict(seed=6, rows=12, max_nnz=150),
    "last_feature": dict(seed=7, features=3),
    "factors_3": dict(seed=8, K=3),
    "factors_40": dict(seed=9, K=40, rows=16),
    # 12 factors: three float4 a nonzero on the card's vector route
    "factors_12": dict(seed=24, K=12, out_of_range=(5,), pad_nnz=4),
    "one_field": dict(seed=10, fields=1),
    # the index rule (C6): u32 2^32-1 reads V[F-1], 2^31 is invalid
    "c6_u32": dict(seed=17, raw=((3, 2**32 - 1), (9, 2**31),
                                 (12, 2**32 - 5))),
    # u64: 2^32+3 reads V[3], 2^32-2 V[F-2], 2^40+2^31 is invalid
    "c6_u64": dict(seed=18, index_dtype=np.uint64, pad_nnz=4,
                   raw=((3, 2**32 + 3), (9, 2**32 - 2), (20, 2**40 + 2**31))),
    # int32: -1 reads V[F-1], -F-1 is invalid
    "c6_int32": dict(seed=19, index_dtype=np.int32,
                     raw=((3, -1), (9, -201))),
    # the field rule: 2^31 wraps negative and clips to field 0, 2^32+2
    # reads field 2, 2^31-1 clips to the last field
    "c6_field": dict(seed=20, raw_field=((2, 2**31), (5, 2**32 + 2),
                                         (8, 2**31 - 1), (11, -2**31))),
    # an invalid index (2^31) in the padded tail, beside tail nonzeros of
    # index 0: the tail belongs to no row, so it adds nothing to gV (C7)
    "c7_tail": dict(seed=21, pad_rows=2, pad_nnz=3, tail_raw=((1, 2**31),)),
    # rows about K5 forward's window on the card (48 nonzeros, 16 lanes a
    # row, 8 nonzeros a step at K = 4) and past it, at 8 factors (the FM
    # path's), an invalid index in a long row and a padded tail
    "row_lengths": dict(seed=25, K=8, lengths=ROW_LENGTHS, out_of_range=(11,),
                        pad_nnz=6),
}


def _ref_index(raw, n):
    """The reference's reading of raw indices into a table of n: low 32
    bits, signed, negative counted from the end (numpy, independent of
    the port); -1 where invalid."""
    j = (np.asarray(raw).astype(np.uint64) & 0xFFFFFFFF).astype(np.int64)
    j = np.where(j >= 2**31, j - 2**32, j)
    j = np.where(j < 0, j + n, j)
    return np.where((j >= 0) & (j < n), j, -1)


def _ref_field(raw, nf):
    j = (np.asarray(raw).astype(np.uint64) & 0xFFFFFFFF).astype(np.int64)
    return np.clip(np.where(j >= 2**31, j - 2**32, j), 0, nf - 1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_pair(c, ffm):
    """The reference's pair term as a function of V (w = 0, b = 0)."""
    w = jnp.zeros(c["V"].shape[0], jnp.float32)
    rows = len(c["offset"]) - 1
    if ffm:
        return lambda V: _ffm_margins(w, 0.0, V, c["offset"], c["index"],
                                      c["value"], c["field"], num_rows=rows,
                                      num_fields=c["V"].shape[1])
    return lambda V: _fm_margins(w, 0.0, V, c["offset"], c["index"],
                                 c["value"], num_rows=rows)


def _port_pair(c, V, ffm):
    if ffm:
        return fm.ffm_pair(_t(c["offset"]), _t(c["index"]), _t(c["value"]),
                           _t(c["field"]), V)
    return fm.fm_pair(_t(c["offset"]), _t(c["index"]), _t(c["value"]), V)


def _sum_abs_terms(c, ffm):
    """Per row, the magnitudes of the terms the reference sums: its
    ordered-pair total (s·s, or ⟨S[a,b],S[b,a]⟩) and its diagonal, each
    halved. With |x| and |V| the pair is ½ (total − diagonal), so this is
    that pair plus the diagonal."""
    a = dict(c, value=np.abs(c["value"]), V=np.abs(c["V"]))
    pair = _port_pair(a, _t(a["V"]), ffm).numpy().astype(np.float64)
    rows = np.repeat(np.arange(len(c["offset"]) - 1), np.diff(c["offset"]))
    k = np.arange(len(rows))
    idx = np.maximum(_ref_index(c["index"][k], len(c["V"])), 0)
    v = a["V"][idx]
    if ffm:
        v = v[k, _ref_field(c["field"][k], c["V"].shape[1])]
    vx = (a["value"][k, None] * v).astype(np.float64)
    diag = np.zeros(len(pair))
    np.add.at(diag, rows, (vx * vx).sum(-1))
    return pair + diag


# every case for FM and FFM, but the field rule's for FFM only (FM reads
# no field)
PAIR_CASES = [pytest.param(case, ffm, id=f"{case}-{'ffm' if ffm else 'fm'}")
              for case in sorted(CASES) for ffm in (False, True)
              if ffm or case != "c6_field"]


@pytest.mark.parametrize("case,ffm", PAIR_CASES)
def test_pair_plain_matches_jax(case, ffm):
    c = _csr(ffm=ffm, **CASES[case])
    want = np.asarray(_ref_pair(c, ffm)(jnp.asarray(c["V"])))
    got = _port_pair(c, _t(c["V"]), ffm).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isnan(want) | (np.abs(got - want)
                           <= ATOL + RTOL * _sum_abs_terms(c, ffm))
    assert ok.all(), np.abs(got - want)[~ok]


@pytest.mark.parametrize("case,ffm", PAIR_CASES)
def test_pair_backward_matches_jax_grad(case, ffm):
    """The autograd pair (the plain backward on the CPU) against the
    cotangent g pulled back through the reference in V."""
    c = _csr(ffm=ffm, **CASES[case])
    _, pullback = jax.vjp(_ref_pair(c, ffm), jnp.asarray(c["V"]))
    want = np.asarray(pullback(jnp.asarray(c["g"]))[0])
    V = _t(c["V"]).requires_grad_()
    _port_pair(c, V, ffm).backward(_t(c["g"]))
    got = V.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def _brute_force_ffm(c):
    """The FFM pair term by its definition, Σ_{i<j} <v_{i,f_j}, v_{j,f_i}>
    x_i x_j, row by row in float64 (fields read as the model does)."""
    V = c["V"].astype(np.float64)
    nf = V.shape[1]
    out = []
    for r in range(len(c["offset"]) - 1):
        s, e = int(c["offset"][r]), int(c["offset"][r + 1])
        idx = c["index"][s:e].astype(np.int64)
        val = c["value"][s:e].astype(np.float64)
        fld = _ref_field(c["field"][s:e], nf)
        m = 0.0
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                m += float(np.dot(V[idx[a], fld[b]], V[idx[b], fld[a]])
                           * val[a] * val[b])
        out.append(m)
    return np.array(out)


# FFM shapes whose S and D pass a block's shared memory on sm_90 (the
# kernels' global route): a few rows each, an out-of-range index in row 2
# and a clipped field in row 3
WIDE_FFM = {"120x4": dict(fields=120, K=4, max_nnz=60),
            "39x40": dict(fields=39, K=40, max_nnz=39),
            "300x1": dict(fields=300, K=1, max_nnz=40)}


@pytest.mark.parametrize("shape", sorted(WIDE_FFM))
def test_wide_ffm_pair_and_gradient_match_jax(shape):
    c = _csr(seed=22, rows=6, features=50, ffm=True, out_of_range=(2,),
             bad_field=(3,), **WIDE_FFM[shape])
    want = np.asarray(_ref_pair(c, True)(jnp.asarray(c["V"])))
    V = _t(c["V"]).requires_grad_()
    got = _port_pair(c, V, True)
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    assert np.isnan(want).sum() == 1
    ok = np.isnan(want) | (np.abs(got.detach().numpy() - want)
                           <= ATOL + RTOL * _sum_abs_terms(c, True))
    assert ok.all()
    _, pullback = jax.vjp(_ref_pair(c, True), jnp.asarray(c["V"]))
    want_g = np.asarray(pullback(jnp.asarray(c["g"]))[0])
    got.backward(_t(c["g"]))
    np.testing.assert_allclose(V.grad.numpy(), want_g, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.isnan(V.grad.numpy()),
                                  np.isnan(want_g))


# sm_90's opt-in shared memory a block (232,448 bytes) less K6's static
# staging (1,056 bytes)
SM90_K6_SHARED = 232448 - 1056


@pytest.mark.parametrize("fields,K,route", [(39, 4, "shared"),
                                            (39, 37, "shared"),
                                            (39, 40, "global"),
                                            (120, 4, "global"),
                                            (300, 1, "global")])
def test_ffm_route_at_sm90_optin(fields, K, route):
    """S and D of 39 fields of 4 factors (24,960 bytes) stay in shared
    memory; 39 × 40 (249,600), 120 × 4 (232,320) and 300 × 1 (361,200)
    take the global route instead of raising."""
    assert fm.ffm_route(fields, K, SM90_K6_SHARED) == route
    assert (fm.ffm_shared_bytes(fields, K) <= SM90_K6_SHARED) == (
        route == "shared")


def test_ffm_static_shared_bytes_is_the_kernels():
    """ops/fm.py subtracts the K6 kernels' static shared memory from the
    card's opt-in size by a constant that csrc/fm.cu asserts, and it is
    the 1,056 bytes SM90_K6_SHARED takes off."""
    src = os.path.join(os.path.dirname(fm.__file__), "..", "csrc", "fm.cu")
    with open(src) as f:
        asserted = re.search(r"static_assert\(kStaticSharedBytes == (\d+)",
                             f.read())
    assert asserted is not None
    assert int(asserted.group(1)) == fm.FFM_STATIC_SHARED_BYTES == 1056


@pytest.mark.parametrize("K,aligned,route", [(8, True, "vector"),
                                              (40, True, "vector"),
                                              (4, True, "vector"),
                                              (3, True, "scalar"),
                                              (6, True, "scalar"),
                                              (8, False, "scalar")])
def test_fm_bwd_route(K, aligned, route):
    """K5 backward reads and adds four factors at once only where K is a
    multiple of 4 and V, s and gV start on 16 bytes (the route it shares
    with the forward)."""
    assert fm.fm_route(K, aligned) == route


@pytest.mark.parametrize("shift,route", [(0, "vector"), (1, "scalar"),
                                         (2, "scalar"), (3, "scalar"),
                                         (4, "vector")])
def test_fm_route_reads_the_alignment_of_a_view(shift, route):
    """At the FM path's 8 factors, K5 takes its vector route forward and
    backward only where its tensors start on 16 bytes: V viewed ``shift``
    floats into its allocation does at 0 and 4 floats, not at 1-3."""
    base = torch.zeros(200 * 8 + 4)
    V = base[shift:shift + 200 * 8].view(200, 8)
    s = torch.zeros(48, 8)
    assert fm.fm_route(8, fm.starts_aligned(V, s)) == route
    assert fm.fm_route(6, fm.starts_aligned(V, s)) == "scalar"


@pytest.mark.parametrize("case", ["plain", "empty_rows", "bad_field",
                                  "long_rows", "one_field", "c6_field"])
def test_ffm_pair_matches_pairwise_definition(case):
    c = _csr(ffm=True, **CASES[case])
    got = _port_pair(c, _t(c["V"]), True).numpy()
    np.testing.assert_allclose(got, _brute_force_ffm(c), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_out_of_range_index_gives_nan_row(ffm):
    """The row is NaN, the others are not; the gradient is NaN exactly
    where the row's NaN factors reach (FM: every in-range feature of the
    row; FFM: those features' factors for the bad nonzero's field), and
    the out-of-range nonzero adds nothing."""
    c = _csr(ffm=ffm, seed=11, rows=8, out_of_range=(2,))
    V = _t(c["V"]).requires_grad_()
    pair = _port_pair(c, V, ffm)
    pair.backward(_t(c["g"]))
    assert np.isnan(pair[2].item())
    assert np.isfinite(np.delete(pair.detach().numpy(), 2)).all()
    s, e = c["offset"][2], c["offset"][3]
    others = c["index"][s + 1:e].astype(np.int64)
    nan_at = np.isnan(V.grad.numpy())
    want = np.zeros_like(nan_at)
    if ffm:
        want[others, c["field"][s]] = True
    else:
        want[others] = True
    np.testing.assert_array_equal(nan_at, want)


@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_one_nonzero_row_has_pair_exactly_zero(ffm):
    """A row of one nonzero pairs it with nothing: its pair is exactly 0,
    not a rounding residue, so the loss's subgradient at a zero margin
    (ROADMAP C4) is the same in the plain versions and the kernels."""
    c = _csr(ffm=ffm, seed=16, rows=64)
    c["offset"] = np.arange(65, dtype=np.int64)  # every row: one nonzero
    pair = _port_pair(c, _t(c["V"]), ffm).numpy()
    assert (pair == 0.0).all()


def test_ffm_field_is_clipped():
    """A field past the fields reads as the last field, one below 0 as
    field 0 (the reference's jnp.clip)."""
    c = _csr(ffm=True, seed=12, bad_field=(1, 7))
    clipped = dict(c, field=np.clip(c["field"], 0, c["V"].shape[1] - 1))
    np.testing.assert_array_equal(
        _port_pair(c, _t(c["V"]), True).numpy(),
        _port_pair(clipped, _t(c["V"]), True).numpy())


def test_fm_forward_returns_s():
    c = _csr(seed=13)
    _, s = fm.fm_pair_fwd(_t(c["offset"]), _t(c["index"]), _t(c["value"]),
                          _t(c["V"]))
    rows = np.repeat(np.arange(len(c["offset"]) - 1), np.diff(c["offset"]))
    want = np.zeros(s.shape, np.float64)
    np.add.at(want, rows, c["value"][:len(rows), None]
              * c["V"][c["index"][:len(rows)].astype(np.int64)])
    np.testing.assert_allclose(s.numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ wrappers

def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    off = torch.zeros(3, dtype=torch.int64, device=meta)
    idx = torch.zeros(4, dtype=torch.uint32, device=meta)
    val = torch.zeros(4, device=meta)
    fld = torch.zeros(4, dtype=torch.int64, device=meta)
    g = torch.zeros(2, device=meta)
    V2, V3 = torch.zeros(8, 4, device=meta), torch.zeros(8, 3, 4, device=meta)
    for call in (lambda: fm.fm_pair_fwd(off, idx, val, V2),
                 lambda: fm.fm_pair_bwd(off, idx, val, V2,
                                        torch.zeros(2, 4, device=meta), g),
                 lambda: fm.ffm_pair_fwd(off, idx, val, fld, V3),
                 lambda: fm.ffm_pair_bwd(off, idx, val, fld, V3, g)):
        with pytest.raises(DMLCError):
            call()


def test_wrappers_check_shapes_and_dtypes():
    c = _csr(seed=14, rows=4, ffm=True)
    off, idx, val = _t(c["offset"]), _t(c["index"]), _t(c["value"])
    fld, V3 = _t(c["field"]), _t(c["V"])
    V2 = V3[:, 0].contiguous()
    with pytest.raises(DMLCError, match="2-D"):
        fm.fm_pair_fwd(off, idx, val, V3)
    with pytest.raises(DMLCError, match="3-D"):
        fm.ffm_pair_fwd(off, idx, val, fld, V2)
    with pytest.raises(DMLCError, match="field"):
        fm.ffm_pair_fwd(off, idx, val, fld.to(torch.int32), V3)
    with pytest.raises(DMLCError, match="index dtype"):
        fm.fm_pair_fwd(off, idx.to(torch.int64), val, V2)
    with pytest.raises(DMLCError, match="g must"):
        fm.ffm_pair_bwd(off, idx, val, fld, V3, torch.zeros(5))
    with pytest.raises(DMLCError, match="s must"):
        fm.fm_pair_bwd(off, idx, val, V2, torch.zeros(4, 7), torch.zeros(4))
    with pytest.raises(DMLCError, match="factors"):
        fm.fm_pair_fwd(off, idx, val, torch.zeros(V2.shape[0], 0))


def test_cpu_calls_do_not_count_as_launches():
    kernels = (fm.fm_pair_fwd, fm.fm_pair_bwd, fm.ffm_pair_fwd,
               fm.ffm_pair_bwd)
    before = [k.launches for k in kernels]
    for ffm in (False, True):
        c = _csr(seed=15, rows=6, ffm=ffm)
        V = _t(c["V"]).requires_grad_()
        _port_pair(c, V, ffm).sum().backward()
    assert [k.launches for k in kernels] == before


# ------------------------------------------------------------ models

FEATURES, FIELDS = 120, 4


def _batch(seed, rows=100, row_bucket=128, max_nnz=9, zero_weight_rows=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, max_nnz + 1, rows)
    offset = np.zeros(rows + 1, np.int64)
    offset[1:] = np.cumsum(lens)
    nnz = int(offset[-1])
    block = RefRowBlock(
        offset=offset,
        label=np.where(rng.rand(rows) > 0.5, 1.0, -1.0).astype(np.float32),
        index=rng.randint(0, FEATURES, nnz).astype(np.uint32),
        value=rng.rand(nnz).astype(np.float32),
        weight=np.where(np.arange(rows) < zero_weight_rows, 0.0,
                        rng.rand(rows) + 0.5).astype(np.float32),
        field=rng.randint(0, FIELDS, nnz).astype(np.int64))
    return dict(ref_pad_single(block, row_bucket, nnz + 11))


def _models(ffm, l2, lr=0.5, seed=3):
    if ffm:
        ref = RefFFM(FEATURES, FIELDS, num_factors=4, l2=l2,
                     learning_rate=lr, init_scale=0.3)
        port = SparseFFMModel(FEATURES, FIELDS, num_factors=4, l2=l2,
                              learning_rate=lr, device="cpu")
    else:
        ref = RefFM(FEATURES, num_factors=8, l2=l2, learning_rate=lr,
                    init_scale=0.3)
        port = SparseFMModel(FEATURES, num_factors=8, l2=l2,
                             learning_rate=lr, device="cpu")
    params = {k: np.asarray(v) for k, v in ref.init_params(seed).items()}
    params["w"] = (0.2 * np.random.RandomState(seed).randn(FEATURES)
                   ).astype(np.float32)
    port.load_state_dict(params_from_jax(params, device="cpu"), strict=True)
    return ref, port, params


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_three_train_steps_match_jax(ffm, l2):
    ref, port, params = _models(ffm, l2)
    for step in range(3):
        batch = _batch(20 + step, zero_weight_rows=10 * step)
        params, want = ref.train_step(params, batch)
        got = port.train_step(_tensors(batch))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=ATOL)
    got = params_to_numpy(port.state_dict())
    assert sorted(got) == ["V", "b", "w"]
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(params[k]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_forward_and_predict_proba_match_jax(ffm):
    ref, port, params = _models(ffm, 0.0)
    batch = _batch(30)
    np.testing.assert_allclose(port(_tensors(batch)).detach().numpy(),
                               np.asarray(ref.forward(params, batch)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        port.predict_proba(_tensors(batch)).detach().numpy(),
        np.asarray(ref.predict_proba(params, batch)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_params_round_trip_and_shape_check(ffm):
    _, port, params = _models(ffm, 0.0)
    back = params_to_numpy(port.state_dict())
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
        assert back[k].dtype == np.float32
    wrong = dict(params, V=params["V"][:, :-1])
    with pytest.raises(RuntimeError, match="V"):
        port.load_state_dict(params_from_jax(wrong, device="cpu"))


def test_ffm_validate_batch():
    model = SparseFFMModel(FEATURES, FIELDS, device="cpu")
    batch = _tensors(_batch(31))
    model.validate_batch(batch)
    model.validate_batch({"field": torch.zeros(0, dtype=torch.int64)})
    for bad in (FIELDS, -1):
        b = dict(batch, field=batch["field"].clone())
        b["field"][3] = bad
        with pytest.raises(DMLCError, match="num_fields"):
            model.validate_batch(b)


def test_ffm_needs_the_field_column():
    model = SparseFFMModel(FEATURES, FIELDS, device="cpu")
    batch = _tensors(_batch(32))
    del batch["field"]
    with pytest.raises(DMLCError, match="field"):
        model.loss(batch)


def test_init_is_seeded_and_scaled():
    g = torch.Generator().manual_seed(5)
    a = SparseFFMModel(2000, 3, num_factors=4, device="cpu", generator=g)
    b = SparseFFMModel(2000, 3, num_factors=4, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    assert a.V.shape == (2000, 3, 4) and a.V.device.type == "cpu"
    assert torch.equal(a.V, b.V)
    assert abs(a.V.std().item() - 0.05) < 0.005
    assert not a.w.any() and a.b.item() == 0.0
    fm_model = SparseFMModel(2000, device="cpu")
    assert fm_model.V.shape == (2000, 8)
    assert abs(fm_model.V.std().item() - 0.01) < 0.001
    assert torch.equal(fm_model.V,
                       SparseFMModel(2000, device="cpu").V)  # seed 0
