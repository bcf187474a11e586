"""The ranking path of the port (kernel K7's plain versions and
SparseRankingModel) against the JAX package.

On the CPU the K7 wrappers run their plain PyTorch versions. These are
held to ``dmlc_tpu.models.ranking._pair_sums`` and to ``jax.vjp`` of it in
the margins, on inputs made with numpy from a seed; the model's ``loss``,
``train_step`` and ``pairwise_accuracy`` to the reference's from the same
converted parameters, and the slice end to end (libsvm text with qid →
parser → padded batches → steps) to the reference's.

Tolerances, each with its reason. Both sides compute in fp32 on the CPU
and sum the n² pair terms in different orders, so the error of a sum
scales with the sum of its terms' magnitudes, not with the result:
- lsum and wsum: rtol 1e-5 (all their terms are >= 0, so their sum is the
  sum of the magnitudes);
- the gradient: |err| <= 1e-6 + 1e-5 · Σ_j |term| per row, the terms
  being s·pw·sp′ of the row's pairs in both directions, which cancel;
- losses and parameters after SGD steps: rtol 1e-5, atol 1e-6.
NaN must sit at the same places on both sides.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.parser import Parser as RefParser
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models.ranking import SparseRankingModel as RefModel
from dmlc_tpu.models.ranking import _pair_sums, _pair_weights
from dmlc_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_tpu_torch.data.padding import pad_single
from dmlc_tpu_torch.data.parser import Parser
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models import SparseRankingModel
from dmlc_tpu_torch.native import native_available
from dmlc_tpu_torch.ops import ranking
from dmlc_tpu_torch.parallel.device_iter import device_prefetch
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6


def _docs(seed, n=128, queries=8, pad=0, split_qid=False, nan_at=(),
          inf_at=(), zero_margins=False, tie_query=False, neg_inf_at=(),
          huge_at=(), nan_weight_at=(), weight_at=(), qids="sorted"):
    """n documents in contiguous queries (labels 0-4 with ties, weights
    in (0, 1]); the last ``pad`` made padding (qid -1, weight 0, label
    0); with ``split_qid`` query 1's id reused by the last query, so its
    rows are not contiguous; with ``tie_query`` every label of query 2
    equal (no pairs). ``huge_at`` = (i, j): margins 3e38 at i and -3e38
    at j, in different queries (each finite, their difference not);
    ``nan_weight_at`` rows weigh NaN (after the padding); ``weight_at``
    holds (row, weight) pairs; ``qids``: "sorted" (contiguous queries),
    "own" (every row its own query) or "interleaved" (row r in query r
    mod ``queries``)."""
    rng = np.random.RandomState(seed)
    qid = np.sort(rng.randint(0, queries, n)).astype(np.int64)
    label = rng.randint(0, 5, n).astype(np.float32)
    weight = (1.0 - rng.rand(n)).astype(np.float32)  # (0, 1]
    m = rng.randn(n).astype(np.float32)
    if qids == "own":
        qid = np.arange(n, dtype=np.int64)
    elif qids == "interleaved":
        qid = np.arange(n, dtype=np.int64) % queries
    if split_qid:
        qid[qid == queries - 1] = 1
    if tie_query:
        label[qid == 2] = 3.0
    if pad:
        qid[n - pad:] = -1
        weight[n - pad:] = 0.0
        label[n - pad:] = 0.0
    if zero_margins:
        m[:] = 0.0
    m[list(nan_at)] = np.nan
    m[list(inf_at)] = np.inf
    m[list(neg_inf_at)] = -np.inf
    if huge_at:
        i, j = huge_at
        assert qid[i] != qid[j]
        m[i], m[j] = 3e38, -3e38
    weight[list(nan_weight_at)] = np.nan
    for r, v in weight_at:
        weight[r] = v
    return dict(m=m, label=label, qid=qid, weight=weight)


CASES = {
    "plain": dict(seed=0),
    "n64": dict(seed=1, n=64, queries=3),
    "n256": dict(seed=2, n=256, queries=20),
    "padded_tail": dict(seed=3, pad=30),
    "split_qid": dict(seed=4, split_qid=True),
    "tie_query": dict(seed=5, tie_query=True),
    "zero_margins": dict(seed=6, zero_margins=True),
    "nan_margin": dict(seed=7, nan_at=(17,)),
    "inf_margin": dict(seed=8, inf_at=(40,)),
    "all_padded": dict(seed=9, n=64, pad=64),
    # the skip rule's edges: each unsafe batch falls back to every pair
    "neg_inf_margin": dict(seed=13, neg_inf_at=(25,)),
    "huge_margins": dict(seed=14, huge_at=(5, 120)),
    "nan_weight_padded": dict(seed=15, pad=20, nan_weight_at=(115,)),
    "big_weight": dict(seed=16, weight_at=((10, 2e19),)),  # 2e19² > 3.4e38
    # no tile can be skipped, or every pair is unweighted
    "one_query": dict(seed=17, queries=1),
    "own_queries": dict(seed=18, qids="own"),
    "interleaved": dict(seed=19, queries=7, qids="interleaved"),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_args(d):
    return _t(d["m"]), _t(d["label"]), _t(d["qid"]), _t(d["weight"])


def _ref_sums(d):
    return lambda m: _pair_sums(m, d["label"], d["qid"], d["weight"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_sums_plain_matches_jax(case):
    d = _docs(**CASES[case])
    want_l, want_w = (float(x) for x in _ref_sums(d)(jnp.asarray(d["m"])))
    got_l, got_w, table = ranking.pair_sums(*_port_args(d))
    assert table is None  # the CPU route writes no tile table
    got_l, got_w = float(got_l), float(got_w)
    for got, want in ((got_l, want_l), (got_w, want_w)):
        assert np.isnan(got) == np.isnan(want)
        if not np.isnan(want):
            assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    if case == "all_padded":
        assert got_l == 0.0 and got_w == 0.0


def _grad_scale(d, s):
    """Per row, the sum of the magnitudes of its gradient's terms
    |s|·pw·sp′ (both directions), in float64."""
    m = d["m"].astype(np.float64)
    pw = np.asarray(_pair_weights(jnp.asarray(d["label"]),
                                  jnp.asarray(d["qid"]),
                                  jnp.asarray(d["weight"])), np.float64)
    with np.errstate(all="ignore"):
        x = m[None, :] - m[:, None]
        ct = abs(s) * pw / (1.0 + np.exp(-x))
    return np.nan_to_num(ct.sum(0) + ct.sum(1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_sums_grad_plain_matches_jax_vjp(case):
    d = _docs(**CASES[case])
    s = 0.37
    _, pullback = jax.vjp(_ref_sums(d), jnp.asarray(d["m"]))
    want = np.asarray(pullback((jnp.float32(s), jnp.float32(0.0)))[0])
    got = ranking.pair_sums_grad(*_port_args(d),
                                 torch.tensor(s, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isnan(want) | (np.abs(got - want)
                           <= ATOL + RTOL * _grad_scale(d, s))
    assert ok.all(), np.abs(got - want)[~ok]
    if case == "nan_margin":
        assert np.isnan(got).all()  # every row pairs with the NaN one
    if case == "inf_margin":
        assert np.isnan(got).tolist() == [i == 40 for i in range(len(got))]


@pytest.mark.parametrize("case", ["plain", "nan_margin", "big_weight",
                                  "one_query"])
def test_pair_sums_grad_plain_matches_jax_vjp_at_inf_cotangent(case):
    """s = inf: the reference's s·pw is inf·0 = NaN for every unweighted
    pair, so NaN reaches each row that has one."""
    d = _docs(**CASES[case])
    _, pullback = jax.vjp(_ref_sums(d), jnp.asarray(d["m"]))
    want = np.asarray(pullback((jnp.float32(np.inf), jnp.float32(0.0)))[0])
    got = ranking.pair_sums_grad(*_port_args(d),
                                 torch.tensor(np.inf, dtype=torch.float32))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got.numpy()[~np.isnan(want)],
                                  want[~np.isnan(want)])


# ------------------------------------------------------------ the skip rule

def _sp32(x):
    """jax.nn.softplus in float32."""
    with np.errstate(all="ignore"):
        sp = np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))
    return np.where(np.isnan(x), x, sp).astype(np.float32)


def _sp_grad32(x):
    """Its derivative as jax's logaddexp jvp forms it, in float32."""
    sp = _sp32(x)
    with np.errstate(all="ignore"):
        return np.exp(np.where(x == np.inf, 0, x).astype(np.float32)
                      - np.where(sp == np.inf, 0, sp)).astype(np.float32)


def _tile_table(d, T):
    """The kernels' pre-pass (csrc/ranking.cu): the safe flag and each
    tile's valid-qid interval, (INT64_MAX, -1) where it has none."""
    m, w, q = d["m"], d["weight"], d["qid"]
    with np.errstate(all="ignore"):
        safe = bool(np.isfinite(m).all() and np.isfinite(w).all()
                    and np.isfinite(np.float32(m.max()) - np.float32(m.min()))
                    and np.isfinite(np.abs(w).max() * np.abs(w).max()))
    tiles = []
    for t0 in range(0, len(m), T):
        tq = q[t0:t0 + T]
        tq = tq[tq >= 0]
        tiles.append((int(tq.min()), int(tq.max())) if tq.size
                     else (np.iinfo(np.int64).max, -1))
    return safe, tiles


def _skip_model(d, s=None, T=16, R=8):
    """A numpy model of K7's skip rule: blocks of R rows visit only the
    tiles of T documents whose valid-qid interval meets theirs, rows only
    the tiles whose interval holds their qid, and pairs only where pw !=
    0, when the batch is safe (and s finite); every pair otherwise.
    Returns ((lsum, wsum) or g, the tiles visited, the tiles in all)."""
    m, label, q, w = d["m"], d["label"], d["qid"], d["weight"]
    n = len(m)
    safe, tiles = _tile_table(d, T)
    if s is not None:
        safe = safe and bool(np.isfinite(s))
        s = np.float32(s)
    row_l, row_w, g = np.zeros(n), np.zeros(n), np.zeros(n)
    visited = 0
    for r0 in range(0, n, R):
        rows = range(r0, min(n, r0 + R))
        valid = [int(q[i]) for i in rows if q[i] >= 0]
        blo, bhi = (min(valid), max(valid)) if valid else (2**63 - 1, -1)
        for t, (tlo, thi) in enumerate(tiles):
            if safe and (tlo > bhi or thi < blo):
                continue
            visited += 1
            j = np.arange(t * T, min(n, (t + 1) * T))
            for i in rows:
                if safe and not tlo <= q[i] <= thi:
                    continue
                with np.errstate(all="ignore"):
                    on = (q[i] >= 0) & (q[j] >= 0) & (q[j] == q[i])
                    pw_dn = (w[i] * w[j]) * (on & (label[i] > label[j]))
                    pw_up = (w[j] * w[i]) * (on & (label[j] > label[i]))
                    if s is None:
                        keep = pw_dn != 0 if safe else np.ones(j.size, bool)
                        row_l[i] += np.sum(_sp32(-(m[i] - m[j]))[keep]
                                           * pw_dn[keep], dtype=np.float64)
                        row_w[i] += np.sum(pw_dn[keep], dtype=np.float64)
                        continue
                    up = (s * pw_up) * _sp_grad32(-(m[j] - m[i]))
                    down = (s * pw_dn) * _sp_grad32(-(m[i] - m[j]))
                    if safe:
                        term = np.where(pw_up != 0, up,
                                        np.where(pw_dn != 0, -down, 0.0))
                    else:
                        term = up - down
                    g[i] += np.sum(term, dtype=np.float64)
    out = (row_l.sum(), row_w.sum()) if s is None else g
    return out, visited, -(-n // R) * len(tiles)


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_rule_model_matches_jax(case):
    """The skip rule, modelled in numpy, against the reference: lsum, wsum
    and the gradient (s = 0.37 and s = inf) with the NaN pattern exact."""
    d = _docs(**CASES[case])
    want = [float(x) for x in _ref_sums(d)(jnp.asarray(d["m"]))]
    got, _, _ = _skip_model(d)
    for a, b in zip(got, want):
        assert np.isnan(a) == np.isnan(b)
        if not np.isnan(b):
            assert a == pytest.approx(b, rel=RTOL, abs=ATOL)
    _, pullback = jax.vjp(_ref_sums(d), jnp.asarray(d["m"]))
    for s in (0.37, np.inf):
        want_g = np.asarray(pullback((jnp.float32(s), jnp.float32(0.0)))[0])
        got_g, _, _ = _skip_model(d, s)
        np.testing.assert_array_equal(np.isnan(got_g), np.isnan(want_g))
        ok = np.isnan(want_g) | (np.abs(got_g - want_g)
                                 <= ATOL + RTOL * _grad_scale(d, s))
        assert ok.all(), (s, np.abs(got_g - want_g)[~ok])


def test_skip_rule_skips_only_safe_batches():
    """Contiguous queries leave most tiles unvisited; an unsafe batch, one
    query over the batch and interleaved queries leave none; every row
    its own query visits only its own tile."""
    def share(case, s=None):
        _, visited, total = _skip_model(_docs(**CASES[case]), s)
        return visited / total
    assert share("plain") < 0.5 and share("plain", 0.37) < 0.5
    assert share("own_queries") == pytest.approx(1 / 8)
    for case in ("nan_margin", "inf_margin", "neg_inf_margin", "huge_margins",
                 "nan_weight_padded", "big_weight", "one_query",
                 "interleaved"):
        assert share(case) == 1.0, case
    assert share("plain", np.inf) == 1.0


@pytest.mark.parametrize("case", ["plain", "padded_tail", "nan_margin"])
def test_autograd_pairs_forward_with_backward(case):
    """pair_sums_autograd: the forward's sums, and a gradient in the
    margins only, that of lsum (wsum takes none)."""
    d = _docs(**CASES[case])
    m, label, qid, weight = _port_args(d)
    m = m.clone().requires_grad_()
    lsum, wsum = ranking.pair_sums_autograd(m, label, qid, weight)
    assert not wsum.requires_grad
    want_l, want_w = ranking.pair_sums_plain(m.detach(), label, qid, weight)
    assert torch.equal(wsum, want_w)
    assert torch.equal(lsum.detach(), want_l) or (
        torch.isnan(lsum) and torch.isnan(want_l))
    (2.5 * lsum + wsum).backward()
    want = ranking.pair_sums_grad_plain(m.detach(), label, qid, weight,
                                        torch.tensor(2.5))
    np.testing.assert_array_equal(m.grad.numpy(), want.numpy())


def test_softplus_is_jax_softplus():
    """Element by element, to 1e-6 relative; atol is the least normal
    float32, since XLA on the CPU flushes subnormal results (softplus(-100)
    = 3.9e-44) to 0 and torch does not."""
    x = np.array([-100.0, -30.0, -1.0, -1e-3, 0.0, 1e-3, 1.0, 19.0, 21.0,
                  30.0, 100.0, np.inf, -np.inf, np.nan], np.float32)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ranking._softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=tiny)
    want_g = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(x)))
    got_g = ranking._softplus_grad(_t(x)).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=tiny)


def test_pair_weights_plain_matches_jax():
    d = _docs(seed=10, pad=9, split_qid=True)
    want = np.asarray(_pair_weights(jnp.asarray(d["label"]),
                                    jnp.asarray(d["qid"]),
                                    jnp.asarray(d["weight"])))
    got = ranking.pair_weights_plain(_t(d["label"]), _t(d["qid"]),
                                     _t(d["weight"])).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ wrappers

def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    m = torch.zeros(4, device=meta)
    qid = torch.zeros(4, dtype=torch.int64, device=meta)
    with pytest.raises(DMLCError):
        ranking.pair_sums(m, m, qid, m)
    with pytest.raises(DMLCError):
        ranking.pair_sums_grad(m, m, qid, m, torch.zeros((), device=meta))


def test_wrappers_check_shapes_and_dtypes():
    m, label, qid, weight = _port_args(_docs(seed=11, n=16))
    with pytest.raises(DMLCError, match="qid"):
        ranking.pair_sums(m, label, qid.to(torch.int32), weight)
    with pytest.raises(DMLCError, match="label"):
        ranking.pair_sums(m, label[:-1], qid, weight)
    with pytest.raises(DMLCError, match="weight"):
        ranking.pair_sums(m, label, qid, weight.double())
    with pytest.raises(DMLCError, match="s must"):
        ranking.pair_sums_grad(m, label, qid, weight, torch.zeros(2))
    with pytest.raises(DMLCError, match="tile table"):
        ranking.pair_sums_grad(m, label, qid, weight, torch.tensor(1.0),
                               torch.zeros(ranking.table_size(16),
                                           dtype=torch.int64))


def test_tile_table_size_matches_the_kernels_tile():
    """The wrapper sizes the tile table by the tile that csrc/ranking.cu
    compiles in: the flag, the block count and two entries a tile."""
    src = (Path(ranking.__file__).parents[1] / "csrc" / "ranking.cu"
           ).read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", src).group(1))
    assert ranking._TILE == tile
    for n in (1, tile, tile + 1, 4096):
        assert ranking.table_size(n) == 2 + 2 * -(-n // tile)


def test_cpu_calls_do_not_count_as_launches():
    before = (ranking.pair_sums.launches, ranking.pair_sums_grad.launches)
    m, label, qid, weight = _port_args(_docs(seed=12, n=16))
    m.requires_grad_()
    ranking.pair_sums_autograd(m, label, qid, weight)[0].backward()
    assert (ranking.pair_sums.launches,
            ranking.pair_sums_grad.launches) == before


# ------------------------------------------------------------ model

FEATURES = 40


def _ranking_block(container_cls, seed, queries=12, docs=(1, 14)):
    """Contiguous queries of graded documents (labels 0-4 from a hidden
    linear scorer plus noise), each row 2-8 features."""
    rng = np.random.RandomState(seed)
    w_true = np.random.RandomState(5).randn(FEATURES)
    c = container_cls(np.uint32)
    for q in range(queries):
        for _ in range(rng.randint(docs[0], docs[1] + 1)):
            nnz = rng.randint(2, 9)
            idx = np.sort(rng.choice(FEATURES, nnz, replace=False))
            val = rng.rand(nnz).astype(np.float32)
            score = float((val * w_true[idx]).sum()) + 0.3 * rng.randn()
            c.push(float(np.digitize(score, [-0.5, 0.3, 1.0, 1.8])), idx, val,
                   qid=q, weight=float(0.5 + rng.rand()))
    return c.get_block()


def _batch(seed, row_bucket=128, **kw):
    block = _ranking_block(RefContainer, seed, **kw)
    return dict(ref_pad_single(block, row_bucket, row_bucket * 8,
                               want_qid=True))


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _models(l2, random_w, lr=0.5, seed=3):
    ref = RefModel(FEATURES, l2=l2, learning_rate=lr)
    port = SparseRankingModel(FEATURES, l2=l2, learning_rate=lr,
                              device="cpu")
    params = {k: np.asarray(v) for k, v in ref.init_params().items()}
    if random_w:
        params["w"] = (0.3 * np.random.RandomState(seed).randn(FEATURES)
                       ).astype(np.float32)
        params["b"] = np.float32(0.2)
    port.load_state_dict(params_from_jax(params, device="cpu"), strict=True)
    return ref, port, params


@pytest.mark.parametrize("random_w", [False, True], ids=["zero", "random"])
def test_loss_matches_jax(random_w):
    ref, port, params = _models(0.0, random_w)
    batch = _batch(20)
    want = float(ref.loss(params, batch))
    got = port.loss(_tensors(batch)).item()
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert got > 0


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("random_w", [False, True], ids=["zero", "random"])
def test_three_train_steps_match_jax(random_w, l2):
    ref, port, params = _models(l2, random_w)
    for step in range(3):
        batch = _batch(21 + step)
        params, want = ref.train_step(params, batch)
        got = port.train_step(_tensors(batch))
        assert float(got) == pytest.approx(float(want), rel=RTOL, abs=ATOL)
    got = params_to_numpy(port.state_dict())
    assert sorted(got) == ["b", "w"]
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(params[k]), rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(got["w"]).max() > 0


@pytest.mark.parametrize("random_w", [False, True], ids=["zero", "random"])
def test_pairwise_accuracy_matches_jax(random_w):
    ref, port, params = _models(0.0, random_w)
    batch = _batch(30)
    want = ref.pairwise_accuracy(params, batch)
    got = port.pairwise_accuracy(_tensors(batch))
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    if not random_w:
        assert got == 0.0  # every margin ties: no pair is ordered


def test_training_raises_pairwise_accuracy():
    port = SparseRankingModel(FEATURES, learning_rate=1.0, device="cpu")
    batch = _tensors(_batch(31, row_bucket=256, queries=24))
    acc0 = port.pairwise_accuracy(batch)
    for _ in range(40):
        loss = port.train_step(batch)
    acc1 = port.pairwise_accuracy(batch)
    assert np.isfinite(float(loss))
    assert acc1 > max(acc0, 0.75), (acc0, acc1)


def test_max_row_bucket_raises_before_any_work():
    port = SparseRankingModel(FEATURES, max_row_bucket=64, device="cpu")
    ref = RefModel(FEATURES, max_row_bucket=64)
    batch = _batch(32, row_bucket=128)
    with pytest.raises(DMLCError, match="max_row_bucket"):
        port.loss(_tensors(batch))
    with pytest.raises(Exception, match="max_row_bucket"):
        ref.loss(ref.init_params(), batch)
    port.loss(_tensors(_batch(32, row_bucket=64, queries=4, docs=(1, 8))))


def test_qid_less_batch_raises_named_error():
    port = SparseRankingModel(FEATURES, device="cpu")
    batch = _tensors(_batch(33))
    del batch["qid"]
    for call in (lambda: port.loss(batch), lambda: port.validate_batch(batch),
                 lambda: port.pairwise_accuracy(batch)):
        with pytest.raises(DMLCError, match="qid"):
            call()


def test_all_padded_batch_has_loss_zero():
    ref, port, params = _models(0.0, True)
    batch = _batch(34)
    batch["qid"] = np.full_like(batch["qid"], -1)
    batch["weight"] = np.zeros_like(batch["weight"])
    assert float(ref.loss(params, batch)) == 0.0
    t = _tensors(batch)
    assert port.loss(t).item() == 0.0
    port.train_step(t)  # a zero gradient: the weights stay as they were
    got = params_to_numpy(port.state_dict())
    np.testing.assert_array_equal(got["w"], params["w"])
    np.testing.assert_array_equal(got["b"], params["b"])
    assert np.isnan(port.pairwise_accuracy(t))


def test_params_round_trip():
    _, port, params = _models(0.0, True)
    back = params_to_numpy(port.state_dict())
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    assert port.w.device.type == "cpu" and port.max_row_bucket == 4096


# ------------------------------------------------------------ the slice

def _qid_lines(seed=0, queries=60):
    """libsvm text with qid: contiguous queries of 1-12 documents, graded
    labels 0-4, 3-10 features a row of FEATURES (1-based, as LETOR files
    write them)."""
    rng = np.random.RandomState(seed)
    w_true = np.random.RandomState(6).randn(FEATURES + 1)
    lines = []
    for q in range(queries):
        for _ in range(rng.randint(1, 13)):
            nnz = rng.randint(3, 11)
            idx = np.sort(rng.choice(np.arange(1, FEATURES + 1), nnz,
                                     replace=False))
            val = np.round(rng.rand(nnz), 4)
            score = float((val * w_true[idx]).sum()) + 0.3 * rng.randn()
            label = int(np.digitize(score, [-0.5, 0.3, 1.0, 1.8]))
            lines.append(f"{label} qid:{1000 + q} " + " ".join(
                f"{j}:{v:.4f}" for j, v in zip(idx, val)))
    return lines


@pytest.mark.parametrize("engine", ["python", "native"])
def test_slice_end_to_end(tmp_path, engine):
    """libsvm text with qid → the port's parser (native ``next_padded
    (want_qid=True)``, or the Python parser + ``pad_single``) →
    device_prefetch (CPU, staging) → SGD steps of SparseRankingModel,
    against the reference's parser → pad_single → train_step from the
    same zero weights; the native qid batches byte-identical to the
    reference's pad_single."""
    if engine == "native" and not native_available():
        pytest.fail("the port's native engine did not build")
    path = tmp_path / "rank.libsvm"
    path.write_text("\n".join(_qid_lines()) + "\n")
    rows, nb = 128, 128 * 10
    ref = RefModel(FEATURES + 1, learning_rate=1.0)
    params = {k: np.asarray(v) for k, v in ref.init_params().items()}
    c = RefContainer(np.uint32)
    for block in RefParser.create(str(path), format="libsvm",
                                  engine="python"):
        c.push_block(block)
    block = c.get_block()
    want, want_batches = [], []
    for s in range(0, block.size, rows):
        batch = dict(ref_pad_single(block.slice(s, min(s + rows,
                                                       block.size)),
                                    rows, nb, want_qid=True))
        want_batches.append(batch)
        params, loss = ref.train_step(params, batch)
        want.append(float(loss))

    parser = Parser.create(str(path), format="libsvm", engine=engine)
    if engine == "native":
        host = iter(lambda: parser.next_padded(rows, nnz_bucket=nb,
                                               want_qid=True), None)
    else:
        pc = RowBlockContainer(np.uint32)
        for b in parser:
            pc.push_block(b)
        pb = pc.get_block()
        host = (pad_single(pb.slice(s, min(s + rows, pb.size)), rows, nb,
                           want_qid=True)
                for s in range(0, pb.size, rows))
    port = SparseRankingModel(FEATURES + 1, learning_rate=1.0, device="cpu")
    got = []
    for batch, ref_batch in zip(device_prefetch(host, device="cpu",
                                                staging=True),
                                want_batches):
        assert sorted(batch) == sorted(ref_batch)
        for k in batch:
            a = batch[k].numpy()
            assert a.dtype == ref_batch[k].dtype, k
            assert a.tobytes() == np.asarray(ref_batch[k]).tobytes(), k
        port.validate_batch(batch)
        got.append(float(port.train_step(batch)))
    assert len(got) == len(want) >= 3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    new = params_to_numpy(port.state_dict())
    for k in ("w", "b"):
        np.testing.assert_allclose(new[k], np.asarray(params[k]), rtol=RTOL,
                                   atol=ATOL)
