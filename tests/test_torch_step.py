"""The step's objective (K8) and update (K9) of the port against the JAX
package: ``dmlc_tpu_torch.ops.step``'s plain versions, which the wrappers
run for CPU tensors, and the models' steps that call them.

K8's plain version is held to ``jax.value_and_grad`` of the reference's
``_weighted_mean(Σ stable_bce_on_logits·w, Σ w)`` in the margins, at
edge cases (m exactly 0, where the gradient is −y·w/W (ROADMAP C4); W = 0;
0 < W < 1; ±1 and {0, 1} labels; |m| of 88 and 3e38; a NaN margin), with
the margins given as two terms and a bias. K9's plain version is held to
the reference's SGD step, ``p − lr·grad`` of the loss with l2, over three
steps of each model, single-part and on the 8-part mesh, fed the
reference's gradients of the loss without l2. Both at rtol=1e-5,
atol=1e-6: fp32 on the CPU on both sides, sums in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from dmlc_tpu.data.padding import pad_single as ref_pad_single
from dmlc_tpu.data.padding import pad_to_bucket as ref_pad_to_bucket
from dmlc_tpu.data.rowblock import RowBlockContainer as RefContainer
from dmlc_tpu.models import SparseFFMModel as RefFFM
from dmlc_tpu.models import SparseFMModel as RefFM
from dmlc_tpu.models import SparseLinearModel as RefLinear
from dmlc_tpu.models import SparseRankingModel as RefRanking
from dmlc_tpu.models.common import _weighted_mean as ref_weighted_mean
from dmlc_tpu.models.common import stable_bce_on_logits as ref_bce
from dmlc_tpu.parallel import make_global_batch as ref_make_global_batch
from dmlc_tpu.parallel import stack_device_batches as ref_stack_batches
from dmlc_tpu_torch.convert import params_from_jax
from dmlc_tpu_torch.data.padding import pad_single, stack_padded_rows
from dmlc_tpu_torch.data.rowblock import RowBlockContainer
from dmlc_tpu_torch.models import (
    SparseFFMModel, SparseFMModel, SparseLinearModel, SparseRankingModel,
)
from dmlc_tpu_torch.ops import step
from dmlc_tpu_torch.parallel.sharded import Mesh, make_global_batch
from dmlc_tpu_torch.utils.logging import DMLCError

RTOL, ATOL = 1e-5, 1e-6
ROWS = 64
PARTS, NCOL, NFIELDS = 8, 24, 3
KINDS = ("linear", "fm", "ffm", "ranking")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ K8

def _objective_case(name, rows=ROWS):
    """(t0, t1, bias, label, weight), float32 numpy, for a K8 case of
    ``rows`` rows."""
    rng = np.random.RandomState(sum(map(ord, name)))
    t0 = rng.randn(rows).astype(np.float32)
    t1 = (0.5 * rng.randn(rows)).astype(np.float32)
    bias = np.float32(0.25)
    label = np.where(rng.rand(rows) > 0.5, 1.0, -1.0).astype(np.float32)
    weight = (rng.rand(rows) + 0.5).astype(np.float32)
    if name == "zero_margin":  # the zero-initialised model's first step
        t0[:] = 0.0
        t1[:] = 0.0
        bias = np.float32(0.0)
    elif name == "some_zero":
        t1[:] = 0.0
        bias = np.float32(0.0)
        t0[::3] = 0.0
    elif name == "labels01":
        label = (rng.rand(rows) > 0.5).astype(np.float32)
    elif name == "graded":  # y = label > 0: 0, 0.5, 2 and -3 read as 0/1
        label = rng.choice([-3.0, 0.0, 0.5, 2.0], rows).astype(np.float32)
    elif name == "all_padded":  # W = 0: loss 0, no gradient
        weight[:] = 0.0
    elif name == "small_weight":  # 0 < W < 1: W is not clamped to 1
        weight = (weight / weight.sum() * 0.37).astype(np.float32)
    elif name == "large_margin":
        t1[:] = 0.0
        bias = np.float32(0.0)
        k = min(8, rows)
        t0[:k] = [88.0, -88.0, 3e38, -3e38, 3e38, -3e38, 88.0, -88.0][:k]
        label[:k] = [1, 0, 1, -1, 0, 1, -1, 1][:k]
        weight[4:6] = 1e-3  # their losses are 3e38: keep the sums finite
    elif name == "nan_margin":
        t0[min(5, rows - 1)] = np.nan
    elif name == "one_term":
        t1 = None
    elif name == "no_bias":
        bias = None
    return t0, t1, bias, label, weight


OBJECTIVE_CASES = ("random", "zero_margin", "some_zero", "labels01",
                   "graded", "all_padded", "small_weight", "large_margin",
                   "nan_margin", "one_term", "no_bias")


def _ref_margins(t0, t1, bias):
    m = t0 if t1 is None else t0 + t1
    return m if bias is None else m + bias


def _ref_objective(m, label, weight):
    """The reference's loss and its gradient in the margins."""
    def loss(m):
        return ref_weighted_mean(jnp.sum(ref_bce(m, label) * weight),
                                 jnp.sum(weight))
    value, grad = jax.value_and_grad(loss)(jnp.asarray(m))
    return np.asarray(value), np.asarray(grad)


def _torch(t0, t1, bias, label, weight):
    terms = [torch.from_numpy(t0)] + ([] if t1 is None
                                      else [torch.from_numpy(t1)])
    b = None if bias is None else torch.tensor(bias)
    return terms, b, torch.from_numpy(label), torch.from_numpy(weight)


@pytest.mark.parametrize("case", OBJECTIVE_CASES)
def test_logistic_step_plain_matches_jax(case):
    t0, t1, bias, label, weight = _objective_case(case)
    want_loss, want_g = _ref_objective(_ref_margins(t0, t1, bias), label,
                                       weight)
    loss, g, gb = step.logistic_step_plain(*_torch(t0, t1, bias, label,
                                                   weight))
    _close(loss, want_loss)
    _close(g, want_g)
    _close(gb, want_g.sum())  # the bias's gradient
    # the wrapper takes the plain version for CPU tensors
    again = step.logistic_step(*_torch(t0, t1, bias, label, weight))
    for a, b in zip(again, (loss, g, gb)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("rows", [1, 511, 513, 8181])
@pytest.mark.parametrize("case", OBJECTIVE_CASES)
def test_logistic_step_plain_matches_jax_at_row_counts(case, rows):
    """K8 on one part at the row counts where its grid of 512-row blocks
    is one partial block, one short of a block, one past it and partial
    at its end: the wrapper's CPU path (the plain version) against the
    reference, as at ROWS."""
    t0, t1, bias, label, weight = _objective_case(case, rows)
    want_loss, want_g = _ref_objective(_ref_margins(t0, t1, bias), label,
                                       weight)
    loss, g, gb = step.logistic_step(*_torch(t0, t1, bias, label, weight))
    _close(loss, want_loss)
    _close(g, want_g)
    _close(gb, want_g.sum())


def test_zero_margin_gradient_is_minus_y_over_W():
    """C4: at m = 0 the reference's subgradient is −y, not σ(0) − y."""
    t0, t1, bias, label, weight = _objective_case("zero_margin")
    _, g, _ = step.logistic_step_plain(*_torch(t0, t1, bias, label, weight))
    y = (label > 0).astype(np.float32)
    _close(g, -y * weight / weight.sum())


@pytest.mark.parametrize("case", OBJECTIVE_CASES)
def test_sharded_split_matches_jax(case):
    """K8's two sharded launches over [2, rows/2] parts of two processes:
    each process's (lsum, wsum), summed as the all-reduce would, then
    each process's gradient from the group's total."""
    t0, t1, bias, label, weight = _objective_case(case)
    want_loss, want_g = _ref_objective(_ref_margins(t0, t1, bias), label,
                                       weight)
    halves = []
    for lo in (0, ROWS // 2):
        part = [None if a is None else a[lo:lo + ROWS // 2].reshape(2, -1)
                for a in (t0, t1)]
        terms, b, y, w = _torch(part[0], part[1], bias,
                                label[lo:lo + ROWS // 2].reshape(2, -1),
                                weight[lo:lo + ROWS // 2].reshape(2, -1))
        halves.append((terms, b, y, w))
    total = sum(step.logistic_sums(*h) for h in halves)
    losses, gs, gbs = zip(*(step.logistic_grad(*h, total) for h in halves))
    for loss in losses:
        _close(loss, want_loss)
    _close(torch.cat([g.reshape(-1) for g in gs]), want_g)
    _close(sum(gbs), want_g.sum())


def test_objective_wrappers_check_their_tensors():
    t0, t1, bias, label, weight = _objective_case("random")
    terms, b, y, w = _torch(t0, t1, bias, label, weight)
    with pytest.raises(DMLCError, match="1 or 2 margin terms"):
        step.logistic_step(terms * 2, b, y, w)
    with pytest.raises(DMLCError, match="term must be float32"):
        step.logistic_step([terms[0][:-1]], b, y, w)
    with pytest.raises(DMLCError, match="weight must be float32"):
        step.logistic_sums(terms, b, y, w.double())
    with pytest.raises(DMLCError, match="bias must be a float32 scalar"):
        step.logistic_step(terms, torch.zeros(2), y, w)
    with pytest.raises(DMLCError, match=r"total must be float32 \[2\]"):
        step.logistic_grad(terms, b, y, w, torch.zeros(3))


# ------------------------------------------------------------ K9

def _ref_model(kind, l2, lr=0.3):
    if kind == "linear":
        return RefLinear(NCOL, l2=l2, learning_rate=lr)
    if kind == "fm":
        return RefFM(NCOL, num_factors=4, l2=l2, learning_rate=lr)
    if kind == "ffm":
        return RefFFM(NCOL, NFIELDS, num_factors=2, l2=l2, learning_rate=lr)
    return RefRanking(NCOL, l2=l2, learning_rate=lr)


def _port_model(kind, l2, lr=0.3):
    if kind == "linear":
        return SparseLinearModel(NCOL, l2=l2, learning_rate=lr,
                                 device="cpu")
    if kind == "fm":
        return SparseFMModel(NCOL, num_factors=4, l2=l2, learning_rate=lr,
                             device="cpu")
    if kind == "ffm":
        return SparseFFMModel(NCOL, NFIELDS, num_factors=2, l2=l2,
                              learning_rate=lr, device="cpu")
    return SparseRankingModel(NCOL, l2=l2, learning_rate=lr, device="cpu")


def _blocks(cls, seed, kind, parts=PARTS):
    """``parts`` blocks of 8 rows below NCOL; FFM rows carry a field per
    feature, ranking rows two queries a block."""
    rng = np.random.RandomState(seed)
    fields = rng.randint(0, NFIELDS, size=NCOL)
    out = []
    for d in range(parts):
        c = cls(np.uint32)
        for r in range(8):
            nnz = rng.randint(1, 6)
            idx = np.sort(rng.choice(NCOL, nnz, replace=False))
            val = rng.rand(nnz).astype(np.float32)
            kw = {}
            if kind == "ffm":
                kw["fields"] = fields[idx].astype(np.int64)
            if kind == "ranking":
                kw["qid"] = d * 2 + r // 4
                label = float(rng.randint(0, 3))
            else:
                label = float(rng.randint(0, 2) * 2 - 1)
            c.push(label, idx, val, **kw)
        out.append(c.get_block())
    return out


def _start_params(ref, seed):
    params = {k: np.asarray(v) for k, v in ref.init_params(seed=seed).items()}
    rng = np.random.RandomState(seed)
    params["w"] = (0.3 * rng.randn(NCOL)).astype(np.float32)
    params["b"] = np.float32(0.1)
    return params


@pytest.fixture(scope="module")
def ref_mesh():
    return RefMesh(np.array(jax.devices()[:PARTS]).reshape(PARTS),
                   ("data",))


def _ref_batches(kind, layout, ref_mesh):
    """Three of the reference's batches: flat padded, or global [8, ...]
    on its 8-device mesh."""
    out = []
    for seed in (1, 2, 3):
        blocks = _blocks(RefContainer, seed, kind)
        if layout == "single":
            c = RefContainer(np.uint32)
            for b in blocks:
                c.push_block(b)
            out.append(dict(ref_pad_single(c.get_block(), 64, 512)))
        else:
            out.append(ref_make_global_batch(ref_stack_batches(
                [ref_pad_to_bucket(b, 8, 64) for b in blocks]), ref_mesh))
    return out


@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("kind", KINDS)
def test_sgd_update_plain_matches_reference_steps(kind, layout, l2,
                                                  ref_mesh):
    """Three reference steps (loss with l2) against K9's plain version fed
    the reference's loss and gradients without l2: K9 adds the l2 term to
    both, once."""
    lr = 0.3
    ref, ref_data = _ref_model(kind, l2, lr), _ref_model(kind, 0.0, lr)
    if layout == "single":
        ref_step = jax.jit(ref.train_step)
        data_loss_fn = ref_data.loss
    else:
        ref_step = ref.make_sharded_train_step(ref_mesh)
        data_loss_fn = ref_data.global_loss_fn(ref_mesh)
    data_grad = jax.jit(jax.value_and_grad(data_loss_fn))
    params = _start_params(ref, seed=4)
    port = params_from_jax(params, device="cpu")
    names = list(port)
    for batch in _ref_batches(kind, layout, ref_mesh):
        jparams = {k: jnp.asarray(v.numpy()) for k, v in port.items()}
        want_params, want_loss = ref_step(jparams, batch)
        data_loss, grads = data_grad(jparams, batch)
        loss = torch.tensor(float(data_loss))
        step.sgd_update([port[k] for k in names],
                        [torch.from_numpy(np.array(grads[k])) for k in names],
                        [k != "b" for k in names], lr, l2, loss)
        _close(loss, want_loss)
        for k in names:
            _close(port[k], want_params[k])


def test_sgd_update_skips_the_loss_term_without_l2():
    p, g = torch.ones(5), torch.full((5,), 2.0)
    loss = torch.tensor(0.5)
    step.sgd_update([p], [g], [True], 0.1, 0.0, loss)
    assert float(loss) == 0.5
    _close(p, np.full(5, 0.8))
    step.sgd_update([p], [g], [False], 0.1, 0.5, loss)  # b: no l2
    assert float(loss) == 0.5
    _close(p, np.full(5, 0.6))


def test_sgd_update_checks_its_tensors():
    p = torch.zeros(4)
    with pytest.raises(DMLCError, match="one gradient and one decay flag"):
        step.sgd_update([p], [], [True], 0.1, 0.0)
    with pytest.raises(DMLCError, match="of one shape"):
        step.sgd_update([p], [torch.zeros(3)], [True], 0.1, 0.0)
    with pytest.raises(DMLCError, match="loss must be a float32 scalar"):
        step.sgd_update([p], [p.clone()], [True], 0.1, 0.1, torch.zeros(2))


@pytest.mark.parametrize("numels, sms, want", [
    ([1], 132, 1),                        # the bias alone
    ([137, 1], 132, 1),                   # the ranking model
    ([10**6, 1], 132, 977),               # the linear model: a float4 a thread
    ([10**6, 1, 8 * 10**6], 132, 1056),   # FM: 8 blocks an SM at most
    ([0], 132, 1),
])
def test_sgd_grid(numels, sms, want):
    assert step.sgd_grid(numels, sms) == want


@pytest.mark.parametrize("n, want", [
    (0, 1), (1, 1), (512, 1), (513, 2),
    (8181, 16),                            # [3, 2727]: a partial last block
    (4 * 8192, 64),                        # the sharded [4, 8192] layout
])
def test_objective_grid(n, want):
    assert step.objective_grid(n) == want


@pytest.mark.parametrize("n, want", [
    (0, 1), (1, 1), (256, 1), (257, 2), (511, 2), (513, 3),
    (8181, 32),                            # a partial last block
    (8192, 32),                            # the main path's batch
    (step.OBJECTIVE_STEP_MAX_ROWS, 128),   # the one-launch route's cap
])
def test_objective_step_grid(n, want):
    assert step.objective_grid(n, step.OBJECTIVE_STEP_ROWS) == want


CAP = step.OBJECTIVE_STEP_MAX_ROWS


@pytest.mark.parametrize("numels, addresses, want", [
    ([137, 1], None, "narrow"),            # the ranking model: 35 + 1 units
    ([1], None, "narrow"),                 # the bias alone
    ([1020, 1], None, "narrow"),           # the widest beside b: 255 + 1
    ([1021, 1], None, "wide"),             # one unit more: 256 + 1
    ([1019, 1], None, "wide"),             # 254 float4s + 3 scalars + 1
    ([10**6, 1], None, "wide"),            # the linear model
    ([10**6, 1, 8 * 10**6], None, "wide"),                # FM
    ([10**6, 1, 39 * 4 * 10**6], None, "wide"),           # FFM
    ([137, 1], [(4, 4), (0, 0)], "narrow"),  # one float off, alike: 38 + 1
    ([137, 1], [(4, 8), (0, 0)], "narrow"),  # aligned apart: 137 + 1
    ([255, 1], [(4, 8), (0, 0)], "narrow"),  # apart: 256 units
    ([256, 1], [(4, 8), (0, 0)], "wide"),    # apart: 257 units
    ([0], None, "narrow"),
])
def test_sgd_route(numels, addresses, want):
    assert step.sgd_route(numels, addresses) == want


@pytest.mark.parametrize("n, want", [
    (0, "grid"), (1, "grid"), (8192, "grid"),  # 8192: the path's batch
    (CAP, "grid"), (CAP + 1, "split"),
])
def test_objective_route(n, want):
    assert step.objective_route(n) == want


# ------------------------------------------------------------ the models

@pytest.fixture
def calls(monkeypatch):
    """Counts the models' calls of the step's wrappers (on the CPU no
    kernel launches, so ``.launches`` stays 0)."""
    seen = {}
    for name in ("logistic_step", "logistic_sums", "logistic_grad",
                 "sgd_update"):
        fn = getattr(step, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(step, name, counted)
    return seen


def _port_batches(kind):
    blocks = _blocks(RowBlockContainer, 5, kind, parts=4)
    c = RowBlockContainer(np.uint32)
    for b in blocks:
        c.push_block(b)
    flat = {k: torch.from_numpy(np.asarray(v))
            for k, v in pad_single(c.get_block(), 32, 256,
                                   want_field=kind == "ffm",
                                   want_qid=kind == "ranking").items()}
    gb = make_global_batch(stack_padded_rows(blocks, 8, 64),
                           Mesh((4,), device="cpu"))
    return flat, gb


@pytest.mark.parametrize("kind", KINDS)
def test_steps_run_the_objective_and_update_once(kind, calls):
    """K8 once a single-part step (its two launches once each a sharded
    step) for the logistic models, never for the ranking model, whose
    objective is K7; K9 once a step for every model."""
    flat, gb = _port_batches(kind)
    model = _port_model(kind, 0.01)
    model.train_step(flat)
    want = {"sgd_update": 1}
    if kind != "ranking":
        want["logistic_step"] = 1
    assert calls == want
    calls.clear()
    model.make_sharded_train_step(Mesh((4,), device="cpu"))(gb)
    want = {"sgd_update": 1}
    if kind != "ranking":
        want.update(logistic_sums=1, logistic_grad=1)
    assert calls == want


@pytest.mark.parametrize("kind", KINDS)
def test_losses_run_the_objective_once(kind, calls):
    """``loss`` and ``global_loss`` take the steps' objective: K8 for the
    logistic models (one launch on a part, its two on a mesh), K7 for the
    ranking model; neither runs the update."""
    flat, gb = _port_batches(kind)
    model = _port_model(kind, 0.01)
    model.loss(flat)
    assert calls == ({} if kind == "ranking" else {"logistic_step": 1})
    calls.clear()
    model.global_loss(gb, Mesh((4,), device="cpu"))
    assert calls == ({} if kind == "ranking"
                     else {"logistic_sums": 1, "logistic_grad": 1})
